"""The port's warp and reshape ops against the JAX package's, on the CPU.

The same numpy inputs go through ``demfi_tpu.ops`` (which on the CPU
dispatches to its exact XLA paths) and ``demfi_torch.ops`` (whose kernel
wrappers take the plain PyTorch versions for CPU tensors). Layouts are
transposed at the boundary: JAX is NHWC, the port NCHW.

Tolerances: reshape ops move elements only (atol 0). Warps: atol 1e-5,
rtol 1e-5 (float32; the sums run in another order in the two packages).
Gradients: the port's autograd through the plain versions against
``jax.vjp`` of the JAX package's exact ops, on the same cotangents, at
atol 1e-5, rtol 1e-5.

The CUDA kernels against their plain versions: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demfi_tpu.ops import reshape as jreshape
from demfi_tpu.ops import warp as jwarp
from demfi_torch import nchw_to_nhwc, nhwc_to_nchw
from demfi_torch.ops import kernels, reshape, warp


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

ATOL = RTOL = 1e-5


def to_t(x: np.ndarray) -> torch.Tensor:
    return nhwc_to_nchw(torch.from_numpy(np.array(x, np.float32)))


def to_np(x: torch.Tensor) -> np.ndarray:
    return nchw_to_nhwc(x).numpy()


def close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(to_np(port), np.asarray(ref), atol=atol,
                               rtol=rtol)


@pytest.fixture(scope="module")
def data():
    """Images and flows from 0 to +-40 px on a 24x40 grid, so many taps
    and splat corners fall outside the image."""
    rng = np.random.RandomState(7)
    b, h, w = 2, 24, 40
    img = rng.uniform(-1, 1, (b, h, w, 5)).astype(np.float32)
    flow = (rng.uniform(-1, 1, (b, h, w, 2)) *
            rng.choice([0.0, 0.5, 3.0, 12.0, 40.0], (b, h, w, 1))
            ).astype(np.float32)
    flow2 = (rng.randn(b, h, w, 2) * 6.0).astype(np.float32)
    return img, flow, flow2


@pytest.mark.parametrize("r", [2, 4])
def test_reshape_exact(r):
    x = np.random.RandomState(r).randn(2, 8, 16, 6).astype(np.float32)
    s2d = reshape.space_to_depth(to_t(x), r)
    np.testing.assert_array_equal(to_np(s2d),
                                  np.asarray(jreshape.space_to_depth(x, r)))
    y = np.asarray(jreshape.space_to_depth(x, r))
    np.testing.assert_array_equal(
        to_np(reshape.depth_to_space(to_t(y), r)),
        np.asarray(jreshape.depth_to_space(y, r)))


def test_bwarp(data):
    img, flow, _ = data
    close(warp.bwarp(to_t(img), to_t(flow)), jwarp.bwarp(img, flow))


def test_bwarp_pair(data):
    img, flow, flow2 = data
    a, b = warp.bwarp_pair(to_t(img), to_t(img[::-1]), to_t(flow),
                           to_t(flow2))
    ja, jb = jwarp.bwarp_pair(img, img[::-1].copy(), flow, flow2)
    close(a, ja)
    close(b, jb)


def test_bwarp_pair_rejects_unequal_halves(data):
    img, flow, flow2 = data
    with pytest.raises(ValueError, match="unequal halves"):
        warp.bwarp_pair(to_t(img), to_t(img[:1]), to_t(flow), to_t(flow2))


def _pair_inputs(channels: int, seed: int):
    """Two image halves and two flow fields (0 to +-30 px) on a 20x36
    grid, from a numpy seed, NHWC."""
    rng = np.random.RandomState(seed)
    b, h, w = 3, 20, 36
    a = rng.uniform(-1, 1, (b, h, w, channels)).astype(np.float32)
    c = rng.uniform(-1, 1, (b, h, w, channels)).astype(np.float32)
    fa = (rng.uniform(-1, 1, (b, h, w, 2)) *
          rng.choice([0.0, 0.7, 4.0, 30.0], (b, h, w, 1))).astype(np.float32)
    fc = (rng.randn(b, h, w, 2) * 5.0).astype(np.float32)
    return a, c, fa, fc


@pytest.mark.parametrize("channels", [1, 3, 5])
def test_bwarp_pair_equals_two_bwarps_and_jax(channels):
    """The pair entry gives each half what bwarp gives it, bit for bit,
    and the JAX package's bwarp_pair to 1e-5."""
    a, c, fa, fc = _pair_inputs(channels, 40 + channels)
    got_a, got_c = warp.bwarp_pair(to_t(a), to_t(c), to_t(fa), to_t(fc))
    assert torch.equal(got_a, warp.bwarp(to_t(a), to_t(fa)))
    assert torch.equal(got_c, warp.bwarp(to_t(c), to_t(fc)))
    ja, jc = jwarp.bwarp_pair(a, c, fa, fc)
    close(got_a, ja)
    close(got_c, jc)


@pytest.mark.parametrize("channels", [3, 64])
def test_bwarp_pair_concatenates_nothing(monkeypatch, channels):
    """bwarp_pair hands its halves to the gather as they are: no
    torch.cat of images or flows on the way."""
    a, c, fa, fc = (to_t(x) for x in _pair_inputs(channels, 50 + channels))
    calls = []
    cat = torch.cat
    monkeypatch.setattr(torch, "cat",
                        lambda *args, **kw: calls.append(1) or cat(*args, **kw))
    got_a, got_c = warp.bwarp_pair(a, c, fa, fc)
    monkeypatch.undo()
    assert calls == []
    assert got_a.shape == a.shape and got_c.shape == c.shape


@pytest.mark.parametrize("want_ones", [True, False])
def test_bwarp_is_the_gather_with_or_without_the_ones_plane(data, want_ones):
    """bwarp equals the plain gather's first result whether or not the
    in-image weight plane is asked of the wrapper; bwarp itself asks for
    none."""
    img, flow, _ = data
    want, want_plane = warp.bilinear_gather_plain(to_t(img), to_t(flow), True)
    out, ones = kernels.bilinear_gather(to_t(img), to_t(flow), relative=True,
                                        want_ones=want_ones)
    assert torch.equal(out, want)
    assert torch.equal(warp.bwarp(to_t(img), to_t(flow)), want)
    if want_ones:
        assert torch.equal(ones, want_plane)
    else:
        assert ones is None


def test_bwarp_asks_for_no_ones_plane(data, monkeypatch):
    img, flow, _ = data
    asked = []
    gather = kernels.bilinear_gather

    def spy(*args, **kw):
        asked.append(kw.get("want_ones"))
        return gather(*args, **kw)
    monkeypatch.setattr(kernels, "bilinear_gather", spy)
    warp.bwarp(to_t(img), to_t(flow))
    assert asked == [False]


@pytest.mark.parametrize("want_ones", [True, False])
def test_gather_pair_wrapper_on_cpu(want_ones):
    """The pair wrapper on CPU tensors: the plain version on each half,
    the planes only on request, nothing launched."""
    a, c, fa, fc = (to_t(x) for x in _pair_inputs(4, 60))
    before = kernels.launch_counts()
    outs, ones = kernels.bilinear_gather_pair(a, c, fa, fc, relative=True,
                                              want_ones=want_ones)
    for out, img, flo, k in ((outs[0], a, fa, 0), (outs[1], c, fc, 1)):
        pout, pones = warp.bilinear_gather_plain(img, flo, True)
        assert torch.equal(out, pout)
        if want_ones:
            assert torch.equal(ones[k], pones)
    if not want_ones:
        assert ones is None
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("d", [0, kernels.FWARP_SHIFT_MAX_D + 1])
def test_fwarp_shift_refuses_windows_outside_its_range(data, d):
    """A window below 1 or beyond the largest whose tile fits shared
    memory raises on any device; the largest is taken."""
    img, flow, _ = data
    with pytest.raises(ValueError, match="window d"):
        kernels.fwarp_shift(to_t(img), to_t(flow), d)
    with pytest.raises(ValueError, match="window d"):
        kernels.fwarp_guarded(to_t(img), to_t(flow), d)


@pytest.mark.parametrize("grid", [(24, 40), (30, 17), (72, 120)])
def test_bilinear_sample_abs(data, grid):
    """Absolute coordinates over the image and beyond it, on query grids
    equal to, smaller than and 3x the image grid."""
    img = data[0]
    rng = np.random.RandomState(grid[0])
    coords = np.stack([rng.uniform(-8, 48, (2,) + grid),
                       rng.uniform(-8, 32, (2,) + grid)], -1).astype(np.float32)
    close(warp.bilinear_sample_abs(to_t(img), to_t(coords)),
          jwarp.bilinear_sample_abs(img, coords))


def _fwarp_flows(case: str, rng, b: int, h: int, w: int) -> np.ndarray:
    """Flows [b,h,w,2] (x, y) for the forward splat's cases, NHWC."""
    if case == "tile_constant":
        # constant over 8x32 tiles: every tile's targets form one box
        per_tile = rng.uniform(-6, 6, (b, -(-h // 8), -(-w // 32), 2))
        flow = np.repeat(np.repeat(per_tile, 8, 1), 32, 2)[:, :h, :w]
    elif case == "bucket_edges":
        # integers, -0.0, and values a rounding away from an integer
        flow = rng.randint(-4, 5, (b, h, w, 2)).astype(np.float32)
        flow[flow == 0] = -0.0
        flow[:, ::3, ::2] += np.float32(-1e-8)
        flow[:, 1::3, ::5] = np.float32(-1e-7)
        flow[:, 2::3, 1::4] = np.float32(0.9999999)
    elif case == "noise40":
        flow = rng.uniform(-40, 40, (b, h, w, 2))
    else:
        # "leave_edges": outward motion that carries splats out of the
        # image past all four edges
        yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                             indexing="ij")
        flow = (np.stack([xx, yy], -1)[None] * rng.uniform(6, 14, (b, 1, 1, 2))
                + rng.uniform(-1.5, 1.5, (b, h, w, 2)))
    return flow.astype(np.float32)


FWARP_CASES = ("tile_constant", "bucket_edges", "noise40", "leave_edges")


@pytest.mark.parametrize("case,channels", [("mixed", 5)] + [
    (case, channels) for case in FWARP_CASES for channels in (1, 2, 3)])
def test_fwarp(data, case, channels):
    """The forward splat (plain version) against the JAX package's, on
    flows of every kind the card's tile design treats apart: mixed
    magnitudes up to 40 px, tile-constant, bucket edges, i.i.d. noise and
    motion out of the image."""
    if case == "mixed":
        img, flow, _ = data
    else:
        rng = np.random.RandomState(10 * FWARP_CASES.index(case) + channels)
        b, h, w = 2, 20, 72
        img = rng.uniform(-1, 1, (b, h, w, channels)).astype(np.float32)
        flow = _fwarp_flows(case, rng, b, h, w)
    out, norm = warp.fwarp(to_t(img), to_t(flow))
    jout, jnorm = jwarp.fwarp(img, flow)
    close(out, jout)
    close(norm, jnorm)


@pytest.mark.parametrize("t", [0.125, 0.375, 0.5, 0.875])
def test_cfr_flow_t_align(data, t):
    _, flow, flow2 = data
    tt = np.full((2, 1, 1, 1), t, np.float32)
    f0, f1 = warp.cfr_flow_t_align(to_t(flow), to_t(flow2),
                                   torch.from_numpy(tt))
    j0, j1 = jwarp.cfr_flow_t_align(flow, flow2, tt)
    close(f0, j0)
    close(f1, j1)


@pytest.mark.parametrize("rr,sr", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_fgac_correlate(rr, sr):
    rng = np.random.RandomState(10 * rr + sr)
    b, h, w, c = 2, 12, 20, 8
    ref_k = rng.randn(b, h, w, c).astype(np.float32)
    src_k = rng.randn(b, h, w, c).astype(np.float32)
    flow = np.stack([rng.uniform(-4, w + 4, (b, h, w)),
                     rng.uniform(-4, h + 4, (b, h, w))], -1).astype(np.float32)
    got = warp.fgac_correlate(to_t(ref_k), to_t(src_k), to_t(flow), rr, sr)
    close(got, jwarp.fgac_correlate(jnp.asarray(ref_k), jnp.asarray(src_k),
                                    jnp.asarray(flow), rr, sr))


def test_wrappers_take_plain_version_on_cpu(data):
    """A CPU tensor goes to the plain version and launches nothing."""
    img, flow, _ = data
    before = kernels.launch_counts()
    out, ones = kernels.bilinear_gather(to_t(img), to_t(flow), relative=True)
    pout, pones = warp.bilinear_gather_plain(to_t(img), to_t(flow), True)
    torch.testing.assert_close(out, pout, atol=0, rtol=0)
    torch.testing.assert_close(ones, pones, atol=0, rtol=0)
    out, ones = kernels.bilinear_gather(to_t(img), to_t(flow), relative=False)
    assert ones is None
    s, n = kernels.fwarp_splat(to_t(img), to_t(flow))
    ps, pn = warp.fwarp_splat_plain(to_t(img), to_t(flow))
    torch.testing.assert_close(s, ps, atol=0, rtol=0)
    torch.testing.assert_close(n, pn, atol=0, rtol=0)
    assert kernels.launch_counts() == before


def test_wrappers_refuse_other_devices():
    """No silent path: a tensor that is neither on the CPU nor on a CUDA
    device raises, and nothing is counted."""
    img = torch.empty((1, 3, 8, 8), device="meta")
    flo = torch.empty((1, 2, 8, 8), device="meta")
    before = kernels.launch_counts()
    with pytest.raises(ValueError):
        kernels.bilinear_gather(img, flo, relative=True)
    with pytest.raises(ValueError):
        kernels.fwarp_splat(img, flo)
    assert kernels.launch_counts() == before


# ----------------------------------------------------------------- grads
def _grads_match(port_fn, jax_fn, inputs, seed, atol=ATOL, rtol=RTOL):
    """Every input's gradient: autograd through port_fn (NCHW tensors)
    against jax.vjp of jax_fn (NHWC arrays), for one numpy cotangent of
    each output."""
    jout, vjp = jax.vjp(jax_fn, *[jnp.asarray(x) for x in inputs])
    jout = jout if isinstance(jout, tuple) else (jout,)
    rng = np.random.RandomState(seed)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in jout]
    want = vjp(tuple(cots) if len(cots) > 1 else cots[0])
    xs = [to_t(x).requires_grad_() for x in inputs]
    outs = port_fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o * to_t(c)).sum() for o, c in zip(outs, cots)).backward()
    for x, w in zip(xs, want):
        # an input the output does not read: no gradient here, zeros in JAX
        g = torch.zeros_like(x) if x.grad is None else x.grad
        close(g, w, atol=atol, rtol=rtol)
    return xs


def _flows(kind: str, rng, b: int, h: int, w: int) -> np.ndarray:
    """Flows [b,h,w,2]: "mixed" (0 to +-40 px: taps outside the image and
    pixels the 0.999 mask zeroes), "integer" (whole pixels: floor' = 0 at
    an integer) or "leave_edges" (motion out of every edge)."""
    if kind == "integer":
        return rng.randint(-5, 6, (b, h, w, 2)).astype(np.float32)
    if kind == "leave_edges":
        return _fwarp_flows("leave_edges", rng, b, h, w)
    return (rng.uniform(-1, 1, (b, h, w, 2))
            * rng.choice([0.0, 0.5, 3.0, 12.0, 40.0], (b, h, w, 1))
            ).astype(np.float32)


GRAD_FLOWS = ("mixed", "integer", "leave_edges")


@pytest.mark.parametrize("kind", GRAD_FLOWS)
def test_bwarp_grads(kind):
    rng = np.random.RandomState(GRAD_FLOWS.index(kind))
    img = rng.uniform(-1, 1, (2, 16, 28, 5)).astype(np.float32)
    flow = _flows(kind, rng, 2, 16, 28)
    _, f = _grads_match(warp.bwarp, jwarp._bwarp_xla, [img, flow], 1)
    if kind == "mixed":
        # the mask zeroes some pixels, and with them the flow's gradient
        _, ones = warp.bilinear_gather_plain(to_t(img), to_t(flow), True)
        masked = (ones < 0.999).expand_as(f.grad)
        assert bool(masked.any()) and float(f.grad[masked].abs().max()) == 0


def test_bwarp_pair_grads():
    a, c, fa, fc = _pair_inputs(3, 7)
    _grads_match(warp.bwarp_pair,
                 lambda *x: (jwarp._bwarp_xla(x[0], x[2]),
                             jwarp._bwarp_xla(x[1], x[3])), [a, c, fa, fc], 2)


@pytest.mark.parametrize("grid,integer", [((16, 28), False), ((16, 28), True),
                                          ((48, 84), False)])
def test_bilinear_sample_abs_grads(grid, integer):
    """FGAC's absolute sample: the image grid and the 3Hx3W grid of its
    rr > 0 form, coordinates in and beyond the image, or whole pixels."""
    rng = np.random.RandomState(grid[0] + integer)
    img = rng.uniform(-1, 1, (2, 16, 28, 4)).astype(np.float32)
    coords = np.stack([rng.uniform(-4, 32, (2,) + grid),
                       rng.uniform(-4, 20, (2,) + grid)], -1)
    coords = (np.round(coords) if integer else coords).astype(np.float32)
    _grads_match(warp.bilinear_sample_abs, jwarp._bilinear_abs_xla,
                 [img, coords], 3)


@pytest.mark.parametrize("case,channels", [(c, 2) for c in FWARP_CASES]
                         + [("tile_constant", 5)])
def test_fwarp_grads(case, channels):
    """The forward splat's vjp (image, flow; both outputs' cotangents)."""
    rng = np.random.RandomState(FWARP_CASES.index(case) + channels)
    b, h, w = 2, 16, 40
    img = rng.uniform(-1, 1, (b, h, w, channels)).astype(np.float32)
    flow = _fwarp_flows(case, rng, b, h, w)
    _grads_match(warp.fwarp, jwarp._fwarp_xla, [img, flow], 4)


@pytest.mark.parametrize("t", [0.125, 0.625])
def test_cfr_flow_t_align_grads(t):
    """CFR: both forward warps, the normalisation and the detached norm
    mask (zero-norm pixels pass their flow through)."""
    rng = np.random.RandomState(int(t * 8))
    f01 = _flows("mixed", rng, 2, 16, 28)
    f10 = _flows("leave_edges", rng, 2, 16, 28)
    tt = np.full((2, 1, 1, 1), t, np.float32)
    _grads_match(lambda a, b: warp.cfr_flow_t_align(a, b, torch.from_numpy(tt)),
                 lambda a, b: jwarp.cfr_flow_t_align(a, b, tt), [f01, f10], 5)


@pytest.mark.parametrize("rr,sr", [(0, 0), (1, 1)])
def test_fgac_correlate_grads(rr, sr):
    rng = np.random.RandomState(5 + rr)
    b, h, w, c = 2, 10, 14, 4
    ref_k = rng.randn(b, h, w, c).astype(np.float32)
    src_k = rng.randn(b, h, w, c).astype(np.float32)
    flow = np.stack([rng.uniform(-4, w + 4, (b, h, w)),
                     rng.uniform(-4, h + 4, (b, h, w))], -1).astype(np.float32)
    _grads_match(lambda r, s_, f: warp.fgac_correlate(r, s_, f, rr, sr),
                 lambda r, s_, f: jwarp.fgac_correlate(r, s_, f, rr, sr),
                 [ref_k, src_k, flow], 6)


def _vjp_case(case: str):
    """(img, flow, gout, gnorm) NHWC for the plain-vjp check: "mixed"
    (0 to +-40 px), "tile_constant" (one offset per 8x32 tile: every
    query tile of the card's backward takes its shared-memory box),
    "corner_abs" (values in [0, 5): as absolute coordinates every tap
    falls in a 6x6 corner, as FGAC's raw flows put them near the origin)
    or "ragged" (a width that is not a multiple of 4: the card flushes its
    box entry by entry)."""
    rng = np.random.RandomState(VJP_CASES.index(case) + 8)
    b, (h, w) = 2, {"tile_constant": (16, 40), "corner_abs": (16, 24),
                    "ragged": (12, 21)}.get(case, (12, 20))
    img = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    if case == "tile_constant":
        flow = _fwarp_flows("tile_constant", rng, b, h, w)
    elif case == "corner_abs":
        flow = rng.uniform(0, 5, (b, h, w, 2)).astype(np.float32)
    else:
        flow = _flows("mixed", rng, b, h, w)
    gout = rng.randn(b, h, w, 3).astype(np.float32)
    gnorm = rng.randn(b, h, w, 1).astype(np.float32)
    return img, flow, gout, gnorm


VJP_CASES = ("mixed", "tile_constant", "corner_abs", "ragged")


@pytest.mark.parametrize("case", VJP_CASES)
def test_plain_vjps_are_the_jax_vjps(case):
    """The backward kernels' plain versions, and the backward wrappers on
    CPU tensors, against jax.vjp of _bwarp_xla, _bilinear_abs_xla and
    _fwarp_xla; nothing is launched."""
    img, flow, gout, gnorm = _vjp_case(case)
    before = kernels.launch_counts()
    for relative, jfn in ((True, jwarp._bwarp_xla),
                          (False, jwarp._bilinear_abs_xla)):
        want = jax.vjp(jfn, img, flow)[1](gout)
        for fn in (warp.bilinear_gather_plain_vjp, kernels.bilinear_gather_bwd):
            gi, gc = fn(to_t(img), to_t(flow), relative, to_t(gout))
            close(gi, want[0])
            close(gc, want[1])
    (gia, gib), (gca, gcb) = kernels.bilinear_gather_pair_bwd(
        to_t(img), to_t(img), to_t(flow), to_t(flow), to_t(gout), to_t(gout),
        True)
    want = jax.vjp(jwarp._bwarp_xla, img, flow)[1](gout)
    for gi, gc in ((gia, gca), (gib, gcb)):
        close(gi, want[0])
        close(gc, want[1])
    want = jax.vjp(jwarp._fwarp_xla, img, flow)[1]((gout, gnorm))
    for fn in (warp.fwarp_splat_plain_vjp, kernels.fwarp_splat_bwd):
        gi, gf = fn(to_t(img), to_t(flow), to_t(gout), to_t(gnorm))
        close(gi, want[0])
        close(gf, want[1])
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("peak", [3.0, 6.9])
def test_cpu_guarded_gradient_is_the_splats(peak):
    """Inside its window (max|flo| <= d - 1) the CPU's guarded forward
    warp runs the stencil's plain version; autograd through it gives the
    splat's gradient (which the card's backward kernel computes)."""
    rng = np.random.RandomState(int(peak))
    img = rng.uniform(-1, 1, (2, 3, 18, 30)).astype(np.float32)
    flo = rng.uniform(-peak, peak, (2, 2, 18, 30)).astype(np.float32)
    cot = [rng.randn(2, 3, 18, 30), rng.randn(2, 1, 18, 30)]
    grads = []
    for fn in (lambda i, f: warp.fwarp(i, f, 8), warp.fwarp_splat_plain):
        i = torch.from_numpy(img).requires_grad_()
        f = torch.from_numpy(flo).requires_grad_()
        sum((o * torch.from_numpy(c.astype(np.float32))).sum()
            for o, c in zip(fn(i, f), cot)).backward()
        grads.append((i.grad, f.grad))
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, atol=ATOL, rtol=RTOL)


def test_autograd_functions_route_to_the_backward_kernels(monkeypatch):
    """The card's autograd wiring, run on the CPU with the kernel
    launchers replaced by their plain versions: each Function gives the
    plain versions' gradients, saves what its forward read, launches one
    backward per forward, and the in-image weight plane carries no
    gradient. Under no_grad no Function is built."""
    def gather(halves, relative, want_ones):
        outs = [warp.bilinear_gather_plain(i.detach(), c.detach(), relative)
                for i, c in halves]
        kernels.bilinear_gather.launches += 1
        return (torch.cat([o for o, _ in outs]),
                torch.cat([o for _, o in outs]) if relative and want_ones
                else None)

    def gather_bwd(halves, relative, route_stats=None):
        r = [warp.bilinear_gather_plain_vjp(i, c, relative, g)
             for i, c, g in halves]
        kernels.bilinear_gather_bwd.launches += 1
        return torch.cat([a for a, _ in r]), torch.cat([b for _, b in r])

    def splat(img, flo, stats=None):
        kernels.fwarp_splat.launches += 1
        return tuple(t.detach() for t in warp.fwarp_splat_plain(
            img.detach(), flo.detach()))

    def splat_bwd(img, flo, gout, gnorm):
        kernels.fwarp_splat_bwd.launches += 1
        return warp.fwarp_splat_plain_vjp(img, flo, gout, gnorm)

    monkeypatch.setattr(kernels, "_launch_gather", gather)
    monkeypatch.setattr(kernels, "_launch_gather_bwd", gather_bwd)
    monkeypatch.setattr(kernels, "_launch_splat_bwd", splat_bwd)
    rng = np.random.RandomState(9)

    def leaf(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).requires_grad_()

    def grads_of(fn, xs):
        for x in xs:
            x.grad = None
        outs = fn(*xs)
        sum((o * (k + 1)).square().sum() for k, o in enumerate(outs)
            if o is not None and o.requires_grad).backward()
        return [x.grad.clone() for x in xs]

    a, b = leaf(2, 3, 9, 11), leaf(2, 3, 9, 11)
    fa, fb = leaf(2, 2, 9, 11, scale=3), leaf(2, 2, 9, 11, scale=3)
    before = kernels.launch_counts()
    got = grads_of(lambda *x: kernels._GatherPair.apply(*x, True, True)[:2],
                   [a, b, fa, fb])
    want = grads_of(lambda x, y, f, g: (
        warp.bilinear_gather_plain(x, f, True)[0],
        warp.bilinear_gather_plain(y, g, True)[0]), [a, b, fa, fb])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    out, ones = kernels._Gather.apply(a, fa, True, True)
    assert out.requires_grad and not ones.requires_grad
    got = grads_of(lambda x, f: kernels._Gather.apply(x, f, False, False)[:1],
                   [a, fa])
    want = grads_of(lambda x, f: (warp.bilinear_gather_plain(x, f, False)[0],),
                    [a, fa])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    img, flo = leaf(2, 2, 9, 11), leaf(2, 2, 9, 11, scale=2)
    got = grads_of(lambda i, f: kernels._Fwarp.apply(i, f, splat, None),
                   [img, flo])
    want = grads_of(warp.fwarp_splat_plain, [img, flo])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "bilinear_gather": 3, "fwarp_splat": 1, "fwarp_shift": 0,
        "bilinear_gather_bwd": 2, "fwarp_splat_bwd": 1}
    assert not kernels._needs_grad(a.detach(), fa.detach())
    with torch.no_grad():
        assert not kernels._needs_grad(a, fa)
