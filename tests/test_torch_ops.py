"""The port's warp and reshape ops against the JAX package's, on the CPU.

The same numpy inputs go through ``demfi_tpu.ops`` (which on the CPU
dispatches to its exact XLA paths) and ``demfi_torch.ops`` (whose kernel
wrappers take the plain PyTorch versions for CPU tensors). Layouts are
transposed at the boundary: JAX is NHWC, the port NCHW.

Tolerances: reshape ops move elements only (atol 0). Warps: atol 1e-5,
rtol 1e-5 (float32; the sums run in another order in the two packages).

The CUDA kernels against their plain versions: tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

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


def test_fwarp(data):
    img, flow, _ = data
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
