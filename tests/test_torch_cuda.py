"""The port's CUDA kernels and its whole path on the card (marker ``cuda``).

Every test here needs an NVIDIA GPU and skips without one. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the gather uses round-to-nearest arithmetic in its plain
version's order (atol/rtol 1e-5); the splat's atomics add in a varying
order (rounding-level differences, 1e-5 of the largest value); the
stencil forward warp adds in its plain version's order with
round-to-nearest arithmetic (atol/rtol 1e-6, and bitwise equal from run
to run); the whole network, card against CPU, atol/rtol 1e-3 (float32 convolutions of
cuDNN and of the CPU sum in different orders). The backward kernels
against their plain vjps (autograd through the plain versions): 1e-5 of
the largest value per output (the gather's backward adds onto the taps
with float atomics, in an order that varies from run to run; both sum
in another order than autograd; its coordinates' gradient repeats
bitwise); the splat's backward repeats bitwise.
Gradients of the whole network, card against CPU: a relative Frobenius
error of 1e-3 or less per tensor. The bfloat16 model in channels_last
against itself patched back to NCHW: the rules of tests/test_torch_bf16.py
for whole outputs (moments within 0.08, NaN where NaN) and for a train
step's gradients.
"""
import dataclasses

import numpy as np
import pytest
import torch

from demfi_torch import disable_tf32
from demfi_torch.config import config_rb
from demfi_torch.infer import InferenceEngine, WindowResult
from demfi_torch.models import demfi, make_model
from demfi_torch.ops import kernels, warp
from demfi_torch.train import create_train_state, make_train_step
from demfi_torch.utils import grad_check
from demfi_torch.utils.profiling import calibrate_flow_head


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("relative,c,grid", [
    (True, 64, 1), (True, 3, 1), (False, 64, 1), (False, 8, 3)])
def test_gather_kernel_matches_plain(cuda_device, relative, c, grid):
    rng = np.random.RandomState(c)
    b, h, w = 3, 40, 56
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32))
    hq, wq = grid * h, grid * w
    if relative:
        coords = rng.randn(b, 2, hq, wq) * 20
    else:
        coords = np.stack([rng.uniform(-8, w + 8, (b, hq, wq)),
                           rng.uniform(-8, h + 8, (b, hq, wq))], 1)
    coords = torch.from_numpy(coords.astype(np.float32))
    n = kernels.bilinear_gather.launches
    out, ones = kernels.bilinear_gather(img.to(cuda_device),
                                        coords.to(cuda_device), relative)
    torch.cuda.synchronize()
    assert kernels.bilinear_gather.launches == n + 1
    pout, pones = warp.bilinear_gather_plain(img, coords, relative)
    torch.testing.assert_close(out.cpu(), pout, atol=1e-5, rtol=1e-5)
    if relative:
        torch.testing.assert_close(ones.cpu(), pones, atol=1e-5, rtol=1e-5)
    else:
        assert ones is None


def _exact(got: torch.Tensor, want: torch.Tensor) -> None:
    """Max abs error 0; NaN where the plain version has NaN."""
    torch.testing.assert_close(got, want, atol=0, rtol=0, equal_nan=True)


def _gather_inputs(rng, b, c, h, w, hq, wq, relative, dev):
    """An image and coordinates that reach inside and outside it, with
    NaN, infinite and far-outside entries (beyond int32 too)."""
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32))
    if relative:
        coords = rng.randn(b, 2, hq, wq) * 12
    else:
        coords = np.stack([rng.uniform(-6, w + 6, (b, hq, wq)),
                           rng.uniform(-6, h + 6, (b, hq, wq))], 1)
    coords = coords.astype(np.float32)
    coords[0, 0, 0, :6] = [np.nan, np.inf, -np.inf, 1e6, -1e6, 3e9]
    coords[0, 1, 1, :6] = [np.nan, np.inf, -np.inf, 1e6, -1e6, -3e9]
    return img.to(dev), torch.from_numpy(coords).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("c", [1, 3, 4, 5, 16, 64, 70])
def test_gather_kernel_is_exact_at_every_channel_count(cuda_device, relative,
                                                       c):
    """Every channel tile (1-4, the wide tile and its tail, the chunks of
    8) on a 23x57 grid: an odd width, rows that end inside a block and an
    output that is not 16-byte aligned from row to row."""
    rng = np.random.RandomState(100 + c)
    img, coords = _gather_inputs(rng, 2, c, 23, 57, 23, 57, relative,
                                 cuda_device)
    for want_ones in (True, False):
        out, ones = kernels.bilinear_gather(img, coords, relative,
                                            want_ones=want_ones)
        pout, pones = warp.bilinear_gather_plain(img, coords, relative)
        torch.cuda.synchronize()
        _exact(out, pout)
        if relative and want_ones:
            _exact(ones, pones)
        else:
            assert ones is None


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 8])
def test_gather_kernel_on_a_3x_query_grid(cuda_device, c):
    rng = np.random.RandomState(7 + c)
    img, coords = _gather_inputs(rng, 2, c, 19, 33, 57, 99, False, cuda_device)
    out, ones = kernels.bilinear_gather(img, coords, False)
    torch.cuda.synchronize()
    assert ones is None and out.shape == (2, c, 57, 99)
    _exact(out, warp.bilinear_gather_plain(img, coords, False)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("want_ones", [True, False])
@pytest.mark.parametrize("c", [3, 20])
def test_gather_pair_entry_is_exact(cuda_device, c, want_ones):
    """Two separate halves in one launch: each equals its plain version
    and the single entry, and the ones plane comes only on request."""
    rng = np.random.RandomState(c)
    a, fa = _gather_inputs(rng, 3, c, 21, 70, 21, 70, True, cuda_device)
    b, fb = _gather_inputs(rng, 3, c, 21, 70, 21, 70, True, cuda_device)
    n = kernels.bilinear_gather.launches
    (oa, ob), ones = kernels.bilinear_gather_pair(a, b, fa, fb, True,
                                                  want_ones=want_ones)
    torch.cuda.synchronize()
    assert kernels.bilinear_gather.launches == n + 1
    for out, img, flo, k in ((oa, a, fa, 0), (ob, b, fb, 1)):
        pout, pones = warp.bilinear_gather_plain(img, flo, True)
        _exact(out, pout)
        _exact(out, kernels.bilinear_gather(img, flo, True)[0])
        if want_ones:
            _exact(ones[k], pones)
    if not want_ones:
        assert ones is None
    wa, wb = warp.bwarp_pair(a, b, fa, fb)
    _exact(wa, oa)
    _exact(wb, ob)
    with pytest.raises(ValueError):
        kernels.bilinear_gather_pair(a, b[:2].contiguous(), fa,
                                     fb[:2].contiguous(), True)


@pytest.mark.cuda
@pytest.mark.parametrize("relative,hq,wq", [(True, 23, 57), (False, 23, 57),
                                            (False, 69, 171)])
@pytest.mark.parametrize("c", [1, 3, 5, 64, 70])
def test_gather_kernel_bf16_is_exact(cuda_device, relative, hq, wq, c):
    """bfloat16 image values (the bf16 model's warps): out and ones are
    float32 and equal the plain version bit for bit (a bf16 tap widens
    to float32 exactly; the arithmetic after it is the float32 kernel's),
    with NaN, infinite and far-outside coordinates, ragged sizes and a
    3x query grid."""
    rng = np.random.RandomState(200 + c)
    img, coords = _gather_inputs(rng, 2, c, 23, 57, hq, wq, relative,
                                 cuda_device)
    img = img.bfloat16()
    n = kernels.bilinear_gather.launches
    out, ones = kernels.bilinear_gather(img, coords, relative)
    torch.cuda.synchronize()
    assert kernels.bilinear_gather.launches == n + 1
    pout, pones = warp.bilinear_gather_plain(img, coords, relative)
    assert out.dtype == pout.dtype == torch.float32
    _exact(out, pout)
    if relative:
        assert ones.dtype == torch.float32
        _exact(ones, pones)
    else:
        assert ones is None


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 64])
def test_gather_pair_entry_bf16(cuda_device, c):
    """bwarp_pair at bfloat16: one launch, float32 halves, each equal to
    its plain version."""
    rng = np.random.RandomState(300 + c)
    a, fa = _gather_inputs(rng, 2, c, 21, 70, 21, 70, True, cuda_device)
    b, fb = _gather_inputs(rng, 2, c, 21, 70, 21, 70, True, cuda_device)
    a, b = a.bfloat16(), b.bfloat16()
    n = kernels.bilinear_gather.launches
    oa, ob = warp.bwarp_pair(a, b, fa, fb)
    torch.cuda.synchronize()
    assert kernels.bilinear_gather.launches == n + 1
    for out, img, flo in ((oa, a, fa), (ob, b, fb)):
        assert out.dtype == torch.float32
        _exact(out, warp.bilinear_gather_plain(img, flo, True)[0])


@pytest.mark.cuda
def test_gather_bf16_mask_stays_float32(cuda_device):
    """The 0.999 mask reads the float32 in-image weight whatever the
    image's type. Flows push pixels of the last column outside by f, so
    their in-image weight is 1 - f: 0.9985 (f32 closes; a bf16 compare,
    with 0.999 itself rounded to 0.99805, would open), 0.99901 (f32
    opens; a bf16 weight, rounded to 0.99805, would close) and 0.9998
    (both open)."""
    h, w = 8, 56
    img = torch.full((1, 2, h, w), 0.75, device=cuda_device).bfloat16()
    flow = torch.zeros((1, 2, h, w), device=cuda_device)
    fs = (1.5e-3, 9.9e-4, 2e-4)
    for row, f in enumerate(fs):
        flow[0, 0, row, w - 1] = f
    out, ones = kernels.bilinear_gather(img, flow.contiguous(), True)
    pout, pones = warp.bilinear_gather_plain(img, flow, True)
    torch.cuda.synchronize()
    _exact(out, pout)
    _exact(ones, pones)
    assert ones.dtype == out.dtype == torch.float32
    for row, f in enumerate(fs):
        wgt = float(ones[0, 0, row, w - 1])
        assert abs(wgt - (1.0 - f)) < 1e-5, (f, wgt)
        got = out[0, :, row, w - 1]
        if wgt >= 0.999:
            torch.testing.assert_close(got, torch.full_like(got, 0.75 * wgt))
        else:
            assert float(got.abs().max()) == 0.0, (f, wgt, got)
    assert float(ones[0, 0, 0, w - 1]) < 0.999 <= float(ones[0, 0, 1, w - 1])


@pytest.mark.cuda
def test_splat_kernel_matches_plain(cuda_device):
    rng = np.random.RandomState(3)
    img = torch.from_numpy(rng.randn(3, 2, 40, 56).astype(np.float32) * 20)
    flo = torch.from_numpy(rng.randn(3, 2, 40, 56).astype(np.float32) * 20)
    n = kernels.fwarp_splat.launches
    out, norm = kernels.fwarp_splat(img.to(cuda_device), flo.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.fwarp_splat.launches == n + 1
    pout, pnorm = warp.fwarp_splat_plain(img, flo)
    torch.testing.assert_close(out.cpu(), pout,
                               atol=1e-5 * float(pout.abs().max()), rtol=1e-5)
    torch.testing.assert_close(norm.cpu(), pnorm,
                               atol=1e-5 * float(pnorm.abs().max()), rtol=1e-5)


SPLAT_TILE = (8, 32)         # fwarp_splat.cu's source tile: rows, columns


def _splat_flows(rng, kind: str, b: int, h: int, w: int) -> np.ndarray:
    """Flows [b,2,h,w]: "smooth" (an offset of a few px that varies
    slowly: every source tile's targets fit the kernel's shared box),
    "noise" (i.i.d. +-24 px) or "mixed" (the top half smooth, the bottom
    noise: both routes in one launch)."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    smooth = (np.stack([1.5 * np.sin(xx / 40.0 + yy / 30.0) + 4.3,
                        1.2 * np.cos(yy / 35.0 - xx / 50.0) - 2.6])[None]
              * rng.uniform(0.5, 1.5, (b, 1, 1, 1)))
    noise = rng.uniform(-24, 24, (b, 2, h, w))
    if kind == "smooth":
        flo = smooth
    elif kind == "noise":
        flo = noise
    else:
        flo = np.concatenate([smooth[:, :, :h // 2], noise[:, :, h // 2:]], 2)
    return np.ascontiguousarray(flo, np.float32)


def _close_to_plain(out, norm, pout, pnorm) -> None:
    """Within 1e-5 of the largest value: atomics add in a varying order."""
    scale = max(1.0, float(pout.abs().max()), float(pnorm.abs().max()))
    torch.testing.assert_close(out, pout, atol=1e-5 * scale, rtol=1e-5)
    torch.testing.assert_close(norm, pnorm, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("flows", ["smooth", "noise", "mixed"])
@pytest.mark.parametrize("h,w", [(37, 75), (40, 56), (70, 130)])
@pytest.mark.parametrize("c", [1, 2, 3, 5])
def test_splat_kernel_routes_match_plain(cuda_device, c, h, w, flows):
    """Sizes that are no multiples of the 8x32 source tile, W a multiple
    of 4 (16-byte flush) or not (scalar flush), on flows whose tiles take
    the shared box, global atomics or both in one launch: equal to the
    plain version, one launch, and every block counted on one route."""
    rng = np.random.RandomState(c * 1000 + h + w)
    b = 2
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32) * 4).to(
        cuda_device)
    flo = torch.from_numpy(_splat_flows(rng, flows, b, h, w)).to(cuda_device)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    n = kernels.fwarp_splat.launches
    out, norm = kernels.fwarp_splat(img, flo, route_stats=stats)
    pout, pnorm = warp.fwarp_splat_plain(img, flo)
    torch.cuda.synchronize()
    assert kernels.fwarp_splat.launches == n + 1
    _close_to_plain(out, norm, pout, pnorm)
    shared, spilled = (int(v) for v in stats.cpu())
    ty, tx = SPLAT_TILE
    assert shared + spilled == b * -(-h // ty) * -(-w // tx)
    if flows == "smooth":
        assert spilled == 0
    if flows == "mixed":
        assert shared > 0
    if flows != "smooth" and (h, w) == (70, 130):
        # a noise tile's box spans about 56x80 targets: no C fits it
        assert spilled > 0


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("h,w", [(37, 75), (40, 56)])
def test_splat_kernel_drops_non_finite_flows(cuda_device, c, h, w):
    """NaN, infinite and +-1e9 flow entries drop their source pixel: the
    output is finite, equal to the plain version on the flows with those
    entries set to 1e9 (which drops them there too), and such pixels do
    not widen their tile's box (smooth flows stay on the shared route)."""
    rng = np.random.RandomState(c + h)
    b = 2
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        cuda_device)
    flo = _splat_flows(rng, "smooth", b, h, w)
    bad = [np.nan, np.inf, -np.inf, 1e9, -1e9]
    flo[0, 0, 3, 5:10] = bad
    flo[0, 1, 9, 20:25] = bad
    flo[1, 0, h - 1, w - 5:] = bad
    flo[1, 1, 17, 40:45] = bad
    flo[1, :, 30, 2:7] = np.array(bad, np.float32)[None]
    dropped = np.where(np.isfinite(flo) & (np.abs(flo) < 1e8), flo,
                       np.float32(1e9)).astype(np.float32)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    out, norm = kernels.fwarp_splat(img, torch.from_numpy(flo).to(cuda_device),
                                    route_stats=stats)
    pout, pnorm = warp.fwarp_splat_plain(
        img, torch.from_numpy(dropped).to(cuda_device))
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(norm).all())
    _close_to_plain(out, norm, pout, pnorm)
    assert int(stats[1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,c", [(8, 2), (3, 5), (20, 1)])
def test_shift_kernel_matches_plain_and_repeats(cuda_device, d, c):
    rng = np.random.RandomState(d)
    img = torch.from_numpy(rng.randn(3, c, 40, 56).astype(np.float32) * 5)
    flo = rng.uniform(-(d - 1), d - 1, (3, 2, 40, 56)).astype(np.float32)
    flo[0, :, :6] = np.round(flo[0, :, :6])      # bucket edges
    flo = torch.from_numpy(flo)
    n = kernels.fwarp_shift.launches
    out, norm = kernels.fwarp_shift(img.to(cuda_device), flo.to(cuda_device), d)
    again, nagain = kernels.fwarp_shift(img.to(cuda_device),
                                        flo.to(cuda_device), d)
    torch.cuda.synchronize()
    assert kernels.fwarp_shift.launches == n + 2
    assert torch.equal(out, again) and torch.equal(norm, nagain)
    pout, pnorm = warp.fwarp_shift_plain(img, flo, d)
    torch.testing.assert_close(out.cpu(), pout, atol=1e-6 * float(
        pout.abs().max()), rtol=1e-6)
    torch.testing.assert_close(norm.cpu(), pnorm, atol=1e-6, rtol=1e-6)
    # inside the window the stencil is the splat
    sout, snorm = warp.fwarp_splat_plain(img, flo)
    torch.testing.assert_close(out.cpu(), sout, atol=1e-5 * float(
        sout.abs().max()), rtol=1e-5)
    torch.testing.assert_close(norm.cpu(), snorm, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("d", [1, 3, 8, 20, 32])
def test_shift_kernel_is_bitwise_its_plain_version(cuda_device, d, c):
    """Sizes that are no multiples of the 32x16 tile, flows with NaN,
    infinities and displacements beyond the window (dropped, as the
    plain version drops them): bitwise equal to fwarp_shift_plain on the
    card and to a second run."""
    rng = np.random.RandomState(10 * d + c)
    h, w = 37, 75
    img = torch.from_numpy(rng.randn(2, c, h, w).astype(np.float32) * 3)
    flo = rng.uniform(-(d - 1), d - 1, (2, 2, h, w)).astype(np.float32)
    flo[0, :, :5] = np.round(flo[0, :, :5])             # bucket edges
    flo[1, :, 5:9] = rng.uniform(-2.5 * d, 2.5 * d, (2, 4, w))  # beyond
    flo[1, 0, 10, :4] = [np.nan, np.inf, -np.inf, 1e9]
    flo[1, 1, 11, :4] = [np.nan, np.inf, -np.inf, -1e9]
    img, flo = img.to(cuda_device), torch.from_numpy(flo).to(cuda_device)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    out, norm = kernels.fwarp_shift(img, flo, d)
    again, nagain = kernels.fwarp_shift(img, flo, d, row_stats=stats)
    pout, pnorm = warp.fwarp_shift_plain(img, flo, d)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(norm, nagain)
    assert torch.equal(out, pout) and torch.equal(norm, pnorm)
    assert bool(torch.isfinite(out).all())
    tested, skipped = (int(v) for v in stats.cpu())
    # every warp (32 pixels of one row, in blocks of 16 rows, 4 channels
    # a pass) considers its 2d + 2 source rows
    warps = 2 * (-(-h // 16) * 16) * -(-w // 32) * -(-c // 4)
    assert tested == warps * (2 * d + 2) and 0 <= skipped < tested


@pytest.mark.cuda
def test_shift_kernel_largest_window(cuda_device):
    """The largest window whose tile fits a block's shared
    memory is served, bitwise; the next one is refused and launches nothing."""
    d = kernels.FWARP_SHIFT_MAX_D
    rng = np.random.RandomState(d)
    img = torch.from_numpy(rng.randn(1, 2, 20, 45).astype(np.float32)).to(
        cuda_device)
    flo = torch.from_numpy(rng.uniform(-40, 40, (1, 2, 20, 45)).astype(
        np.float32)).to(cuda_device)
    out, norm = kernels.fwarp_shift(img, flo, d)
    pout, pnorm = warp.fwarp_shift_plain(img, flo, d)
    torch.cuda.synchronize()
    assert torch.equal(out, pout) and torch.equal(norm, pnorm)
    n = kernels.fwarp_shift.launches
    with pytest.raises(ValueError, match="window d"):
        kernels.fwarp_shift(img, flo, d + 1)
    with pytest.raises(ValueError, match="window d"):
        kernels.fwarp_guarded(img, flo, d + 1)
    assert kernels.fwarp_shift.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("peak,served_by", [(6.9, "fwarp_shift"),
                                            (30.0, "fwarp_splat")])
def test_guard_routes_between_the_two_kernels(cuda_device, peak, served_by):
    """fwarp(shift_d=8) launches both kernels on one device flag, which
    the stencil's launch computes; the one whose case it is does the
    work, and the result is the forward warp either way."""
    rng = np.random.RandomState(7)
    img = torch.from_numpy(rng.randn(2, 2, 40, 56).astype(np.float32))
    flo = torch.from_numpy(rng.uniform(-peak, peak, (2, 2, 40, 56)).astype(
        np.float32))
    kernels.fwarp_served(cuda_device, reset=True)
    counts = kernels.launch_counts()
    out, norm = warp.fwarp(img.to(cuda_device), flo.to(cuda_device), shift_d=8)
    served = kernels.fwarp_served(cuda_device)
    assert served == {"fwarp_shift": int(served_by == "fwarp_shift"),
                      "fwarp_splat": int(served_by == "fwarp_splat")}
    assert kernels.fwarp_shift.launches == counts["fwarp_shift"] + 1
    assert kernels.fwarp_splat.launches == counts["fwarp_splat"] + 1
    pout, pnorm = warp.fwarp_splat_plain(img, flo)
    torch.testing.assert_close(out.cpu(), pout, atol=1e-5 * float(
        pout.abs().max()), rtol=1e-5)
    torch.testing.assert_close(norm.cpu(), pnorm, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_dispatch_fetch_on_the_card(cuda_device):
    """dispatch_windows + fetch_windows on the engine's stream equal
    forward_windows bit for bit when CFR takes the deterministic warp."""
    cfg = config_rb(1, 1, seed=2, fwarp_shift_d=8)
    model = make_model(cfg)
    frames = np.random.RandomState(5).uniform(
        -1, 1, (2, 4, 32, 64, 3)).astype(np.float32)
    calibrate_flow_head(model, torch.from_numpy(frames).to(
        cuda_device).permute(0, 1, 4, 2, 3), 6.0)
    engine = InferenceEngine(model, 1, fetch="images")
    ts = np.tile(np.array([0.25, 0.5, 0.75], np.float32), (2, 1))
    kernels.fwarp_served(cuda_device, reset=True)
    want = engine.forward_windows(frames, ts)
    first = engine.dispatch_windows(frames, ts)
    second = engine.dispatch_windows(frames[::-1].copy(), ts)
    got, rev = engine.fetch_windows(first), engine.fetch_windows(second)
    assert kernels.fwarp_served(cuda_device) == {"fwarp_shift": 6,
                                                 "fwarp_splat": 0}
    assert engine.dispatched_windows == 4
    assert engine.dispatched_stream_seconds > 0
    for f in dataclasses.fields(WindowResult):
        for a, b in ((got[0], want[0]), (got[1], want[1]), (rev[1], want[0])):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    img = torch.zeros((1, 3, 8, 8), device=cuda_device)
    flo = torch.zeros((1, 2, 8, 8), device=cuda_device)
    with pytest.raises(TypeError):
        kernels.bilinear_gather(img.double(), flo.double(), relative=True)
    # bfloat16: the gather's image only; never converted
    bf = img.bfloat16()
    with pytest.raises(TypeError):
        kernels.bilinear_gather(img, flo.bfloat16(), relative=True)
    with pytest.raises(TypeError):
        kernels.bilinear_gather_pair(bf, img, flo, flo, relative=True)
    with pytest.raises(TypeError):
        kernels.bilinear_gather_bwd(bf, flo, True, img.bfloat16())
    with pytest.raises(TypeError):
        kernels.fwarp_splat(flo.bfloat16(), flo)
    with pytest.raises(TypeError):
        kernels.fwarp_shift(flo.bfloat16(), flo, 4)
    with pytest.raises(TypeError):
        kernels.fwarp_guarded(flo, flo.bfloat16(), 4)
    with pytest.raises(TypeError):
        kernels.fwarp_splat_bwd(flo.bfloat16(), flo, flo, flo[:, :1])
    with pytest.raises(TypeError):
        kernels.fwarp_splat_bwd_pair(flo, flo, flo, flo[:, :1],
                                     flo.bfloat16(), flo, flo, flo[:, :1])
    with pytest.raises(ValueError):     # halves of unequal shapes
        kernels.fwarp_splat_bwd_pair(flo, flo, flo, flo[:, :1], img, flo,
                                     img, flo[:, :1])
    with pytest.raises(ValueError):
        kernels.fwarp_pair(flo, flo, img, flo)
    with pytest.raises(ValueError):
        kernels.fwarp_splat(img.transpose(2, 3), flo)
    with pytest.raises(ValueError, match="stats"):
        kernels.fwarp_splat(img, flo, route_stats=torch.zeros(
            2, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError):
        kernels.bilinear_gather(img, flo.cpu(), relative=True)
    with pytest.raises(ValueError):
        kernels.bilinear_gather(img, torch.zeros((1, 2, 4, 8), device=cuda_device),
                                relative=True)
    with pytest.raises(ValueError):
        kernels.fwarp_shift(img, flo, 0)
    with pytest.raises(ValueError):
        kernels.fwarp_guarded(img, flo, 0)
    with pytest.raises(ValueError):
        kernels.fwarp_guarded(img, flo[:, :1].contiguous(), 4)
    with pytest.raises(ValueError):
        kernels.fwarp_guarded(img, flo.cpu(), 4)


@pytest.mark.cuda
def test_engine_card_matches_cpu(cuda_device):
    """x4 DeMFI-Net_rb(2,2) at 32x48: the card's path (kernels) against
    the port on the CPU (plain versions), every WindowResult field."""
    cfg = config_rb(2, 2, seed=1)
    gpu_model = make_model(cfg)
    cpu_model = make_model(cfg, device="cpu")
    frames = np.random.RandomState(4).uniform(
        -1, 1, (1, 4, 32, 48, 3)).astype(np.float32)
    ts = np.array([[0.25, 0.5, 0.75]], np.float32)
    counts = kernels.launch_counts()
    got = InferenceEngine(gpu_model, 2).forward_windows(frames, ts)[0]
    assert kernels.bilinear_gather.launches == counts["bilinear_gather"] + 2 + 2 + 2
    assert kernels.fwarp_splat.launches == counts["fwarp_splat"] + 2
    want = InferenceEngine(cpu_model, 2, device="cpu").forward_windows(
        frames, ts)[0]
    for f in dataclasses.fields(WindowResult):
        np.testing.assert_allclose(getattr(got, f.name), getattr(want, f.name),
                                   atol=1e-3, rtol=1e-3, err_msg=f.name)


# ------------------------------------------------ bf16 memory format
MOMENTS = 0.08      # tests/test_torch_bf16.py, (c)


def _nchw_model(monkeypatch):
    """The model's format chooser patched back to NCHW."""
    monkeypatch.setattr(demfi, "activation_format",
                        lambda dt, dev: torch.contiguous_format)


def _output_fields(out) -> dict:
    got = {}
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        for i, x in enumerate(v if isinstance(v, tuple) else (v,)):
            got[f"{f.name}{i}"] = x.float().cpu().numpy().astype(np.float64)
    return got


@pytest.mark.cuda
def test_bf16_model_runs_channels_last_on_the_card(cuda_device, monkeypatch):
    """DeMFI-Net_rb(2,2) in bfloat16 at 64x96, 3 instants, on the card:
    every convolution gets its input channels_last (100 % of the calls in
    the layout), the warps' inputs are copied to NCHW and counted, and
    every output has the NaN sites, mean and std (within 0.08) of the
    same model patched back to NCHW: the rule of tests/test_torch_bf16.py
    (c), since bfloat16 rounding in another order is chaotic through the
    depth."""
    model = make_model(config_rb(2, 2, seed=11, compute_dtype="bfloat16"))
    rng = np.random.RandomState(8)
    frames = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 3, 64, 96)).astype(
        np.float32)).to(cuda_device)
    calibrate_flow_head(model, frames, 6.0)
    t = torch.tensor([0.25, 0.5, 0.75], device=cuda_device)

    def serve():
        kernels.reset_layout_counts()
        with torch.no_grad():
            out = model.synthesize(model.extract(frames).repeat(3), t, 2)
        return _output_fields(out), kernels.layout_counts()
    got, counts = serve()
    assert counts["conv_calls"] > 0
    assert counts["conv_in_layout"] == counts["conv_calls"]
    assert counts["warp_copies"] == 4 + 4 + 2 + 4 + 4 * 2
    _nchw_model(monkeypatch)
    want, nchw_counts = serve()
    assert nchw_counts["conv_calls"] == counts["conv_calls"]
    assert nchw_counts["conv_in_layout"] == counts["conv_calls"]
    assert nchw_counts["warp_copies"] == 0
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        ok = ~np.isnan(w)
        assert abs(g[ok].mean() - w[ok].mean()) <= MOMENTS, name
        assert abs(g[ok].std() - w[ok].std()) <= MOMENTS, name


@pytest.mark.cuda
def test_bf16_train_step_channels_last_on_the_card(cuda_device, monkeypatch):
    """A bfloat16 train step of DeMFI-Net_rb(2,2) at batch 2, 64x64 on the
    card, channels_last against the same step patched back to NCHW, the
    rule of tests/test_torch_bf16.py (d): the loss within 1e-2
    (relative) and each gradient within the larger of 1e-2 and twice the
    NCHW step's own change under a 1e-6 nudge of the batch, the largest
    of three nudges (a bias's bfloat16 gradient sums cotangents that
    cancel: one nudge moved one by 14 %, and the layout by 29 %)."""
    rng = np.random.RandomState(12)
    frames = rng.uniform(-1, 1, (2, 9, 64, 64, 3)).astype(np.float32)
    nudges = [frames + (rng.randn(*frames.shape) * 1e-6).astype(np.float32)
              for _ in range(3)]
    t = np.array([[0.25], [0.625]], np.float32)
    cfg = config_rb(2, 2, seed=13, compute_dtype="bfloat16")

    def step(batch):
        model = make_model(cfg)
        kernels.reset_layout_counts()
        loss = float(make_train_step(cfg)(create_train_state(cfg, model),
                                          batch, t)["total_loss"])
        return loss, {k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None}, kernels.layout_counts()
    loss, got, counts = step(frames)
    assert counts["conv_in_layout"] == counts["conv_calls"] > 0
    _nchw_model(monkeypatch)
    want_loss, want, _ = step(frames)
    moved = [step(nudged)[1] for nudged in nudges]
    assert loss == pytest.approx(want_loss, rel=1e-2)
    assert set(got) == set(want)
    for k, g in want.items():
        err = grad_check.rel_frobenius(got[k], g)
        bound = max(1e-2, 2 * max(grad_check.rel_frobenius(m[k], g)
                                  for m in moved))
        assert err <= bound, (k, err, bound)


# --------------------------------------------------------------- backward
def _within(got: torch.Tensor, want: torch.Tensor, rel: float = 1e-5) -> None:
    """Within rel of the largest |value| of want (and finite)."""
    assert bool(torch.isfinite(got).all())
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got.cpu(), want.cpu(), atol=rel * scale,
                               rtol=0)


def _bwd_coords(rng, kind, b, h, w, hq, wq, relative):
    """Coordinates for the gather's backward: "mixed" (motion that leaves
    every edge, so the relative mask zeroes pixels and taps fall outside),
    "integer" (whole-pixel values: floor' = 0 at an integer) or "edge"
    (taps on the image's last rows and columns)."""
    if kind == "integer":
        c = np.round(rng.randn(b, 2, hq, wq) * 4)
        if not relative:
            c = np.stack([rng.randint(-2, w + 2, (b, hq, wq)),
                          rng.randint(-2, h + 2, (b, hq, wq))], 1)
    elif kind == "edge":
        c = np.stack([rng.uniform(w - 2, w + 0.5, (b, hq, wq)),
                      rng.uniform(h - 2, h + 0.5, (b, hq, wq))], 1)
        if relative:
            c = c - np.stack(np.meshgrid(np.arange(wq), np.arange(hq)), 0)[None]
    else:
        c = (rng.randn(b, 2, hq, wq) * 12 if relative else
             np.stack([rng.uniform(-6, w + 6, (b, hq, wq)),
                       rng.uniform(-6, h + 6, (b, hq, wq))], 1))
    return c.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "integer", "edge"])
@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("c", [1, 2, 3, 64])
def test_gather_bwd_kernel_matches_plain_vjp(cuda_device, c, relative, kind):
    """Ragged sizes; masked pixels, taps outside the image, integer and
    edge coordinates: one launch, within 1e-5 of the plain vjp."""
    rng = np.random.RandomState(c * 10 + relative)
    b, h, w = 2, 37, 75
    hq, wq = (h, w) if relative else (29, 83)
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        cuda_device)
    coords = torch.from_numpy(_bwd_coords(rng, kind, b, h, w, hq, wq,
                                          relative)).to(cuda_device)
    gout = torch.from_numpy(rng.randn(b, c, hq, wq).astype(np.float32)).to(
        cuda_device)
    n = kernels.bilinear_gather_bwd.launches
    gi, gc = kernels.bilinear_gather_bwd(img, coords, relative, gout)
    torch.cuda.synchronize()
    assert kernels.bilinear_gather_bwd.launches == n + 1
    pi, pc = warp.bilinear_gather_plain_vjp(img, coords, relative, gout)
    _within(gi, pi)
    _within(gc, pc)
    if relative and kind == "mixed":
        _, ones = warp.bilinear_gather_plain(img, coords, True)
        masked = (ones < 0.999).expand_as(gc)
        assert bool(masked.any()) and float(gc[masked].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("flows", ["noise", "tile_constant"])
@pytest.mark.parametrize("c", [3, 64])
def test_gather_pair_bwd_is_one_launch(cuda_device, c, flows):
    """bwarp_pair's backward: one launch over both halves, each half equal
    to the single backward's result (its coordinates' gradient bitwise,
    a per-pixel sum in one thread), on 9 px noise flows (both routes) and
    on tile-constant flows (every block on the box route)."""
    rng = np.random.RandomState(c)
    b, h, w = 2, 40, 56
    t = [torch.from_numpy(x.astype(np.float32)).to(cuda_device) for x in (
        rng.randn(b, c, h, w), rng.randn(b, c, h, w),
        rng.randn(b, 2, h, w) * 9, rng.randn(b, 2, h, w) * 9,
        rng.randn(b, c, h, w), rng.randn(b, c, h, w))]
    if flows == "tile_constant":
        t[2], t[3] = (torch.from_numpy(_tile_constant(rng, b, h, w)).to(
            cuda_device) for _ in range(2))
    a, bb, fa, fb, ga, gb = t
    n = kernels.bilinear_gather_bwd.launches
    (gia, gib), (gca, gcb) = kernels.bilinear_gather_pair_bwd(
        a, bb, fa, fb, ga, gb, True)
    torch.cuda.synchronize()
    assert kernels.bilinear_gather_bwd.launches == n + 1
    for img, co, g, gi, gc in ((a, fa, ga, gia, gca), (bb, fb, gb, gib, gcb)):
        si, sc = kernels.bilinear_gather_bwd(img, co, True, g)
        assert torch.equal(gc, sc)
        _within(gi, si, 1e-6)
        pi, pc = warp.bilinear_gather_plain_vjp(img, co, True, g)
        _within(gi, pi)
        _within(gc, pc)


BWD_TILE = (8, 32)      # bilinear_gather_bwd.cu's query tile: rows, columns
BWD_MAX_AREA = 2048     # its largest box (floats a channel) on the box route


def _tile_constant(rng, b, h, w) -> np.ndarray:
    """Relative flows [b,2,h,w] of one offset (up to +-6 px) per 8x32
    query tile: every tile's taps form a box of about 9x40."""
    ty, tx = BWD_TILE
    per = rng.uniform(-6, 6, (b, 2, -(-h // ty), -(-w // tx)))
    return np.ascontiguousarray(
        np.repeat(np.repeat(per, ty, 2), tx, 3)[:, :, :h, :w], np.float32)


def _bwd_route_case(rng, case, b):
    """(coords [b,2,h,w] float32, relative, h, w) for the backward's
    routes: "smooth" (tile-constant relative flows, W a multiple of 4),
    "ragged" (the same at W % 4 != 0: a scalar flush), "noise" (i.i.d.
    relative flows of 12-40 px either way: boxes far beyond the buffer),
    "mixed" (the top 32 rows smooth, the rest noise) or "fgac" (smooth
    absolute coordinates inside a 25x25 corner of a 256x256 plane, as
    FGAC's raw flow values put every tile's taps near the origin)."""
    if case == "fgac":
        h = w = 256
        yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        ph = rng.uniform(0, 6, (b, 1, 1))
        co = np.stack([12 + 10 * np.sin(xx / 57.0 + yy / 83.0 + ph),
                       12 + 10 * np.cos(yy / 61.0 - xx / 79.0 + ph)], 1)
        co = co + rng.uniform(-0.5, 0.5, co.shape)
        return np.ascontiguousarray(co, np.float32), False, h, w
    h, w = {"smooth": (37, 96), "ragged": (37, 75)}.get(case, (96, 160))
    smooth = _tile_constant(rng, b, h, w)
    noise = (rng.uniform(12, 40, (b, 2, h, w))
             * rng.choice([-1.0, 1.0], (b, 2, h, w))).astype(np.float32)
    if case in ("smooth", "ragged"):
        return smooth, True, h, w
    if case == "noise":
        return noise, True, h, w
    return np.concatenate([smooth[:, :, :32], noise[:, :, 32:]], 2), True, h, w


def _bwd_routes(coords, relative, h, w):
    """(box, global): the blocks that must take each route. A pixel is
    live if the mask keeps it and a tap lies in the image; a block's box
    spans its live pixels' tap bases plus one row and column, clipped to
    the image, its columns widened to groups of 4."""
    co = torch.from_numpy(coords)
    b, _, hq, wq = co.shape
    px, py = co[:, 0], co[:, 1]
    keep = torch.ones(b, hq, wq, dtype=torch.bool)
    if relative:
        px = px + torch.arange(wq, dtype=torch.float32)
        py = py + torch.arange(hq, dtype=torch.float32)[:, None]
        ones = warp.bilinear_gather_plain(torch.ones(b, 1, h, w), co, True)[1]
        keep = ones[:, 0] >= 0.999
    x0, y0 = torch.floor(px), torch.floor(py)
    inside = torch.zeros_like(keep)
    for dy in (0, 1):
        for dx in (0, 1):
            inside |= ((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0)
                       & (y0 + dy < h))
    live = keep & inside
    ty, tx = BWD_TILE
    box = spread = 0
    for i in range(b):
        for r in range(0, hq, ty):
            for c in range(0, wq, tx):
                sel = live[i, r:r + ty, c:c + tx]
                if not bool(sel.any()):
                    box += 1
                    continue
                rows = y0[i, r:r + ty, c:c + tx][sel].long()
                cols = x0[i, r:r + ty, c:c + tx][sel].long()
                rb = max(int(rows.min()), 0)
                bh = min(int(rows.max()) + 1, h - 1) - rb + 1
                cb = max(int(cols.min()), 0) & ~3
                bw = ((min(int(cols.max()) + 1, w - 1) | 3) - cb) + 1
                if bh * bw > BWD_MAX_AREA:
                    spread += 1
                else:
                    box += 1
    return box, spread


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["smooth", "noise", "fgac", "mixed",
                                  "ragged"])
@pytest.mark.parametrize("c", [1, 3, 5, 64])
def test_gather_bwd_routes_match_plain_vjp(cuda_device, c, case, dtype):
    """The backward's two routes: one launch, each block on the route its
    taps' box calls for (counted by the kernel), within 1e-5 of the plain
    vjp's largest value (a bfloat16 image's gradient 1e-2), and
    grad_coords bitwise equal from run to run. C = 5 is no multiple of a
    chunk; C = 64 takes several chunks of the box."""
    rng = np.random.RandomState(c * 100 + len(case))
    b = 2
    coords, relative, h, w = _bwd_route_case(rng, case, b)
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        cuda_device).to(dtype)
    co = torch.from_numpy(coords).to(cuda_device)
    gout = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        cuda_device)
    stats = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    n = kernels.bilinear_gather_bwd.launches
    gi, gc = kernels.bilinear_gather_bwd(img, co, relative, gout,
                                         route_stats=stats)
    torch.cuda.synchronize()
    assert kernels.bilinear_gather_bwd.launches == n + 1
    assert gi.dtype == dtype and gc.dtype == torch.float32
    pi, pc = warp.bilinear_gather_plain_vjp(img, co, relative, gout)
    _within(gi.float(), pi.float(), 1e-2 if dtype == torch.bfloat16 else 1e-5)
    _within(gc, pc)
    _, gc2 = kernels.bilinear_gather_bwd(img, co, relative, gout)
    assert torch.equal(gc, gc2)
    box, spread = (int(v) for v in stats.cpu())
    assert (box, spread) == _bwd_routes(coords, relative, h, w)
    if case in ("smooth", "ragged", "fgac"):
        assert spread == 0
    elif case == "noise":
        assert box == 0
    else:
        assert box > 0 and spread > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "edge"])
@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("c", [1, 3, 64])
def test_gather_bwd_kernel_bf16_matches_plain_vjp(cuda_device, c, relative,
                                                  kind):
    """bfloat16 image values: grad_img bfloat16 (float32 sums rounded
    once, in the plain vjp too, in another order) within 1e-2 of the
    largest value of the plain vjp, grad_coords float32 within 1e-5;
    masked pixels get no coordinate gradient."""
    rng = np.random.RandomState(c * 10 + relative + 500)
    b, h, w = 2, 37, 75
    hq, wq = (h, w) if relative else (29, 83)
    img = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        cuda_device).bfloat16()
    coords = torch.from_numpy(_bwd_coords(rng, kind, b, h, w, hq, wq,
                                          relative)).to(cuda_device)
    gout = torch.from_numpy(rng.randn(b, c, hq, wq).astype(np.float32)).to(
        cuda_device)
    n = kernels.bilinear_gather_bwd.launches
    gi, gc = kernels.bilinear_gather_bwd(img, coords, relative, gout)
    torch.cuda.synchronize()
    assert kernels.bilinear_gather_bwd.launches == n + 1
    assert gi.dtype == torch.bfloat16 and gc.dtype == torch.float32
    pi, pc = warp.bilinear_gather_plain_vjp(img, coords, relative, gout)
    assert pi.dtype == torch.bfloat16 and pc.dtype == torch.float32
    _within(gi.float(), pi.float(), 1e-2)
    _within(gc, pc)
    # the float32 sums, rounded once: within a bf16 rounding of the exact
    # vjp (the float32 image's, on the same values)
    ei, ec = warp.bilinear_gather_plain_vjp(img.float(), coords, relative,
                                            gout)
    _within(gi.float(), ei, 2 ** -8)
    _within(gc, ec)
    if relative and kind == "mixed":
        _, ones = warp.bilinear_gather_plain(img, coords, True)
        masked = (ones < 0.999).expand_as(gc)
        assert bool(masked.any()) and float(gc[masked].abs().max()) == 0.0


@pytest.mark.cuda
def test_gather_pair_bwd_bf16(cuda_device):
    """bwarp_pair's backward at bfloat16 under autograd: one launch each
    way, bfloat16 image gradients and float32 flow gradients, against the
    plain vjp."""
    rng = np.random.RandomState(77)
    b, c, h, w = 2, 64, 40, 56
    a, bb = (torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        cuda_device).bfloat16().requires_grad_(True) for _ in range(2))
    fa, fb = (torch.from_numpy((rng.randn(b, 2, h, w) * 9).astype(
        np.float32)).to(cuda_device).requires_grad_(True) for _ in range(2))
    ga, gb = (torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32)).to(
        cuda_device) for _ in range(2))
    n = kernels.launch_counts()
    with torch.enable_grad():
        oa, ob = warp.bwarp_pair(a, bb, fa, fb)
        assert oa.dtype == ob.dtype == torch.float32
        torch.autograd.backward((oa, ob), (ga, gb))
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["bilinear_gather"] == n["bilinear_gather"] + 1
    assert after["bilinear_gather_bwd"] == n["bilinear_gather_bwd"] + 1
    for img, flo, g in ((a, fa, ga), (bb, fb, gb)):
        assert img.grad.dtype == torch.bfloat16
        assert flo.grad.dtype == torch.float32
        pi, pc = warp.bilinear_gather_plain_vjp(img.detach(), flo.detach(),
                                                True, g)
        _within(img.grad.float(), pi.float(), 1e-2)
        _within(flo.grad, pc)


@pytest.mark.cuda
def test_warps_under_autograd_on_the_card(cuda_device):
    """bwarp, bwarp_pair, FGAC's absolute sample (also on a 3Hx3W query
    grid) and the three forward-warp entries under autograd on the card:
    every input's gradient within 1e-5 of CPU autograd through the plain
    versions, one backward launch per forward call, and the same splat
    backward whichever forward kernel served."""
    rng = np.random.RandomState(5)
    b, c, h, w = 2, 5, 33, 47

    def pair(*arrays):
        cpu = [torch.from_numpy(x.astype(np.float32)).requires_grad_()
               for x in arrays]
        gpu = [x.detach().to(cuda_device).requires_grad_() for x in cpu]
        return cpu, gpu

    def check(fn, arrays, n_gather, n_splat):
        cpu, gpu = pair(*arrays)
        before = kernels.launch_counts()
        outs_g = fn(*gpu)
        outs_c = fn(*cpu)
        weights = [torch.from_numpy(rng.randn(*o.shape).astype(np.float32))
                   for o in outs_c]
        sum((o * wt).sum() for o, wt in zip(outs_c, weights)).backward()
        sum((o * wt.to(cuda_device)).sum()
            for o, wt in zip(outs_g, weights)).backward()
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        assert after["bilinear_gather_bwd"] - before["bilinear_gather_bwd"] \
            == n_gather
        assert after["fwarp_splat_bwd"] - before["fwarp_splat_bwd"] == n_splat
        for xc, xg in zip(cpu, gpu):
            _within(xg.grad, xc.grad)

    img = rng.randn(b, c, h, w)
    flo = rng.randn(b, 2, h, w) * 6
    check(lambda x, f: (warp.bwarp(x, f),), (img, flo), 1, 0)
    check(lambda x, y, f, g: warp.bwarp_pair(x, y, f, g),
          (img, rng.randn(b, c, h, w), flo, rng.randn(b, 2, h, w) * 6), 1, 0)
    absc = np.stack([rng.uniform(-4, w + 4, (b, h, w)),
                     rng.uniform(-4, h + 4, (b, h, w))], 1)
    check(lambda x, f: (warp.bilinear_sample_abs(x, f),), (img, absc), 1, 0)
    check(lambda x, f: (warp.bilinear_sample_abs(
        x, warp.fgac_window_coords(f, 1)),), (img, absc), 1, 0)
    small = rng.uniform(-5.5, 5.5, (b, 2, h, w))
    check(lambda x, f: warp.fwarp(x, f), (img, small), 0, 1)
    check(lambda x, f: kernels.fwarp_shift(x, f, 8), (img, small), 0, 1)
    for flows in (small, small * 3):   # the stencil serves, then the splat
        check(lambda x, f: warp.fwarp(x, f, 8), (img, flows), 0, 1)
    t = np.full((b, 1, 1, 1), 0.375)
    # CFR's two forward warps: one backward launch on both halves
    check(lambda f0, f1: warp.cfr_flow_t_align(
        f0, f1, torch.as_tensor(t, dtype=torch.float32, device=f0.device)),
        (small, rng.uniform(-5.5, 5.5, (b, 2, h, w))), 0, 1)
    for d in (0, 8):
        check(lambda x, f, y, g: sum(warp.fwarp_pair(x, f, y, g, d), ()),
              (img, small, rng.randn(b, c, h, w), small * 2), 0, 1)


def _splat_bwd_inputs(rng, kind, b, c, h, w, dev):
    img = rng.randn(b, c, h, w).astype(np.float32)
    if kind == "integer":
        flo = np.round(rng.randn(b, 2, h, w) * 5).astype(np.float32)
    else:
        flo = _splat_flows(rng, kind, b, h, w)
    gout = rng.randn(b, c, h, w).astype(np.float32)
    gnorm = rng.randn(b, 1, h, w).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (img, flo, gout, gnorm)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smooth", "noise", "integer"])
@pytest.mark.parametrize("c", [1, 2, 3, 64])
def test_splat_bwd_kernel_matches_plain_vjp_and_repeats(cuda_device, c,
                                                        kind):
    """Ragged sizes, corners outside every edge (noise of +-24 px on
    37x75), integer flows: one launch, within 1e-5 of the plain vjp, and
    the same bits from two runs."""
    rng = np.random.RandomState(c * 7 + len(kind))
    img, flo, gout, gnorm = _splat_bwd_inputs(rng, kind, 2, c, 37, 75,
                                              cuda_device)
    n = kernels.fwarp_splat_bwd.launches
    gi, gf = kernels.fwarp_splat_bwd(img, flo, gout, gnorm)
    gi2, gf2 = kernels.fwarp_splat_bwd(img, flo, gout, gnorm)
    torch.cuda.synchronize()
    assert kernels.fwarp_splat_bwd.launches == n + 2
    assert torch.equal(gi, gi2) and torch.equal(gf, gf2)
    pi, pf = warp.fwarp_splat_plain_vjp(img, flo, gout, gnorm)
    _within(gi, pi)
    _within(gf, pf)


@pytest.mark.cuda
def test_splat_bwd_kernel_zeroes_non_finite_flows(cuda_device):
    """A source pixel whose flow is NaN, infinite or +-1e9 (dropped by the
    forward kernel) gets zero, finite gradients; elsewhere the result is
    the plain vjp's on the flows with those entries set to 1e9."""
    rng = np.random.RandomState(11)
    b, c, h, w = 2, 2, 37, 75
    img, _, gout, gnorm = _splat_bwd_inputs(rng, "smooth", b, c, h, w,
                                            cuda_device)
    flo = _splat_flows(rng, "smooth", b, h, w)
    bad = [np.nan, np.inf, -np.inf, 1e9, -1e9]
    flo[0, 0, 3, 5:10] = bad
    flo[1, 1, 17, 40:45] = bad
    with np.errstate(invalid="ignore"):
        hit = (~(np.isfinite(flo) & (np.abs(flo) < 1e8))).any(1, keepdims=True)
    dropped = np.where(hit, np.float32(1e9), flo).astype(np.float32)
    gi, gf = kernels.fwarp_splat_bwd(img, torch.from_numpy(flo).to(
        cuda_device), gout, gnorm)
    pi, pf = warp.fwarp_splat_plain_vjp(
        img, torch.from_numpy(dropped).to(cuda_device), gout, gnorm)
    torch.cuda.synchronize()
    gone = torch.from_numpy(~hit).to(cuda_device)
    assert bool(torch.isfinite(gi).all()) and bool(torch.isfinite(gf).all())
    assert float(gi[~gone.expand_as(gi)].abs().max()) == 0.0
    assert float(gf[~gone.expand_as(gf)].abs().max()) == 0.0
    _within(gi, pi)
    _within(gf, pf)


def _splat_bwd_pair_inputs(rng, kind, b, c, h, w, dev):
    """Two halves of the splat's backward: (img, flo, gout, gnorm) each."""
    return [_splat_bwd_inputs(rng, kind, b, c, h, w, dev) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smooth", "noise", "integer"])
@pytest.mark.parametrize("c,h,w", [(2, 256, 256), (2, 37, 75), (2, 13, 129),
                                   (1, 37, 75), (3, 21, 200), (64, 9, 33)])
def test_splat_bwd_pair_matches_plain_vjp_and_repeats(cuda_device, c, h, w,
                                                      kind):
    """The kernel on two halves: one launch, within 1e-5 of the plain vjp
    of each half, the same bits from two runs, and the same bits as a
    launch on each half alone (each pixel's corners and channels are
    summed in one fixed order, whatever the grid). Ragged sizes: W not a
    multiple of the 32 source columns a block covers, H not a multiple of
    8; C = 2 is the compile-time case, the others the runtime channel
    loop."""
    rng = np.random.RandomState(c * 11 + h + len(kind))
    a, b = _splat_bwd_pair_inputs(rng, kind, 2, c, h, w, cuda_device)
    n = kernels.fwarp_splat_bwd.launches
    got = kernels.fwarp_splat_bwd_pair(*a, *b)
    again = kernels.fwarp_splat_bwd_pair(*a, *b)
    torch.cuda.synchronize()
    assert kernels.fwarp_splat_bwd.launches == n + 2
    for half, (gi, gf), (gi2, gf2) in zip((a, b), got, again):
        assert torch.equal(gi, gi2) and torch.equal(gf, gf2)
        pi, pf = warp.fwarp_splat_plain_vjp(*half)
        _within(gi, pi)
        _within(gf, pf)
        si, sf = kernels.fwarp_splat_bwd(*half)
        assert torch.equal(gi, si) and torch.equal(gf, sf)


@pytest.mark.cuda
def test_splat_bwd_pair_zeroes_non_finite_flows(cuda_device):
    """In either half, a source pixel whose flow is NaN, infinite or
    +-1e9 gets zero, finite gradients; elsewhere the plain vjp's on the
    flows with those entries set to 1e9."""
    rng = np.random.RandomState(13)
    b, c, h, w = 2, 2, 37, 75
    halves, want = [], []
    for half in range(2):
        img, _, gout, gnorm = _splat_bwd_inputs(rng, "smooth", b, c, h, w,
                                                cuda_device)
        flo = _splat_flows(rng, "smooth", b, h, w)
        bad = [np.nan, np.inf, -np.inf, 1e9, -1e9]
        flo[half, 0, 3 + half, 5:10] = bad
        flo[1 - half, 1, 17, 40:45] = bad
        with np.errstate(invalid="ignore"):
            hit = (~(np.isfinite(flo) & (np.abs(flo) < 1e8))).any(
                1, keepdims=True)
        dropped = np.where(hit, np.float32(1e9), flo).astype(np.float32)
        halves.append((img, torch.from_numpy(flo).to(cuda_device), gout,
                       gnorm))
        want.append((warp.fwarp_splat_plain_vjp(
            img, torch.from_numpy(dropped).to(cuda_device), gout, gnorm),
            torch.from_numpy(~hit).to(cuda_device)))
    got = kernels.fwarp_splat_bwd_pair(*halves[0], *halves[1])
    torch.cuda.synchronize()
    for (gi, gf), ((pi, pf), gone) in zip(got, want):
        assert bool(torch.isfinite(gi).all()) and bool(torch.isfinite(gf).all())
        assert float(gi[~gone.expand_as(gi)].abs().max()) == 0.0
        assert float(gf[~gone.expand_as(gf)].abs().max()) == 0.0
        _within(gi, pi)
        _within(gf, pf)


@pytest.mark.cuda
def test_model_backward_card_matches_cpu(cuda_device):
    """loss.backward() through DeMFI-Net_rb(2,2) on the card: every warp
    passes its gradient on (the flow head's gradient is nonzero), with the
    backward kernels launched (2 FGAC + 2 feature pairs + 2 booster pairs
    gathers, CFR's two splats in one pair launch), and every parameter's
    gradient is the CPU's
    (plain versions under autograd) within the bound of
    ``grad_check.gradient_bounds``: the larger of 1e-3 and twice the
    larger of the CPU's own change under 1e-6 nudges of the frames, drawn
    until one moves the flows as far as the card's lie from them, and the
    card's change between two runs. Upstream of the warps the gradient is
    that ill-conditioned in float32 (a floor or the 0.999 mask flips with
    rounding; on an H100 the card's forward takes such a flip here, its
    flows 1.3e-3 from the CPU's). Warps that pass no gradient on fail
    this bound (tests/test_torch_train.py)."""
    disable_tf32()
    cfg = config_rb(2, 2, seed=3)
    gpu_model = make_model(cfg)
    rng = np.random.RandomState(6)
    frames = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 3, 32, 48)).astype(
        np.float32))
    directions = [rng.randn(2, 4, 3, 32, 48).astype(np.float32)
                  for _ in range(2)]
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 48)).astype(
        np.float32))
    t = torch.tensor([[0.25], [0.625]])
    calibrate_flow_head(gpu_model, frames.to(cuda_device), 6.0)

    def grads(model, dev, x, flows=None):
        out = model(x.to(dev), t.to(dev), num_update=2)
        g = gt.to(dev)
        ((out.st_prime - g).abs().mean()
         + (out.st_final - g).abs().mean()).backward()
        got = {k: None if p.grad is None else p.grad.cpu()
               for k, p in model.named_parameters()}
        if flows is not None:
            flows.append(out.flow_preds.detach().cpu())
        return got

    def cpu_model():
        m = make_model(cfg, device="cpu")
        m.load_state_dict(gpu_model.state_dict())
        return m

    before = kernels.launch_counts()
    flows = []
    got = grads(gpu_model, cuda_device, frames, flows)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    gpu_model.zero_grad(set_to_none=True)
    rerun = grads(gpu_model, cuda_device, frames)
    assert after["bilinear_gather_bwd"] - before["bilinear_gather_bwd"] == 6
    assert after["fwarp_splat_bwd"] - before["fwarp_splat_bwd"] == 1
    want = grads(cpu_model(), "cpu", frames, flows)

    def cpu_step(delta):
        moved = []
        return grads(cpu_model(), "cpu", frames + torch.from_numpy(delta),
                     moved), moved[0]
    bound, _, _ = grad_check.gradient_bounds(
        cpu_step, want, flows[1], flows[0],
        {k: grad_check.rel_frobenius(rerun[k], g) for k, g in got.items()
         if g is not None},
        directions + [np.random.RandomState(s).randn(2, 4, 3, 32, 48).astype(
            np.float32) for s in range(6)])
    head = got["FF_RDB_Module.UPNet.2.weight"]
    assert float(head[2 * cfg.nf:2 * cfg.nf + 4].abs().max()) > 0
    # at rr = 0 FGAC reads no source key: conv_source_k has no gradient
    assert all((got[k] is None) == (want[k] is None) for k in want)
    for k, b in bound.items():
        assert grad_check.rel_frobenius(got[k], want[k]) <= b, k


@pytest.mark.cuda
@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("image_dtype", [torch.float32, torch.bfloat16])
def test_row_offset_kernels(cuda_device, split, image_dtype):
    """The forward kernels on every shard of a frame split by rows
    (--mesh_spatial): the gather pair at its row offset equals the unsplit
    kernel's rows bit for bit and its plain version to 1e-5 (a bfloat16
    image likewise); the splat of a shard's rows into the whole canvas
    agrees with its plain version, and the shards' canvases summed with
    the unsplit splat, to 1e-5 of the largest value; the stencil on a
    shard's rows and halo equals its plain version and the unsplit
    kernel's rows bit for bit."""
    rng = np.random.RandomState(split)
    b, c, h, w, d = 2, 5, 48, 72, 8
    rows = h // split

    def cuda(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(cuda_device)
    img_a, img_b = cuda(b, c, h, w).to(image_dtype), \
        cuda(b, c, h, w).to(image_dtype)
    fa, fb = cuda(b, 2, h, w, scale=6), cuda(b, 2, h, w, scale=6)
    src = cuda(b, 2, h, w)
    flo = torch.from_numpy(rng.uniform(-d + 1.5, d - 1.5, (b, 2, h, w)).astype(
        np.float32)).to(cuda_device)
    whole_g = kernels.bilinear_gather_pair(img_a, img_b, fa, fb, True)[0]
    whole_s = kernels.fwarp_splat(src, flo * 2)
    whole_k = kernels.fwarp_shift(src, flo, d)
    summed = [torch.zeros_like(v) for v in whole_s]
    for i in range(split):
        r0, r1 = i * rows, (i + 1) * rows
        ca, cb = fa[:, :, r0:r1].contiguous(), fb[:, :, r0:r1].contiguous()
        got = kernels.bilinear_gather_pair(img_a, img_b, ca, cb, True,
                                           row0=r0)[0]
        for g, whole, img, cc in zip(got, whole_g, (img_a, img_b), (ca, cb)):
            assert torch.equal(g, whole[:, :, r0:r1])
            torch.testing.assert_close(
                g, warp.bilinear_gather_plain(img, cc, True, r0)[0],
                atol=1e-5, rtol=1e-5)
        sl, fl = src[:, :, r0:r1].contiguous(), \
            (flo * 2)[:, :, r0:r1].contiguous()
        got = kernels.fwarp_splat(sl, fl, rows=(r0, h))
        want = warp.fwarp_splat_plain(sl, fl, (r0, h))
        for g, p, acc in zip(got, want, summed):
            assert g.shape == p.shape
            assert float((g - p).abs().max()) <= 1e-5 * float(p.abs().max())
            acc += g
        lo, hi = max(r0 - d - 1, 0), min(r1 + d, h)
        sh, fh = src[:, :, lo:hi].contiguous(), flo[:, :, lo:hi].contiguous()
        got = kernels.fwarp_shift(sh, fh, d, rows=(r0 - lo, rows))
        want = warp.fwarp_shift_plain(sh, fh, d, (r0 - lo, rows))
        for g, p, whole in zip(got, want, whole_k):
            assert torch.equal(g, p)
            assert torch.equal(g, whole[:, :, r0:r1])
    for acc, whole in zip(summed, whole_s):
        assert float((acc - whole).abs().max()) <= \
            1e-5 * float(whole.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("image_dtype", [torch.float32, torch.bfloat16])
def test_row_offset_backward_kernels(cuda_device, split, image_dtype):
    """The backward kernels on every shard of a frame split by rows
    (training's --mesh_spatial): the gather pair's backward at its row
    offset against its plain vjp (1e-5 of the largest value, a bfloat16
    image's gradient 1e-2), its coordinates' gradient bitwise the unsplit
    kernel's rows and its image gradients, summed over the shards, the
    unsplit kernel's (1e-5); the splat's backward of a shard's source rows
    on the whole frame's cotangents (CFR's two halves in one launch)
    bitwise the unsplit kernel's rows and within 1e-5 of its plain vjp."""
    rng = np.random.RandomState(10 + split)
    b, c, h, w = 2, 5, 48, 72
    rows = h // split

    def cuda(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32)).to(cuda_device)
    img_a, img_b = (cuda(b, c, h, w).to(image_dtype) for _ in range(2))
    fa, fb = cuda(b, 2, h, w, scale=6), cuda(b, 2, h, w, scale=6)
    ga, gb = cuda(b, c, h, w), cuda(b, c, h, w)
    srcs = [cuda(b, 2, h, w) for _ in range(2)]
    flos = [cuda(b, 2, h, w, scale=3) for _ in range(2)]
    gouts = [cuda(b, 2, h, w) for _ in range(2)]
    gnorms = [cuda(b, 1, h, w) for _ in range(2)]
    (wi_a, wi_b), (wc_a, wc_b) = kernels.bilinear_gather_pair_bwd(
        img_a, img_b, fa, fb, ga, gb, True)
    whole_s = kernels.fwarp_splat_bwd_pair(srcs[0], flos[0], gouts[0],
                                           gnorms[0], srcs[1], flos[1],
                                           gouts[1], gnorms[1])
    summed = [torch.zeros(b, c, h, w, device=cuda_device) for _ in range(2)]
    img_tol = 1e-2 if image_dtype == torch.bfloat16 else 1e-5
    for i in range(split):
        r0, r1 = i * rows, (i + 1) * rows

        def sl(t):
            return t[:, :, r0:r1].contiguous()
        n = kernels.bilinear_gather_bwd.launches
        (gi_a, gi_b), (gc_a, gc_b) = kernels.bilinear_gather_pair_bwd(
            img_a, img_b, sl(fa), sl(fb), sl(ga), sl(gb), True, row0=r0)
        assert kernels.bilinear_gather_bwd.launches == n + 1
        for gi, gc, img, f, g, wc, acc in zip(
                (gi_a, gi_b), (gc_a, gc_b), (img_a, img_b), (fa, fb),
                (ga, gb), (wc_a, wc_b), summed):
            assert gi.shape == img.shape and gi.dtype == image_dtype
            pi, pc = warp.bilinear_gather_plain_vjp(img, sl(f), True, sl(g),
                                                    r0)
            assert float((gi.float() - pi.float()).abs().max()) <= \
                img_tol * float(pi.float().abs().max())
            assert float((gc - pc).abs().max()) <= \
                1e-5 * float(pc.abs().max())
            assert torch.equal(gc, wc[:, :, r0:r1])
            acc += gi.float()
        n = kernels.fwarp_splat_bwd.launches
        got = kernels.fwarp_splat_bwd_pair(
            sl(srcs[0]), sl(flos[0]), gouts[0], gnorms[0], sl(srcs[1]),
            sl(flos[1]), gouts[1], gnorms[1], rows=(r0, h))
        assert kernels.fwarp_splat_bwd.launches == n + 1
        for k, ((gi, gf), (wi, wf)) in enumerate(zip(got, whole_s)):
            assert torch.equal(gi, wi[:, :, r0:r1])
            assert torch.equal(gf, wf[:, :, r0:r1])
            pi, pf = warp.fwarp_splat_plain_vjp(
                sl(srcs[k]), sl(flos[k]), gouts[k], gnorms[k], (r0, h))
            for x, p in ((gi, pi), (gf, pf)):
                assert float((x - p).abs().max()) <= \
                    1e-5 * float(p.abs().max())
    for acc, whole in zip(summed, (wi_a, wi_b)):
        assert float((acc - whole.float()).abs().max()) <= \
            img_tol * float(whole.float().abs().max())


@pytest.mark.cuda
def test_row_offset_stencil_gradient(cuda_device):
    """The stencil on a shard's rows and halo under autograd on the card,
    alone (``fwarp_shift(rows=)``) and as CFR's pair (``fwarp_pair(d,
    rows=)``, the split model's path: one backward launch for both
    halves): its gradient is the splat's of the source rows for the
    output rows' cotangent, equal to autograd through the plain stencil
    on the CPU inside its window (1e-5 of the largest value)."""
    rng = np.random.RandomState(3)
    b, c, h, w, d = 2, 2, 40, 36, 8
    srcs = [rng.randn(b, c, h, w).astype(np.float32) for _ in range(2)]
    flos = [rng.uniform(-d + 1.5, d - 1.5, (b, 2, h, w)).astype(np.float32)
            for _ in range(2)]
    cots = [[rng.randn(b, k, 16, w).astype(np.float32) for k in (c, 1)]
            for _ in range(2)]

    def grads_of(dev, pair):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_()
                  for half in zip(srcs, flos) for a in half]
        if pair:
            halves = kernels.fwarp_pair(*leaves, d=d, rows=(9, 16))
        else:
            halves = [kernels.fwarp_shift(*leaves[:2], d, rows=(9, 16))]
        n = kernels.fwarp_splat_bwd.launches
        sum((o * torch.from_numpy(g).to(dev)).sum()
            for outs, cot in zip(halves, cots) for o, g in zip(outs, cot)
            ).backward()
        if dev.type == "cuda":
            assert kernels.fwarp_splat_bwd.launches == n + 1
        return [t.grad.cpu() for t in leaves if t.grad is not None]
    for pair in (False, True):
        got = grads_of(cuda_device, pair)
        want = grads_of(torch.device("cpu"), pair)
        assert len(got) == len(want) == (4 if pair else 2)
        for g, wt in zip(got, want):
            assert float((g - wt).abs().max()) <= \
                1e-5 * float(wt.abs().max())
