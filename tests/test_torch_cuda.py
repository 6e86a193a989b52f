"""The port's CUDA kernels and its whole path on the card (marker ``cuda``).

Every test here needs an NVIDIA GPU and skips without one. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the gather uses round-to-nearest arithmetic in its plain
version's order (atol/rtol 1e-5); the splat's atomics add in a varying
order (rounding-level differences, rtol 1e-5 of the values); the
stencil forward warp adds in its plain version's order with
round-to-nearest arithmetic (atol/rtol 1e-6, and bitwise equal from run
to run); the whole network, card against CPU, atol/rtol 1e-3 (float32 convolutions of
cuDNN and of the CPU sum in different orders).
"""
import dataclasses

import numpy as np
import pytest
import torch

from demfi_torch.config import config_rb
from demfi_torch.infer import InferenceEngine, WindowResult
from demfi_torch.models import make_model
from demfi_torch.ops import kernels, warp
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
    with pytest.raises(ValueError):
        kernels.fwarp_splat(img.transpose(2, 3), flo)
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
