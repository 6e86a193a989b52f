"""The port's CUDA kernels and its whole path on the card (marker ``cuda``).

Every test here needs an NVIDIA GPU and skips without one. The file
imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the gather uses round-to-nearest arithmetic in its plain
version's order (atol/rtol 1e-5); the splat's atomics add in a varying
order (rounding-level differences, rtol 1e-5 of the values); the whole
network, card against CPU, atol/rtol 1e-3 (float32 convolutions of
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
