"""DeMFI in PyTorch on an NVIDIA Hopper GPU (H100, sm_90a).

A port of ``demfi_tpu`` (JAX/Flax on a TPU). Convolutions, the ConvGRU
and the elementwise code are plain PyTorch; the two irregular-memory warp
ops (the bilinear gather behind ``bwarp`` / FGAC's sampler, and the
forward splat behind CFR) and their gradients are CUDA kernels written
by hand (``demfi_torch/csrc``), each with a plain PyTorch version beside
it (``demfi_torch/ops/warp.py``) that the CPU takes.

Layout conventions:
  - modules work on NCHW tensors: images / features [B, C, H, W];
  - flows are [B, 2, H, W] with channel 0 = dx (along W) and
    channel 1 = dy (along H);
  - frame stacks entering the model are [B, 4, 3, H, W] in the order
    (B0, B1, B-1, B2), BGR in [-1, 1];
  - the inference engine's public surface keeps the JAX package's
    layout: numpy frames [N, 4, H, W, 3] in, NHWC numpy results out.

Entry points (the inference engine, the train step, and ``python -m
demfi_torch.main`` for the reference's ``train`` / ``test`` /
``test_custom`` phases) run on ``cuda`` unless the caller passes
``device="cpu"`` / ``--device cpu``; with no GPU present and no explicit
CPU request they raise. On the card the warp kernels' gradients are
kernels too (``demfi_torch/ops/kernels.py``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the GPU; raise if it is absent. An explicit
    ``"cpu"`` (or any explicit device) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "demfi_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


def disable_tf32() -> None:
    """Float32 parity on the card: turn TF32 off for cuDNN convolutions and
    cuBLAS matmuls, process-wide (cuDNN's float32 convolutions otherwise
    run in TF32; the counterpart of the JAX model's
    ``Precision.HIGHEST``). The inference engine and the train step both
    call it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W, C] -> [..., C, H, W] (contiguous)."""
    nd = x.dim()
    perm = list(range(nd - 3)) + [nd - 1, nd - 3, nd - 2]
    return x.permute(*perm).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """[..., C, H, W] -> [..., H, W, C] (contiguous)."""
    nd = x.dim()
    perm = list(range(nd - 3)) + [nd - 2, nd - 1, nd - 3]
    return x.permute(*perm).contiguous()
