"""Hand-written CUDA kernels for Hopper (sm_90a), their build and wrappers.

Two kernels carry the warp ops of the main path:

  ``bilinear_gather`` (csrc/bilinear_gather.cu) replaces the TPU kernel
      ``_gather_kernel`` / ``bilinear_gather_tpu``
      (demfi_tpu/ops/pallas_kernels.py:58, :145): the bilinear,
      zero-padded gather behind ``bwarp`` (relative mode) and FGAC's
      ``bilinear_sample_abs`` (absolute mode).
  ``fwarp_splat`` (csrc/fwarp_splat.cu) replaces ``_fwarp_kernel`` /
      ``fwarp_tpu`` (pallas_kernels.py:273, :343): the Gaussian forward
      splat behind CFR.

Both are bound by device-memory bytes (a few flops per byte moved); each
source file says what its design does about it. The TPU kernels' banded
one-hot matmuls, slab sweep and +-vr/+-127 motion window were Mosaic
workarounds and are not carried over: these kernels are exact for any
motion and need no runtime guard.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` of each
source into its own shared library with a plain C interface (one nvcc
per source, all started together), loaded with ctypes. The build runs at
first use, from the sources in this checkout, into
``demfi_torch/_build/<hash of sources and flags>/``.

Wrappers: a CPU tensor goes to the kernel's plain version in
``demfi_torch/ops/warp.py``; a CUDA tensor launches the kernel on the
current stream or raises. Each wrapper counts its launches in
``<wrapper>.launches``, incremented where the kernel is launched and
nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from demfi_torch.ops import warp as _warp

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = {"bilinear_gather": "bilinear_gather.cu",
           "fwarp_splat": "fwarp_splat.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Dict[str, ctypes.CDLL]:
    """Build (if needed) and load every kernel library. Idempotent."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        out_dir = _build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, src in SOURCES.items():
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, lib)
        errors = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{SOURCES[name]}:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        for name in SOURCES:
            _libs[name] = _bind(name, ctypes.CDLL(str(out_dir / f"lib{name}.so")))
        return _libs


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "bilinear_gather":
        fn = lib.demfi_bilinear_gather_f32
        # img, coords, out, ones, B, C, H, W, Hq, Wq, relative, stream
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    else:
        fn = lib.demfi_fwarp_splat_f32
        # img, flo, out, norm, B, C, H, W, stream
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, vp]
    fn.restype = i
    return lib


def _check(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on different devices")


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def bilinear_gather(img: torch.Tensor, coords: torch.Tensor, relative: bool
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Bilinear zero-padded gather of img [B,C,H,W] at coords [B,2,Hq,Wq].

    relative=True (bwarp): sample at grid + coords (Hq, Wq == H, W) and
    return (out * (ones >= 0.999), ones), ones being the float32 in-image
    weight [B,1,H,W]. relative=False (FGAC): sample at the absolute coords
    on any query grid and return (out, None)."""
    if img.device.type == "cpu" and coords.device.type == "cpu":
        return _warp.bilinear_gather_plain(img, coords, relative)
    _check("bilinear_gather", img, coords)
    b, c, h, w = img.shape
    if coords.dim() != 4 or coords.shape[:2] != (b, 2):
        raise ValueError(f"bilinear_gather: coords {tuple(coords.shape)} "
                         f"for img {tuple(img.shape)}")
    hq, wq = coords.shape[2:]
    if relative and (hq, wq) != (h, w):
        raise ValueError("bilinear_gather: relative mode needs the query "
                         "grid to equal the image grid")
    lib = build()["bilinear_gather"]
    out = torch.empty((b, c, hq, wq), dtype=torch.float32, device=img.device)
    ones = (torch.empty((b, 1, hq, wq), dtype=torch.float32,
                        device=img.device) if relative else None)
    rc = lib.demfi_bilinear_gather_f32(
        img.data_ptr(), coords.data_ptr(), out.data_ptr(),
        ones.data_ptr() if relative else None,
        b, c, h, w, hq, wq, int(relative),
        torch.cuda.current_stream(img.device).cuda_stream)
    _raise_on("bilinear_gather", rc)
    bilinear_gather.launches += 1
    return out, ones


bilinear_gather.launches = 0


def fwarp_splat(img: torch.Tensor, flo: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian forward splat of img [B,C,H,W] by flo [B,2,H,W].
    Returns (warped [B,C,H,W], weight norm [B,1,H,W])."""
    if img.device.type == "cpu" and flo.device.type == "cpu":
        return _warp.fwarp_splat_plain(img, flo)
    _check("fwarp_splat", img, flo)
    b, c, h, w = img.shape
    if tuple(flo.shape) != (b, 2, h, w):
        raise ValueError(f"fwarp_splat: flo {tuple(flo.shape)} for img "
                         f"{tuple(img.shape)}")
    lib = build()["fwarp_splat"]
    out = torch.zeros((b, c, h, w), dtype=torch.float32, device=img.device)
    norm = torch.zeros((b, 1, h, w), dtype=torch.float32, device=img.device)
    rc = lib.demfi_fwarp_splat_f32(
        img.data_ptr(), flo.data_ptr(), out.data_ptr(), norm.data_ptr(),
        b, c, h, w, torch.cuda.current_stream(img.device).cuda_stream)
    _raise_on("fwarp_splat", rc)
    fwarp_splat.launches += 1
    return out, norm


fwarp_splat.launches = 0

WRAPPERS = (bilinear_gather, fwarp_splat)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}
