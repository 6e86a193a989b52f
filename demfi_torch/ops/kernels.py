"""Hand-written CUDA kernels for Hopper (sm_90a), their build and wrappers.

Three kernels carry the warp ops:

  ``bilinear_gather`` (csrc/bilinear_gather.cu) replaces the TPU kernel
      ``_gather_kernel`` / ``bilinear_gather_tpu``
      (demfi_tpu/ops/pallas_kernels.py:58, :145): the bilinear,
      zero-padded gather behind ``bwarp`` (relative mode) and FGAC's
      ``bilinear_sample_abs`` (absolute mode).
      :func:`bilinear_gather_pair` is the same launch on two halves
      (``bwarp_pair``), the kernel taking both halves' pointers.
  ``fwarp_splat`` (csrc/fwarp_splat.cu) replaces ``_fwarp_kernel`` /
      ``fwarp_tpu`` (pallas_kernels.py:273, :343): the Gaussian forward
      splat behind CFR: float32 atomics, exact for any motion, bits
      that vary from run to run.
  ``fwarp_shift`` (csrc/fwarp_shift.cu) replaces ``_fwarp_shift_kernel_v2``
      and ``_fwarp_shift_kernel`` / ``fwarp_shift_tpu``
      (pallas_kernels.py:479, :421, :551): the same forward warp as an
      atomic-free stencil sum over a (2D+2)^2 window, the same bits every
      run, exact where max|flo| <= D - 1.

Bound: all three functions are bound by device-memory bytes (a few flops
per byte moved). The gather reaches that bound's neighbourhood only at
wide C and a large batch; at every C = 64 shape it delivers about the
same output elements per second whatever its bytes: four tap loads per
output element through the SM's load path hold it. The stencil pays the
search of its window on top of its bytes.

Design, in short (each source file says more): the gather is a 2-D grid
with int32 offsets inside a plane, two query pixels per thread 32 apart,
compile-time channel tiles, chunks of 8 channels per block, streaming
stores, an optional ones plane and a two-half entry. The stencil loads
its source window once per block into shared memory as one packed int32
of floor(flo) per pixel, tests a tap with one load, one subtraction and
one mask, skips rows and columns by per-row ranges reduced while the
tile is loaded, and adds a warp's matches together. The TPU kernels'
banded one-hot matmuls, slab sweeps and +-vr/+-127 motion window were
Mosaic workarounds and are not carried over: the gather and the splat
are exact for any motion and need no runtime guard.

:func:`fwarp_guarded` chooses between the two forward warps without a
copy to the host: the stencil's launch reduces ``any(|flo| > d - 1)`` to
one device flag and either does the work or clears the outputs, and the
splat, given the same flag, does the work or returns at once. Each adds
1 to a device counter when it does the work (:func:`fwarp_served`),
since under the guard a launch does not say which kernel served the
call.

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
           "fwarp_splat": "fwarp_splat.cu",
           "fwarp_shift": "fwarp_shift.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# the largest window of fwarp_shift: its (8 + 2d + 1) x (32 + 2d + 1) int32
# tile must fit the 227 KB of shared memory a block can have
FWARP_SHIFT_MAX_D = 107
# per device: int32 [2], the calls served by (fwarp_shift, fwarp_splat)
_served: Dict[torch.device, torch.Tensor] = {}


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
    """Build (if needed) and load every kernel library. Idempotent; once
    the libraries are loaded a call takes no lock."""
    if len(_libs) == len(SOURCES):
        return _libs
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
        loaded = {name: _bind(name, ctypes.CDLL(str(out_dir / f"lib{name}.so")))
                  for name in SOURCES}
        _libs.update(loaded)     # all at once: the check above counts them
        return _libs


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "bilinear_gather":
        fn = lib.demfi_bilinear_gather_f32
        # img_a, img_b, coords_a, coords_b, out, ones, n, C, H, W, Hq, Wq,
        # relative, stream
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    elif name == "fwarp_splat":
        fn = lib.demfi_fwarp_splat_f32
        # img, flo, out, norm, flag, served, B, C, H, W, stream
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, vp]
    else:
        fn = lib.demfi_fwarp_shift_f32
        # img, flo, out, norm, flag, served, row_stats, B, C, H, W, D, stream
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
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


def _raw_stream(device: torch.device) -> int:
    """The handle of the device's current stream. On an H100's host
    ``torch.cuda.current_stream(device).cuda_stream`` (it builds a Stream
    object) took 11.3 of a wrapper call's 46 microseconds; the raw getter,
    which torch's own generated code calls, takes 0.5
    (``python -m demfi_torch.utils.gather_variants``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def _launch_gather(halves, relative: bool, want_ones: bool):
    """One launch of the gather kernel on one or two (img, coords) halves
    of equal shapes. Returns (out, ones) over all halves' batch elements,
    the first half's first."""
    (img, coords) = halves[0]
    _check("bilinear_gather", *(t for half in halves for t in half))
    n, c, h, w = img.shape
    if coords.dim() != 4 or coords.shape[:2] != (n, 2):
        raise ValueError(f"bilinear_gather: coords {tuple(coords.shape)} "
                         f"for img {tuple(img.shape)}")
    hq, wq = coords.shape[2:]
    if relative and (hq, wq) != (h, w):
        raise ValueError("bilinear_gather: relative mode needs the query "
                         "grid to equal the image grid")
    if any(i.shape != img.shape or q.shape != coords.shape
           for i, q in halves[1:]):
        raise ValueError("bilinear_gather: the two halves differ in shape")
    if h * w >= 2 ** 31 or hq * wq >= 2 ** 31:
        raise ValueError("bilinear_gather: a plane of 2^31 elements or more")
    batch = len(halves) * n
    out = torch.empty((batch, c, hq, wq), dtype=torch.float32,
                      device=img.device)
    ones = (torch.empty((batch, 1, hq, wq), dtype=torch.float32,
                        device=img.device) if relative and want_ones else None)
    img_b, coords_b = halves[1] if len(halves) == 2 else (None, None)
    rc = build()["bilinear_gather"].demfi_bilinear_gather_f32(
        img.data_ptr(), None if img_b is None else img_b.data_ptr(),
        coords.data_ptr(), None if coords_b is None else coords_b.data_ptr(),
        out.data_ptr(), None if ones is None else ones.data_ptr(),
        n, c, h, w, hq, wq, int(relative),
        _raw_stream(img.device))
    _raise_on("bilinear_gather", rc)
    bilinear_gather.launches += 1
    return out, ones


def bilinear_gather(img: torch.Tensor, coords: torch.Tensor, relative: bool,
                    want_ones: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Bilinear zero-padded gather of img [B,C,H,W] at coords [B,2,Hq,Wq].

    relative=True (bwarp): sample at grid + coords (Hq, Wq == H, W) and
    return (out * (ones >= 0.999), ones), ones being the float32 in-image
    weight [B,1,H,W], or None with want_ones=False: the kernel then
    neither allocates nor writes the plane. relative=False (FGAC): sample
    at the absolute coords on any query grid and return (out, None)."""
    if img.device.type == "cpu" and coords.device.type == "cpu":
        out, ones = _warp.bilinear_gather_plain(img, coords, relative)
        return out, ones if want_ones else None
    return _launch_gather([(img, coords)], relative, want_ones)


bilinear_gather.launches = 0


def bilinear_gather_pair(img_a: torch.Tensor, img_b: torch.Tensor,
                         coords_a: torch.Tensor, coords_b: torch.Tensor,
                         relative: bool, want_ones: bool = False):
    """:func:`bilinear_gather` of two halves of equal shapes in one
    launch (counted in ``bilinear_gather.launches``), the kernel taking
    both halves' pointers: nothing is concatenated. Returns
    ((out_a, out_b), (ones_a, ones_b) or None); on the card the two are
    views of one allocation."""
    tensors = (img_a, img_b, coords_a, coords_b)
    if all(t.device.type == "cpu" for t in tensors):
        out_a, ones_a = bilinear_gather(img_a, coords_a, relative, want_ones)
        out_b, ones_b = bilinear_gather(img_b, coords_b, relative, want_ones)
        return (out_a, out_b), (None if ones_a is None else (ones_a, ones_b))
    out, ones = _launch_gather([(img_a, coords_a), (img_b, coords_b)],
                               relative, want_ones)
    n = img_a.shape[0]
    return (out[:n], out[n:]), (None if ones is None
                                else (ones[:n], ones[n:]))


def _served_counter(device: torch.device) -> torch.Tensor:
    counter = _served.get(device)       # a tensor's device has its index
    if counter is not None:
        return counter
    device = torch.device(device.type, device.index
                          if device.index is not None
                          else torch.cuda.current_device())
    with _lock:
        if device not in _served:
            _served[device] = torch.zeros(2, dtype=torch.int32, device=device)
        return _served[device]


def _check_fwarp(name: str, img: torch.Tensor, flo: torch.Tensor) -> None:
    _check(name, img, flo)
    b, _, h, w = img.shape
    if tuple(flo.shape) != (b, 2, h, w):
        raise ValueError(f"{name}: flo {tuple(flo.shape)} for img "
                         f"{tuple(img.shape)}")


def _launch_splat(img, flo, out, norm, flag) -> None:
    b, c, h, w = img.shape
    rc = build()["fwarp_splat"].demfi_fwarp_splat_f32(
        img.data_ptr(), flo.data_ptr(), out.data_ptr(), norm.data_ptr(),
        flag.data_ptr() if flag is not None else None,
        _served_counter(img.device).data_ptr() + 4,
        b, c, h, w, _raw_stream(img.device))
    _raise_on("fwarp_splat", rc)
    fwarp_splat.launches += 1


def _launch_shift(img, flo, d, out, norm, flag, row_stats=None) -> None:
    b, c, h, w = img.shape
    if h * w >= 2 ** 31:
        raise ValueError("fwarp_shift: a plane of 2^31 elements or more")
    rc = build()["fwarp_shift"].demfi_fwarp_shift_f32(
        img.data_ptr(), flo.data_ptr(), out.data_ptr(), norm.data_ptr(),
        flag.data_ptr() if flag is not None else None,
        _served_counter(img.device).data_ptr(),
        row_stats.data_ptr() if row_stats is not None else None,
        b, c, h, w, int(d), _raw_stream(img.device))
    _raise_on("fwarp_shift", rc)
    fwarp_shift.launches += 1


def _fwarp_outputs(img: torch.Tensor, alloc
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, c, h, w = img.shape
    return (alloc((b, c, h, w), dtype=torch.float32, device=img.device),
            alloc((b, 1, h, w), dtype=torch.float32, device=img.device))


def fwarp_splat(img: torch.Tensor, flo: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian forward splat of img [B,C,H,W] by flo [B,2,H,W].
    Returns (warped [B,C,H,W], weight norm [B,1,H,W])."""
    if img.device.type == "cpu" and flo.device.type == "cpu":
        return _warp.fwarp_splat_plain(img, flo)
    _check_fwarp("fwarp_splat", img, flo)
    out, norm = _fwarp_outputs(img, torch.zeros)
    _launch_splat(img, flo, out, norm, None)
    return out, norm


fwarp_splat.launches = 0


def _check_window(name: str, d: int) -> None:
    if not 1 <= d <= FWARP_SHIFT_MAX_D:
        raise ValueError(f"{name}: window d must be in [1, "
                         f"{FWARP_SHIFT_MAX_D}], got {d}")


def fwarp_shift(img: torch.Tensor, flo: torch.Tensor, d: int,
                row_stats: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic forward warp of img [B,C,H,W] by flo [B,2,H,W]: the
    stencil sum over the (2d+2)^2 window, equal to the splat where
    max|flo| <= d - 1; splats beyond the window are dropped.
    1 <= d <= FWARP_SHIFT_MAX_D (107), the largest window whose tile of
    targets fits a block's shared memory; a larger d raises.
    row_stats, for measurement on the card: an int64 [2] tensor to which
    the kernel adds the source rows its warps tested and the rows their
    vote skipped.
    Returns (warped [B,C,H,W], weight norm [B,1,H,W])."""
    _check_window("fwarp_shift", d)
    if img.device.type == "cpu" and flo.device.type == "cpu":
        return _warp.fwarp_shift_plain(img, flo, d)
    _check_fwarp("fwarp_shift", img, flo)
    if row_stats is not None and (
            row_stats.device != img.device or row_stats.dtype != torch.int64
            or row_stats.shape != (2,)):
        raise ValueError("fwarp_shift: row_stats must be an int64 [2] "
                         "tensor on the image's device")
    out, norm = _fwarp_outputs(img, torch.empty)
    _launch_shift(img, flo, d, out, norm, None, row_stats)
    return out, norm


fwarp_shift.launches = 0


def fwarp_guarded(img: torch.Tensor, flo: torch.Tensor, d: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward warp by the stencil kernel where no |flo| exceeds d - 1,
    by the atomic splat otherwise; both exact, only the first with the
    same bits every run. Returns (warped, weight norm).

    On the card both kernels are launched, on one device flag that the
    stencil's launch computes from flo: the stencil does the work or
    clears the outputs, the splat does the work or returns at once.
    Nothing is copied to the host. On the CPU the flag is read and the
    one plain version runs."""
    _check_window("fwarp_guarded", d)
    if img.device.type == "cpu" and flo.device.type == "cpu":
        if bool((flo.abs() > float(d - 1)).any()):
            return _warp.fwarp_splat_plain(img, flo)
        return _warp.fwarp_shift_plain(img, flo, d)
    _check_fwarp("fwarp_guarded", img, flo)
    out, norm = _fwarp_outputs(img, torch.empty)
    flag = torch.empty(1, dtype=torch.int32, device=img.device)
    _launch_shift(img, flo, d, out, norm, flag)
    _launch_splat(img, flo, out, norm, flag)
    return out, norm


WRAPPERS = (bilinear_gather, fwarp_splat, fwarp_shift)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def fwarp_served(device=None, reset: bool = False) -> Dict[str, int]:
    """Forward-warp calls that each kernel served (did the work of) on
    ``device`` since the last reset. Waits for the device."""
    counter = _served_counter(torch.device(device or "cuda"))
    torch.cuda.synchronize(counter.device)
    shift, splat = (int(v) for v in counter.cpu())
    if reset:
        counter.zero_()
        torch.cuda.synchronize(counter.device)
    return {"fwarp_shift": shift, "fwarp_splat": splat}
