"""Hand-written CUDA kernels for Hopper (sm_90a), their build and wrappers.

Three kernels carry the warp ops forward:

  ``bilinear_gather`` (csrc/bilinear_gather.cu) replaces the TPU kernel
      ``_gather_kernel`` / ``bilinear_gather_tpu``
      (demfi_tpu/ops/pallas_kernels.py:58, :145): the bilinear,
      zero-padded gather behind ``bwarp`` (relative mode) and FGAC's
      ``bilinear_sample_abs`` (absolute mode). Its image is float32 or
      bfloat16 (one instantiation each; the bf16 model's feature and
      image warps), everything else float32: the coordinates, weights,
      accumulation, the 0.999 mask, ``ones`` and the output.
      :func:`bilinear_gather_pair` is the same launch on two halves
      (``bwarp_pair``), the kernel taking both halves' pointers.
  ``fwarp_splat`` (csrc/fwarp_splat.cu) replaces ``_fwarp_kernel`` /
      ``fwarp_tpu`` (pallas_kernels.py:273, :343): the Gaussian forward
      splat behind CFR: float32 atomics, exact for any motion, bits
      that vary from run to run; a source pixel with a non-finite or
      huge flow is dropped.
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
search of its window on top of its bytes; the splat its atomics.

Design, in short (each source file says more): the gather is a 2-D grid
with int32 offsets inside a plane, two query pixels per thread 32 apart,
compile-time channel tiles, chunks of 8 channels per block, streaming
stores, an optional ones plane and a two-half entry. The stencil loads
its source window once per block into shared memory as one packed int32
of floor(flo) per pixel, tests a tap with one load, one subtraction and
one mask, skips rows and columns by per-row ranges reduced while the
tile is loaded, and adds a warp's matches together. The splat gathers a
32x8 source tile's splats in a shared-memory box of their targets with
shared atomics and flushes it with one 16-byte global reduction per four
targets and plane; a tile whose targets spread beyond the box adds
straight to global memory, in the same launch. The TPU kernels'
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

Two more carry their gradients. The JAX package's fast paths are
``jax.custom_vjp``s whose backward recomputes through the exact XLA op
(demfi_tpu/ops/warp.py:177-295), so these have no Pallas counterpart:

  ``bilinear_gather_bwd`` (csrc/bilinear_gather_bwd.cu): the vjp of the
      gather (of ``_bwarp_xla`` and ``_bilinear_abs_xla``,
      demfi_tpu/ops/warp.py:448, :494), one or two halves a launch; the
      image's gradient scattered through a shared-memory box of each
      query tile's taps, flushed with 16-byte reductions (a tile whose
      taps spread beyond the box adds straight to global memory, in the
      same launch), a per-pixel sum over channels for the coordinates'.
      For a bfloat16 image the scatter adds into a float32 scratch plane
      that a second launch rounds to bfloat16 once. ``row0`` as the
      forward's: the query rows of a shard of a frame split by rows, on
      the whole gathered frame, whose image gradient is the whole
      frame's.
  ``fwarp_splat_bwd`` (csrc/fwarp_splat_bwd.cu): the vjp of the forward
      warp (of ``_fwarp_xla``, :549), whichever kernel served the
      forward: a gather over each source pixel's four corners, no
      atomics, the same bits every run. :func:`fwarp_pair` (CFR's two
      forward warps) takes its backward as one launch on both halves
      (:func:`fwarp_splat_bwd_pair`): the kernel's grid covers one half
      or two. ``rows=(r0, Ho)`` as the forward's: a shard's source rows,
      its cotangents the whole frame's canvases.

One more serves the model's bfloat16 convolutions, not the warps:

  ``conv_epilogue`` (csrc/conv_epilogue.cu): a convolution's bias add and
      the ReLU or residual add after it, in place on its bfloat16 output
      held channels_last (NHWC), in one vectorised pass; the same
      operations and roundings as the separate ops, so the same bits
      (:func:`conv_epilogue_plain`). It replaces no TPU kernel (XLA fuses
      these for the JAX model). The model takes it where
      :func:`conv_epilogue_takes` holds: on the card, dense channels_last,
      autograd not recording.

Autograd: on the card, a call whose inputs require grad (with grad
enabled) goes through a ``torch.autograd.Function`` that saves only its
inputs and whose backward launches the backward kernel on the current
stream, or raises; nothing falls back to a plain version. A call under
``torch.no_grad()`` launches the forward kernel directly, as before. On
the CPU the plain versions run under ordinary autograd.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` of each
source into its own shared library with a plain C interface (one nvcc
per source, all started together), loaded with ctypes. The build runs at
first use, from the sources in this checkout, into
``demfi_torch/_build/<hash of sources and flags>/``.

Wrappers: a CPU tensor goes to the kernel's plain version in
``demfi_torch/ops/warp.py``; a CUDA tensor launches the kernel on the
current stream or raises (``_check``: a dtype a kernel does not take is
a TypeError, never converted: bfloat16 reaches only the gather's
image). Each wrapper counts its launches in ``<wrapper>.launches``,
incremented where the kernel is launched and nowhere else; the gather
and its backward count their bfloat16 instantiation's launches in
``<wrapper>.bf16_launches`` as well. Beside them, :func:`layout_counts`
counts the model's convolution calls, those whose input arrived in the
model's activation layout, and the NCHW copies that the kernels'
boundary (:func:`nchw`) makes of channels_last inputs, and
:func:`epilogue_counts` the convolutions by the form of their epilogue
and those that :func:`conv_epilogue` served.
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

from demfi_torch.ops import reshape as _reshape
from demfi_torch.ops import warp as _warp

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = {"bilinear_gather": "bilinear_gather.cu",
           "fwarp_splat": "fwarp_splat.cu",
           "fwarp_shift": "fwarp_shift.cu",
           "bilinear_gather_bwd": "bilinear_gather_bwd.cu",
           "fwarp_splat_bwd": "fwarp_splat_bwd.cu",
           "conv_epilogue": "conv_epilogue.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# the gather and its backward take these image types (each its own
# instantiation of the kernel); every other tensor of every kernel is
# float32
GATHER_IMAGE_DTYPES = (torch.float32, torch.bfloat16)

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
        # img_a, img_b, coords_a, coords_b, out, ones, n, C, H, W, Hq, Wq,
        # relative, row0, stream (the image float32 or bfloat16)
        fns = [lib.demfi_bilinear_gather_f32, lib.demfi_bilinear_gather_bf16]
        for fn in fns:
            fn.argtypes = [vp] * 6 + [i] * 8 + [vp]
    elif name == "fwarp_splat":
        fns = [lib.demfi_fwarp_splat_f32]
        # img, flo, out, norm, flag, served, route_stats, B, C, H, W, Hs,
        # r0, stream
        fns[0].argtypes = [vp] * 7 + [i] * 6 + [vp]
    elif name == "bilinear_gather_bwd":
        # img_a, img_b, coords_a, coords_b, gout_a, gout_b, grad_img,
        # grad_coords, route_stats, n, C, H, W, Hq, Wq, relative, row0,
        # stream; at bfloat16 the float32 scratch plane comes before
        # grad_img
        fns = [lib.demfi_bilinear_gather_bwd_f32,
               lib.demfi_bilinear_gather_bwd_bf16]
        fns[0].argtypes = [vp] * 9 + [i] * 8 + [vp]
        fns[1].argtypes = [vp] * 10 + [i] * 8 + [vp]
    elif name == "conv_epilogue":
        # y, bias, residual, n, C, relu, stream
        fns = [lib.demfi_conv_epilogue_bf16]
        fns[0].argtypes = [vp] * 3 + [ctypes.c_longlong, i, i, vp]
    elif name == "fwarp_splat_bwd":
        fns = [lib.demfi_fwarp_splat_bwd_f32]
        # img_a, img_b, flo_a, flo_b, gout_a, gout_b, gnorm_a, gnorm_b,
        # grad_img, grad_flo, halves, B, C, H, W, Ho, r0, stream
        fns[0].argtypes = [vp] * 10 + [i] * 7 + [vp]
    else:
        fns = [lib.demfi_fwarp_shift_f32]
        # img, flo, out, norm, flag, served, row_stats, B, C, H, W, Ho,
        # row_off, D, stream
        fns[0].argtypes = [vp] * 7 + [i] * 7 + [vp]
    for fn in fns:
        fn.restype = i
    return lib


def _check(name: str, *tensors: torch.Tensor,
           images: Tuple[torch.Tensor, ...] = ()) -> None:
    """Refuse what a kernel does not take; convert nothing. ``tensors``
    must be float32 and ``images`` (the gather's image halves) float32 or
    bfloat16, all of one type (else TypeError); every one contiguous and
    on one CUDA device (else ValueError). The dtypes are checked first."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
    for t in images:
        if t.dtype not in GATHER_IMAGE_DTYPES:
            raise TypeError(f"{name}: expected a float32 or bfloat16 image, "
                            f"got {t.dtype}")
    if len({t.dtype for t in images}) > 1:
        raise TypeError(f"{name}: image halves of different dtypes")
    every = tensors + tuple(images)
    for t in every:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    if len({t.device for t in every}) != 1:
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


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """A call whose result autograd must be able to differentiate. The
    others launch their forward kernel without a Function: on an H100
    host, ``Function.apply`` added about 10 us to a call's enqueue
    (PERF.md, section 6)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_rows(name: str, relative: bool, h: int, w: int, hq: int, wq: int,
                row0: Optional[int]) -> None:
    """A relative gather's query grid is the image grid (row0 None) or,
    given row0, rows [row0, row0 + Hq) of it: the rows that a card holds
    of a frame split by rows. Absolute mode takes any query grid and no
    row0."""
    if relative and row0 is None and (hq, wq) != (h, w):
        raise ValueError(f"{name}: relative mode needs the query grid to "
                         f"equal the image grid (or a row0)")
    if relative and row0 is not None and (wq != w or row0 < 0
                                          or row0 + hq > h):
        raise ValueError(f"{name}: relative mode needs the query grid to be "
                         f"rows [row0, row0 + Hq) of the image grid: query "
                         f"{hq}x{wq} at row {row0}, image {h}x{w}")
    if not relative and row0 is not None:
        raise ValueError(f"{name}: row0 applies to relative mode only")


def _launch_gather(halves, relative: bool, want_ones: bool,
                   row0: Optional[int] = None):
    """One launch of the gather kernel on one or two (img, coords) halves
    of equal shapes. Returns (out, ones) over all halves' batch elements,
    the first half's first."""
    (img, coords) = halves[0]
    _check("bilinear_gather", *(q for _, q in halves),
           images=tuple(i for i, _ in halves))
    n, c, h, w = img.shape
    if coords.dim() != 4 or coords.shape[:2] != (n, 2):
        raise ValueError(f"bilinear_gather: coords {tuple(coords.shape)} "
                         f"for img {tuple(img.shape)}")
    hq, wq = coords.shape[2:]
    _check_rows("bilinear_gather", relative, h, w, hq, wq, row0)
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
    lib = build()["bilinear_gather"]
    rc = (lib.demfi_bilinear_gather_f32 if img.dtype == torch.float32
          else lib.demfi_bilinear_gather_bf16)(
        img.data_ptr(), None if img_b is None else img_b.data_ptr(),
        coords.data_ptr(), None if coords_b is None else coords_b.data_ptr(),
        out.data_ptr(), None if ones is None else ones.data_ptr(),
        n, c, h, w, hq, wq, int(relative), int(row0 or 0),
        _raw_stream(img.device))
    _raise_on("bilinear_gather", rc)
    bilinear_gather.launches += 1
    if img.dtype == torch.bfloat16:
        bilinear_gather.bf16_launches += 1
    return out, ones


def _launch_gather_bwd(halves, relative: bool, route_stats=None,
                       row0: Optional[int] = None):
    """One launch of the gather's backward kernel on one or two (img,
    coords, grad_out) halves of equal shapes. Returns (grad_img,
    grad_coords) over all halves' batch elements, the first half's
    first; grad_img is the whole image's, also for a row0."""
    (img, coords, gout) = halves[0]
    _check("bilinear_gather_bwd", *(t for half in halves for t in half[1:]),
           images=tuple(half[0] for half in halves))
    _check_stats("bilinear_gather_bwd", route_stats, img)
    n, c, h, w = img.shape
    if coords.dim() != 4 or coords.shape[:2] != (n, 2):
        raise ValueError(f"bilinear_gather_bwd: coords {tuple(coords.shape)} "
                         f"for img {tuple(img.shape)}")
    hq, wq = coords.shape[2:]
    _check_rows("bilinear_gather_bwd", relative, h, w, hq, wq, row0)
    if tuple(gout.shape) != (n, c, hq, wq):
        raise ValueError(f"bilinear_gather_bwd: grad_out {tuple(gout.shape)} "
                         f"for an output {(n, c, hq, wq)}")
    if any(i.shape != img.shape or q.shape != coords.shape
           or g.shape != gout.shape for i, q, g in halves[1:]):
        raise ValueError("bilinear_gather_bwd: the two halves differ in shape")
    if h * w >= 2 ** 31 or hq * wq >= 2 ** 31:
        raise ValueError("bilinear_gather_bwd: a plane of 2^31 elements or "
                         "more")
    batch = len(halves) * n
    # the scatter's float32 sums: grad_img itself at float32, a scratch
    # plane that the kernel rounds into grad_img once at bfloat16
    grad_acc = torch.zeros((batch, c, h, w), dtype=torch.float32,
                           device=img.device)
    grad_coords = torch.empty((batch, 2, hq, wq), dtype=torch.float32,
                              device=img.device)
    img_b = coords_b = gout_b = None
    if len(halves) == 2:
        img_b, coords_b, gout_b = (t.data_ptr() for t in halves[1])
    args = (img.data_ptr(), img_b, coords.data_ptr(), coords_b,
            gout.data_ptr(), gout_b)
    tail = (grad_coords.data_ptr(),
            None if route_stats is None else route_stats.data_ptr(),
            n, c, h, w, hq, wq, int(relative), int(row0 or 0),
            _raw_stream(img.device))
    lib = build()["bilinear_gather_bwd"]
    if img.dtype == torch.float32:
        grad_img = grad_acc
        rc = lib.demfi_bilinear_gather_bwd_f32(*args, grad_img.data_ptr(),
                                               *tail)
    else:
        grad_img = torch.empty((batch, c, h, w), dtype=img.dtype,
                               device=img.device)
        rc = lib.demfi_bilinear_gather_bwd_bf16(
            *args, grad_acc.data_ptr(), grad_img.data_ptr(), *tail)
    _raise_on("bilinear_gather_bwd", rc)
    bilinear_gather_bwd.launches += 1
    if img.dtype == torch.bfloat16:
        bilinear_gather_bwd.bf16_launches += 1
    return grad_img, grad_coords


class _Gather(torch.autograd.Function):
    """The gather kernel under autograd: its backward is the backward
    kernel. The in-image weight plane is not differentiable (it feeds
    the mask, a comparison)."""

    @staticmethod
    def forward(ctx, img, coords, relative, want_ones, row0=None):
        out, ones = _launch_gather([(img, coords)], relative, want_ones,
                                   row0=row0)
        ctx.save_for_backward(img, coords)
        ctx.relative, ctx.row0 = relative, row0
        if ones is not None:
            ctx.mark_non_differentiable(ones)
        return out, ones

    @staticmethod
    def backward(ctx, grad_out, _grad_ones):
        img, coords = ctx.saved_tensors
        grad_img, grad_coords = _launch_gather_bwd(
            [(img, coords, grad_out.contiguous())], ctx.relative,
            row0=ctx.row0)
        return grad_img, grad_coords, None, None, None


def _launch_gather_pair(img_a, img_b, coords_a, coords_b, relative: bool,
                        want_ones: bool, row0: Optional[int] = None):
    """One launch on two halves, split back into ((out_a, out_b),
    (ones_a, ones_b) or None): views of one allocation."""
    out, ones = _launch_gather([(img_a, coords_a), (img_b, coords_b)],
                               relative, want_ones, row0=row0)
    n = img_a.shape[0]
    return (out[:n], out[n:]), (None if ones is None
                                else (ones[:n], ones[n:]))


def _launch_gather_pair_bwd(img_a, img_b, coords_a, coords_b, grad_a,
                            grad_b, relative: bool, route_stats=None,
                            row0: Optional[int] = None):
    """One backward launch on two halves, split back into
    ((grad_img_a, grad_img_b), (grad_coords_a, grad_coords_b))."""
    grad_img, grad_coords = _launch_gather_bwd(
        [(img_a, coords_a, grad_a), (img_b, coords_b, grad_b)], relative,
        route_stats, row0=row0)
    n = img_a.shape[0]
    return ((grad_img[:n], grad_img[n:]), (grad_coords[:n], grad_coords[n:]))


class _GatherPair(torch.autograd.Function):
    """:func:`bilinear_gather_pair` under autograd: two outputs (views of
    one allocation), each with its own gradient; one backward launch."""

    @staticmethod
    def forward(ctx, img_a, img_b, coords_a, coords_b, relative, want_ones,
                row0=None):
        outs, ones = _launch_gather_pair(img_a, img_b, coords_a, coords_b,
                                         relative, want_ones, row0)
        ctx.save_for_backward(img_a, img_b, coords_a, coords_b)
        ctx.relative, ctx.row0 = relative, row0
        if ones is None:
            return outs + (None, None)
        ctx.mark_non_differentiable(*ones)
        return outs + ones

    @staticmethod
    def backward(ctx, grad_a, grad_b, _grad_ones_a, _grad_ones_b):
        (gi_a, gi_b), (gc_a, gc_b) = _launch_gather_pair_bwd(
            *ctx.saved_tensors, grad_a.contiguous(), grad_b.contiguous(),
            ctx.relative, row0=ctx.row0)
        return gi_a, gi_b, gc_a, gc_b, None, None, None


def bilinear_gather(img: torch.Tensor, coords: torch.Tensor, relative: bool,
                    want_ones: bool = True, row0: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Bilinear zero-padded gather of img [B,C,H,W] (float32 or bfloat16)
    at coords [B,2,Hq,Wq] (float32); the output is float32 either way.

    relative=True (bwarp): sample at grid + coords (Hq, Wq == H, W) and
    return (out * (ones >= 0.999), ones), ones being the float32 in-image
    weight [B,1,H,W], or None with want_ones=False: the kernel then
    neither allocates nor writes the plane. relative=False (FGAC): sample
    at the absolute coords on any query grid and return (out, None).
    row0 (relative mode): the query grid is rows [row0, row0 + Hq) of
    the image grid, as for the rows that a card holds of a frame split
    by rows. Differentiable in img and coords (on the card by
    :func:`bilinear_gather_bwd`; with a row0 the image's gradient is the
    whole image's)."""
    if img.device.type == "cpu" and coords.device.type == "cpu":
        _check_rows("bilinear_gather", relative, *img.shape[2:],
                    *coords.shape[2:], row0)
        out, ones = _warp.bilinear_gather_plain(img, coords, relative,
                                                row0 or 0)
        return out, ones if want_ones else None
    if _needs_grad(img, coords):
        return _Gather.apply(img, coords, relative, want_ones, row0)
    return _launch_gather([(img, coords)], relative, want_ones, row0)


bilinear_gather.launches = 0
bilinear_gather.bf16_launches = 0       # of them, the bfloat16 image's


def bilinear_gather_pair(img_a: torch.Tensor, img_b: torch.Tensor,
                         coords_a: torch.Tensor, coords_b: torch.Tensor,
                         relative: bool, want_ones: bool = False,
                         row0: Optional[int] = None):
    """:func:`bilinear_gather` of two halves of equal shapes in one
    launch (counted in ``bilinear_gather.launches``), the kernel taking
    both halves' pointers: nothing is concatenated. Returns
    ((out_a, out_b), (ones_a, ones_b) or None); on the card the two are
    views of one allocation. Under autograd each half has its own
    gradient, and the backward is one launch too. row0 as for
    :func:`bilinear_gather`."""
    tensors = (img_a, img_b, coords_a, coords_b)
    if all(t.device.type == "cpu" for t in tensors):
        out_a, ones_a = bilinear_gather(img_a, coords_a, relative, want_ones,
                                        row0=row0)
        out_b, ones_b = bilinear_gather(img_b, coords_b, relative, want_ones,
                                        row0=row0)
        return (out_a, out_b), (None if ones_a is None else (ones_a, ones_b))
    if _needs_grad(*tensors):
        out_a, out_b, ones_a, ones_b = _GatherPair.apply(
            img_a, img_b, coords_a, coords_b, relative, want_ones, row0)
        return (out_a, out_b), (None if ones_a is None else (ones_a, ones_b))
    return _launch_gather_pair(img_a, img_b, coords_a, coords_b, relative,
                               want_ones, row0)


def bilinear_gather_bwd(img: torch.Tensor, coords: torch.Tensor,
                        relative: bool, grad_out: torch.Tensor,
                        route_stats: Optional[torch.Tensor] = None,
                        row0: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vjp of :func:`bilinear_gather`'s first output: (grad_img
    [B,C,H,W] in the image's dtype, grad_coords [B,2,Hq,Wq] float32) for
    the float32 cotangent grad_out [B,C,Hq,Wq]. CPU tensors take
    :func:`demfi_torch.ops.warp.bilinear_gather_plain_vjp`; CUDA tensors
    launch the backward kernel (its float reductions into grad_img add
    in an order that varies from run to run; grad_coords has the same
    bits every run).
    route_stats, for measurement on the card: an int64 [2] tensor to
    which the kernel adds its 32x8 query tiles that scattered through
    the shared-memory box and those that added straight to global
    memory.
    row0 as for :func:`bilinear_gather`: grad_out and grad_coords are the
    query rows', grad_img the whole image's."""
    if all(t.device.type == "cpu" for t in (img, coords, grad_out)):
        _check_rows("bilinear_gather_bwd", relative, *img.shape[2:],
                    *coords.shape[2:], row0)
        return _warp.bilinear_gather_plain_vjp(img, coords, relative,
                                               grad_out, row0 or 0)
    return _launch_gather_bwd([(img, coords, grad_out)], relative,
                              route_stats, row0=row0)


bilinear_gather_bwd.launches = 0
bilinear_gather_bwd.bf16_launches = 0


def bilinear_gather_pair_bwd(img_a, img_b, coords_a, coords_b, grad_a,
                             grad_b, relative: bool,
                             route_stats: Optional[torch.Tensor] = None,
                             row0: Optional[int] = None):
    """:func:`bilinear_gather_bwd` of two halves of equal shapes in one
    launch (counted in ``bilinear_gather_bwd.launches``). Returns
    ((grad_img_a, grad_img_b), (grad_coords_a, grad_coords_b))."""
    tensors = (img_a, img_b, coords_a, coords_b, grad_a, grad_b)
    if all(t.device.type == "cpu" for t in tensors):
        gi_a, gc_a = bilinear_gather_bwd(img_a, coords_a, relative, grad_a,
                                         row0=row0)
        gi_b, gc_b = bilinear_gather_bwd(img_b, coords_b, relative, grad_b,
                                         row0=row0)
        return (gi_a, gi_b), (gc_a, gc_b)
    return _launch_gather_pair_bwd(img_a, img_b, coords_a, coords_b, grad_a,
                                   grad_b, relative, route_stats, row0)


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


def _launch_splat(img, flo, out, norm, flag, route_stats=None,
                  r0: int = 0) -> None:
    """The splat of img's rows into out and norm, whose rows may be more:
    source row y lands on output row y + r0 (the rows of a split
    frame)."""
    b, c, h, w = img.shape
    ho = out.shape[2]
    if max(h, ho) * w >= 2 ** 31:
        raise ValueError("fwarp_splat: a plane of 2^31 elements or more")
    rc = build()["fwarp_splat"].demfi_fwarp_splat_f32(
        img.data_ptr(), flo.data_ptr(), out.data_ptr(), norm.data_ptr(),
        flag.data_ptr() if flag is not None else None,
        _served_counter(img.device).data_ptr() + 4,
        route_stats.data_ptr() if route_stats is not None else None,
        b, c, ho, w, h, int(r0), _raw_stream(img.device))
    _raise_on("fwarp_splat", rc)
    fwarp_splat.launches += 1


def _launch_shift(img, flo, d, out, norm, flag, row_stats=None,
                  row_off: int = 0) -> None:
    """The stencil sum for out's rows, which may be fewer than img's:
    output row y is source row y + row_off."""
    b, c, h, w = img.shape
    if h * w >= 2 ** 31:
        raise ValueError("fwarp_shift: a plane of 2^31 elements or more")
    rc = build()["fwarp_shift"].demfi_fwarp_shift_f32(
        img.data_ptr(), flo.data_ptr(), out.data_ptr(), norm.data_ptr(),
        flag.data_ptr() if flag is not None else None,
        _served_counter(img.device).data_ptr(),
        row_stats.data_ptr() if row_stats is not None else None,
        b, c, h, w, out.shape[2], int(row_off), int(d),
        _raw_stream(img.device))
    _raise_on("fwarp_shift", rc)
    fwarp_shift.launches += 1


def _fwarp_outputs(img: torch.Tensor, alloc, h: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B,C,h,W], norm [B,1,h,W]), h the image's rows unless given:
    two contiguous views of one allocation, so that the splat's zeroing
    is one fill, not two."""
    b, c, hi, w = img.shape
    h = hi if h is None else h
    n = b * c * h * w
    buf = alloc(n + b * h * w, dtype=torch.float32, device=img.device)
    return buf[:n].view(b, c, h, w), buf[n:].view(b, 1, h, w)


def _check_stats(name: str, stats: Optional[torch.Tensor],
                 img: torch.Tensor) -> None:
    if stats is not None and (stats.device != img.device
                              or stats.dtype != torch.int64
                              or stats.shape != (2,)):
        raise ValueError(f"{name}: its stats must be an int64 [2] tensor on "
                         f"the image's device")


def _splat_fwd(img, flo, stats=None):
    out, norm = _fwarp_outputs(img, torch.zeros)
    _launch_splat(img, flo, out, norm, None, stats)
    return out, norm


def _shift_fwd(img, flo, d, stats=None):
    out, norm = _fwarp_outputs(img, torch.empty)
    _launch_shift(img, flo, d, out, norm, None, stats)
    return out, norm


def _guarded_fwd(img, flo, d):
    out, norm = _fwarp_outputs(img, torch.empty)
    flag = torch.empty(1, dtype=torch.int32, device=img.device)
    _launch_shift(img, flo, d, out, norm, flag)
    _launch_splat(img, flo, out, norm, flag)
    return out, norm


def _splat_bwd_on(geometry, *halves):
    """The backward kernel's launch on (img, flo, grad_out, grad_norm)
    halves of a forward warp whose outputs have ``geometry``: None, the
    image's rows; ("canvas", r0, Ho), a canvas of Ho rows with the
    image's rows at r0 (a shard's splat); ("crop", row_off, Ho), rows
    [row_off, row_off + Ho) of the image's (the stencil on a shard's rows
    and halo), whose cotangent goes into zeros of the image's rows."""
    halves = [(img, flo, go.contiguous(), gn.contiguous())
              for img, flo, go, gn in halves]
    if geometry is None:
        return _launch_splat_bwd(*halves)
    kind, r0, ho = geometry
    if kind == "canvas":
        return _launch_splat_bwd(*halves, rows=(r0, ho))
    padded = []
    for img, flo, go, gn in halves:
        b, c, h, w = img.shape
        full = [g.new_zeros((b, g.shape[1], h, w)) for g in (go, gn)]
        for f, g in zip(full, (go, gn)):
            f[:, :, r0:r0 + ho] = g
        padded.append((img, flo, *full))
    return _launch_splat_bwd(*padded)


class _Fwarp(torch.autograd.Function):
    """A forward warp kernel under autograd (``forward`` one of
    :func:`_splat_fwd`, :func:`_shift_fwd`, :func:`_guarded_fwd`, given
    its trailing arguments): whichever kernel served the forward, the
    backward is the splat's backward kernel, the vjp of the exact splat
    (as JAX's ``_fwarp_shift_fast_bwd`` takes ``_fwarp_xla``'s). The
    saved tensors are the img and flo that the forward read."""

    @staticmethod
    def forward(ctx, img, flo, forward, *args):
        ctx.save_for_backward(img, flo)
        ctx.n_args = len(args)
        ctx.geometry = None
        return forward(img, flo, *args)

    @staticmethod
    def backward(ctx, grad_out, grad_norm):
        img, flo = ctx.saved_tensors
        (grad_img, grad_flo), = _splat_bwd_on(
            ctx.geometry, (img, flo, grad_out, grad_norm))
        return (grad_img, grad_flo, None) + (None,) * ctx.n_args


class _FwarpRows(_Fwarp):
    """:class:`_Fwarp` of a forward warp on the rows of a split frame,
    its outputs' ``geometry`` (:func:`_splat_bwd_on`) given first."""

    @staticmethod
    def forward(ctx, img, flo, geometry, forward, *args):
        out = _Fwarp.forward(ctx, img, flo, forward, *args)
        ctx.geometry = geometry
        ctx.n_args += 1
        return out


def _fwarp_call(img, flo, forward, *args):
    if _needs_grad(img, flo):
        return _Fwarp.apply(img, flo, forward, *args)
    return forward(img, flo, *args)


class _FwarpPair(torch.autograd.Function):
    """Two forward warps of equal shapes under autograd (CFR's): the
    forward is ``forward`` on each half (two launches of whichever kernel
    serves it), the backward one launch of the backward kernel on
    both."""

    @staticmethod
    def forward(ctx, img_a, flo_a, img_b, flo_b, forward, *args):
        ctx.save_for_backward(img_a, flo_a, img_b, flo_b)
        ctx.n_args = len(args)
        ctx.geometry = None
        return forward(img_a, flo_a, *args) + forward(img_b, flo_b, *args)

    @staticmethod
    def backward(ctx, go_a, gn_a, go_b, gn_b):
        img_a, flo_a, img_b, flo_b = ctx.saved_tensors
        (gi_a, gf_a), (gi_b, gf_b) = _splat_bwd_on(
            ctx.geometry, (img_a, flo_a, go_a, gn_a),
            (img_b, flo_b, go_b, gn_b))
        return (gi_a, gf_a, gi_b, gf_b, None) + (None,) * ctx.n_args


class _FwarpPairRows(_FwarpPair):
    """:class:`_FwarpPair` on the rows of a split frame, its outputs'
    ``geometry`` (:func:`_splat_bwd_on`) given first."""

    @staticmethod
    def forward(ctx, img_a, flo_a, img_b, flo_b, geometry, forward, *args):
        out = _FwarpPair.forward(ctx, img_a, flo_a, img_b, flo_b, forward,
                                 *args)
        ctx.geometry = geometry
        ctx.n_args += 1
        return out


def _fwarp_one(img, flo, d, rows=None):
    """One forward warp as :func:`demfi_torch.ops.warp.fwarp` chooses it:
    the splat for d <= 0, else the guarded pair of kernels; with rows
    and d > 0, the stencil on them (:func:`fwarp_shift`)."""
    if d <= 0:
        return fwarp_splat(img, flo, rows=rows)
    if rows is not None:
        return fwarp_shift(img, flo, d, rows=rows)
    return fwarp_guarded(img, flo, d)


def fwarp_pair(img_a: torch.Tensor, flo_a: torch.Tensor,
               img_b: torch.Tensor, flo_b: torch.Tensor, d: int = 0,
               rows: Optional[Tuple[int, int]] = None):
    """Two forward warps of equal shapes, each as :func:`_fwarp_one`
    serves it (d as ``shift_d`` of :func:`demfi_torch.ops.warp.fwarp`).
    Returns ((out_a, norm_a), (out_b, norm_b)). On the card, under
    autograd, both backwards are one launch of the backward kernel
    (:func:`fwarp_splat_bwd_pair`); on the CPU the two warps are the two
    single entries, plain versions under autograd.
    rows, on the rows of a frame split by rows: with d = 0, (r0, Ho) as
    :func:`fwarp_splat` takes it (canvases of the whole frame); with
    d > 0, (row_off, Ho) as :func:`fwarp_shift` takes it (the stencil,
    unguarded, on a shard's rows and halo)."""
    if d > 0:
        _check_window("fwarp_pair", d)
    tensors = (img_a, flo_a, img_b, flo_b)
    if all(t.device.type == "cpu" for t in tensors):
        return (_fwarp_one(img_a, flo_a, d, rows),
                _fwarp_one(img_b, flo_b, d, rows))
    _check_fwarp("fwarp_pair", img_a, flo_a)
    _check_fwarp("fwarp_pair", img_b, flo_b)
    if img_a.shape != img_b.shape:
        raise ValueError(f"fwarp_pair: the two halves differ in shape: "
                         f"{tuple(img_a.shape)}, {tuple(img_b.shape)}")
    if rows is None:
        forward, args = ((_splat_fwd, (None,)) if d <= 0
                         else (_guarded_fwd, (d,)))
    elif d <= 0:
        _check_canvas(img_a, rows)
        forward, args, geometry = _canvas_fwd, (rows, None), "canvas"
    else:
        _check_crop("fwarp_pair", img_a, rows)
        forward, args, geometry = _shift_rows_fwd, (d, rows, None), "crop"
    if _needs_grad(*tensors):
        if rows is None:
            outs = _FwarpPair.apply(img_a, flo_a, img_b, flo_b, forward,
                                    *args)
        else:
            outs = _FwarpPairRows.apply(img_a, flo_a, img_b, flo_b,
                                        (geometry,) + tuple(rows), forward,
                                        *args)
        out_a, norm_a, out_b, norm_b = outs
        return (out_a, norm_a), (out_b, norm_b)
    return forward(img_a, flo_a, *args), forward(img_b, flo_b, *args)


def fwarp_splat(img: torch.Tensor, flo: torch.Tensor,
                route_stats: Optional[torch.Tensor] = None,
                rows: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian forward splat of img [B,C,H,W] by flo [B,2,H,W], exact for
    any motion. A source pixel whose flow is NaN, infinite or so large
    that no corner lies in the image is dropped on the card (the plain
    version has no defined result there).
    route_stats, for measurement on the card: an int64 [2] tensor to
    which the kernel adds its 32x8 source tiles that went through the
    shared-memory box and those that added straight to global memory.
    Returns (warped [B,C,H,W], weight norm [B,1,H,W]), differentiable in
    img and flo (on the card by :func:`fwarp_splat_bwd`).
    rows=(r0, Ho): img and flo are rows [r0, r0 + H) of a frame of Ho
    rows (a card's rows of a frame split by rows), and the outputs are
    that frame's [B,C,Ho,W] and [B,1,Ho,W] canvases with only these rows'
    splats; the sum of every card's canvases is the splat of the whole
    frame. Their gradient takes the whole canvases' cotangents."""
    if rows is not None:
        return _splat_canvas(img, flo, rows, route_stats)
    if img.device.type == "cpu" and flo.device.type == "cpu":
        return _warp.fwarp_splat_plain(img, flo)
    _check_fwarp("fwarp_splat", img, flo)
    _check_stats("fwarp_splat", route_stats, img)
    return _fwarp_call(img, flo, _splat_fwd, route_stats)


def _check_canvas(img, rows) -> None:
    r0, ho = rows
    if not 0 <= r0 <= ho - img.shape[2]:
        raise ValueError(f"fwarp_splat: rows [{r0}, {r0 + img.shape[2]}) "
                         f"are not rows of a frame of {ho}")


def _canvas_fwd(img, flo, rows, stats=None):
    out, norm = _fwarp_outputs(img, torch.zeros, rows[1])
    _launch_splat(img, flo, out, norm, None, stats, rows[0])
    return out, norm


def _splat_canvas(img, flo, rows, route_stats=None):
    """:func:`fwarp_splat` with rows=(r0, Ho)."""
    _check_canvas(img, rows)
    if img.device.type == "cpu" and flo.device.type == "cpu":
        return _warp.fwarp_splat_plain(img, flo, rows)
    _check_fwarp("fwarp_splat", img, flo)
    _check_stats("fwarp_splat", route_stats, img)
    if _needs_grad(img, flo):
        return _FwarpRows.apply(img, flo, ("canvas",) + tuple(rows),
                                _canvas_fwd, rows, route_stats)
    return _canvas_fwd(img, flo, rows, route_stats)


fwarp_splat.launches = 0


def _check_window(name: str, d: int) -> None:
    if not 1 <= d <= FWARP_SHIFT_MAX_D:
        raise ValueError(f"{name}: window d must be in [1, "
                         f"{FWARP_SHIFT_MAX_D}], got {d}")


def fwarp_shift(img: torch.Tensor, flo: torch.Tensor, d: int,
                row_stats: Optional[torch.Tensor] = None,
                rows: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic forward warp of img [B,C,H,W] by flo [B,2,H,W]: the
    stencil sum over the (2d+2)^2 window, equal to the splat where
    max|flo| <= d - 1; splats beyond the window are dropped.
    1 <= d <= FWARP_SHIFT_MAX_D (107), the largest window whose tile of
    targets fits a block's shared memory; a larger d raises.
    row_stats, for measurement on the card: an int64 [2] tensor to which
    the kernel adds the source rows its warps tested and the rows their
    vote skipped.
    Returns (warped [B,C,H,W], weight norm [B,1,H,W]); on the card its
    gradient is the splat's (:func:`fwarp_splat_bwd`), the window's
    equal where max|flo| <= d - 1.
    rows=(row_off, Ho): only the output rows [row_off, row_off + Ho) of
    img's grid are computed ([B,C,Ho,W], [B,1,Ho,W]), bit for bit those
    rows of the call without rows. A card that holds rows of a frame
    split by rows passes its rows with a halo of d + 1 rows above and d
    below (as far as the frame reaches), and row_off the halo above it
    has. On the card the gradient is then the splat's of img's rows for
    the cotangent of these rows (zeros elsewhere)."""
    _check_window("fwarp_shift", d)
    if rows is not None:
        _check_crop("fwarp_shift", img, rows)
    if img.device.type == "cpu" and flo.device.type == "cpu":
        return _warp.fwarp_shift_plain(img, flo, d, rows)
    _check_fwarp("fwarp_shift", img, flo)
    _check_stats("fwarp_shift", row_stats, img)
    if rows is None:
        return _fwarp_call(img, flo, _shift_fwd, d, row_stats)
    if _needs_grad(img, flo):
        return _FwarpRows.apply(img, flo, ("crop",) + tuple(rows),
                                _shift_rows_fwd, d, rows, row_stats)
    return _shift_rows_fwd(img, flo, d, rows, row_stats)


def _check_crop(name: str, img, rows) -> None:
    row_off, ho = rows
    if not (0 <= row_off and row_off + ho <= img.shape[2]):
        raise ValueError(f"{name}: output rows [{row_off}, "
                         f"{row_off + ho}) outside {img.shape[2]}")


def _shift_rows_fwd(img, flo, d, rows, stats=None):
    out, norm = _fwarp_outputs(img, torch.empty, rows[1])
    _launch_shift(img, flo, d, out, norm, None, stats, rows[0])
    return out, norm


fwarp_shift.launches = 0


def fwarp_guarded(img: torch.Tensor, flo: torch.Tensor, d: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward warp by the stencil kernel where no |flo| exceeds d - 1,
    by the atomic splat otherwise; both exact, only the first with the
    same bits every run. Returns (warped, weight norm), whose gradient is
    the splat's whichever kernel served.

    On the card both kernels are launched, on one device flag that the
    stencil's launch computes from flo: the stencil does the work or
    clears the outputs, the splat does the work or returns at once.
    Nothing is copied to the host. On the CPU the flag is read and the
    one plain version runs (autograd through the stencil's plain version
    equals the splat's gradient inside its window,
    tests/test_torch_ops.py)."""
    _check_window("fwarp_guarded", d)
    if img.device.type == "cpu" and flo.device.type == "cpu":
        if bool((flo.abs() > float(d - 1)).any()):
            return _warp.fwarp_splat_plain(img, flo)
        return _warp.fwarp_shift_plain(img, flo, d)
    _check_fwarp("fwarp_guarded", img, flo)
    return _fwarp_call(img, flo, _guarded_fwd, d)


def _check_splat_bwd(img, flo, grad_out, grad_norm, rows=None) -> None:
    _check_fwarp("fwarp_splat_bwd", img, flo)
    _check("fwarp_splat_bwd", img, grad_out, grad_norm)
    b, c, h, w = img.shape
    r0, ho = (0, h) if rows is None else rows
    if not 0 <= r0 <= ho - h:
        raise ValueError(f"fwarp_splat_bwd: rows [{r0}, {r0 + h}) are not "
                         f"rows of a frame of {ho}")
    if (tuple(grad_out.shape) != (b, c, ho, w)
            or tuple(grad_norm.shape) != (b, 1, ho, w)):
        raise ValueError(f"fwarp_splat_bwd: cotangents "
                         f"{tuple(grad_out.shape)}, {tuple(grad_norm.shape)} "
                         f"for img {tuple(img.shape)} in {ho} rows")
    if ho * w >= 2 ** 31:
        raise ValueError("fwarp_splat_bwd: a plane of 2^31 elements or more")


def _launch_splat_bwd(*halves, rows: Optional[Tuple[int, int]] = None):
    """One launch of the backward kernel on one or two halves (img, flo,
    grad_out, grad_norm) of equal shapes. Returns [(grad_img, grad_flo)]
    per half, views of one allocation each for the images' and the
    flows' gradients. rows=(r0, Ho): img and flo are rows [r0, r0 + H)
    of a frame of Ho rows, the cotangents that frame's canvases."""
    for half in halves:
        _check_splat_bwd(*half, rows=rows)
    (img_a, flo_a, gout_a, gnorm_a), (img_b, flo_b, gout_b, gnorm_b) = (
        halves[0], halves[-1])
    if img_a.shape != img_b.shape or img_a.device != img_b.device:
        raise ValueError("fwarp_splat_bwd_pair: the two halves differ in "
                         "shape or device")
    n = len(halves)
    b, c, h, w = img_a.shape
    r0, ho = (0, h) if rows is None else rows
    grad_img = torch.empty((n * b, c, h, w), dtype=torch.float32,
                           device=img_a.device)
    grad_flo = torch.empty((n * b, 2, h, w), dtype=torch.float32,
                           device=img_a.device)
    rc = build()["fwarp_splat_bwd"].demfi_fwarp_splat_bwd_f32(
        img_a.data_ptr(), img_b.data_ptr(), flo_a.data_ptr(),
        flo_b.data_ptr(), gout_a.data_ptr(), gout_b.data_ptr(),
        gnorm_a.data_ptr(), gnorm_b.data_ptr(), grad_img.data_ptr(),
        grad_flo.data_ptr(), n, b, c, h, w, ho, r0,
        _raw_stream(img_a.device))
    _raise_on("fwarp_splat_bwd", rc)
    fwarp_splat_bwd.launches += 1
    return [(grad_img[k * b:(k + 1) * b], grad_flo[k * b:(k + 1) * b])
            for k in range(n)]


def fwarp_splat_bwd(img: torch.Tensor, flo: torch.Tensor,
                    grad_out: torch.Tensor, grad_norm: torch.Tensor,
                    rows: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The vjp of the forward warp: (grad_img [B,C,H,W], grad_flo
    [B,2,H,W]) for the cotangents grad_out [B,C,H,W] and grad_norm
    [B,1,H,W]. CPU tensors take
    :func:`demfi_torch.ops.warp.fwarp_splat_plain_vjp`; CUDA tensors
    launch the backward kernel (no atomics: the same bits every run; a
    source pixel the forward kernel drops gets zero gradients).
    rows=(r0, Ho), as for :func:`fwarp_splat`: the cotangents are the
    canvases [B,C,Ho,W] and [B,1,Ho,W] of a frame whose rows [r0, r0 +
    H) img and flo are."""
    if all(t.device.type == "cpu" for t in (img, flo, grad_out, grad_norm)):
        if rows is not None:
            _check_canvas(img, rows)
        return _warp.fwarp_splat_plain_vjp(img, flo, grad_out, grad_norm,
                                           rows)
    return _launch_splat_bwd((img, flo, grad_out, grad_norm),
                             rows=rows)[0]


fwarp_splat_bwd.launches = 0


def fwarp_splat_bwd_pair(img_a, flo_a, gout_a, gnorm_a,
                         img_b, flo_b, gout_b, gnorm_b,
                         rows: Optional[Tuple[int, int]] = None):
    """:func:`fwarp_splat_bwd` of two halves of equal shapes in one launch
    of its kernel (counted in ``fwarp_splat_bwd.launches``). Returns
    ((grad_img_a, grad_flo_a), (grad_img_b, grad_flo_b)); CPU tensors take
    the plain vjp of each half. rows as for :func:`fwarp_splat_bwd`."""
    tensors = (img_a, flo_a, gout_a, gnorm_a, img_b, flo_b, gout_b, gnorm_b)
    if all(t.device.type == "cpu" for t in tensors):
        return (fwarp_splat_bwd(img_a, flo_a, gout_a, gnorm_a,
                                rows=rows),
                fwarp_splat_bwd(img_b, flo_b, gout_b, gnorm_b,
                                rows=rows))
    return tuple(_launch_splat_bwd(tensors[:4], tensors[4:],
                                   rows=rows))


# the widest output whose float32 bias a block of the epilogue kernel
# stages in its 48 KB of shared memory
EPILOGUE_MAX_C = 48 * 1024 // 4


def conv_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                        relu: bool = False,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """:func:`conv_epilogue`'s plain version, by the separate ops in
    place: y + bias cast to y's dtype (broadcast over H and W), then
    ``relu`` or ``residual + y``."""
    torch.add(y, bias.to(y.dtype)[:, None, None], out=y)
    if relu:
        return torch.relu_(y)
    if residual is not None:
        torch.add(residual, y, out=y)
    return y


def _epilogue_refusal(y: torch.Tensor, bias: torch.Tensor,
                      residual: Optional[torch.Tensor]):
    """Why :func:`conv_epilogue`'s kernel cannot take these tensors, as
    (exception type, message), or None: what it does not take, or a
    gradient that autograd records through them (the kernel writes in
    place and has no backward)."""
    cl = torch.channels_last
    if y.dtype != torch.bfloat16 or bias.dtype != torch.float32 or (
            residual is not None and residual.dtype != y.dtype):
        return TypeError, "expected a bfloat16 output and residual and a " \
            "float32 bias"
    if y.device.type != "cuda":
        return ValueError, f"expected a CUDA output, got {y.device}"
    if y.dim() != 4 or not y.is_contiguous(memory_format=cl):
        return ValueError, "expected a dense channels_last [N, C, H, W] output"
    if y.data_ptr() % 16 or (residual is not None
                             and residual.data_ptr() % 16):
        return ValueError, "the output and the residual must start on 16 " \
            "bytes (the kernel moves 8 values a load)"
    if y.shape[1] > EPILOGUE_MAX_C:
        return ValueError, f"{y.shape[1]} channels, more than {EPILOGUE_MAX_C}"
    if (bias.shape != (y.shape[1],) or bias.device != y.device
            or not bias.is_contiguous()):
        return ValueError, f"a bias {tuple(bias.shape)} on {bias.device} " \
            f"for an output {tuple(y.shape)} on {y.device}"
    if residual is not None and (
            residual.shape != y.shape or residual.device != y.device
            or not residual.is_contiguous(memory_format=cl)):
        return ValueError, "the residual must be a dense channels_last " \
            "tensor of the output's shape, on its device"
    if _needs_grad(y, bias, *(() if residual is None else (residual,))):
        return ValueError, "the in-place kernel has no backward: call it " \
            "where autograd does not record"
    return None


def conv_epilogue_takes(y: torch.Tensor, bias: torch.Tensor,
                        residual: Optional[torch.Tensor] = None) -> bool:
    """Whether :func:`conv_epilogue` may update the convolution output y
    in place on the card: y bfloat16 on a CUDA device, dense channels_last
    (NHWC) with at most EPILOGUE_MAX_C channels, bias its float32 [C] on
    that device, residual None or a bfloat16 dense channels_last tensor of
    y's shape there, y and residual starting on 16 bytes, and autograd
    recording no graph through any of them."""
    return _epilogue_refusal(y, bias, residual) is None


def conv_epilogue(y: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                  residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The epilogue of a bfloat16 convolution, in place on its output y
    [N, C, H, W] (returned): v = bf16(y + bf16(bias[c])), then
    bf16(max(v, 0)) (NaN kept) where ``relu``, or bf16(residual + v) where
    a residual is given (not both); bit for bit the separate ops
    ``y + bias.to(bfloat16)[:, None, None]`` and ``F.relu`` or
    ``residual + y``. The tensors must be what
    :func:`conv_epilogue_takes` takes (on the card, dense channels_last,
    aligned, bias float32), and nothing may need a gradient: the kernel
    has no backward. Each launch counts as ``fused`` in
    :func:`epilogue_counts`."""
    if relu and residual is not None:
        raise ValueError("conv_epilogue: a ReLU or a residual, not both")
    refusal = _epilogue_refusal(y, bias, residual)
    if refusal is not None:
        raise refusal[0](f"conv_epilogue: {refusal[1]}")
    rc = build()["conv_epilogue"].demfi_conv_epilogue_bf16(
        y.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), y.numel(),
        y.shape[1], int(relu), _raw_stream(y.device))
    _raise_on("conv_epilogue", rc)
    _layout["fused"] += 1
    return y


WRAPPERS = (bilinear_gather, fwarp_splat, fwarp_shift, bilinear_gather_bwd,
            fwarp_splat_bwd)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    for fn in (bilinear_gather, bilinear_gather_bwd):
        fn.bf16_launches = 0


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset, by wrapper name: the
    three forward kernels and the two backward ones."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def bf16_launch_counts() -> Dict[str, int]:
    """Of :func:`launch_counts`, the launches of the gather's and its
    backward's bfloat16-image instantiations."""
    return {fn.__name__: fn.bf16_launches
            for fn in (bilinear_gather, bilinear_gather_bwd)}


LAYOUT_COUNTS = ("conv_calls", "conv_in_layout", "warp_copies")
EPILOGUE_COUNTS = ("bias", "bias_relu", "bias_residual", "fused")
_layout = dict.fromkeys(LAYOUT_COUNTS + EPILOGUE_COUNTS, 0)


def count_conv(in_layout: bool, epilogue: str = "bias") -> None:
    """Count one convolution call of the model, whether its input
    arrived in the model's activation layout
    (``demfi_torch.models.demfi.activation_format``), and the form of its
    epilogue (``bias``, ``bias_relu`` or ``bias_residual``)."""
    _layout["conv_calls"] += 1
    _layout["conv_in_layout"] += bool(in_layout)
    _layout[epilogue] += 1


def nchw(t: torch.Tensor) -> torch.Tensor:
    """t as the warp kernels take it: contiguous NCHW. The copy of an
    input held channels_last (``reshape.channels_last``) is counted in
    :func:`layout_counts`; a view of an NCHW tensor is copied as
    before."""
    if t.is_contiguous():
        return t
    _layout["warp_copies"] += _reshape.channels_last(t)
    return t.contiguous()


def reset_layout_counts() -> None:
    """Zero :func:`layout_counts` and :func:`epilogue_counts`."""
    for k in _layout:
        _layout[k] = 0


def layout_counts() -> Dict[str, int]:
    """Since the last reset: the model's convolution calls
    (``conv_calls``: ``_Conv``, ``_Conv3dT1`` and the GRU's fused and q
    convolutions), how many of them got their input already in the
    model's activation layout (``conv_in_layout``), and the copies into
    NCHW of channels_last inputs at the warp kernels' boundary
    (``warp_copies``)."""
    return {k: _layout[k] for k in LAYOUT_COUNTS}


def epilogue_counts() -> Dict[str, int]:
    """Since the last reset (:func:`reset_layout_counts`): the model's
    convolution calls by what follows the convolution, the bias alone
    (``bias``), the bias and a ReLU (``bias_relu``) or the bias and a
    residual add (``bias_residual``), and the launches of
    :func:`conv_epilogue`'s kernel, which did that in one pass
    (``fused``)."""
    return {k: _layout[k] for k in EPILOGUE_COUNTS}


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
