"""The train sampler's crop, flip, rot90 and normalisation in one native
pass (``augment.cpp``), bound with ctypes.

The library is compiled with g++ at first use into
``demfi_torch/_build/native-<hash of the source, flags and machine>/``,
never beside its source. A build that fails raises, with the compiler's
own message: nothing here falls back to numpy. A caller that wants the
numpy chain asks for it (``AdobeTrainDataset(..., use_native=False)``).

Frames are three-channel uint8 [T, H, W, 3] (what ``imageio.imread``
returns); the single-channel form of ``datasets._normalize`` (the
BT.601 luma of ``channels=1``) has no native counterpart and stays in
numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "augment.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """Where the library of this source, these flags and this machine
    lies."""
    h = hashlib.sha256(" ".join([CXX, *CXX_FLAGS, platform.machine()])
                       .encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libdemfi_augment.so"


def _build(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native augment: could not run {' '.join(cmd)}: "
                           f"{e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"native augment: {' '.join(cmd)} failed "
                           f"(exit {res.returncode}):\n{res.stderr}")
    os.replace(tmp, path)


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first where it is not there yet."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.demfi_augment_pack.argtypes = [ctypes.c_void_p] + [
                ctypes.c_int] * 8 + [ctypes.c_void_p]
            lib.demfi_augment_pack.restype = None
            lib.demfi_normalize.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_void_p]
            lib.demfi_normalize.restype = None
            _lib = lib
    return _lib


def _frames(frames_u8: np.ndarray) -> np.ndarray:
    if frames_u8.dtype != np.uint8 or frames_u8.ndim != 4 \
            or frames_u8.shape[-1] != 3:
        raise ValueError(f"native augment takes uint8 [T,H,W,3] frames, got "
                         f"{frames_u8.dtype} {frames_u8.shape}")
    return np.ascontiguousarray(frames_u8)


def augment_pack(frames_u8: np.ndarray, cy: int, cx: int, ps: int,
                 flip: bool, rot: int) -> np.ndarray:
    """[T,H,W,3] uint8 -> [T,ps,ps,3] float32 in [-1, 1]: the crop at
    (cy, cx) of side ps, the horizontal flip, rot90 x rot and the
    normalisation in one pass."""
    frames_u8 = _frames(frames_u8)
    t, h, w, _ = frames_u8.shape
    if not (0 <= cy and cy + ps <= h and 0 <= cx and cx + ps <= w and ps > 0):
        raise ValueError(f"crop ({cy}, {cx}) of side {ps} outside "
                         f"{h}x{w} frames")
    lib = get_lib()
    out = np.empty((t, ps, ps, 3), np.float32)
    lib.demfi_augment_pack(frames_u8.ctypes.data, t, h, w, cy, cx, ps,
                           int(flip), rot & 3, out.ctypes.data)
    return out


def normalize(frames_u8: np.ndarray) -> np.ndarray:
    """[T,H,W,3] uint8 -> float32 in [-1, 1]."""
    frames_u8 = _frames(frames_u8)
    lib = get_lib()
    out = np.empty(frames_u8.shape, np.float32)
    lib.demfi_normalize(frames_u8.ctypes.data, frames_u8.size,
                        out.ctypes.data)
    return out
