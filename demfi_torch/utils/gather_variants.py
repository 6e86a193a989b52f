"""Times source variants of the gather kernel on the card, for tuning.

    python -m demfi_torch.utils.gather_variants [variant ...]

Each variant is ``csrc/bilinear_gather.cu`` with a few constants or lines
replaced (tile sizes, pixels per thread, channels per block, the store
instruction), built with nvcc into a temporary directory and called
through ctypes on four synthetic shapes of the main path's sizes (smooth
random flows). Every variant's output must equal the unchanged source's
bit for bit. Device milliseconds as ``chip_smoke.py`` times them (a cold
call queued behind a spin kernel). Beside them: ``fill_`` of the two
absolute shapes' outputs, the card's practical rate for a pure store
stream, and the host microseconds of the pieces of a wrapper call.

A substitution that no longer applies to the source raises: the list
describes this source, update it with the kernel.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from demfi_torch.ops import kernels

H, W = 352, 640
BOUNDS = "__launch_bounds__(kTX * kTY)\nbilinear"
VARIANTS = {
    "base": [],
    "chunk4": [("kChunk = 8", "kChunk = 4")],
    "chunk16": [("kChunk = 8", "kChunk = 16")],
    "chunk64": [("kChunk = 8", "kChunk = 64")],
    "wide1": [("kWideTile = 2", "kWideTile = 1")],
    "wide4": [("kWideTile = 2", "kWideTile = 4")],
    "wide8": [("kWideTile = 2", "kWideTile = 8")],
    "rows1": [("kTY = 4", "kTY = 1")],
    "rows2": [("kTY = 4", "kTY = 2")],
    "rows8": [("kTY = 4", "kTY = 8")],
    "px1": [("kPX = 2", "kPX = 1")],
    "px4": [("kPX = 2", "kPX = 4")],
    "px8": [("kPX = 2", "kPX = 8")],
    "regs40": [(BOUNDS, BOUNDS.replace("kTY)", "kTY, 12)"))],
    "plain_store": [("__stcs(dk + j * kTX, v[k][j])",
                     "dk[j * kTX] = v[k][j]")],
    # four neighbouring pixels per thread, one 16-byte store
    "vector_store": [
        ("kPX = 2", "kPX = 4"),
        ("      if (live[j]) __stcs(dk + j * kTX, v[k][j]);",
         "      if (j == 0 && live[0]) __stcs((float4*)dk, make_float4("
         "v[k][0], v[k][1], v[k][2], v[k][3]));"),
        ("blockIdx.x * (kTX * kPX) + threadIdx.x",
         "(blockIdx.x * kTX + threadIdx.x) * kPX"),
        ("j * kTX", "j")],
}


def build(names, tmp: Path):
    src = (kernels.CSRC / kernels.SOURCES["bilinear_gather"]).read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(tmp / f"{name}.so"), str(tmp / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"{name}:\n{log}")
        lib = kernels._bind("bilinear_gather",
                            ctypes.CDLL(str(tmp / f"{name}.so")))
        libs[name] = (lib, ",".join(re.findall(r"Used (\d+) registers", log)))
    return libs


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gather_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from chip_smoke import DeviceTimer       # the repository's timing
    names = argv or list(VARIANTS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def smooth(n, amp):
        low = torch.randn(n, 2, H // 16, W // 16, device=dev, generator=gen)
        return (F.interpolate(low, size=(H, W), mode="bilinear")
                * amp).contiguous()

    def call(lib, a, b, ca, cb, out, relative):
        n, c, h, w = a.shape
        rc = lib.demfi_bilinear_gather_f32(
            a.data_ptr(), None if b is None else b.data_ptr(), ca.data_ptr(),
            None if cb is None else cb.data_ptr(), out.data_ptr(), None,
            n, c, h, w, ca.shape[2], ca.shape[3], int(relative),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cudaError {rc}")

    fa, fb = smooth(7, 6.0), smooth(7, 6.0)
    a64, b64 = (torch.randn(7, 64, H, W, device=dev, generator=gen)
                for _ in range(2))
    a3, b3 = (torch.randn(7, 3, H, W, device=dev, generator=gen)
              for _ in range(2))
    one, c1 = a64[:1].contiguous(), smooth(1, 10.0)
    c9 = c1.repeat(1, 1, 3, 3).contiguous()
    shapes = {
        "pair rel C=64 2x7": (a64, b64, fa, fb,
                              torch.empty(14, 64, H, W, device=dev), True),
        "pair rel C=3 2x7": (a3, b3, fa, fb,
                             torch.empty(14, 3, H, W, device=dev), True),
        "abs C=64 B=1": (one, None, c1, None,
                         torch.empty(1, 64, H, W, device=dev), False),
        "abs C=64 B=1 3Hx3W": (one, None, c9, None,
                               torch.empty(1, 64, 3 * H, 3 * W, device=dev),
                               False),
    }
    timer = DeviceTimer(torch)
    print(torch.cuda.get_device_name(0))
    with tempfile.TemporaryDirectory(prefix="gather_variants_") as tmp:
        libs = build(names, Path(tmp))
        want = {}
        print("variant (registers per channel tile 4,3,2,1) | "
              + " | ".join(shapes) + "   [device ms]")
        for name, (lib, regs) in libs.items():
            cells = []
            for sname, args in shapes.items():
                call(lib, *args)
                torch.cuda.synchronize()
                same = torch.equal(want.setdefault(sname, args[4].clone()),
                                   args[4])
                ms = timer.ms(lambda: call(lib, *args), 10)
                cells.append(f"{ms:.4f}" + ("" if same else " DIFFERS"))
            print(f"{name} ({regs}) | " + " | ".join(cells), flush=True)
    for sname in ("abs C=64 B=1", "abs C=64 B=1 3Hx3W"):
        out = shapes[sname][4]
        ms = timer.ms(lambda: out.fill_(1.5), 10)
        print(f"fill_ of the output of {sname}: {ms:.4f} ms "
              f"({out.numel() * 4 / ms / 1e9:.2f} TB/s)")

    def host_us(label, fn, n=1000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        print(f"host us per call, {label}: {us:.2f}")

    lib = kernels.build()["bilinear_gather"]
    out = shapes["pair rel C=3 2x7"][4]
    host_us("_check of 4 tensors", lambda: kernels._check("x", a3, fa, b3, fb))
    host_us("torch.empty of the output", lambda: torch.empty(
        out.shape, dtype=torch.float32, device=dev))
    host_us("torch.cuda.current_stream(dev).cuda_stream",
            lambda: torch.cuda.current_stream(dev).cuda_stream)
    host_us("kernels._raw_stream(dev)", lambda: kernels._raw_stream(out.device))
    host_us("the ctypes call, its launch, data_ptrs and current_stream",
            lambda: call(lib, a3, b3, fa, fb, out, True), 300)
    host_us("kernels.bilinear_gather_pair (C=3 pair)",
            lambda: kernels.bilinear_gather_pair(a3, b3, fa, fb, True), 300)
    grid = torch.randn(7, H, W, 2, device=dev, generator=gen)
    host_us("F.grid_sample (C=3 B=7)", lambda: F.grid_sample(
        a3, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
        300)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
