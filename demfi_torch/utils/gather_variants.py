"""Times source variants of the gather kernel on the card, for tuning.

    python -m demfi_torch.utils.gather_variants [variant ...]
    python -m demfi_torch.utils.gather_variants --bwd [variant ...]

Each variant is ``csrc/bilinear_gather.cu`` with a few constants or lines
replaced (tile sizes, pixels per thread, channels per block, the store
instruction), built with nvcc into a temporary directory and called
through ctypes on four synthetic shapes of the main path's sizes (smooth
random flows). Every variant's output must equal the unchanged source's
bit for bit. Device milliseconds as ``chip_smoke.py`` times them (a cold
call queued behind a spin kernel). Beside them: ``fill_`` of the two
absolute shapes' outputs, the card's practical rate for a pure store
stream, and the host microseconds of the pieces of a wrapper call.

With ``--bwd`` the variants are those of ``csrc/bilinear_gather_bwd.cu``
(the box in float32 with shared float atomics, a lane taking its left
neighbour's shared taps, the bfloat16 rounding pass element by element,
no prefetch of the next channel's loads,
register caps, the box's size, the largest box on the box route;
"global" sends every block to the global route, the first design's
scatter; and diagnostic cuts that leave work out), called on the train
step's three sites (the C=64 feature pair, FGAC's absolute sample, the
C=3 booster pair; batch 2, 256x256): on synthetic inputs
(``chip_smoke.gather_bwd_sites``: smooth flows that peak at 24 px) at
float32 and with bfloat16 images, and on DeMFI-Net_rb(5,3)'s own Stage
I as ``chip_smoke.py`` phase 7(a) makes them (float32). First, per
site, the quantiles of the kernel's box area over 8x32 query tiles and
over single rows of 32. Then device milliseconds of the kernel alone
(its outputs zeroed once before), the share of blocks on the box route,
and whether grad_coords equals the unchanged source's bit for bit and
grad_img's float32 sums agree with its to 1e-5 of their largest value
(the global reductions add in a varying order).

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

import numpy as np
import torch
import torch.nn.functional as F

from demfi_torch.ops import kernels, warp

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


BWD_FIXED = """        // exact: a power-of-two scale, then integers below 2^50
        const float v = rintf(__fmul_rn(val[k], scale));
        const float hi = floorf(__fmul_rn(v, kLowUnit));
        const float lo = __fsub_rn(v, __fmul_rn(hi, kLowScale));
        atomicAdd(hi_plane + slot[k], __float2int_rz(hi));
        if (lo != 0.0f) atomicAdd(lo_plane + slot[k], __float2int_rz(lo));"""
BWD_LOAD = "if (c + 1 < C) next.load(g, p, c + 1, nq, hw, off);"
BWD_TERMS = """      float val[4];
      channel_terms(cur, wt, dwx, dwy, val, gcx, gcy);"""
BWD_ADDS = "      int* hi_plane = box + 2 * ch * area;"
BWD_CC = "  // a channel takes two planes: the high parts, then the low ones"
# lane i's right taps are lane i + 1's left ones where their bases are
# neighbours: lane i + 1 adds both (the loop runs on every lane, for the
# shuffles)
PAIRS = [
    (BWD_CC, """  const int nty = __shfl_down_sync(kAll, ty, 1);
  const int ntx = __shfl_down_sync(kAll, tx, 1);
  const bool nlive = __shfl_down_sync(kAll, (int)live, 1);
  const bool give = live && nlive && lane < 31 && nty == ty && ntx == tx + 1;
  const bool take = __shfl_up_sync(kAll, (int)give, 1) && lane > 0;
""" + BWD_CC),
    ("    for (int ch = 0; live && ch < nc; ++ch) {",
     "    for (int ch = 0; ch < nc; ++ch) {"),
    (BWD_LOAD, "if (live && c + 1 < C) next.load(g, p, c + 1, nq, hw, off);"),
    (BWD_TERMS, """      float val[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (live) channel_terms(cur, wt, dwx, dwy, val, gcx, gcy);"""),
    (BWD_ADDS, """      const float in1 = __shfl_up_sync(kAll, val[1], 1);
      const float in3 = __shfl_up_sync(kAll, val[3], 1);
      if (take) {
        val[0] = __fadd_rn(val[0], in1);
        val[2] = __fadd_rn(val[2], in3);
      }
      if (give) val[1] = val[3] = 0.0f;
""" + BWD_ADDS),
]


def _sub(old, new):
    return [(old, new)]


BWD_VARIANTS = {
    "base": [],
    # the box in float32 with shared float atomics (compare-and-swap loops)
    "float_box": _sub(BWD_FIXED, "        atomicAdd(reinterpret_cast<float*>("
                                 "hi_plane) + slot[k], val[k]);")
    + [(f"to_float(h.{e}, l.{e}, unscale)", f"__int_as_float(h.{e})")
       for e in "xyzw"],
    "pairs": PAIRS,
    # the bfloat16 rounding pass element by element
    "scalar_round": _sub("  if (vec && i + 3 < n) {", "  if (false) {"),
    # each channel's loads issued where they are used
    "noprefetch": _sub("const Channel<T> cur = next;",
                       "Channel<T> cur;\n      cur.load(g, p, c, nq, hw, off);")
    + _sub(BWD_LOAD, ";"),
    "3blocks": _sub("__launch_bounds__(kThreads, kMinBlocks)",
                    "__launch_bounds__(kThreads)"),
    "5blocks": _sub("kMinBlocks = 4", "kMinBlocks = 5"),
    "box4k": _sub("kBoxWords = 8192", "kBoxWords = 4096"),
    "box16k": _sub("kBoxWords = 8192", "kBoxWords = 16384"),
    "area1k": _sub("kMaxArea = 2048", "kMaxArea = 1024"),
    "area4k": _sub("kMaxArea = 2048", "kMaxArea = 4096"),
    "global": _sub("kMaxArea = 2048", "kMaxArea = -1"),
    # diagnostic cuts: they leave work out (and DIFFER by design)
    "cut_prepass": _sub("""      big = max(big, __float_as_uint(__ldg(g + (int64_t)c * nq)) &
                         0x7fffffffu);""", "      big = 0x3f800000u;"),
    "cut_atomics": _sub(BWD_FIXED, ";"),
    "cut_flush": _sub("atomicAdd(reinterpret_cast<float4*>(dst), v);", ";"),
    "cut_taps": _sub("tap[k] = tap_f32(p + (int64_t)c * hw + off[k]);",
                     "tap[k] = 1.0f;"),
}


def build(names, tmp: Path, kernel: str = "bilinear_gather",
          variants=VARIANTS):
    src = (kernels.CSRC / kernels.SOURCES[kernel]).read_text()
    procs = {}
    for name in names:
        text = src
        for old, new in variants[name]:
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
        lib = kernels._bind(kernel, ctypes.CDLL(str(tmp / f"{name}.so")))
        libs[name] = (lib, ",".join(re.findall(r"Used (\d+) registers", log)))
    return libs


def model_bwd_sites(dev) -> dict:
    """The three sites on DeMFI-Net_rb(5,3)'s own Stage I at the train
    step's shapes, as ``chip_smoke.py`` phase 7(a) makes them (its seeds,
    the flow head calibrated to 24 px): the features f0, f1 warped by the
    t-aligned CFR flows, FGAC's sample of f0 at flow_01's raw values, the
    two blurry frames warped by the same flows; float32 images."""
    from chip_smoke import FLOW_TARGET_PX, SEED, TRAIN_B, TRAIN_PS
    from demfi_torch.config import config_rb
    from demfi_torch.models import make_model
    from demfi_torch.ops import cfr_flow_t_align
    from demfi_torch.utils.profiling import calibrate_flow_head
    batch = np.random.RandomState(SEED + 5).uniform(
        -1, 1, (TRAIN_B, 9, TRAIN_PS, TRAIN_PS, 3)).astype(np.float32)
    inputs = torch.from_numpy(batch).to(dev)[:, :4].permute(
        0, 1, 4, 2, 3).contiguous()
    model = make_model(config_rb(5, 3, seed=SEED), device=dev)
    calibrate_flow_head(model, inputs, FLOW_TARGET_PX)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        ctx = model.extract(inputs)
        tt = torch.tensor([0.375, 0.625], device=dev).reshape(-1, 1, 1, 1)
        ft0, ft1 = cfr_flow_t_align(ctx.flow_01, ctx.flow_10, tt)

    def cot(like):
        return torch.randn(like.shape, device=dev, generator=gen)
    f0, f1 = ctx.f0.contiguous(), ctx.f1.contiguous()
    b0, b1 = inputs[:, 0].contiguous(), inputs[:, 1].contiguous()
    return {"model pair rel C=64": ([(f0, ft0, cot(f0)), (f1, ft1, cot(f1))],
                                    True),
            "model abs C=64 (FGAC)": ([(f0, ctx.flow_01.contiguous(),
                                        cot(f0))], False),
            "model pair rel C=3": ([(b0, ft0, cot(b0)), (b1, ft1, cot(b1))],
                                   True)}


def box_areas(coords, relative: bool, h: int, w: int, rows: int):
    """Per query tile of ``rows`` x 32 pixels with a live pixel: the area
    (floats a channel) of the box of its live pixels' tap bases, one row
    and column more, clipped to the image, columns widened to groups of
    4, as the backward kernel sizes it."""
    b, _, hq, wq = coords.shape
    px, py = coords[:, 0], coords[:, 1]
    keep = torch.ones((b, hq, wq), dtype=torch.bool, device=coords.device)
    if relative:
        px = px + torch.arange(wq, device=coords.device)
        py = py + torch.arange(hq, device=coords.device)[:, None]
        ones = torch.ones((b, 1, h, w), device=coords.device)
        keep = warp.bilinear_gather_plain(ones, coords, True)[1][:, 0] >= 0.999
    x0, y0 = torch.floor(px), torch.floor(py)
    inside = torch.zeros_like(keep)
    for dy in (0, 1):
        for dx in (0, 1):
            inside |= ((x0 + dx >= 0) & (x0 + dx < w) & (y0 + dy >= 0)
                       & (y0 + dy < h))
    live = keep & inside
    big = float(2 ** 30)
    shape = (b, hq // rows, rows, wq // 32, 32)   # whole tiles only
    live = live[:, :shape[1] * rows, :shape[3] * 32].reshape(shape)

    def lo_hi(v):
        v = v[:, :shape[1] * rows, :shape[3] * 32].reshape(shape)
        lo = torch.where(live, v, big).amin(dim=(2, 4))
        hi = torch.where(live, v, -big).amax(dim=(2, 4))
        return lo, hi
    (rlo, rhi), (clo, chi) = lo_hi(y0), lo_hi(x0)
    any_live = live.any(dim=(2, 4))
    rb = rlo.clamp(min=0)
    bh = torch.minimum(rhi + 1, torch.tensor(h - 1.0)) - rb + 1
    cb = torch.div(clo.clamp(min=0), 4, rounding_mode="floor") * 4
    ce = torch.div(torch.minimum(chi + 1, torch.tensor(w - 1.0)), 4,
                   rounding_mode="floor") * 4 + 3
    return ((bh * (ce - cb + 1))[any_live]).float()


def main_bwd(names) -> int:
    """The backward's variants on the train step's three sites."""
    from chip_smoke import DeviceTimer, gather_bwd_sites
    dev = torch.device("cuda")
    sites = gather_bwd_sites(torch, dev)
    sites.update(model_bwd_sites(dev))
    for key, (halves, relative) in sites.items():
        if "bf16" in key:
            continue
        h, w = halves[0][0].shape[2:]
        for rows in (8, 1):
            a = torch.cat([box_areas(co, relative, h, w, rows)
                           for _, co, _ in halves])
            q = torch.quantile(a, torch.tensor([0.5, 0.9, 0.99, 1.0],
                                               device=dev)).tolist()
            print(f"{key}: box area of a {rows}x32 query tile, floats a "
                  f"channel: median {q[0]:.0f}, 90 % {q[1]:.0f}, 99 % "
                  f"{q[2]:.0f}, max {q[3]:.0f} ({a.numel()} tiles)")
    timer = DeviceTimer(torch)
    stats = torch.zeros(2, dtype=torch.int64, device=dev)
    outs = {}
    for key, (halves, _) in sites.items():
        n, c, h, w = halves[0][0].shape
        batch = len(halves) * n
        hq, wq = halves[0][1].shape[2:]
        outs[key] = (torch.zeros(batch, c, h, w, device=dev),
                     torch.empty(batch, c, h, w, dtype=halves[0][0].dtype,
                                 device=dev),
                     torch.empty(batch, 2, hq, wq, device=dev))

    def call(lib, key, route_stats=None):
        halves, relative = sites[key]
        acc, gimg, gco = outs[key]
        (a, ca, ga) = halves[0]
        second = halves[1] if len(halves) == 2 else (None, None, None)
        ptrs = [None if t is None else t.data_ptr()
                for t in (a, second[0], ca, second[1], ga, second[2])]
        n, c, h, w = a.shape
        tail = (gco.data_ptr(), None if route_stats is None
                else route_stats.data_ptr(), n, c, h, w, ca.shape[2],
                ca.shape[3], int(relative),
                torch.cuda.current_stream().cuda_stream)
        if a.dtype == torch.float32:
            rc = lib.demfi_bilinear_gather_bwd_f32(*ptrs, acc.data_ptr(), *tail)
        else:
            rc = lib.demfi_bilinear_gather_bwd_bf16(*ptrs, acc.data_ptr(),
                                                    gimg.data_ptr(), *tail)
        if rc != 0:
            raise RuntimeError(f"cudaError {rc}")

    print(torch.cuda.get_device_name(0))
    want = {}
    with tempfile.TemporaryDirectory(prefix="gather_bwd_variants_") as tmp:
        libs = build(names, Path(tmp), "bilinear_gather_bwd", BWD_VARIANTS)
        print("variant (registers) | " + " | ".join(
            f"{k} ms, box share" for k in sites) + "   [device ms]")
        for name, (lib, regs) in libs.items():
            cells = []
            for key in sites:
                acc, gimg, gco = outs[key]
                acc.zero_()
                stats.zero_()
                call(lib, key, stats)
                torch.cuda.synchronize()
                # the float32 sums (a bfloat16 rounding of sums taken in
                # another order may differ by one bfloat16 step)
                got_i = acc
                wi, wc = want.setdefault(key, (got_i.clone(), gco.clone()))
                same = (torch.equal(gco, wc) and float(
                    (got_i - wi).abs().max()) <= 1e-5 * max(
                        1.0, float(wi.abs().max())))
                box, glob = (int(v) for v in stats.cpu())
                ms = timer.ms(lambda: call(lib, key), 10)
                cells.append(f"{ms:.4f}, {box / max(1, box + glob):.3f}"
                             + ("" if same else " DIFFERS"))
            print(f"{name} ({regs}) | " + " | ".join(cells), flush=True)
    return 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gather_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    if argv[:1] == ["--bwd"]:
        return main_bwd(argv[1:] or list(BWD_VARIANTS))
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
            n, c, h, w, ca.shape[2], ca.shape[3], int(relative), 0,
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
