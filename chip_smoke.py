#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demfi_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of
                                     # one window

Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels, compiled from demfi_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes (352x640, x8: 7 instants), on inputs taken
     from DeMFI-Net_rb(5,3)'s own Stage I with the flow head calibrated
     to about 24 px; CUDA-event times of the kernel, its plain version
     and, for the gather, F.grid_sample as a yardstick;
  4. main path: x8 DeMFI-Net_rb(5,3), full width, seeded random weights,
     through InferenceEngine.forward_windows on one 352x640 window
     (warm-up, then timed runs; the rate is all windows over all their
     time, printed beside each window's seconds); every output finite
     and of its shape, and exactly 7 gather and 2 splat launches per
     window;
  5. whole path: the card (kernels) against the port on the CPU (plain
     versions) at 64x96 on the same weights, every WindowResult field.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {"platform": "gpu", ...}}. Any failed phase exits
non-zero before either is printed; so does a run without a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, W = 352, 640           # the reference's native test geometry
M = 8                     # x8: 7 instants per window
SMALL_H, SMALL_W = 64, 96
SEED = 0
REPEATS = 5
FLOW_TARGET_PX = 24.0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
GATHERS_PER_WINDOW = 7         # 2 FGAC + 2 feature bwarp_pair + 3 booster
SPLATS_PER_WINDOW = 2          # CFR
GATHER_TOL = 1e-5
SPLAT_RTOL = 1e-5              # of the largest |value|: atomics reorder sums
PATH_ATOL = PATH_RTOL = 1e-3   # card vs CPU, whole network in float32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def event_ms(torch, fn, n: int, flush) -> float:
    """Mean CUDA-event time of fn over n runs, each after an L2 flush."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(n):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / n


def gather_image_pixels(torch, coords, relative: bool, h: int, w: int) -> int:
    """Pixels of the image that a bilinear gather at coords [B,2,Hq,Wq]
    must read: the union, per batch element, of its in-image taps."""
    b, _, hq, wq = coords.shape
    px, py = coords[:, 0], coords[:, 1]
    if relative:
        px = px + torch.arange(w, device=coords.device)[None, None]
        py = py + torch.arange(h, device=coords.device)[None, :, None]
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    reached = torch.zeros(b, h * w, dtype=torch.bool, device=coords.device)
    rows = torch.arange(b, device=coords.device)[:, None, None].expand(
        b, hq, wq)
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            reached[rows[valid], (yi * w + xi)[valid]] = True
    return int(reached.sum())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import torch.nn.functional as F
    from demfi_torch.config import config_rb
    from demfi_torch.infer import InferenceEngine, WindowResult
    from demfi_torch.infer.engine import _field_channels
    from demfi_torch.models import make_model
    from demfi_torch.ops import cfr_flow_t_align, kernels, warp
    from demfi_torch.utils.profiling import calibrate_flow_head

    dev = torch.device("cuda")
    torch.set_grad_enabled(False)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---------------------------------------------------------- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    say(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")

    # ----------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    kernels.build()
    say(f"[2 build] {len(kernels.SOURCES)} kernels built in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})")

    # ---------------------------------------- 3. kernels against plain
    cfg = config_rb(5, 3, seed=SEED)
    model = make_model(cfg, device=dev)
    rng = np.random.RandomState(SEED)
    frames = rng.uniform(-1, 1, (1, 4, H, W, 3)).astype(np.float32)
    ts = (np.arange(1, M, dtype=np.float32) / M)[None]
    fr_t = torch.from_numpy(frames).to(dev).permute(0, 1, 4, 2, 3)
    raw_peak = calibrate_flow_head(model, fr_t, FLOW_TARGET_PX)
    ctx = model.extract(fr_t)
    n_t = M - 1
    t = torch.from_numpy(ts).to(dev).reshape(n_t, 1, 1, 1)
    flow_01 = ctx.flow_01.expand(n_t, -1, -1, -1).contiguous()
    flow_10 = ctx.flow_10.expand(n_t, -1, -1, -1).contiguous()
    ft0, ft1 = cfr_flow_t_align(flow_01, flow_10, t)
    peak = float(max(ctx.flow_01.abs().max(), ctx.flow_10.abs().max()))
    say(f"[3 kernels] flow head calibrated: peak |flow| {raw_peak:.2f} -> "
        f"{peak:.2f} px; CFR flows peak {float(ft0.abs().max()):.2f} px")

    def rep(x, n):
        return x.expand(n, -1, -1, -1).contiguous()

    b0 = fr_t[:, 0].contiguous()
    b1 = fr_t[:, 1].contiguous()
    cases = [
        # name, per-window count, kernel args
        ("gather rel C=64 B=14", 2, "bilinear_gather",
         (torch.cat([rep(ctx.f0, n_t), rep(ctx.f1, n_t)]),
          torch.cat([ft0, ft1]).contiguous(), True)),
        ("gather rel C=3 B=14", 3, "bilinear_gather",
         (torch.cat([rep(b0, n_t), rep(b1, n_t)]),
          torch.cat([ft0, ft1]).contiguous(), True)),
        ("gather abs C=64 B=1", 2, "bilinear_gather",
         (ctx.f0.contiguous(), ctx.flow_01.contiguous(), False)),
        ("gather abs C=64 B=1 query 3Hx3W", 0, "bilinear_gather",
         (ctx.f0.contiguous(),
          warp.fgac_window_coords(ctx.flow_01, 1).contiguous(), False)),
        ("splat C=2 B=7", 2, "fwarp_splat", (flow_01, (t * flow_01).contiguous())),
    ]
    flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32, device=dev)
    rows = []
    for name, per_window, kname, kargs in cases:
        wrapper = getattr(kernels, kname)
        if kname == "bilinear_gather":
            img, coords, relative = kargs
            plain = warp.bilinear_gather_plain
            b, c, h, w = img.shape
            hq, wq = coords.shape[2:]
            # the image pixels the taps reach, the coords, out and ones
            nbytes = 4 * (gather_image_pixels(torch, coords, relative, h, w)
                          * c + coords.numel() + b * c * hq * wq
                          + (b * hq * wq if relative else 0))
            flops = b * hq * wq * (8 * c + 24)
            gx = coords[:, 0] + (torch.arange(w, device=dev)[None, None]
                                 if relative else 0)
            gy = coords[:, 1] + (torch.arange(h, device=dev)[None, :, None]
                                 if relative else 0)
            grid = torch.stack([gx * (2.0 / (w - 1)) - 1.0,
                                gy * (2.0 / (h - 1)) - 1.0], dim=-1)

            def library(img=img, grid=grid):
                return F.grid_sample(img, grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)
        else:
            img, flo = kargs
            plain = warp.fwarp_splat_plain
            b, c, h, w = img.shape
            nbytes = 4 * (img.numel() + flo.numel() + img.numel() + b * h * w)
            flops = b * h * w * 4 * (2 * (c + 1) + 12)
            library = None
        got = wrapper(*kargs)
        want = plain(*kargs)
        torch.cuda.synchronize()
        errs = [float((g - p).abs().max()) for g, p in zip(got, want)
                if g is not None]
        scale = max(float(p.abs().max()) for p in want if p is not None)
        err = max(errs)
        tol = GATHER_TOL if kname == "bilinear_gather" else \
            SPLAT_RTOL * max(1.0, scale)
        finite = all(bool(torch.isfinite(g).all()) for g in got
                     if g is not None)
        ms = event_ms(torch, lambda: wrapper(*kargs), 10, flush)
        plain_ms = event_ms(torch, lambda: plain(*kargs), 3, flush)
        lib_ms = (event_ms(torch, library, 10, flush) if library else None)
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = flops / F32_FLOPS_PER_S * 1e3
        row = dict(case=name, kernel=kname, per_window=per_window,
                   max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bytes=nbytes,
                   bound_ms=max(bound_b, bound_o),
                   bound_by="bytes" if bound_b >= bound_o else "operations")
        rows.append(row)
        say(f"[3 kernels] {name}: max_abs_err {err:.3g} (tol {tol:.3g}) | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{'none (no single-call equivalent)' if lib_ms is None else f'{lib_ms:.4f} ms (F.grid_sample)'}"
            f" | bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
            f"({nbytes / 1e9:.4f} GB)")
        check(finite, f"{name}: non-finite kernel output")
        check(err <= tol, f"{name}: kernel disagrees with its plain version "
                          f"({err} > {tol})")
    del cases, flush, ctx, fr_t, flow_01, flow_10, ft0, ft1, t, b0, b1
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 4. main path
    engine = InferenceEngine(model, num_update=cfg.N_tst)
    engine.forward_windows(frames, ts)                       # warm-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    secs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        res = engine.forward_windows(frames, ts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    per_pi = (peak_bytes - base) / (H * W * (M - 1))
    check(len(res) == 1, "forward_windows returned the wrong window count")
    for f in dataclasses.fields(WindowResult):
        arr = getattr(res[0], f.name)
        check(arr.shape == (M - 1, H, W, _field_channels(f.name)),
              f"{f.name}: shape {arr.shape}")
        check(bool(np.isfinite(arr).all()), f"{f.name}: non-finite values")
    want_counts = {"bilinear_gather": GATHERS_PER_WINDOW * REPEATS,
                   "fwarp_splat": SPLATS_PER_WINDOW * REPEATS}
    check(counts == want_counts,
          f"launch counts {counts} != {want_counts} over {REPEATS} windows")
    s_win = sum(secs) / REPEATS         # all windows over all their time
    say(f"[4 main path] x8 DeMFI-Net_rb(5,3) 352x640 float32, "
        f"{REPEATS} windows: seconds {['%.4f' % s for s in secs]} "
        f"(min {min(secs):.4f}, max {max(secs):.4f}); "
        f"{1 / s_win:.4f} windows/s = {(M - 1) / s_win:.4f} "
        f"interpolated frames/s; peak allocated {peak_bytes / 2 ** 30:.3f} "
        f"GiB ({per_pi:.0f} B per pixel-instant above the weights); "
        f"launches {counts}")

    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.forward_windows(frames, ts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        avg = prof.key_averages()
        # device busy time: the union of the intervals of device-side
        # events (kernels and copies), profiler bookkeeping rows excluded
        spans = sorted(
            (e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and "Buffer" not in e.name)
        busy_us, end = 0.0, float("-inf")
        for lo, hi in spans:
            busy_us += max(0.0, hi - max(lo, end))
            end = max(end, hi)
        busy = busy_us / 1e6
        groups = {"warp kernels": ("bilinear_gather", "fwarp_splat"),
                  "copies": ("Memcpy", "Memset"),
                  "convolutions": ("conv", "gemm", "fft", "xmma", "winograd")}
        share = dict.fromkeys(list(groups) + ["other"], 0.0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and "Buffer" not in e.name:
                g = next((k for k, keys in groups.items()
                          if any(x in e.name for x in keys)), "other")
                share[g] += e.time_range.elapsed_us() / 1e6
        table = avg.table(sort_by="self_device_time_total", row_limit=25)
        say(f"[4 profile] one window: wall {wall:.4f} s, device busy "
            f"{busy:.4f} s ({100 * busy / wall:.1f} %, idle "
            f"{100 * (1 - busy / wall):.1f} %); device seconds by kind "
            f"{ {k: round(v, 4) for k, v in share.items()} }; top:\n" +
            table)

    # ------------------------------------- 5. whole path, card vs CPU
    small = np.random.RandomState(SEED + 1).uniform(
        -1, 1, (1, 4, SMALL_H, SMALL_W, 3)).astype(np.float32)
    cpu_model = make_model(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict(), strict=True)
    gpu_res = engine.forward_windows(small, ts)[0]
    cpu_res = InferenceEngine(cpu_model, num_update=cfg.N_tst,
                              device="cpu").forward_windows(small, ts)[0]
    worst = (0.0, 0.0, "")
    for f in dataclasses.fields(WindowResult):
        a, b = getattr(gpu_res, f.name), getattr(cpu_res, f.name)
        check(a.shape == b.shape, f"{f.name}: card {a.shape} cpu {b.shape}")
        err = float(np.abs(a - b).max())
        ratio = float((np.abs(a - b) / (PATH_ATOL + PATH_RTOL * np.abs(b))).max())
        if ratio >= worst[1]:
            worst = (err, ratio, f.name)
        check(ratio <= 1.0, f"{f.name}: card vs CPU max abs err {err} beyond "
                            f"atol {PATH_ATOL} + rtol {PATH_RTOL} * |cpu|")
    say(f"[5 whole path] card vs CPU at {SMALL_H}x{SMALL_W} x8: worst field "
        f"{worst[2]} max abs err {worst[0]:.3g}, {worst[1]:.3f} of the "
        f"tolerance (atol {PATH_ATOL} + rtol {PATH_RTOL} * |cpu|)")

    # ---------------------------------------------------------- results
    def summary(kname, source, replaces, per_window):
        mine = [r for r in rows if r["kernel"] == kname]
        on_path = [r for r in mine if r["per_window"]]

        def per_win(key):
            if any(r[key] is None for r in on_path):
                return None
            return sum(r[key] * r["per_window"] for r in on_path)
        return dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=counts[kname], launches_per_window=per_window,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_win("ms"), plain_ms=per_win("plain_ms"),
            bound_ms=per_win("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in mine)
            else "operations",
            library_ms=per_win("library_ms"),
            times_are="per window, summed over its launches",
            shapes=mine)

    say(json.dumps({"kernels": [
        summary("bilinear_gather", "demfi_torch/csrc/bilinear_gather.cu",
                "demfi_tpu/ops/pallas_kernels.py:58", GATHERS_PER_WINDOW),
        summary("fwarp_splat", "demfi_torch/csrc/fwarp_splat.cu",
                "demfi_tpu/ops/pallas_kernels.py:273", SPLATS_PER_WINDOW),
    ], "card": card, "windows_per_s": 1 / s_win,
        "frames_per_s": (M - 1) / s_win, "window_seconds": secs,
        "peak_bytes": peak_bytes,
        "bytes_per_pixel_instant": per_pi}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
