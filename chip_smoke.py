#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demfi_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of
                                     # one window
    python3 chip_smoke.py --kernels-of DIR   # phases 1-3 only, on the
                                     # checkout of the port at DIR

Phases:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels, compiled from demfi_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card,
     at the main path's shapes (352x640, x8: 7 instants), on inputs taken
     from DeMFI-Net_rb(5,3)'s own Stage I with the flow head calibrated
     to about 24 px. Per case two times: the device's (CUDA events
     around one cold call that is queued behind a spin kernel, so the
     host's enqueue is not in it; see DeviceTimer) and the host's
     enqueue (host clock per call over many calls, no synchronise), of
     the kernel, of its plain version (device only) and, for the gather,
     of F.grid_sample as a yardstick. The gather runs as the main path
     calls it (bwarp_pair on two separate halves: one launch, no
     torch.cat, equal to the gather of the concatenation; FGAC's
     absolute sample), with and without the in-image weight plane, and
     on a 3Hx3W query grid; a case without the plane counts no plane
     into its byte bound. The stencil forward warp runs at D = 8 (flows
     scaled into its window) and D = 32 (the 24 px flows), against its
     plain version (bitwise) and the plain splat, twice for a bitwise
     comparison, with the share of source rows its range test skipped,
     at the largest window it takes and one beyond (refused), and once
     beyond its window, where the guard must hand the call to the atomic
     splat. The stencil's bound is the function's (the splat's bytes and
     operations); its window's taps are printed beside it, not counted
     into it;
  4. main path: x8 DeMFI-Net_rb(5,3), full width, seeded random weights,
     through InferenceEngine.forward_windows on one 352x640 window
     (warm-up, then timed runs; the rate is all windows over all their
     time, printed beside each window's seconds); every output finite
     and of its shape, and exactly 7 gather and 2 splat launches per
     window;
  5. whole path: the card (kernels) against the port on the CPU (plain
     versions) at 64x96 on the same weights, every WindowResult field;
  6. eval entry point: a synthetic dataset tree (2 scenes, 2 windows
     each, 352x640 PNGs) and a seeded checkpoint of full-width
     DeMFI-Net_rb(5,3) with the flow head calibrated to 6.5 px, then
     ``demfi_torch.main.cli --phase test --multiple_MFI 8
     --fwarp_shift_d 8`` twice: finite metrics, the result tables, the
     expected PNGs, every CFR call served by the stencil kernel, every
     window through dispatch_windows/fetch_windows, and the two runs'
     metrics and PNG bytes identical; windows/s and the share of wall
     time that the engine's stream spent inside dispatched windows (an
     upper bound on the device's busy share); then ``--phase
     test_custom`` x4 on one small scene.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {"platform": "gpu", ...}}. Any failed phase exits
non-zero before either is printed; so does a run without a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
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
SHIFT_D = 8                    # the eval path's stencil window
SHIFT_D_BIG = 32               # a window that covers FLOW_TARGET_PX
EVAL_FLOW_PX = 6.5             # eval path: every |flow| <= SHIFT_D - 1
EVAL_SCENES, EVAL_BLUR_FRAMES = 2, 5       # 2 windows per scene
CUSTOM_H, CUSTOM_W = 128, 192
GATHER_TOL = 1e-5
SPLAT_RTOL = 1e-5              # of the largest |value|: atomics reorder sums
# stencil against its plain version: the same order and rounding, so 0 is
# expected; 1e-6 of the largest |value| allows one ulp of expf
SHIFT_RTOL = 1e-6
ENQUEUE_CALLS = 100            # calls per host-clock enqueue measurement
PATH_ATOL = PATH_RTOL = 1e-3   # card vs CPU, whole network in float32


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def enqueue_us(torch, fn, n: int) -> float:
    """Host microseconds per call of fn, enqueue only: the host clock over
    n back-to-back calls with no synchronise between them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


class DeviceTimer:
    """Device time of one call, apart from the host's time to enqueue it.

    Each timed call is preceded by an L2 flush (a 64 MB fill: the callers
    on the main path find their inputs cold, written by far larger
    layers) and by a spin kernel (``torch.cuda._sleep``) long enough to
    cover the host's enqueue of the call. So the device reaches the first
    event only after the host has queued the call and the second event:
    the interval between the events holds the call's kernels and nothing
    of the host. A run of n back-to-back calls between one pair of events
    would also hide the host, but leaves inputs under 50 MB warm in L2;
    the spin keeps every call cold. The same method times a kernel, its
    plain version and the library call.
    """

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 2 ** 20 // 4, dtype=torch.float32,
                                 device="cuda")
        cycles = 20_000_000
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        e1.synchronize()
        self.cycles_per_us = cycles / (e0.elapsed_time(e1) * 1e3)

    def ms(self, fn, n: int) -> float:
        """Mean device milliseconds of fn over n cold calls."""
        torch = self.torch
        # the spin covers twice the host's enqueue of one call, and 50 us
        spin = int((2 * enqueue_us(torch, fn, 1) + 50) * self.cycles_per_us)
        pairs = []
        for _ in range(n):
            self.flush.zero_()
            torch.cuda._sleep(spin)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn()
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / n


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
    ap.add_argument("--kernels-of", metavar="DIR", default="",
                    help="run phases 1-3 on the checkout of the port at DIR "
                         "and stop ('.' for this one; an earlier commit's, "
                         "to time both in one run: what that checkout's "
                         "kernels lack, the pair entry and the stencil's "
                         "row count and largest window, is then not "
                         "checked)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one GPU")
    sys.path.insert(0, str(Path(args.kernels_of).resolve() if args.kernels_of
                           else Path(__file__).resolve().parent))
    import torch.nn.functional as F
    from demfi_torch.config import config_rb
    from demfi_torch.infer import InferenceEngine, WindowResult
    from demfi_torch.infer.engine import _field_channels
    from demfi_torch.models import make_model
    from demfi_torch.ops import cfr_flow_t_align, kernels, warp
    from demfi_torch.utils.profiling import calibrate_flow_head

    # False only for an earlier checkout under --kernels-of
    has_pair_entry = hasattr(kernels, "bilinear_gather_pair")
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

    timer = DeviceTimer(torch)
    say(f"[3 kernels] times: device ms = CUDA events around one cold call "
        f"(L2 flushed) queued behind a spin kernel that covers its "
        f"enqueue ({timer.cycles_per_us:.0f} spin cycles per us); enqueue us "
        f"= host clock per call over {ENQUEUE_CALLS} calls, no synchronise")

    def timed(fn, plain, library, n_plain):
        """Device ms and host enqueue us of a kernel call, its plain
        version and its library call (or None)."""
        out = dict(ms=timer.ms(fn, 10),
                   enqueue_us=enqueue_us(torch, fn, ENQUEUE_CALLS),
                   plain_ms=timer.ms(plain, n_plain),
                   library_ms=None, library_enqueue_us=None)
        if library is not None:
            out["library_ms"] = timer.ms(library, 10)
            out["library_enqueue_us"] = enqueue_us(torch, library,
                                                   ENQUEUE_CALLS)
        return out

    def times_text(r, library_name):
        lib = ("none (no single-call equivalent)" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms device, "
                    f"{r['library_enqueue_us']:.1f} us enqueue ({library_name})")
        return (f"kernel {r['ms']:.4f} ms device, {r['enqueue_us']:.1f} us "
                f"enqueue; plain {r['plain_ms']:.4f} ms; library {lib}")

    def grid_sample_of(img, coords, relative):
        """F.grid_sample computing the same gather (the 0.999 mask of the
        relative mode apart), on a grid made outside the timed call."""
        h, w = img.shape[2:]
        gx = coords[:, 0] + (torch.arange(w, device=dev)[None, None]
                             if relative else 0)
        gy = coords[:, 1] + (torch.arange(h, device=dev)[None, :, None]
                             if relative else 0)
        grid = torch.stack([gx * (2.0 / (w - 1)) - 1.0,
                            gy * (2.0 / (h - 1)) - 1.0], dim=-1)
        return lambda: F.grid_sample(img, grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)

    def gather_bytes(img, coords, relative, ones_plane):
        """What the call must move: the image pixels its taps reach, the
        coordinates, the output and, where asked for, the ones plane."""
        b, c, h, w = img.shape
        hq, wq = coords.shape[2:]
        return 4 * (gather_image_pixels(torch, coords, relative, h, w) * c
                    + coords.numel() + b * c * hq * wq
                    + (b * hq * wq if ones_plane else 0))

    def count_cats(fn):
        """fn(), and how often it called torch.cat."""
        calls, cat = [0], torch.cat

        def counting(*a, **k):
            calls[0] += 1
            return cat(*a, **k)
        torch.cat = counting
        try:
            return fn(), calls[0]
        finally:
            torch.cat = cat

    b0 = fr_t[:, 0].contiguous()
    b1 = fr_t[:, 1].contiguous()
    flows_t = torch.cat([ft0, ft1]).contiguous()
    rows = []

    def gather_row(name, per_window, relative, ones_plane, imgs, coords,
                   fn, pairs, note=""):
        """One gather case: fn() launches once; pairs() gives (kernel
        result, plain result) tensors; imgs/coords are the call's halves."""
        n0 = kernels.bilinear_gather.launches
        got_want = pairs()
        torch.cuda.synchronize()
        check(kernels.bilinear_gather.launches == n0 + 1,
              f"{name}: {kernels.bilinear_gather.launches - n0} launches, "
              f"expected 1")
        err = max(float((g - p).abs().max()) for g, p in got_want)
        finite = all(bool(torch.isfinite(g).all()) for g, _ in got_want)
        nbytes = sum(gather_bytes(i, c, relative, ones_plane)
                     for i, c in zip(imgs, coords))
        flops = sum(c.shape[0] * c.shape[2] * c.shape[3]
                    * (8 * i.shape[1] + 24) for i, c in zip(imgs, coords))
        samplers = [grid_sample_of(i, c, relative)
                    for i, c in zip(imgs, coords)]
        r = timed(fn,
                  lambda: [warp.bilinear_gather_plain(i, c, relative)
                           for i, c in zip(imgs, coords)],
                  lambda: [f() for f in samplers], 3)
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = flops / F32_FLOPS_PER_S * 1e3
        r.update(case=name, kernel="bilinear_gather", per_window=per_window,
                 max_abs_err=err, tol=GATHER_TOL, bytes=nbytes,
                 bound_ms=max(bound_b, bound_o),
                 bound_by="bytes" if bound_b >= bound_o else "operations")
        rows.append(r)
        lib_name = ("F.grid_sample" if len(imgs) == 1
                    else f"{len(imgs)} F.grid_sample calls")
        say(f"[3 kernels] {name}: max_abs_err {err:.3g} (tol {GATHER_TOL:.3g})"
            f"{note} | {times_text(r, lib_name)} | bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes / 1e9:.4f} "
            f"GB; kernel at {r['ms'] / r['bound_ms']:.2f}x)")
        check(finite, f"{name}: non-finite kernel output")
        check(err <= GATHER_TOL, f"{name}: kernel disagrees with its plain "
                                 f"version ({err} > {GATHER_TOL})")

    def single(name, per_window, img, coords, relative):
        def pairs():
            got = kernels.bilinear_gather(img, coords, relative)
            want = warp.bilinear_gather_plain(img, coords, relative)
            return [(g, p) for g, p in zip(got, want) if g is not None]
        gather_row(name, per_window, relative, relative, [img], [coords],
                   lambda: kernels.bilinear_gather(img, coords, relative),
                   pairs)

    def no_ones(name, img, coords):
        """bwarp: the relative gather without the in-image weight plane."""
        def pairs():
            return [(warp.bwarp(img, coords),
                     warp.bilinear_gather_plain(img, coords, True)[0])]
        gather_row(name, 0, True, False, [img], [coords],
                   lambda: warp.bwarp(img, coords), pairs)

    def pair(name, per_window, a, b, fa, fb):
        """bwarp_pair on two separate halves: one launch, each half equal
        to its plain version, both equal to the gather of the
        concatenation, and no torch.cat on the way."""
        cats = []

        def pairs():
            (ga, gb), n_cat = count_cats(lambda: warp.bwarp_pair(a, b, fa, fb))
            cats.append(n_cat)
            return [(ga, warp.bilinear_gather_plain(a, fa, True)[0]),
                    (gb, warp.bilinear_gather_plain(b, fb, True)[0])]
        gather_row(name, per_window, True, False, [a, b], [fa, fb],
                   lambda: warp.bwarp_pair(a, b, fa, fb), pairs,
                   note="; one launch")
        ga, gb = warp.bwarp_pair(a, b, fa, fb)
        whole = kernels.bilinear_gather(torch.cat([a, b]),
                                        torch.cat([fa, fb]), True)[0]
        same = torch.equal(torch.cat([ga, gb]), whole)
        say(f"[3 kernels] {name}: torch.cat calls inside bwarp_pair "
            f"{cats[0]}; bitwise equal to the gather of the concatenated "
            f"halves: {same}")
        check(same, f"{name}: differs from the gather of the concatenation")
        if has_pair_entry:
            check(cats[0] == 0, f"{name}: bwarp_pair concatenated its halves")

    n_f0, n_f1 = rep(ctx.f0, n_t), rep(ctx.f1, n_t)
    n_b0, n_b1 = rep(b0, n_t), rep(b1, n_t)
    pair("gather pair rel C=64 2x7", 2, n_f0, n_f1, ft0, ft1)
    pair("gather pair rel C=3 2x7", 3, n_b0, n_b1, ft0, ft1)
    single("gather abs C=64 B=1", 2, ctx.f0.contiguous(),
           ctx.flow_01.contiguous(), False)
    single("gather abs C=64 B=1 query 3Hx3W", 0, ctx.f0.contiguous(),
           warp.fgac_window_coords(ctx.flow_01, 1).contiguous(), False)
    f01 = torch.cat([n_f0, n_f1])
    del n_f0, n_f1
    single("gather rel C=64 B=14", 0, f01, flows_t, True)
    no_ones("gather rel C=64 B=14 no ones plane", f01, flows_t)
    del f01
    b01 = torch.cat([n_b0, n_b1])
    single("gather rel C=3 B=14", 0, b01, flows_t, True)
    no_ones("gather rel C=3 B=14 no ones plane", b01, flows_t)
    del b01, n_b0, n_b1

    # the atomic splat; C = 2 (CFR warps the flows)
    img, flo = flow_01, (t * flow_01).contiguous()
    got = kernels.fwarp_splat(img, flo)
    want = warp.fwarp_splat_plain(img, flo)
    torch.cuda.synchronize()
    scale = max(float(p.abs().max()) for p in want)
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    tol = SPLAT_RTOL * max(1.0, scale)
    b, c = img.shape[:2]
    nbytes = 4 * (img.numel() + flo.numel() + img.numel() + b * H * W)
    flops = b * H * W * 4 * (2 * (c + 1) + 12)
    r = timed(lambda: kernels.fwarp_splat(img, flo),
              lambda: warp.fwarp_splat_plain(img, flo), None, 3)
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = flops / F32_FLOPS_PER_S * 1e3
    r.update(case="splat C=2 B=7", kernel="fwarp_splat", per_window=2,
             max_abs_err=err, tol=tol, bytes=nbytes,
             bound_ms=max(bound_b, bound_o),
             bound_by="bytes" if bound_b >= bound_o else "operations")
    rows.append(r)
    say(f"[3 kernels] splat C=2 B=7: max_abs_err {err:.3g} (tol {tol:.3g}) | "
        f"{times_text(r, '')} | bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']} ({nbytes / 1e9:.4f} GB; kernel at "
        f"{r['ms'] / r['bound_ms']:.2f}x)")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "splat: non-finite kernel output")
    check(err <= tol, f"splat: kernel disagrees with its plain version "
                      f"({err} > {tol})")

    # the stencil forward warp: D = 8 on the flows scaled into its
    # window, D = 32 on the 24 px flows; C = 2 (CFR warps the flows)
    def corners_in_image(flo):
        r = torch.floor(flo[:, 1]) + torch.arange(H, device=dev)[None, :, None]
        c = torch.floor(flo[:, 0]) + torch.arange(W, device=dev)[None, None]
        return sum(int(((r + dr >= 0) & (r + dr < H) & (c + dc >= 0)
                        & (c + dc < W)).sum())
                   for dr in (0, 1) for dc in (0, 1))

    def window_taps(n, d):
        # over output positions 0..n-1: source positions inside [0, n)
        # among the 2d + 2 of the window
        pos = torch.arange(n)
        return int((torch.clamp(pos + d, max=n - 1)
                    - torch.clamp(pos - d - 1, min=0) + 1).sum())

    for d, img in ((SHIFT_D, (flow_01 * ((SHIFT_D - 1.1) / peak)).contiguous()),
                   (SHIFT_D_BIG, flow_01)):
        flo = (t * img).contiguous()
        check(float(flo.abs().max()) <= d - 1, f"D={d}: flows beyond the window")
        name = f"shift C=2 B=7 D={d}"
        got = kernels.fwarp_shift(img, flo, d)
        again = kernels.fwarp_shift(img, flo, d)
        want = warp.fwarp_shift_plain(img, flo, d)
        splat = warp.fwarp_splat_plain(img, flo)
        torch.cuda.synchronize()
        scale = max(1.0, float(want[0].abs().max()), float(want[1].abs().max()))
        err = max(float((g - p).abs().max()) for g, p in zip(got, want))
        err_splat = max(float((g - p).abs().max()) for g, p in zip(got, splat))
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, want))
        b, c = img.shape[:2]
        nbytes = 4 * (img.numel() + flo.numel() + img.numel() + b * H * W)
        # the function's operations are the splat's: per corner inside
        # the image the weight and the C+1 multiply-adds. What the
        # stencil spends on top, two floors and four compares per tap
        # of its window inside the image, is printed and not counted.
        flops = corners_in_image(flo) * (2 * (c + 1) + 12)
        window_ops = 6 * b * window_taps(H, d) * window_taps(W, d)
        r = timed(lambda: kernels.fwarp_shift(img, flo, d),
                  lambda: warp.fwarp_shift_plain(img, flo, d), None, 1)
        guarded_ms = timer.ms(lambda: warp.fwarp(img, flo, d), 10)
        guarded_us = enqueue_us(torch, lambda: warp.fwarp(img, flo, d),
                                ENQUEUE_CALLS)
        # the share of its (2D+2) source rows per warp that the kernel
        # skipped on these flows, counted by the kernel itself
        skipped = None
        if has_pair_entry:
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            counted = kernels.fwarp_shift(img, flo, d, row_stats=stats)
            check(all(torch.equal(a, b) for a, b in zip(got, counted)),
                  f"{name}: counting the rows changed the result")
            tested, skipped_rows = (int(v) for v in stats.cpu())
            check(tested > 0, f"{name}: the kernel counted no rows")
            skipped = skipped_rows / tested
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = flops / F32_FLOPS_PER_S * 1e3
        r.update(
            case=name, kernel="fwarp_shift", per_window=2 if d == SHIFT_D else 0,
            max_abs_err=err, tol=SHIFT_RTOL * scale, bitwise_equal_to_plain=bitwise,
            two_runs_bitwise_equal=repeats, max_abs_err_vs_plain_splat=err_splat,
            guarded_fwarp_ms=guarded_ms, guarded_fwarp_enqueue_us=guarded_us,
            rows_skipped_share=skipped,
            bytes=nbytes, operations=flops, window_ops=window_ops,
            bound_ms=max(bound_b, bound_o),
            bound_by="bytes" if bound_b >= bound_o else "operations")
        rows.append(r)
        say(f"[3 kernels] {name}: max_abs_err {err:.3g} (tol "
            f"{SHIFT_RTOL * scale:.3g}; bitwise equal to plain: {bitwise}; two "
            f"runs bitwise equal: {repeats}); against the plain splat "
            f"{err_splat:.3g} (tol {SPLAT_RTOL * scale:.3g}) | "
            f"{times_text(r, '')}; through the guard (flag pass, both "
            f"launches) {guarded_ms:.4f} ms device, {guarded_us:.1f} us "
            f"enqueue | source rows skipped by their range test: "
            f"{'not counted' if skipped is None else f'{100 * skipped:.1f} %'}"
            f" | bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']} ({nbytes / 1e9:.4f} GB, "
            f"{flops / 1e9:.3f} G operations; kernel at "
            f"{r['ms'] / r['bound_ms']:.1f}x; the window's tap tests, "
            f"not in the bound: {window_ops / 1e9:.3f} G taps x 6)")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{name}: non-finite kernel output")
        check(err <= SHIFT_RTOL * scale,
              f"{name}: kernel disagrees with its plain version ({err})")
        check(err_splat <= SPLAT_RTOL * scale,
              f"{name}: stencil disagrees with the plain splat ({err_splat})")
        check(repeats, f"{name}: two runs of the kernel differ")
        check(bitwise, f"{name}: kernel not bitwise equal to its plain version")
    # a window whose tile of targets does not fit a block's shared memory
    # is refused, the largest that fits is served
    if has_pair_entry:
        d_max = kernels.FWARP_SHIFT_MAX_D
        small_img, small_flo = img[:1, :, :40, :64].contiguous(), \
            flo[:1, :, :40, :64].contiguous()
        got = kernels.fwarp_shift(small_img, small_flo, d_max)
        want = warp.fwarp_shift_plain(small_img, small_flo, d_max)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"D={d_max}: kernel not bitwise equal to its plain version")
        n0 = kernels.fwarp_shift.launches
        try:
            kernels.fwarp_shift(small_img, small_flo, d_max + 1)
        except ValueError as e:
            refusal = str(e)
        else:
            fail(f"D={d_max + 1}: a window beyond the largest was not refused")
        check(kernels.fwarp_shift.launches == n0,
              "a refused window counted as a launch")
        say(f"[3 kernels] shift: D={d_max} (the largest whose tile fits a "
            f"block's shared memory) bitwise equal to plain at 40x64; "
            f"D={d_max + 1} refused: {refusal}")
    # beyond the window the guard hands the call to the atomic splat
    flo = (t * flow_01).contiguous()
    kernels.fwarp_served(dev, reset=True)
    got = warp.fwarp(flow_01, flo, SHIFT_D)
    served = kernels.fwarp_served(dev, reset=True)
    want = warp.fwarp_splat_plain(flow_01, flo)
    scale = max(1.0, float(want[0].abs().max()))
    err = max(float((g - p).abs().max()) for g, p in zip(got, want))
    say(f"[3 kernels] guard: peak |flow| {float(flo.abs().max()):.2f} px beyond "
        f"D={SHIFT_D}: served by {served}; max_abs_err against the plain "
        f"splat {err:.3g} (tol {SPLAT_RTOL * scale:.3g})")
    check(served == {"fwarp_shift": 0, "fwarp_splat": 1},
          f"guard: beyond the window the splat must serve, got {served}")
    check(err <= SPLAT_RTOL * scale, f"guard: splat route disagrees ({err})")
    del timer, ctx, fr_t, flow_01, flow_10, ft0, ft1, flows_t, t, b0, b1
    del got, again, want, splat, img, flo
    torch.cuda.empty_cache()
    if args.kernels_of:
        say(json.dumps({"kernel_cases": rows, "card": card,
                        "tree": args.kernels_of}))
        return 0

    # ------------------------------------------------------- 4. main path
    engine = InferenceEngine(model, num_update=cfg.N_tst)
    engine.forward_windows(frames, ts)                       # warm-up
    torch.cuda.synchronize()
    # dispatch_windows must return while the device still works on the
    # window (one host copy from pageable memory would make it wait)
    t0 = time.perf_counter()
    handle = engine.dispatch_windows(frames, ts)
    enqueue_s = time.perf_counter() - t0
    busy_at_return = not handle[0][0].done.query()
    engine.fetch_windows(handle)
    total_s = time.perf_counter() - t0
    say(f"[4 main path] dispatch_windows returned after {enqueue_s:.4f} s, "
        f"device still busy: {busy_at_return}; fetched after {total_s:.4f} s "
        f"({engine.dispatched_stream_seconds:.4f} s between the events on "
        f"the engine's stream)")
    check(busy_at_return, "dispatch_windows waited for the device")
    del handle
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    kernels.fwarp_served(dev, reset=True)
    secs = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        res = engine.forward_windows(frames, ts)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    served = kernels.fwarp_served(dev)
    peak_bytes = torch.cuda.max_memory_allocated()
    per_pi = (peak_bytes - base) / (H * W * (M - 1))
    check(len(res) == 1, "forward_windows returned the wrong window count")
    for f in dataclasses.fields(WindowResult):
        arr = getattr(res[0], f.name)
        check(arr.shape == (M - 1, H, W, _field_channels(f.name)),
              f"{f.name}: shape {arr.shape}")
        check(bool(np.isfinite(arr).all()), f"{f.name}: non-finite values")
    want_counts = {"bilinear_gather": GATHERS_PER_WINDOW * REPEATS,
                   "fwarp_splat": SPLATS_PER_WINDOW * REPEATS,
                   "fwarp_shift": 0}
    check(counts == want_counts,
          f"launch counts {counts} != {want_counts} over {REPEATS} windows")
    check(served == {"fwarp_shift": 0,
                     "fwarp_splat": SPLATS_PER_WINDOW * REPEATS},
          f"forward warps served by {served}")
    s_win = sum(secs) / REPEATS         # all windows over all their time
    say(f"[4 main path] x8 DeMFI-Net_rb(5,3) 352x640 float32, "
        f"{REPEATS} windows: seconds {['%.4f' % s for s in secs]} "
        f"(min {min(secs):.4f}, max {max(secs):.4f}); "
        f"{1 / s_win:.4f} windows/s = {(M - 1) / s_win:.4f} "
        f"interpolated frames/s; peak allocated {peak_bytes / 2 ** 30:.3f} "
        f"GiB ({per_pi:.0f} B per pixel-instant above the weights); "
        f"launches {counts}; forward warps served by {served}")

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
        groups = {"warp kernels": ("bilinear_gather", "fwarp_splat",
                                   "fwarp_shift"),
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

    del engine, model, cpu_model, gpu_res, cpu_res, res
    torch.cuda.empty_cache()

    # ------------------------------------------------ 6. eval entry point
    from demfi_torch.checkpoint import checkpoint_path, save_checkpoint
    from demfi_torch.data import imageio
    from demfi_torch.data.datasets import _normalize
    from demfi_torch.infer import driver
    from demfi_torch.main import cli, parse_args

    def run_cli(argv):
        """cli(argv) with its standard output captured."""
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = cli(argv)
        return result, out.getvalue(), time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="demfi_smoke_") as tmp:
        tmp = Path(tmp)
        rng = np.random.RandomState(SEED + 2)
        blur_names = [17 + 8 * k for k in range(EVAL_BLUR_FRAMES)]
        windows = []
        t0 = time.perf_counter()
        for sc in range(EVAL_SCENES):
            sharp_dir = tmp / "data" / "test" / f"scene{sc}"
            blur_dir = tmp / "data" / "test_blur" / f"scene{sc}"
            sharp_dir.mkdir(parents=True)
            blur_dir.mkdir(parents=True)
            for i in range(blur_names[0], blur_names[-1] + 1):
                imageio.imwrite(str(sharp_dir / f"{i:05d}.png"),
                                rng.randint(0, 256, (H, W, 3)).astype(np.uint8))
            blur = [rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
                    for _ in blur_names]
            for i, img in zip(blur_names, blur):
                imageio.imwrite(str(blur_dir / f"{i:05d}.png"), img)
            # the windows evaluate will build, in its order B0, B1, B-1, B2
            windows += [np.stack([blur[k], blur[k + 1], blur[k - 1], blur[k + 2]])
                        for k in range(1, EVAL_BLUR_FRAMES - 2)]
        n_windows = len(windows)
        write_s = time.perf_counter() - t0

        argv = ["--phase", "test", "--multiple_MFI", str(M),
                "--fwarp_shift_d", str(SHIFT_D), "--seed", str(SEED + 2),
                "--test_data_path", str(tmp / "data"),
                "--checkpoint_dir", str(tmp / "ckpt")]
        ecfg = parse_args(argv)
        check((ecfg.nf, ecfg.N_trn, ecfg.N_tst) == (64, 5, 3),
              "the eval phase must run full-width DeMFI-Net_rb(5,3)")
        emodel = make_model(ecfg, device=dev)
        wins = torch.from_numpy(_normalize(np.stack(windows))).to(
            dev).permute(0, 1, 4, 2, 3)
        raw = calibrate_flow_head(emodel, wins, EVAL_FLOW_PX)
        ckpt = checkpoint_path(ecfg, "latest")
        save_checkpoint(ckpt, emodel.state_dict(), {"last_epoch": 0})
        del emodel, wins
        torch.cuda.empty_cache()
        say(f"[6 eval] dataset: {EVAL_SCENES} scenes x "
            f"{n_windows // EVAL_SCENES} windows of {H}x{W} PNGs written in "
            f"{write_s:.2f} s; checkpoint {os.path.getsize(ckpt) / 2 ** 20:.1f} "
            f"MiB, flow head calibrated {raw:.2f} -> {EVAL_FLOW_PX} px")

        runs = []
        for tag in ("a", "b"):
            kernels.reset_launch_counts()
            kernels.fwarp_served(dev, reset=True)
            driver.last_eval_stats = None
            result, text, wall = run_cli(
                argv + ["--test_img_dir", str(tmp / f"imgs_{tag}")])
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            served = kernels.fwarp_served(dev)
            st = driver.last_eval_stats
            check(st is not None, f"eval run {tag}: evaluate left no stats")
            done, dispatched = st.windows, st.dispatched
            ev_wall, ev_span = st.wall_seconds, st.stream_seconds
            dec, met, enc = (v / max(done, 1)
                             for v in (st.decode, st.metrics, st.encode))
            check(result is not None and bool(np.isfinite(result[:5]).all()),
                  f"eval run {tag}: metrics {result}")
            for head in (f"x{M} MFI results", "[PSNR Stage I (7 intp, 1 dblr)]",
                         "[SSIM Stage I (7 intp, 1 dblr)]",
                         "[PSNR Stage II (7 intp, 1 dblr)]",
                         "[SSIM Stage II (7 intp, 1 dblr)]"):
                check(head in text, f"eval run {tag}: no table {head!r}")
            check(done == dispatched == n_windows,
                  f"eval run {tag}: {done} windows, {dispatched} through "
                  f"dispatch_windows, expected {n_windows}")
            check(served == {"fwarp_shift": SPLATS_PER_WINDOW * n_windows,
                             "fwarp_splat": 0},
                  f"eval run {tag}: forward warps served by {served}")
            check(launches == {"bilinear_gather": GATHERS_PER_WINDOW * n_windows,
                               "fwarp_shift": SPLATS_PER_WINDOW * n_windows,
                               "fwarp_splat": SPLATS_PER_WINDOW * n_windows},
                  f"eval run {tag}: launches {launches}")
            files = {}
            for sc in range(EVAL_SCENES):
                names = sorted(os.listdir(os.path.join(result[5], f"scene{sc}")))
                # every St of both windows, and the windows' S0/S1 frames
                want_names = sorted(
                    {f"{b + j:05d}.png" for b in blur_names[1:-2]
                     for j in range(1, M)}
                    | {f"{b:05d}.png" for b in blur_names[1:-1]})
                check(names == want_names, f"eval run {tag}: scene{sc} holds "
                                           f"{names}, expected {want_names}")
                for n in names:
                    files[f"scene{sc}/{n}"] = Path(
                        result[5], f"scene{sc}", n).read_bytes()
            runs.append(dict(result=result, files=files, launches=launches,
                             served=served, cli_wall=wall, wall=ev_wall,
                             stream_span=ev_span, decode=dec, metrics=met,
                             encode=enc))
            say(f"[6 eval] run {tag}: loss {result[0]:.6f}, intp PSNR "
                f"{result[1]:.4f} SSIM {result[2]:.6f}, deblur PSNR "
                f"{result[3]:.4f} SSIM {result[4]:.6f}; {len(files)} PNGs; cli "
                f"wall {wall:.2f} s; evaluate wall {ev_wall:.4f} s = "
                f"{n_windows / ev_wall:.4f} windows/s, engine-stream span "
                f"{ev_span:.4f} s ({100 * ev_span / ev_wall:.1f} % of wall); "
                f"host s/window: "
                f"decode {dec:.4f}, metrics {met:.4f}, encode {enc:.4f}; "
                f"launches {launches}; forward warps served by {served}")
        a, b = runs
        check(a["result"][:5] == b["result"][:5],
              f"the two eval runs' metrics differ: {a['result'][:5]} vs "
              f"{b['result'][:5]}")
        check(a["files"].keys() == b["files"].keys()
              and all(a["files"][k] == b["files"][k] for k in a["files"]),
              "the two eval runs' PNG bytes differ")
        eval_launches = b["launches"]

        # test_custom, x4, one small scene
        clip = tmp / "clips" / "clipA"
        clip.mkdir(parents=True)
        for i in range(5):
            imageio.imwrite(str(clip / f"{i:05d}.png"), rng.randint(
                0, 256, (CUSTOM_H, CUSTOM_W, 3)).astype(np.uint8))
        _, text, wall = run_cli([
            "--phase", "test_custom", "--multiple_MFI", "4",
            "--fwarp_shift_d", str(SHIFT_D), "--custom_path",
            str(tmp / "clips"), "--checkpoint_dir", str(tmp / "ckpt")])
        out_dir = tmp / "clips" / "clipA_sharply_interpolated_x4"
        names = sorted(os.listdir(out_dir))
        want_names = sorted([f"{w:05d}_{j:03d}.png" for w in (1, 2)
                             for j in range(3)]
                            + ["00001.png", "00002.png", "00003.png"])
        check(names == want_names, f"test_custom wrote {names}")
        for n in names:
            img = imageio.imread(str(out_dir / n))
            check(img.shape == (CUSTOM_H, CUSTOM_W, 3), f"{n}: {img.shape}")
        say(f"[6 eval] test_custom x4 at {CUSTOM_H}x{CUSTOM_W}: {len(names)} "
            f"PNGs in clipA_sharply_interpolated_x4, cli wall {wall:.2f} s")
    ev = runs[1]
    say(f"[6 eval] x8 DeMFI-Net_rb(5,3) {H}x{W} float32 through "
        f"demfi_torch.main.cli --phase test, second run: "
        f"{n_windows / ev['wall']:.4f} windows/s, engine-stream span share "
        f"{100 * ev['stream_span'] / ev['wall']:.1f} % of wall time (CUDA "
        f"events around each dispatched window on the engine's stream, "
        f"launch gaps included: the device's busy share is at most this); "
        f"two runs identical in metrics and in {len(ev['files'])} PNG files")

    # ---------------------------------------------------------- results
    def summary(kname, source, replaces, per_window, launches):
        mine = [r for r in rows if r["kernel"] == kname]
        on_path = [r for r in mine if r["per_window"]]

        def per_win(key):
            if any(r[key] is None for r in on_path):
                return None
            return sum(r[key] * r["per_window"] for r in on_path)
        check(launches > 0, f"{kname}: never launched on its main path")
        return dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=launches, launches_per_window=per_window,
            launches_eval_path=eval_launches[kname],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_win("ms"), plain_ms=per_win("plain_ms"),
            bound_ms=per_win("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in on_path)
            else "operations",
            library_ms=per_win("library_ms"),
            times_are="per window, summed over its launches",
            shapes=mine)

    say(json.dumps({"kernels": [
        summary("bilinear_gather", "demfi_torch/csrc/bilinear_gather.cu",
                "demfi_tpu/ops/pallas_kernels.py:58", GATHERS_PER_WINDOW,
                counts["bilinear_gather"]),
        summary("fwarp_splat", "demfi_torch/csrc/fwarp_splat.cu",
                "demfi_tpu/ops/pallas_kernels.py:273", SPLATS_PER_WINDOW,
                counts["fwarp_splat"]),
        summary("fwarp_shift", "demfi_torch/csrc/fwarp_shift.cu",
                "demfi_tpu/ops/pallas_kernels.py:479", SPLATS_PER_WINDOW,
                eval_launches["fwarp_shift"]),
    ], "card": card, "windows_per_s": 1 / s_win,
        "frames_per_s": (M - 1) / s_win, "window_seconds": secs,
        "peak_bytes": peak_bytes,
        "bytes_per_pixel_instant": per_pi,
        "eval": {k: [r[k] for r in runs] for k in (
            "wall", "stream_span", "decode", "metrics", "encode",
            "cli_wall")},
        "eval_windows": n_windows,
        "eval_windows_per_s": n_windows / ev["wall"],
        "eval_engine_stream_span_share": ev["stream_span"] / ev["wall"]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
