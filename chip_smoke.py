#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demfi_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of
                                     # one window and of one train step
    python3 chip_smoke.py --kernels-of DIR   # phases 1-3c only, on the
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
     into its byte bound. The atomic splat runs on the smooth CFR flows
     (the main path's call), on i.i.d. noise flows of the same peak (its
     worst case: no source tile's targets fit its shared box) and on
     flows with NaN, infinite and huge entries (dropped by the kernel,
     held against the plain version with those entries set to 1e9), each
     with the share of its blocks per route (shared box or global
     atomics), after a line of how far floor(flo) spreads inside its
     source tiles. The stencil forward warp runs at D = 8 (flows
     scaled into its window) and D = 32 (the 24 px flows), against its
     plain version (bitwise) and the plain splat, twice for a bitwise
     comparison, with the share of source rows its range test skipped,
     at the largest window it takes and one beyond (refused), and once
     beyond its window, where the guard must hand the call to the atomic
     splat. The stencil's bound is the function's (the splat's bytes and
     operations); its window's taps are printed beside it, not counted
     into it. The bfloat16 model's gathers: both pairs again on bfloat16
     values (image bytes counted at 2 B, F.grid_sample in bfloat16 as the
     yardstick; FGAC's sample stays float32 there);
  3c. (``--kernels-of`` only) the gather's backward at the train step's
     three sites on synthetic inputs (gather_bwd_sites), float32 and
     bfloat16 images: device ms, the share of blocks per route and the
     error against the plain vjp, so that two checkouts compare in one
     run;
  4. main path: x8 DeMFI-Net_rb(5,3), full width, seeded random weights,
     through InferenceEngine.forward_windows on one 352x640 window
     (warm-up, then timed runs; the rate is all windows over all their
     time, printed beside each window's seconds); every output finite
     and of its shape, and exactly 7 gather and 2 splat launches per
     window; the device's busy share of one profiled window;
  4b. the same at --compute_dtype bfloat16 on the same weights: the same
     numbers, 5 of the 7 gathers on the bfloat16 instantiation, float32
     on the host, the PSNR of its frames against phase 4's through
     ``bf16_serving_label``; then each of the two with cudnn.benchmark
     off and on in turns (the default, off, is left as it is);
  5. whole path: the card (kernels) against the port on the CPU (plain
     versions) at 64x96 on the same weights, every WindowResult field,
     with cudnn.benchmark on and off;
  5b. the same at bfloat16: every field float32 and of its shape, its
     mean and std within 0.08 (per-pixel checks mean nothing there);
  6. eval entry point: a synthetic dataset tree (2 scenes, 2 windows
     each, 352x640 PNGs) and a seeded checkpoint of full-width
     DeMFI-Net_rb(5,3) with the flow head calibrated to 6.5 px, then
     ``demfi_torch.main.cli --phase test --multiple_MFI 8
     --fwarp_shift_d 8`` twice: finite metrics, the result tables, the
     expected PNGs, every CFR call served by the stencil kernel, every
     window through dispatch_windows/fetch_windows, and the two runs'
     metrics and PNG bytes identical; windows/s and the share of wall
     time that the engine's stream spent inside dispatched windows (an
     upper bound on the device's busy share); once more with
     ``--compute_dtype bfloat16`` (finite metrics, the same PNG names);
     then ``--phase test_custom`` x4 on one small scene, at float32 and
     at bfloat16;
  7. training, DeMFI-Net_rb(5,3) at its published setting (batch 2,
     256x256 patches, N_trn = 5, float32 and bfloat16): (a) each backward
     kernel
     against its plain vjp (autograd through the plain version) at the
     train step's shapes, on inputs from the model's own Stage I with the
     flow head calibrated to about 24 px: the gather's on both C=64
     bwarp_pairs (one launch), FGAC's absolute sample and the C=3 booster
     pair, with aten.grid_sampler_2d_backward (on the masked cotangent) as
     a yardstick; the splat's on the CFR flows, i.i.d. noise flows and
     non-finite flows (dropped pixels get zero gradients), twice for a
     bitwise comparison; each with device ms, enqueue us, bound and the
     plain vjp's ms, the gather's with the share of its blocks per route
     (shared box or global atomics); the gather's three sites again on
     bfloat16 images (their gradient within 1e-2 of the largest value,
     the coordinates' 1e-5; FGAC's only as a check, it samples float32 in
     the bfloat16 model);
     (b) one train step on the card against the port on
     the CPU at 64x64 on the same weights and batch: the loss, and every
     gradient against the CPU's to the larger of 1e-3 and twice the
     larger of the CPU's own change under 1e-6 nudges of the batch
     (sized to the card's departure on the flows:
     ``demfi_torch.utils.grad_check.gradient_bounds``) and the card's
     change between two runs; each of five planted faults (a group of
     warps passing no gradient on) must fail that check; (b') the same
     at bfloat16, where the fault of every warp must fail it; (c) 8 steps
     on one fixed batch: the loss falls; seconds per step, forward /
     backward / optimizer device time (CUDA events), peak memory, and
     exactly 9 gather, 9 gather-backward, 2 splat, 2 splat-backward and
     no stencil launches per step; then steps with cudnn.benchmark off
     and on in turns;
     (c') the same at bfloat16 from the same weights (7 of the 9 gathers
     and gather-backwards on the bfloat16 instantiation; parameters,
     gradients and Adam's state float32); (d) ``cli --phase train`` on a
     synthetic tree (4
     train scenes, phase 6's test scenes for validation and the final
     evaluation at x2) for 2 epochs, ``--auto_resume`` for a third
     (starts at epoch 2, Adam's step count carried over), then ``--phase
     test`` on the trained checkpoint (strict load); then one epoch at
     ``--compute_dtype bfloat16``, whose float32 checkpoint loads into a
     float32 model.

Prints a {"kernels": [...]} line, then as its last line
{"ok": true, "device": {"platform": "gpu", ...}}. Any failed phase exits
non-zero before either is printed; so does a run without a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import inspect
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
SPLAT_TILE = (8, 32)           # fwarp_splat.cu's source tile, rows x columns
SPREAD_BINS = ((0, 0), (1, 1), (2, 2), (3, 4), (5, 8), (9, 16), (17, 10 ** 6))
NONFINITE_SHARE = 1e-3         # of the flow entries, in the non-finite case
NONFINITE_VALUES = (np.nan, np.inf, -np.inf, 1e9, -1e9)
# stencil against its plain version: the same order and rounding, so 0 is
# expected; 1e-6 of the largest |value| allows one ulp of expf
SHIFT_RTOL = 1e-6
ENQUEUE_CALLS = 100            # calls per host-clock enqueue measurement
PATH_ATOL = PATH_RTOL = 1e-3   # card vs CPU, whole network in float32
# phase 7, training: DeMFI-Net_rb(5,3)'s published setting
TRAIN_B, TRAIN_PS = 2, 256     # batch, patch
TRAIN_SMALL = 64               # card against CPU
# backward kernel against its plain vjp: of the largest value per output
# (the gather's backward adds onto the taps with float atomics, in an
# order that varies from run to run)
BWD_RTOL = 1e-5
STEP_LOSS_RTOL = 1e-4
OVERFIT_STEPS, OVERFIT_WARMUP = 8, 2
# per train step: 2 FGAC + 2 feature pairs + 5 booster pairs; 2 CFR splats
TRAIN_LAUNCHES = {"bilinear_gather": 9, "fwarp_splat": 2, "fwarp_shift": 0,
                  "bilinear_gather_bwd": 9, "fwarp_splat_bwd": 2}
CLI_TRAIN_SCENES, CLI_BLUR_FRAMES = 4, 4
# bfloat16 (--compute_dtype bfloat16): the feature and booster pairs
# gather bfloat16 values, FGAC's two samples stay float32
BF16_GATHERS_PER_WINDOW = 5    # 2 feature pairs + 3 booster pairs
TRAIN_BF16_LAUNCHES = {"bilinear_gather": 7, "bilinear_gather_bwd": 7}
# the backward's bfloat16 image gradient against its plain vjp: of the
# largest value (a bfloat16 rounding is 2^-8 of the value)
BWD_BF16_IMG_RTOL = 1e-2
# bfloat16 against bfloat16 on other hardware: per-pixel checks mean
# nothing (rounding a flow moves which pixel a warp reads), each output's
# mean and std within this (docs/PERF.md:216-218)
BF16_MOMENTS_TOL = 0.08
# cudnn.benchmark off against on: after one call with it on (it
# autotunes), rounds of calls in turns off, on, on, off, so that a drift
# of the host or the card falls on both sides
BENCHMARK_ROUNDS = 2
BF16_LOSS_RTOL = 1e-2          # a bfloat16 train step's loss, card vs CPU


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


def benchmark_ab(torch, fn) -> dict:
    """Seconds of fn() (host clock to a synchronise) with
    torch.backends.cudnn.benchmark off and on, in turns (off, on, on,
    off) over BENCHMARK_ROUNDS rounds, after one call with it on that
    autotunes. Leaves it off, the default."""
    secs = {"off": [], "on": []}
    try:
        torch.backends.cudnn.benchmark = True
        fn()
        torch.cuda.synchronize()
        for _ in range(BENCHMARK_ROUNDS):
            for on in (False, True, True, False):
                torch.backends.cudnn.benchmark = on
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                secs["on" if on else "off"].append(time.perf_counter() - t0)
    finally:
        torch.backends.cudnn.benchmark = False
    return secs


def benchmark_text(secs: dict, unit: str) -> str:
    med = {k: float(np.median(v)) for k, v in secs.items()}
    return (f"off against on in turns (off, on, on, off) x "
            f"{BENCHMARK_ROUNDS}: seconds a {unit} off "
            f"{['%.4f' % v for v in secs['off']]}, on "
            f"{['%.4f' % v for v in secs['on']]}; medians off "
            f"{med['off']:.4f}, on {med['on']:.4f} (on/off "
            f"{med['on'] / med['off']:.3f}); on faster in "
            f"{sum(a < b for a, b in zip(secs['on'], secs['off']))} of "
            f"{len(secs['on'])} pairs")


def gather_image_pixels(torch, coords, relative: bool, h: int, w: int,
                        where=None) -> int:
    """Pixels of the image that a bilinear gather at coords [B,2,Hq,Wq]
    must read: the union, per batch element, of its in-image taps (of the
    query pixels ``where`` [B,Hq,Wq] marks, if given)."""
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
            if where is not None:
                valid &= where
            reached[rows[valid], (yi * w + xi)[valid]] = True
    return int(reached.sum())


def gather_bwd_counts(torch, warp, coords, relative: bool, h: int, w: int):
    """What the gather's vjp at coords [B,2,Hq,Wq] must touch: the
    unmasked query pixels (the relative mode's 0.999 mask zeroes the
    rest, grad_out there is not read) and the image pixels their in-image
    taps reach."""
    b, _, hq, wq = coords.shape
    if relative:
        ones = torch.ones((b, 1, h, w), device=coords.device)
        live = warp.bilinear_gather_plain(ones, coords, True)[1][:, 0] >= 0.999
    else:
        live = torch.ones((b, hq, wq), dtype=torch.bool, device=coords.device)
    return (int(live.sum()),
            gather_image_pixels(torch, coords, relative, h, w, where=live))


def gather_bwd_sites(torch, dev) -> dict:
    """Synthetic inputs of the gather backward's three train-step sites,
    at the train step's shapes (batch 2, 256x256): the C=64 feature pair
    and the C=3 booster pair on smooth relative flows (a 16x16 field of
    normal draws, upsampled bilinearly, scaled to peak at FLOW_TARGET_PX),
    and FGAC's absolute sample at such a field's raw values (taps near
    the image's origin, as the main path's FGAC takes them), each with a
    float32 image and again with a bfloat16 one. Made from SEED on the
    card. Returns {site: ([(img, coords, grad_out)], relative)}."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    nb, ps = TRAIN_B, TRAIN_PS

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=g)

    def smooth():
        f = F.interpolate(randn(nb, 2, ps // 16, ps // 16), size=(ps, ps),
                          mode="bilinear", align_corners=False)
        return (f * (FLOW_TARGET_PX / f.abs().max())).contiguous()

    fa, fb, fabs = smooth(), smooth(), smooth()
    f64, i3 = [randn(nb, 64, ps, ps) for _ in range(2)], \
        [randn(nb, 3, ps, ps) for _ in range(2)]
    g64, g3 = [randn(nb, 64, ps, ps) for _ in range(3)], \
        [randn(nb, 3, ps, ps) for _ in range(2)]
    sites = {}
    for dt, tag in ((torch.float32, ""), (torch.bfloat16, " bf16")):
        sites["pair rel C=64" + tag] = ([(f64[0].to(dt), fa, g64[0]),
                                         (f64[1].to(dt), fb, g64[1])], True)
        sites["abs C=64 (FGAC)" + tag] = ([(f64[0].to(dt), fabs, g64[2])],
                                          False)
        sites["pair rel C=3" + tag] = ([(i3[0].to(dt), fa, g3[0]),
                                        (i3[1].to(dt), fb, g3[1])], True)
    return sites


def splat_targets(torch, flo) -> int:
    """Distinct in-image pixels the forward splat of flo [B,2,H,W] lands
    on (the splat's vjp reads grad_out and grad_norm there only)."""
    b, _, h, w = flo.shape
    r = torch.floor(flo[:, 1]).long() + torch.arange(h, device=flo.device)[
        None, :, None]
    c = torch.floor(flo[:, 0]).long() + torch.arange(w, device=flo.device)[
        None, None]
    fin = torch.isfinite(flo).all(1)
    reached = torch.zeros(b, h * w, dtype=torch.bool, device=flo.device)
    rows = torch.arange(b, device=flo.device)[:, None, None].expand(b, h, w)
    for dr in (0, 1):
        for dc in (0, 1):
            ok = fin & (r + dr >= 0) & (r + dr < h) & (c + dc >= 0) & (c + dc < w)
            reached[rows[ok], ((r + dr) * w + c + dc)[ok]] = True
    return int(reached.sum())


def device_breakdown(torch, fn, label: str):
    """A torch.profiler trace of fn(): wall time, the device's busy share
    (the union of the intervals of device-side events, profiler
    bookkeeping rows excluded), device seconds by kind and the top
    kernels. Returns (the text, the busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and "Buffer" not in e.name]
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        busy_us += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    busy = busy_us / 1e6
    groups = {"warp kernels": ("bilinear_gather", "fwarp_splat",
                               "fwarp_shift"),
              "copies": ("Memcpy", "Memset"),
              "convolutions": ("conv", "gemm", "fft", "xmma", "winograd")}
    share = dict.fromkeys(list(groups) + ["other"], 0.0)
    for e in events:
        g = next((k for k, keys in groups.items()
                  if any(x in e.name for x in keys)), "other")
        share[g] += e.time_range.elapsed_us() / 1e6
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    return (f"{label}: wall {wall:.4f} s, device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f} "
            f"%); device seconds by kind "
            f"{ {k: round(v, 4) for k, v in share.items()} }; top:\n"
            + table), busy / wall


def train_phase(torch, dev, data_root: Path, tmp: Path,
                profile: bool = False) -> dict:
    """Phase 7: the training path at full width. (a) each backward kernel
    against its plain vjp at the train step's shapes, timed; (b) one train
    step on the card against the port on the CPU; (c) 8 steps on one fixed
    batch, timed, with the launches of all five kernels per step; (d)
    ``cli --phase train``, its resume and a test load of its checkpoint.
    Returns what the results line reports."""
    from demfi_torch.checkpoint import load_training_checkpoint
    from demfi_torch.config import config_rb
    from demfi_torch.data import imageio
    from demfi_torch.main import cli
    from demfi_torch.models import make_model
    from demfi_torch.ops import cfr_flow_t_align, kernels, warp
    from demfi_torch.train import create_train_state, make_train_step
    from demfi_torch.utils.grad_check import (GRAD_TOL, NUDGE, NUDGE_DRAWS,
                                              PLANTED_FAULTS, gradient_bounds,
                                              planted_fault, rel_frobenius)
    from demfi_torch.utils.profiling import calibrate_flow_head

    cfg = config_rb(5, 3, seed=SEED)
    check((cfg.nf, cfg.N_trn, cfg.batch_size, cfg.patch_size)
          == (64, 5, TRAIN_B, TRAIN_PS),
          "the train phase must run DeMFI-Net_rb(5,3)'s published setting")
    rng = np.random.RandomState(SEED + 5)
    batch = rng.uniform(-1, 1, (TRAIN_B, 9, TRAIN_PS, TRAIN_PS, 3)).astype(
        np.float32)
    t_np = np.array([[0.375], [0.625]], np.float32)
    frames = torch.from_numpy(batch).to(dev)
    t_dev = torch.from_numpy(t_np).to(dev)
    model = make_model(cfg, device=dev)
    inputs = frames[:, :4].permute(0, 1, 4, 2, 3).contiguous()
    raw_peak = calibrate_flow_head(model, inputs, FLOW_TARGET_PX)

    # ---- (a) the backward kernels against their plain vjps
    timer = DeviceTimer(torch)
    with torch.no_grad():
        ctx = model.extract(inputs)
        tt = t_dev.reshape(-1, 1, 1, 1)
        ft0, ft1 = cfr_flow_t_align(ctx.flow_01, ctx.flow_10, tt)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def cot(*shape):
        return torch.randn(shape, device=dev, generator=g)

    bwd_rows = []

    def bwd_row(kernel, name, per_step, fn, plain, library, pairs, nbytes,
                ops, note="", tols=None, per_step_bf16=0, routes=""):
        """One backward case: pairs() gives (kernel result, plain vjp
        result) tensors, ``tols`` their tolerances (BWD_RTOL each by
        default); fn() launches once; ``routes`` ends the printed line."""
        n0 = getattr(kernels, kernel).launches
        got_want = [(a.float(), b.float()) for a, b in pairs()]
        torch.cuda.synchronize()
        check(getattr(kernels, kernel).launches == n0 + 1,
              f"{name}: {getattr(kernels, kernel).launches - n0} launches, "
              f"expected 1")
        tols = tols or [BWD_RTOL] * len(got_want)
        errs = [float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                for a, b in got_want]
        finite = all(bool(torch.isfinite(a).all()) for a, _ in got_want)
        r = dict(kernel=kernel, case=name, per_step=per_step,
                 per_step_bf16=per_step_bf16, ms=timer.ms(fn, 10),
                 enqueue_us=enqueue_us(torch, fn, ENQUEUE_CALLS),
                 plain_ms=timer.ms(plain, 3),
                 library_ms=None if library is None else timer.ms(library, 10),
                 max_abs_err=max(float((a - b).abs().max())
                                 for a, b in got_want),
                 max_rel_err=max(errs), tol=max(tols), bytes=nbytes,
                 operations=ops)
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = ops / F32_FLOPS_PER_S * 1e3
        r.update(bound_ms=max(bound_b, bound_o),
                 bound_by="bytes" if bound_b >= bound_o else "operations")
        bwd_rows.append(r)
        lib = ("none (no single-call equivalent)" if library is None else
               f"{r['library_ms']:.4f} ms (aten.grid_sampler_2d_backward)")
        say(f"[7 train a] {name}: max err "
            f"{', '.join('%.3g' % e for e in errs)} of the largest value "
            f"(tol {', '.join('%.0e' % v for v in tols)}){note} | kernel "
            f"{r['ms']:.4f} ms "
            f"device, {r['enqueue_us']:.1f} us enqueue; plain vjp "
            f"{r['plain_ms']:.4f} ms; library {lib} | bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes / 1e9:.4f} "
            f"GB, {ops / 1e9:.4f} G operations; kernel at "
            f"{r['ms'] / r['bound_ms']:.2f}x){routes}")
        check(finite, f"{name}: non-finite kernel output")
        check(all(e <= v for e, v in zip(errs, tols)),
              f"{name}: kernel disagrees with its plain vjp ({errs} > {tols})")
        return got_want

    def grid_of(img, coords, relative):
        h, w = img.shape[2:]
        gx = coords[:, 0] + (torch.arange(w, device=dev)[None, None]
                             if relative else 0)
        gy = coords[:, 1] + (torch.arange(h, device=dev)[None, :, None]
                             if relative else 0)
        return torch.stack([gx * (2.0 / (w - 1)) - 1.0,
                            gy * (2.0 / (h - 1)) - 1.0], dim=-1)

    def gather_case(name, per_step, halves, relative, per_step_bf16=0):
        """halves: [(img, coords, grad_out)], one or two; one launch. A
        bfloat16 image's gradient is held to BWD_BF16_IMG_RTOL (it is
        rounded to bfloat16), the coordinates' to BWD_RTOL."""
        pair = len(halves) == 2
        nbytes = ops = 0
        library = []
        for img, co, go in halves:
            b, c, h, w = img.shape
            hq, wq = co.shape[2:]
            live, reached = gather_bwd_counts(torch, warp, co, relative, h, w)
            # read: grad_out at the unmasked pixels, the coordinates, the
            # image pixels their taps reach (at the image's element size);
            # written: grad_img in full (its zero fill, in the image's
            # dtype), grad_coords
            nbytes += (4 * (live * c + 2 * co.numel())
                       + img.element_size() * (reached * c + img.numel()))
            ops += live * (24 * c + 30)
            grid = grid_of(img, co, relative).to(img.dtype)
            masked = (go * (warp.bilinear_gather_plain(
                torch.ones_like(img[:, :1]), co, True)[1] >= 0.999)
                if relative else go).to(img.dtype)
            library.append(lambda m=masked, i=img, gr=grid:
                           torch.ops.aten.grid_sampler_2d_backward(
                               m, i, gr, 0, 0, True, [True, True]))
        if pair:
            (a, fa, ga), (a2, fb, gb) = halves

            def fn(stats=None):
                return kernels.bilinear_gather_pair_bwd(
                    a, a2, fa, fb, ga, gb, relative, route_stats=stats)

            def pairs():
                (gia, gib), (gca, gcb) = fn()
                pa = warp.bilinear_gather_plain_vjp(a, fa, relative, ga)
                pb = warp.bilinear_gather_plain_vjp(a2, fb, relative, gb)
                return [(gia, pa[0]), (gca, pa[1]), (gib, pb[0]),
                        (gcb, pb[1])]
        else:
            (a, fa, ga), = halves

            def fn(stats=None):
                return kernels.bilinear_gather_bwd(a, fa, relative, ga,
                                                   route_stats=stats)

            def pairs():
                gi, gc = fn()
                p = warp.bilinear_gather_plain_vjp(a, fa, relative, ga)
                return [(gi, p[0]), (gc, p[1])]
        bf16 = halves[0][0].dtype == torch.bfloat16
        # the kernel's 32x8 query tiles per route (box or global), counted
        # by the kernel in a launch of its own
        stats = torch.zeros(2, dtype=torch.int64, device=dev)
        fn(stats)
        box, spread = (int(v) for v in stats.cpu())
        blocks = len(halves) * halves[0][1].shape[0] * -(
            -halves[0][1].shape[2] // 8) * -(-halves[0][1].shape[3] // 32)
        check(box + spread == blocks, f"{name}: {box} + {spread} blocks "
                                      f"counted, the grid has {blocks}")
        bwd_row("bilinear_gather_bwd", name, per_step, fn,
                lambda: [warp.bilinear_gather_plain_vjp(i, co, relative, go)
                         for i, co, go in halves],
                lambda: [f() for f in library], pairs, nbytes, ops,
                "; one launch" if pair else "",
                [BWD_BF16_IMG_RTOL if bf16 else BWD_RTOL, BWD_RTOL]
                * len(halves), per_step_bf16,
                f" | {100 * box / blocks:.1f} % of {blocks} blocks on the box "
                f"route, {100 * spread / blocks:.1f} % global")
        bwd_rows[-1].update(image_dtype="bfloat16" if bf16 else "float32",
                            box_route_share=box / blocks)

    nb, nf, ps = TRAIN_B, cfg.nf, TRAIN_PS
    gather_case(f"gather bwd pair rel C={nf} 2x{nb} {ps}x{ps}", 2,
                [(ctx.f0.contiguous(), ft0, cot(nb, nf, ps, ps)),
                 (ctx.f1.contiguous(), ft1, cot(nb, nf, ps, ps))], True)
    # FGAC's sample stays float32 in the bfloat16 model
    gather_case(f"gather bwd abs C={nf} B={nb} (FGAC)", 2,
                [(ctx.f0.contiguous(), ctx.flow_01.contiguous(),
                  cot(nb, nf, ps, ps))], False, per_step_bf16=2)
    gather_case(f"gather bwd pair rel C=3 2x{nb}", cfg.N_trn,
                [(inputs[:, 0].contiguous(), ft0, cot(nb, 3, ps, ps)),
                 (inputs[:, 1].contiguous(), ft1, cot(nb, 3, ps, ps))], True)
    # the bfloat16 model's pairs: bfloat16 images, float32 cotangents
    gather_case(f"gather bwd pair rel C={nf} 2x{nb} {ps}x{ps} bf16", 0,
                [(ctx.f0.bfloat16(), ft0, cot(nb, nf, ps, ps)),
                 (ctx.f1.bfloat16(), ft1, cot(nb, nf, ps, ps))], True,
                per_step_bf16=2)
    gather_case(f"gather bwd pair rel C=3 2x{nb} bf16", 0,
                [(inputs[:, 0].bfloat16(), ft0, cot(nb, 3, ps, ps)),
                 (inputs[:, 1].bfloat16(), ft1, cot(nb, 3, ps, ps))], True,
                per_step_bf16=cfg.N_trn)
    # the bfloat16 instantiation in absolute mode: not on the bfloat16
    # path (FGAC samples float32 there), held to its plain vjp all the same
    gather_case(f"gather bwd abs C={nf} B={nb} (FGAC) bf16", 0,
                [(ctx.f0.bfloat16(), ctx.flow_01.contiguous(),
                  cot(nb, nf, ps, ps))], False)

    img = ctx.flow_01.contiguous()
    flo_smooth = (tt * ctx.flow_01).contiguous()
    noise = np.random.RandomState(SEED + 6).uniform(
        -FLOW_TARGET_PX, FLOW_TARGET_PX, tuple(flo_smooth.shape))
    flo_noise = torch.from_numpy(noise.astype(np.float32)).to(dev)
    bad = flo_smooth.cpu().numpy().copy()
    where = np.random.RandomState(SEED + 7).rand(*bad.shape) < NONFINITE_SHARE
    bad[where] = np.resize(np.array(NONFINITE_VALUES, np.float32),
                           int(where.sum()))
    flo_bad = torch.from_numpy(bad).to(dev)
    with np.errstate(invalid="ignore"):
        dropped = (~(np.isfinite(bad) & (np.abs(bad) < 1e8))).any(
            1, keepdims=True)
    bad = np.where(dropped, np.float32(1e9), bad).astype(np.float32)
    flo_bad_dropped = torch.from_numpy(bad).to(dev)
    gout = cot(*img.shape)
    gnorm = cot(img.shape[0], 1, *img.shape[2:])
    repeats = {}
    for name, flo, want_flo, per_step in (
            ("smooth", flo_smooth, flo_smooth, 2),
            ("noise", flo_noise, flo_noise, 0),
            ("non-finite", flo_bad, flo_bad_dropped, 0)):
        def fn(flo=flo):
            return kernels.fwarp_splat_bwd(img, flo, gout, gnorm)

        def pairs(flo=flo, want_flo=want_flo):
            return list(zip(fn(), warp.fwarp_splat_plain_vjp(
                img, want_flo, gout, gnorm)))
        b, c, h, w = img.shape
        reached = splat_targets(torch, flo)
        live = int(torch.isfinite(flo).all(1).sum())
        # read: img, flo, grad_out and grad_norm at the targets; written:
        # grad_img, grad_flo
        nbytes = 4 * (img.numel() + flo.numel() + reached * (c + 1)
                      + img.numel() + flo.numel())
        ops = 4 * live * (4 * c + 10)
        got_want = bwd_row(
            "fwarp_splat_bwd", f"splat bwd C=2 B={b} {name}", per_step, fn,
            lambda f=want_flo: warp.fwarp_splat_plain_vjp(img, f, gout, gnorm),
            None, pairs, nbytes, ops,
            "; dropped pixels zero" if name == "non-finite" else "")
        again = fn()
        repeats[name] = all(torch.equal(a, g) for (a, _), g in
                            zip(got_want, again))
        check(repeats[name], f"splat bwd {name}: two runs differ")
        bwd_rows[-1]["two_runs_bitwise_equal"] = repeats[name]
    say(f"[7 train a] splat bwd: two runs bitwise equal on every input: "
        f"{all(repeats.values())}")
    del ctx, ft0, ft1, flo_noise, flo_bad, flo_bad_dropped, timer
    torch.cuda.empty_cache()

    # ---- (b) one full-width train step, card against CPU, 64x64, at
    # float32 and at bfloat16 (b')
    small = np.random.RandomState(SEED + 8).uniform(
        -1, 1, (TRAIN_B, 9, TRAIN_SMALL, TRAIN_SMALL, 3)).astype(np.float32)
    with torch.enable_grad():
        gmodel = make_model(cfg, device=dev)
        calibrate_flow_head(gmodel, torch.from_numpy(small[:, :4]).to(dev)
                            .permute(0, 1, 4, 2, 3).contiguous(),
                            FLOW_TARGET_PX)
        weights = {k: v.cpu() for k, v in gmodel.state_dict().items()}
    del gmodel

    def step_check(scfg, tag, must_catch, loss_rtol):
        """One train step of ``scfg`` on the card against the port on the
        CPU: the loss, every gradient against its gradient_bounds bound,
        and the planted faults (``must_catch`` of them must fail the
        check; the others are reported)."""
        def grads_of(device, batch):
            """(loss, {name: gradient or None}, the flows [N+1,B,4,H,W])
            of one train step."""
            m = make_model(scfg, device=device)
            m.load_state_dict(weights, strict=True)
            state = create_train_state(scfg, m)
            got, flows = {}, []
            m.register_forward_hook(lambda _m, _in, out: flows.append(
                out.flow_preds.detach().cpu()))

            def snap(phase):
                if phase == "backward":
                    got.update({k: None if p.grad is None
                                else p.grad.detach().cpu().clone()
                                for k, p in m.named_parameters()})
            metrics = make_train_step(scfg)(state, batch, t_np, on_phase=snap)
            return float(metrics["total_loss"]), got, flows[0]
        with torch.enable_grad():
            loss_g, grads_g, flows_g = grads_of(dev, small)
            rerun = grads_of(dev, small)[1]
            loss_c, grads_c, flows_c = grads_of("cpu", small)
            try:
                bound, moves, gap = gradient_bounds(
                    lambda delta: grads_of("cpu", small + delta)[1:], grads_c,
                    flows_c, flows_g, {k: rel_frobenius(rerun[k], g)
                                       for k, g in grads_g.items()
                                       if g is not None},
                    (np.random.RandomState(s).randn(*small.shape).astype(
                        np.float32) for s in range(SEED + 9,
                                                   SEED + 9 + NUDGE_DRAWS)))
            except RuntimeError as e:
                fail(f"{tag}: {e}")
            faulty = {}
            for kind in PLANTED_FAULTS:    # the check must catch each
                with planted_fault(kind):
                    faulty[kind] = grads_of(dev, small)[1]
        check(all(g is None or g.dtype == torch.float32
                  for g in grads_g.values()),
              f"{tag}: a gradient that is not float32")
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        say(f"[{tag}] one train step at {TRAIN_SMALL}x{TRAIN_SMALL} "
            f"B={TRAIN_B}, full width, {scfg.compute_dtype}: loss card "
            f"{loss_g:.7f} cpu {loss_c:.7f} (rel {loss_rel:.2e}, tol "
            f"{loss_rtol:.0e})")
        check(loss_rel <= loss_rtol, f"{tag} train step loss: card "
                                     f"{loss_g} cpu {loss_c}")
        check(all((grads_g[k] is None) == (grads_c[k] is None)
                  for k in grads_c),
              f"{tag}: card and CPU differ in which parameters have a "
              f"gradient")
        say(f"[{tag}] flows, relative Frobenius: card against CPU "
            f"{gap:.3g}; the CPU under the {len(moves)} counted {NUDGE:.0e} "
            f"nudges of the batch {', '.join('%.3g' % v for v in moves)} "
            f"({max(moves) / gap:.2f}x the card's)")
        worst = (0.0, "", 0.0, 0.0)
        for k, b in bound.items():
            err = rel_frobenius(grads_g[k], grads_c[k])
            check(err <= b, f"{tag} train step gradient {k}: card against "
                            f"CPU {err:.3g} > {b:.3g}")
            worst = max(worst, (err / b, k, err, b))
        over = sum(1 for k in bound
                   if rel_frobenius(grads_g[k], grads_c[k]) > GRAD_TOL)
        say(f"[{tag}] {len(bound)} parameter gradients, card against CPU "
            f"(relative Frobenius error; bound per tensor the larger of "
            f"{GRAD_TOL:.0e} and twice the larger of the CPU's change under "
            f"the nudges and the card's between two runs): worst {worst[1]} "
            f"{worst[2]:.3g} (bound {worst[3]:.3g}, {worst[0]:.2f} of it); "
            f"{over} tensors above {GRAD_TOL:.0e}; largest bound "
            f"{max(bound.values()):.3g}")
        caught = {}
        for kind, got in faulty.items():
            ratios = [rel_frobenius(torch.zeros_like(grads_c[k])
                                    if got[k] is None else got[k],
                                    grads_c[k]) / bound[k]
                      for k in bound]
            caught[kind] = (sum(r > 1 for r in ratios), max(ratios))
            if kind in must_catch:
                check(caught[kind][0] > 0, f"{tag}: a planted fault ({kind}) "
                                           f"passes the gradient check")
        say(f"[{tag}] planted faults, one group of warps passing no "
            f"gradient on: tensors beyond their bounds (largest ratio) "
            + ", ".join(f"{k} {n} ({r:.1f}x)" for k, (n, r) in caught.items())
            + f"; required to fail: {', '.join(must_catch)}")
        return dict(loss_card_cpu=[loss_g, loss_c],
                    worst_grad=dict(name=worst[1], err=worst[2],
                                    bound=worst[3]),
                    largest_bound=max(bound.values()),
                    flow_gap_nudges=[gap] + moves, planted_faults=caught)
    checked = step_check(cfg, "7 train b", PLANTED_FAULTS, STEP_LOSS_RTOL)
    # at bfloat16 the step's rounding is chaotic: the bounds widen, and
    # the fault of every warp must still fail the check
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    checked16 = step_check(cfg16, "7 train b'", ("every_warp",),
                           BF16_LOSS_RTOL)

    # ---- (c) 8 steps on one fixed full-width batch, at float32 and at
    # bfloat16 (c'), from the same weights; then cudnn.benchmark on
    weights0 = {k: v.clone() for k, v in model.state_dict().items()}

    def fixed_steps(scfg, tag, m):
        with torch.enable_grad():
            state = create_train_state(scfg, m)
            step = make_train_step(scfg)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            losses, secs, split = [], [], []
            for _ in range(OVERFIT_STEPS):
                ev = {k: torch.cuda.Event(enable_timing=True)
                      for k in ("start", "forward", "backward", "optimizer")}
                t0 = time.perf_counter()
                ev["start"].record()
                m_ = step(state, frames, t_dev,
                          on_phase=lambda phase: ev[phase].record())
                losses.append(float(m_["total_loss"]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                split.append([ev["start"].elapsed_time(ev["forward"]),
                              ev["forward"].elapsed_time(ev["backward"]),
                              ev["backward"].elapsed_time(ev["optimizer"])])
            counts = kernels.launch_counts()
            bf16_counts = kernels.bf16_launch_counts()
            peak = torch.cuda.max_memory_allocated()
            if profile:
                say(device_breakdown(torch, lambda: step(state, frames, t_dev),
                                     f"[{tag} profile] one train step, "
                                     f"{scfg.compute_dtype}")[0])
            bench = benchmark_ab(torch, lambda: step(state, frames, t_dev))
        want = {k: v * OVERFIT_STEPS for k, v in TRAIN_LAUNCHES.items()}
        check(counts == want, f"{tag}: train launches {counts} != {want} over "
                              f"{OVERFIT_STEPS} steps")
        want16 = ({k: v * OVERFIT_STEPS for k, v in TRAIN_BF16_LAUNCHES.items()}
                  if scfg.compute_dtype == "bfloat16"
                  else dict.fromkeys(TRAIN_BF16_LAUNCHES, 0))
        check(bf16_counts == want16, f"{tag}: bfloat16 launches {bf16_counts} "
                                     f"!= {want16}")
        check(all(np.isfinite(losses)), f"{tag}: train losses {losses}")
        check(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")
        check(all(p.dtype == torch.float32 for p in m.parameters())
              and all(p.grad is None or p.grad.dtype == torch.float32
                      for p in m.parameters())
              and all(v.dtype == torch.float32
                      for st in state.optimizer.state.values()
                      for v in st.values()
                      if torch.is_tensor(v) and v.is_floating_point()),
              f"{tag}: parameters, gradients or Adam's state not float32")
        s_step = float(np.median(secs[OVERFIT_WARMUP:]))
        split_ms = np.median(np.array(split[OVERFIT_WARMUP:]), axis=0)
        say(f"[{tag}] {OVERFIT_STEPS} steps of DeMFI-Net_rb(5,3) at "
            f"{TRAIN_B}x{TRAIN_PS}x{TRAIN_PS}, {scfg.compute_dtype}, one fixed "
            f"batch, flow head {raw_peak:.2f} -> {FLOW_TARGET_PX} px: losses "
            f"{['%.5f' % v for v in losses]}; seconds per step "
            f"{['%.4f' % v for v in secs]}, median after {OVERFIT_WARMUP} "
            f"warm-up {s_step:.4f} s = {TRAIN_B / s_step:.3f} samples/s; "
            f"device ms per step (CUDA events, median): forward "
            f"{split_ms[0]:.2f}, backward {split_ms[1]:.2f}, optimizer "
            f"{split_ms[2]:.2f}; peak allocated {peak / 2 ** 30:.3f} GiB "
            f"({(peak - base) / 2 ** 30:.3f} above the weights); launches per "
            f"step { {k: v / OVERFIT_STEPS for k, v in counts.items()} }, of "
            f"them bfloat16 "
            f"{ {k: v / OVERFIT_STEPS for k, v in bf16_counts.items()} }; "
            f"parameters, gradients and Adam's state float32")
        say(f"[{tag}] cudnn.benchmark " + benchmark_text(bench, "step"))
        return dict(counts=counts, bf16_counts=bf16_counts,
                    seconds_per_step=s_step, step_seconds=secs,
                    losses=losses, samples_per_s=TRAIN_B / s_step,
                    device_ms_forward_backward_optimizer=split_ms.tolist(),
                    peak_bytes=peak, cudnn_benchmark_step_seconds=bench)
    fixed = fixed_steps(cfg, "7 train c", model)
    train_counts = fixed["counts"]
    del model
    model16 = make_model(cfg16, device=dev)
    model16.load_state_dict(weights0, strict=True)
    fixed16 = fixed_steps(cfg16, "7 train c'", model16)
    del model16, frames, inputs
    torch.cuda.empty_cache()

    # ---- (d) the CLI: train two epochs, resume a third, load it for test
    t0 = time.perf_counter()
    train_root = tmp / "train_data"
    ids = [17 + 8 * k for k in range(CLI_BLUR_FRAMES)]
    n_sharp = ids[1] + 2 * (ids[1] - ids[0])       # s2 of the only window
    for sc in range(CLI_TRAIN_SCENES):
        sharp_dir = train_root / "train" / f"scene{sc}"
        blur_dir = train_root / "train_blur" / f"scene{sc}"
        sharp_dir.mkdir(parents=True)
        blur_dir.mkdir(parents=True)
        for i in range(n_sharp):
            imageio.imwrite(str(sharp_dir / f"{i:05d}.png"), rng.randint(
                0, 256, (TRAIN_PS, TRAIN_PS, 3)).astype(np.uint8))
        for i in ids:
            imageio.imwrite(str(blur_dir / f"{i:05d}.png"), rng.randint(
                0, 256, (TRAIN_PS, TRAIN_PS, 3)).astype(np.uint8))
    write_s = time.perf_counter() - t0
    argv = ["--phase", "train", "--train_data_path", str(train_root),
            "--test_data_path", str(data_root), "--multiple_MFI", "2",
            "--batch_size", str(TRAIN_B), "--patch_size", str(TRAIN_PS),
            "--checkpoint_dir", str(tmp / "train_ckpt"),
            "--text_dir", str(tmp / "train_txt"),
            "--log_dir", str(tmp / "train_log"),
            "--test_img_dir", str(tmp / "train_img"), "--num_thrds", "4",
            "--freq_display", "2", "--epoch_freq_save", "1",
            "--seed", str(SEED + 10), "--device", str(dev)]
    runs = []
    for extra in (["--epochs", "2"], ["--epochs", "3", "--auto_resume"]):
        t0 = time.perf_counter()
        out = io.StringIO()
        with torch.enable_grad(), contextlib.redirect_stdout(out):
            res = cli(argv + extra)
        wall = time.perf_counter() - t0
        ck = tmp / "train_ckpt" / "DeMFInet_exp1"
        _, opt, meta = load_training_checkpoint(
            str(ck / "DeMFInet_exp1_latest.pt"))
        runs.append(dict(res=res, wall=wall, text=out.getvalue(),
                         steps=int(opt["state"][0]["step"]),
                         last_epoch=meta["last_epoch"]))
    first, second = runs
    files = sorted(os.listdir(tmp / "train_ckpt" / "DeMFInet_exp1"))
    want_files = sorted(f"DeMFInet_exp1_{tag}.pt" for tag in
                        ("latest", "best_PSNR", "epc0", "epc1", "epc2"))
    per_epoch = CLI_TRAIN_SCENES // TRAIN_B
    check(first["res"]["start_epoch"] == 0
          and len(first["res"]["epoch_losses"]) == 2,
          f"train run: {first['res']}")
    check(all(np.isfinite(r["res"]["epoch_losses"]).all() for r in runs),
          "train run: a loss is not finite")
    check(first["steps"] == 2 * per_epoch and first["last_epoch"] == 1,
          f"train run: {first['steps']} Adam steps, last epoch "
          f"{first['last_epoch']}")
    check(second["res"]["start_epoch"] == 2
          and second["steps"] == 3 * per_epoch and second["last_epoch"] == 2,
          f"resumed run: start {second['res']['start_epoch']}, "
          f"{second['steps']} Adam steps")
    check("Start epoch 0" not in second["text"], "the resumed run re-ran epoch 0")
    check(files == want_files, f"checkpoints {files}, expected {want_files}")
    sheets = os.listdir(tmp / "train_img" / "DeMFInet_exp1" / "while_training")
    check("trainIdx_00000_Bx20.png" in sheets, f"debug sheets: {sheets}")
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        test_res = cli(["--phase", "test", "--multiple_MFI", "2",
                        "--device", str(dev),
                        "--test_data_path", str(data_root),
                        "--checkpoint_dir", str(tmp / "train_ckpt"),
                        "--test_img_dir", str(tmp / "train_img_test")])
    test_wall = time.perf_counter() - t0
    check(test_res is not None and bool(np.isfinite(test_res[:5]).all())
          and "epoch: 2" in out.getvalue(),
          f"--phase test on the trained checkpoint: {test_res}")
    # one epoch at bfloat16; its checkpoint loads into a float32 model
    t0 = time.perf_counter()
    ck16 = tmp / "train_ckpt_bf16"
    with torch.enable_grad(), contextlib.redirect_stdout(io.StringIO()):
        res16 = cli([a if a != str(tmp / "train_ckpt") else str(ck16)
                     for a in argv]
                    + ["--epochs", "1", "--compute_dtype", "bfloat16"])
    wall16 = time.perf_counter() - t0
    sd16, _, _ = load_training_checkpoint(
        str(ck16 / "DeMFInet_exp1" / "DeMFInet_exp1_latest.pt"))
    check(bool(np.isfinite(res16["epoch_losses"]).all())
          and bool(np.isfinite(res16["final"][:5]).all()),
          f"bfloat16 train run: {res16}")
    check(all(v.dtype == torch.float32 for v in sd16.values()),
          "the bfloat16 train run saved parameters that are not float32")
    make_model(cfg, device="cpu").load_state_dict(sd16, strict=True)
    say(f"[7 train d] cli --phase train at {TRAIN_B}x{TRAIN_PS}x{TRAIN_PS} on "
        f"{CLI_TRAIN_SCENES} scenes (written in {write_s:.2f} s): epochs 0-1 in "
        f"{first['wall']:.2f} s, losses "
        f"{['%.5f' % v for v in first['res']['epoch_losses']]}, step seconds "
        f"{['%.4f' % v for v in first['res']['step_seconds']]}; --auto_resume "
        f"from epoch {second['res']['start_epoch']} with {first['steps']} Adam "
        f"steps carried ({second['steps']} after it) in {second['wall']:.2f} s;"
        f" {len(files)} checkpoints; --phase test x2 on the trained latest "
        f"(strict load) in {test_wall:.2f} s: intp PSNR {test_res[1]:.4f}, "
        f"deblur PSNR {test_res[3]:.4f}; --compute_dtype bfloat16, one epoch "
        f"in {wall16:.2f} s, losses "
        f"{['%.5f' % v for v in res16['epoch_losses']]}, its float32 "
        f"checkpoint loaded strictly into a float32 model")
    return dict(bwd_rows=bwd_rows, counts=train_counts,
                bf16_counts=fixed16["bf16_counts"],
                float32={**{k: v for k, v in fixed.items()
                            if k not in ("counts", "bf16_counts")}, **checked},
                bfloat16={**{k: v for k, v in fixed16.items()
                             if k not in ("counts",)}, **checked16},
                cli_wall=[first["wall"], second["wall"], test_wall, wall16])


def gather_bwd_timings(torch, dev, kernels, warp) -> list:
    """Phase 3c (``--kernels-of`` only): the gather's backward at the
    train step's three sites on synthetic inputs (gather_bwd_sites), so
    that two checkouts compare in one run: per site the device ms of the
    wrapper call (its zero fill included), the share of blocks per route
    ("not counted" by a checkout without route_stats) and the largest
    error against the plain vjp. Returns the rows."""
    has_routes = "route_stats" in inspect.signature(
        kernels.bilinear_gather_bwd).parameters
    timer = DeviceTimer(torch)
    out = []
    for site, (halves, relative) in gather_bwd_sites(torch, dev).items():
        def fn(**stats):
            if len(halves) == 1:
                (i, co, go), = halves
                return kernels.bilinear_gather_bwd(i, co, relative, go,
                                                   **stats)
            (a, fa, ga), (b, fb, gb) = halves
            return kernels.bilinear_gather_pair_bwd(a, b, fa, fb, ga, gb,
                                                    relative, **stats)
        got = fn()
        # grad_img first (one or two halves), then grad_coords
        got = ([got[0], got[1]] if len(halves) == 1 else
               [got[0][0], got[0][1], got[1][0], got[1][1]])
        want = [t for i, co, go in halves
                for t in warp.bilinear_gather_plain_vjp(i, co, relative, go)]
        want = want if len(halves) == 1 else [want[0], want[2], want[1],
                                              want[3]]
        bf16 = halves[0][0].dtype == torch.bfloat16
        errs = [float((a.float() - b.float()).abs().max())
                / max(1.0, float(b.float().abs().max()))
                for a, b in zip(got, want)]
        tols = ([BWD_BF16_IMG_RTOL if bf16 else BWD_RTOL] * len(halves)
                + [BWD_RTOL] * len(halves))
        share = None
        if has_routes:
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            fn(route_stats=stats)
            box, spread = (int(v) for v in stats.cpu())
            share = box / (box + spread)
        r = dict(site=site, ms=timer.ms(fn, 10), box_route_share=share,
                 max_rel_err=max(errs))
        out.append(r)
        say(f"[3c gather bwd] {site}: kernel {r['ms']:.4f} ms device (zero "
            f"fill included) | max err {max(errs):.3g} of the largest value "
            f"(tol {max(tols):.0e}) | "
            + ("routes not counted" if share is None else
               f"{100 * share:.1f} % of blocks on the box route, "
               f"{100 * (1 - share):.1f} % global"))
        check(all(e <= t for e, t in zip(errs, tols)),
              f"{site}: kernel disagrees with its plain vjp ({errs})")
    del timer
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--kernels-of", metavar="DIR", default="",
                    help="run phases 1-3c on the checkout of the port at "
                         "DIR and stop ('.' for this one; an earlier "
                         "commit's, to time both in one run: what that "
                         "checkout's kernels lack, the pair entry, the "
                         "stencil's row count and largest window and the "
                         "gather backward's route counts, is then not "
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
    # set here, not through demfi_torch.disable_tf32: --kernels-of may
    # load an earlier checkout that lacks it
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
        relative mode apart), on a grid made outside the timed call, in
        the image's dtype (grid_sample takes one dtype)."""
        h, w = img.shape[2:]
        gx = coords[:, 0] + (torch.arange(w, device=dev)[None, None]
                             if relative else 0)
        gy = coords[:, 1] + (torch.arange(h, device=dev)[None, :, None]
                             if relative else 0)
        grid = torch.stack([gx * (2.0 / (w - 1)) - 1.0,
                            gy * (2.0 / (h - 1)) - 1.0], dim=-1).to(img.dtype)
        return lambda: F.grid_sample(img, grid, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)

    def gather_bytes(img, coords, relative, ones_plane):
        """What the call must move: the image pixels its taps reach (at
        the image's element size), the coordinates, the output and, where
        asked for, the ones plane (float32)."""
        b, c, h, w = img.shape
        hq, wq = coords.shape[2:]
        return (img.element_size()
                * gather_image_pixels(torch, coords, relative, h, w) * c
                + 4 * (coords.numel() + b * c * hq * wq
                       + (b * hq * wq if ones_plane else 0)))

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
                   fn, pairs, note="", per_window_bf16=0):
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
                 per_window_bf16=per_window_bf16,
                 image_dtype=str(imgs[0].dtype).replace("torch.", ""),
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

    def single(name, per_window, img, coords, relative, per_window_bf16=0):
        def pairs():
            got = kernels.bilinear_gather(img, coords, relative)
            want = warp.bilinear_gather_plain(img, coords, relative)
            return [(g, p) for g, p in zip(got, want) if g is not None]
        gather_row(name, per_window, relative, relative, [img], [coords],
                   lambda: kernels.bilinear_gather(img, coords, relative),
                   pairs, per_window_bf16=per_window_bf16)

    def no_ones(name, img, coords):
        """bwarp: the relative gather without the in-image weight plane."""
        def pairs():
            return [(warp.bwarp(img, coords),
                     warp.bilinear_gather_plain(img, coords, True)[0])]
        gather_row(name, 0, True, False, [img], [coords],
                   lambda: warp.bwarp(img, coords), pairs)

    def pair(name, per_window, a, b, fa, fb, per_window_bf16=0):
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
                   note="; one launch", per_window_bf16=per_window_bf16)
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
    # FGAC's sample is float32 in the bfloat16 model too
    single("gather abs C=64 B=1", 2, ctx.f0.contiguous(),
           ctx.flow_01.contiguous(), False, per_window_bf16=2)
    # the bfloat16 model's pairs: the same calls on bfloat16 values (its
    # features and decoder outputs), read at 2 B; float32 out
    # an earlier checkout under --kernels-of may take float32 only
    has_bf16 = hasattr(kernels, "GATHER_IMAGE_DTYPES")
    if has_bf16:
        pair("gather pair rel C=64 2x7 bf16", 0, n_f0.bfloat16(),
             n_f1.bfloat16(), ft0, ft1, per_window_bf16=2)
        pair("gather pair rel C=3 2x7 bf16", 0, n_b0.bfloat16(),
             n_b1.bfloat16(), ft0, ft1, per_window_bf16=3)
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

    def corners_in_image(flo):
        r = torch.floor(flo[:, 1]) + torch.arange(H, device=dev)[None, :, None]
        c = torch.floor(flo[:, 0]) + torch.arange(W, device=dev)[None, None]
        return sum(int(((r + dr >= 0) & (r + dr < H) & (c + dc >= 0)
                        & (c + dc < W)).sum())
                   for dr in (0, 1) for dc in (0, 1))

    # the atomic splat; C = 2 (CFR warps the flows), on three inputs: the
    # main path's smooth flows; i.i.d. uniform noise of the same peak
    # (FLOW_TARGET_PX), whose source tiles' targets spread too far for the
    # kernel's shared box: the worst case for its tile design; and the
    # smooth flows with NaN, infinite and huge entries, which the kernel
    # drops, held against the plain version on the flows with those
    # entries set to 1e9 (which drops them there too)
    has_routes = "route_stats" in inspect.signature(
        kernels.fwarp_splat).parameters
    img = flow_01
    b, c = img.shape[:2]
    tile_y, tile_x = SPLAT_TILE
    splat_blocks = b * -(-H // tile_y) * -(-W // tile_x)
    flo_smooth = (t * flow_01).contiguous()
    noise = np.random.RandomState(SEED + 3).uniform(
        -FLOW_TARGET_PX, FLOW_TARGET_PX, tuple(flo_smooth.shape))
    flo_noise = torch.from_numpy(noise.astype(np.float32)).to(dev)
    bad = flo_smooth.cpu().numpy()
    where = np.random.RandomState(SEED + 4).rand(*bad.shape) < NONFINITE_SHARE
    bad[where] = np.resize(np.array(NONFINITE_VALUES, np.float32),
                           int(where.sum()))
    flo_bad = torch.from_numpy(bad).to(dev)
    bad[where] = 1e9
    flo_bad_dropped = torch.from_numpy(bad).to(dev)

    # why a tile design can work: how far floor(flo) spreads inside each
    # source tile of the kernel (the larger of its two components' max -
    # min), as a share of tiles per spread
    fl = torch.floor(flo_smooth).reshape(b, 2, H // tile_y, tile_y,
                                         W // tile_x, tile_x)
    spread = (fl.amax(dim=(3, 5)) - fl.amin(dim=(3, 5))).amax(dim=1).long()
    spread_counts = torch.bincount(spread.flatten()).cpu().tolist()
    n_tiles = spread.numel()
    tile_spread = {}
    for lo, hi in SPREAD_BINS:
        n = sum(spread_counts[lo:hi + 1])
        tile_spread[f"{lo}" if lo == hi else f"{lo}-{hi}"] = n / n_tiles
    say(f"[3 kernels] splat: spread of floor(flo) inside each {tile_y}x"
        f"{tile_x} source tile of the smooth CFR flows (max - min, the larger "
        f"of the two components), share of {n_tiles} tiles: " + ", ".join(
            f"{k} px {100 * v:.1f} %" for k, v in tile_spread.items()))

    def splat_case(name, flo, want_flo, per_window):
        got = kernels.fwarp_splat(img, flo)
        want = warp.fwarp_splat_plain(img, want_flo)
        torch.cuda.synchronize()
        scale = max(float(p.abs().max()) for p in want)
        err = max(float((g - p).abs().max()) for g, p in zip(got, want))
        tol = SPLAT_RTOL * max(1.0, scale)
        shared_share = None
        if has_routes:
            stats = torch.zeros(2, dtype=torch.int64, device=dev)
            kernels.fwarp_splat(img, flo, route_stats=stats)
            shared_blocks, global_blocks = (int(v) for v in stats.cpu())
            check(shared_blocks + global_blocks == splat_blocks,
                  f"{name}: {shared_blocks} + {global_blocks} blocks counted, "
                  f"the grid has {splat_blocks}")
            shared_share = shared_blocks / splat_blocks
        nbytes = 4 * (img.numel() + flo.numel() + img.numel() + b * H * W)
        # per corner inside the image the weight and the C+1 multiply-adds
        flops = corners_in_image(flo) * (2 * (c + 1) + 12)
        r = timed(lambda: kernels.fwarp_splat(img, flo),
                  lambda: warp.fwarp_splat_plain(img, want_flo), None, 3)
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = flops / F32_FLOPS_PER_S * 1e3
        r.update(case=name, kernel="fwarp_splat", per_window=per_window,
                 max_abs_err=err, tol=tol, bytes=nbytes, operations=flops,
                 shared_route_share=shared_share,
                 bound_ms=max(bound_b, bound_o),
                 bound_by="bytes" if bound_b >= bound_o else "operations")
        rows.append(r)
        routes = ("not counted" if shared_share is None else
                  f"{100 * shared_share:.1f} % of {splat_blocks} blocks on "
                  f"the shared route, {100 * (1 - shared_share):.1f} % global")
        say(f"[3 kernels] {name}: max_abs_err {err:.3g} (tol {tol:.3g}) | "
            f"{times_text(r, '')} | bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']} ({nbytes / 1e9:.4f} GB, {flops / 1e9:.4f} G "
            f"operations; kernel at {r['ms'] / r['bound_ms']:.2f}x) | "
            f"{routes}")
        check(all(bool(torch.isfinite(g).all()) for g in got),
              f"{name}: non-finite kernel output")
        check(err <= tol, f"{name}: kernel disagrees with its plain version "
                          f"({err} > {tol})")

    splat_case("splat C=2 B=7", flo_smooth, flo_smooth, 2)
    splat_case("splat C=2 B=7 noise", flo_noise, flo_noise, 0)
    splat_case("splat C=2 B=7 non-finite", flo_bad, flo_bad_dropped, 0)
    del flo_smooth, flo_noise, flo_bad, flo_bad_dropped, fl, spread

    # the stencil forward warp: D = 8 on the flows scaled into its
    # window, D = 32 on the 24 px flows; C = 2 (CFR warps the flows)
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
                        "splat_tile_spread": tile_spread,
                        "gather_bwd_sites": gather_bwd_timings(
                            torch, dev, kernels, warp),
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
                   "fwarp_shift": 0, "bilinear_gather_bwd": 0,
                   "fwarp_splat_bwd": 0}
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

    text, busy = device_breakdown(
        torch, lambda: engine.forward_windows(frames, ts),
        "[4 profile] one window")
    if args.profile:
        say(text)

    # ------------------------------------ 4b. main path at bfloat16
    from demfi_torch.metrics import bf16_serving_label, denorm255, psnr
    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model16 = make_model(cfg16, device=dev)
    model16.load_state_dict(model.state_dict(), strict=True)   # same weights
    engine16 = InferenceEngine(model16, num_update=cfg.N_tst)
    engine16.forward_windows(frames, ts)                     # warm-up
    torch.cuda.synchronize()
    base16 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    kernels.fwarp_served(dev, reset=True)
    secs16 = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        res16 = engine16.forward_windows(frames, ts)
        torch.cuda.synchronize()
        secs16.append(time.perf_counter() - t0)
    counts16 = kernels.launch_counts()
    bf16_counts = kernels.bf16_launch_counts()
    served16 = kernels.fwarp_served(dev)
    peak16 = torch.cuda.max_memory_allocated()
    per_pi16 = (peak16 - base16) / (H * W * (M - 1))
    for f in dataclasses.fields(WindowResult):
        arr = getattr(res16[0], f.name)
        check(arr.shape == (M - 1, H, W, _field_channels(f.name))
              and arr.dtype == np.float32,
              f"bfloat16 {f.name}: {arr.shape} {arr.dtype} on the host")
        check(bool(np.isfinite(arr).all()), f"bfloat16 {f.name}: non-finite")
    check(counts16 == want_counts,
          f"bfloat16 launch counts {counts16} != {want_counts}")
    check(bf16_counts == {"bilinear_gather": BF16_GATHERS_PER_WINDOW * REPEATS,
                          "bilinear_gather_bwd": 0},
          f"bfloat16 instantiation launches {bf16_counts}")
    check(served16 == served, f"bfloat16 forward warps served by {served16}")
    # the served frames: 7 interpolated, the 2 deblurred centre frames
    def served_frames(r):
        return denorm255(np.concatenate([r.st_final, r.s0_final[:1],
                                         r.s1_final[:1]]))
    psnr16 = psnr(served_frames(res16[0]), served_frames(res[0]))
    shift16, certified16, label16 = bf16_serving_label(psnr16)
    text16, busy16 = device_breakdown(
        torch, lambda: engine16.forward_windows(frames, ts),
        "[4b profile] one window, bfloat16")
    if args.profile:
        say(text16)
    s_win16 = sum(secs16) / REPEATS
    say(f"[4b main path] x8 DeMFI-Net_rb(5,3) {H}x{W} bfloat16 (same weights), "
        f"{REPEATS} windows: seconds {['%.4f' % v for v in secs16]} (min "
        f"{min(secs16):.4f}, max {max(secs16):.4f}); {1 / s_win16:.4f} "
        f"windows/s = {(M - 1) / s_win16:.4f} interpolated frames/s "
        f"(float32 {1 / s_win:.4f} windows/s); device busy "
        f"{100 * busy16:.1f} % of one profiled window (float32 "
        f"{100 * busy:.1f} %); peak allocated {peak16 / 2 ** 30:.3f} GiB "
        f"({per_pi16:.0f} B per pixel-instant above the weights, float32 "
        f"{per_pi:.0f}); launches {counts16}, of them the bfloat16 "
        f"instantiation's {bf16_counts}; host dtype float32; PSNR of the "
        f"bfloat16 output against the float32 output on this window "
        f"(random weights) {psnr16:.3f} dB -> {label16}")

    # ----- cudnn.benchmark off against on (the default, off, is restored)
    bench_secs = {}
    for name, eng in (("float32", engine), ("bfloat16", engine16)):
        bench_secs[name] = benchmark_ab(
            torch, lambda eng=eng: eng.forward_windows(frames, ts))
        say(f"[4 benchmark] {name}, cudnn.benchmark "
            + benchmark_text(bench_secs[name], "window"))

    # ------------------------------------- 5. whole path, card vs CPU
    small = np.random.RandomState(SEED + 1).uniform(
        -1, 1, (1, 4, SMALL_H, SMALL_W, 3)).astype(np.float32)
    cpu_model = make_model(cfg, device="cpu")
    cpu_model.load_state_dict(model.state_dict(), strict=True)
    cpu_res = InferenceEngine(cpu_model, num_update=cfg.N_tst,
                              device="cpu").forward_windows(small, ts)[0]
    for benchmark in (True, False):   # the check holds with it on as off
        torch.backends.cudnn.benchmark = benchmark
        gpu_res = engine.forward_windows(small, ts)[0]
        worst = (0.0, 0.0, "")
        for f in dataclasses.fields(WindowResult):
            a, b = getattr(gpu_res, f.name), getattr(cpu_res, f.name)
            check(a.shape == b.shape,
                  f"{f.name}: card {a.shape} cpu {b.shape}")
            err = float(np.abs(a - b).max())
            ratio = float((np.abs(a - b)
                           / (PATH_ATOL + PATH_RTOL * np.abs(b))).max())
            if ratio >= worst[1]:
                worst = (err, ratio, f.name)
            check(ratio <= 1.0, f"{f.name}: card vs CPU max abs err {err} "
                                f"beyond atol {PATH_ATOL} + rtol {PATH_RTOL} "
                                f"* |cpu| (cudnn.benchmark {benchmark})")
        say(f"[5 whole path] card vs CPU at {SMALL_H}x{SMALL_W} x8, float32, "
            f"cudnn.benchmark {'on' if benchmark else 'off'}: worst field "
            f"{worst[2]} max abs err {worst[0]:.3g}, {worst[1]:.3f} of the "
            f"tolerance (atol {PATH_ATOL} + rtol {PATH_RTOL} * |cpu|)")

    # ------------------------ 5b. whole path at bfloat16, card vs CPU
    cpu16 = make_model(cfg16, device="cpu")
    cpu16.load_state_dict(model.state_dict(), strict=True)
    gpu16_res = engine16.forward_windows(small, ts)[0]
    cpu16_res = InferenceEngine(cpu16, num_update=cfg.N_tst,
                                device="cpu").forward_windows(small, ts)[0]
    worst16 = (0.0, "")
    for f in dataclasses.fields(WindowResult):
        a, b = getattr(gpu16_res, f.name), getattr(cpu16_res, f.name)
        check(a.shape == b.shape and a.dtype == b.dtype == np.float32,
              f"bfloat16 {f.name}: card {a.shape} {a.dtype}, cpu {b.shape} "
              f"{b.dtype}")
        gap = max(abs(float(a.mean()) - float(b.mean())),
                  abs(float(a.std()) - float(b.std())))
        worst16 = max(worst16, (gap, f.name))
        check(gap <= BF16_MOMENTS_TOL,
              f"bfloat16 {f.name}: card vs CPU mean/std differ by {gap}")
    say(f"[5b whole path] card vs CPU at {SMALL_H}x{SMALL_W} x8, bfloat16: "
        f"every field float32 on the host and of its shape; largest gap of "
        f"mean or std {worst16[0]:.4g} ({worst16[1]}; tol "
        f"{BF16_MOMENTS_TOL})")

    del engine, model, cpu_model, gpu_res, cpu_res, res
    del engine16, model16, cpu16, gpu16_res, cpu16_res, res16
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
                               "fwarp_splat": SPLATS_PER_WINDOW * n_windows,
                               "bilinear_gather_bwd": 0, "fwarp_splat_bwd": 0},
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

        # the same evaluation at bfloat16, on the same float32 checkpoint
        kernels.reset_launch_counts()
        kernels.fwarp_served(dev, reset=True)
        driver.last_eval_stats = None
        result16, text16, wall16 = run_cli(
            argv + ["--compute_dtype", "bfloat16",
                    "--test_img_dir", str(tmp / "imgs_bf16")])
        torch.cuda.synchronize()
        launches16 = kernels.launch_counts()
        bf16_eval = kernels.bf16_launch_counts()
        st16 = driver.last_eval_stats
        check(result16 is not None and bool(np.isfinite(result16[:5]).all()),
              f"bfloat16 eval run: metrics {result16}")
        check("# compute_dtype : bfloat16" in text16
              and f"x{M} MFI results" in text16,
              "bfloat16 eval run: no bfloat16 config or result table")
        check(launches16 == eval_launches and bf16_eval == {
            "bilinear_gather": BF16_GATHERS_PER_WINDOW * n_windows,
            "bilinear_gather_bwd": 0},
            f"bfloat16 eval run: launches {launches16}, bfloat16 {bf16_eval}")
        names16 = {f"scene{sc}/{n}" for sc in range(EVAL_SCENES)
                   for n in os.listdir(os.path.join(result16[5], f"scene{sc}"))}
        check(names16 == set(b["files"]),
              f"bfloat16 eval run wrote {sorted(names16)}")
        say(f"[6 eval] bfloat16 run (--compute_dtype bfloat16, the float32 "
            f"checkpoint): loss {result16[0]:.6f}, intp PSNR "
            f"{result16[1]:.4f} SSIM {result16[2]:.6f}, deblur PSNR "
            f"{result16[3]:.4f} SSIM {result16[4]:.6f}; {len(names16)} PNGs; "
            f"evaluate wall {st16.wall_seconds:.4f} s = "
            f"{n_windows / st16.wall_seconds:.4f} windows/s; launches "
            f"{launches16}, of them bfloat16 {bf16_eval}")

        # test_custom, x4, one small scene, at float32 and at bfloat16
        clip = [rng.randint(0, 256, (CUSTOM_H, CUSTOM_W, 3)).astype(np.uint8)
                for _ in range(5)]
        for dtype in ("float32", "bfloat16"):
            root = tmp / f"clips_{dtype}"
            (root / "clipA").mkdir(parents=True)
            for i, img in enumerate(clip):
                imageio.imwrite(str(root / "clipA" / f"{i:05d}.png"), img)
            _, text, wall = run_cli([
                "--phase", "test_custom", "--multiple_MFI", "4",
                "--fwarp_shift_d", str(SHIFT_D), "--custom_path", str(root),
                "--checkpoint_dir", str(tmp / "ckpt"),
                "--compute_dtype", dtype])
            out_dir = root / "clipA_sharply_interpolated_x4"
            names = sorted(os.listdir(out_dir))
            want_names = sorted([f"{w:05d}_{j:03d}.png" for w in (1, 2)
                                 for j in range(3)]
                                + ["00001.png", "00002.png", "00003.png"])
            check(names == want_names, f"test_custom {dtype} wrote {names}")
            for n in names:
                img = imageio.imread(str(out_dir / n))
                check(img.shape == (CUSTOM_H, CUSTOM_W, 3),
                      f"{n}: {img.shape}")
            say(f"[6 eval] test_custom x4 at {CUSTOM_H}x{CUSTOM_W}, {dtype}: "
                f"{len(names)} PNGs in clipA_sharply_interpolated_x4, cli "
                f"wall {wall:.2f} s")
        ev = runs[1]
        say(f"[6 eval] x8 DeMFI-Net_rb(5,3) {H}x{W} float32 through "
            f"demfi_torch.main.cli --phase test, second run: "
            f"{n_windows / ev['wall']:.4f} windows/s, engine-stream span share "
            f"{100 * ev['stream_span'] / ev['wall']:.1f} % of wall time (CUDA "
            f"events around each dispatched window on the engine's stream, "
            f"launch gaps included: the device's busy share is at most this); "
            f"two runs identical in metrics and in {len(ev['files'])} PNG files")

        # -------------------------------------------------- 7. training
        # (the evaluation tree of phase 6 serves its validation and test)
        train = train_phase(torch, dev, tmp / "data", tmp, args.profile)

    # ---------------------------------------------------------- results
    def entry(name, source, replaces, launches, on_path, weight, extra):
        """One kernel of the kernels line: its times on its path summed
        over the path's launches (``weight`` of each row)."""
        mine = [r for r in on_path if r[weight]]

        def total(key):
            if any(r[key] is None for r in mine):
                return None
            return sum(r[key] * r[weight] for r in mine)
        check(launches > 0, f"{name}: never launched on its main path")
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=max(r["max_abs_err"]
                                               for r in on_path),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in mine)
            else "operations",
            library_ms=total("library_ms"), **extra, shapes=on_path)

    def summary(kname, source, replaces, per_window, launches):
        return entry(kname, source, replaces, launches,
                     [r for r in rows if r["kernel"] == kname
                      and r.get("image_dtype", "float32") == "float32"],
                     "per_window", dict(
                         launches_per_window=per_window,
                         launches_eval_path=eval_launches[kname],
                         launches_train_path=train["counts"][kname],
                         times_are="per window, summed over its launches"))

    def bwd_summary(kname, source, replaces):
        """A backward kernel: launches from phase 7(c)'s run of the train
        path, times per train step summed over its launches."""
        return entry(kname, source, replaces, train["counts"][kname],
                     [r for r in train["bwd_rows"] if r["kernel"] == kname
                      and r.get("image_dtype", "float32") == "float32"],
                     "per_step", dict(
                         launches_per_step=train["counts"][kname]
                         // OVERFIT_STEPS,
                         times_are="per train step, summed over its "
                                   "launches"))

    gather_src = "demfi_torch/csrc/bilinear_gather.cu"
    gather_bwd_src = "demfi_torch/csrc/bilinear_gather_bwd.cu"
    gather_bwd_replaces = ("demfi_tpu/ops/warp.py:448 (no Pallas kernel: the "
                           "vjp of _bwarp_xla, and of _bilinear_abs_xla :494)")
    say(json.dumps({"kernels": [
        summary("bilinear_gather", gather_src,
                "demfi_tpu/ops/pallas_kernels.py:58", GATHERS_PER_WINDOW,
                counts["bilinear_gather"]),
        entry("bilinear_gather (bfloat16 image)", gather_src,
              "demfi_tpu/ops/pallas_kernels.py:58",
              bf16_counts["bilinear_gather"],
              [r for r in rows if r["kernel"] == "bilinear_gather"
               and r["image_dtype"] == "bfloat16"],
              "per_window_bf16", dict(
                  launches_per_window=BF16_GATHERS_PER_WINDOW,
                  launches_eval_path=bf16_eval["bilinear_gather"],
                  launches_train_path=train["bf16_counts"]["bilinear_gather"],
                  times_are="per bfloat16 window, summed over its launches "
                            "of this instantiation")),
        summary("fwarp_splat", "demfi_torch/csrc/fwarp_splat.cu",
                "demfi_tpu/ops/pallas_kernels.py:273", SPLATS_PER_WINDOW,
                counts["fwarp_splat"]),
        summary("fwarp_shift", "demfi_torch/csrc/fwarp_shift.cu",
                "demfi_tpu/ops/pallas_kernels.py:479", SPLATS_PER_WINDOW,
                eval_launches["fwarp_shift"]),
        bwd_summary("bilinear_gather_bwd", gather_bwd_src,
                    gather_bwd_replaces),
        entry("bilinear_gather_bwd (bfloat16 image)", gather_bwd_src,
              gather_bwd_replaces, train["bf16_counts"]["bilinear_gather_bwd"],
              [r for r in train["bwd_rows"]
               if r["kernel"] == "bilinear_gather_bwd"
               and r["image_dtype"] == "bfloat16"],
              "per_step_bf16", dict(
                  launches_per_step=train["bf16_counts"]["bilinear_gather_bwd"]
                  // OVERFIT_STEPS,
                  times_are="per bfloat16 train step, summed over its "
                            "launches of this instantiation")),
        bwd_summary("fwarp_splat_bwd", "demfi_torch/csrc/fwarp_splat_bwd.cu",
                    "demfi_tpu/ops/warp.py:549 (no Pallas kernel: the vjp of "
                    "_fwarp_xla)"),
    ], "card": card, "splat_tile_spread": tile_spread,
        "windows_per_s": 1 / s_win,
        "frames_per_s": (M - 1) / s_win, "window_seconds": secs,
        "device_busy_share": busy,
        "peak_bytes": peak_bytes,
        "bytes_per_pixel_instant": per_pi,
        "bf16": {"windows_per_s": 1 / s_win16, "window_seconds": secs16,
                 "device_busy_share": busy16, "peak_bytes": peak16,
                 "bytes_per_pixel_instant": per_pi16,
                 "psnr_vs_float32_db": psnr16,
                 "expected_shift_db": shift16, "certified": certified16,
                 "label": label16, "card_vs_cpu_moments_gap": worst16[0],
                 "eval_windows_per_s": n_windows / st16.wall_seconds,
                 "eval_metrics": list(result16[:5])},
        "cudnn_benchmark_window_seconds": bench_secs,
        "eval": {k: [r[k] for r in runs] for k in (
            "wall", "stream_span", "decode", "metrics", "encode",
            "cli_wall")},
        "eval_windows": n_windows,
        "eval_windows_per_s": n_windows / ev["wall"],
        "eval_engine_stream_span_share": ev["stream_span"] / ev["wall"],
        "train": {k: v for k, v in train.items()
                  if k not in ("bwd_rows", "counts", "bf16_counts")}}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
