#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demfi_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of
                                     # one window and of one train step
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
     test_custom`` x4 on one small scene;
  7. training, DeMFI-Net_rb(5,3) at its published setting (batch 2,
     256x256 patches, N_trn = 5, float32): (a) each backward kernel
     against its plain vjp (autograd through the plain version) at the
     train step's shapes, on inputs from the model's own Stage I with the
     flow head calibrated to about 24 px: the gather's on both C=64
     bwarp_pairs (one launch), FGAC's absolute sample and the C=3 booster
     pair, with aten.grid_sampler_2d_backward (on the masked cotangent) as
     a yardstick; the splat's on the CFR flows, i.i.d. noise flows and
     non-finite flows (dropped pixels get zero gradients), twice for a
     bitwise comparison; each with device ms, enqueue us, bound and the
     plain vjp's ms; (b) one train step on the card against the port on
     the CPU at 64x64 on the same weights and batch: the loss, and every
     gradient against the CPU's to the larger of 1e-3 and twice the
     larger of the CPU's own change under 1e-6 nudges of the batch
     (sized to the card's departure on the flows:
     ``demfi_torch.utils.grad_check.gradient_bounds``) and the card's
     change between two runs; each of five planted faults (a group of
     warps passing no gradient on) must fail that check; (c) 8 steps on
     one
     fixed batch: the loss falls; seconds per step, forward / backward /
     optimizer device time (CUDA events), peak memory, and exactly 9
     gather, 9 gather-backward, 2 splat, 2 splat-backward and no stencil
     launches per step; (d) ``cli --phase train`` on a synthetic tree (4
     train scenes, phase 6's test scenes for validation and the final
     evaluation at x2) for 2 epochs, ``--auto_resume`` for a third
     (starts at epoch 2, Adam's step count carried over), then ``--phase
     test`` on the trained checkpoint (strict load).

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


def device_breakdown(torch, fn, label: str) -> str:
    """A torch.profiler trace of fn(): wall time, the device's busy share
    (the union of the intervals of device-side events, profiler
    bookkeeping rows excluded), device seconds by kind and the top
    kernels."""
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
            f"{ {k: round(v, 4) for k, v in share.items()} }; top:\n" + table)


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
                ops, note=""):
        """One backward case: pairs() gives (kernel result, plain vjp
        result) tensors; fn() launches once."""
        n0 = getattr(kernels, kernel).launches
        got_want = pairs()
        torch.cuda.synchronize()
        check(getattr(kernels, kernel).launches == n0 + 1,
              f"{name}: {getattr(kernels, kernel).launches - n0} launches, "
              f"expected 1")
        errs = [float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                for a, b in got_want]
        finite = all(bool(torch.isfinite(a).all()) for a, _ in got_want)
        r = dict(kernel=kernel, case=name, per_step=per_step,
                 ms=timer.ms(fn, 10),
                 enqueue_us=enqueue_us(torch, fn, ENQUEUE_CALLS),
                 plain_ms=timer.ms(plain, 3),
                 library_ms=None if library is None else timer.ms(library, 10),
                 max_abs_err=max(float((a - b).abs().max())
                                 for a, b in got_want),
                 max_rel_err=max(errs), tol=BWD_RTOL, bytes=nbytes,
                 operations=ops)
        bound_b = nbytes / HBM_BYTES_PER_S * 1e3
        bound_o = ops / F32_FLOPS_PER_S * 1e3
        r.update(bound_ms=max(bound_b, bound_o),
                 bound_by="bytes" if bound_b >= bound_o else "operations")
        bwd_rows.append(r)
        lib = ("none (no single-call equivalent)" if library is None else
               f"{r['library_ms']:.4f} ms (aten.grid_sampler_2d_backward)")
        say(f"[7 train a] {name}: max err {max(errs):.3g} of the largest "
            f"value (tol {BWD_RTOL:.0e}){note} | kernel {r['ms']:.4f} ms "
            f"device, {r['enqueue_us']:.1f} us enqueue; plain vjp "
            f"{r['plain_ms']:.4f} ms; library {lib} | bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes / 1e9:.4f} "
            f"GB, {ops / 1e9:.4f} G operations; kernel at "
            f"{r['ms'] / r['bound_ms']:.2f}x)")
        check(finite, f"{name}: non-finite kernel output")
        check(max(errs) <= BWD_RTOL, f"{name}: kernel disagrees with its "
                                     f"plain vjp ({max(errs)} > {BWD_RTOL})")
        return got_want

    def grid_of(img, coords, relative):
        h, w = img.shape[2:]
        gx = coords[:, 0] + (torch.arange(w, device=dev)[None, None]
                             if relative else 0)
        gy = coords[:, 1] + (torch.arange(h, device=dev)[None, :, None]
                             if relative else 0)
        return torch.stack([gx * (2.0 / (w - 1)) - 1.0,
                            gy * (2.0 / (h - 1)) - 1.0], dim=-1)

    def gather_case(name, per_step, halves, relative):
        """halves: [(img, coords, grad_out)], one or two; one launch."""
        pair = len(halves) == 2
        nbytes = ops = 0
        library = []
        for img, co, go in halves:
            b, c, h, w = img.shape
            hq, wq = co.shape[2:]
            live, reached = gather_bwd_counts(torch, warp, co, relative, h, w)
            # read: grad_out at the unmasked pixels, the coordinates, the
            # image pixels their taps reach; written: grad_img in full
            # (its zero fill), grad_coords
            nbytes += 4 * (live * c + co.numel() + reached * c
                           + img.numel() + co.numel())
            ops += live * (24 * c + 30)
            grid = grid_of(img, co, relative)
            masked = (go * (warp.bilinear_gather_plain(
                torch.ones_like(img[:, :1]), co, True)[1] >= 0.999)
                if relative else go)
            library.append(lambda m=masked, i=img, gr=grid:
                           torch.ops.aten.grid_sampler_2d_backward(
                               m, i, gr, 0, 0, True, [True, True]))
        if pair:
            (a, fa, ga), (a2, fb, gb) = halves

            def fn():
                return kernels.bilinear_gather_pair_bwd(a, a2, fa, fb, ga, gb,
                                                        relative)

            def pairs():
                (gia, gib), (gca, gcb) = fn()
                pa = warp.bilinear_gather_plain_vjp(a, fa, relative, ga)
                pb = warp.bilinear_gather_plain_vjp(a2, fb, relative, gb)
                return [(gia, pa[0]), (gca, pa[1]), (gib, pb[0]),
                        (gcb, pb[1])]
        else:
            (a, fa, ga), = halves

            def fn():
                return kernels.bilinear_gather_bwd(a, fa, relative, ga)

            def pairs():
                gi, gc = fn()
                p = warp.bilinear_gather_plain_vjp(a, fa, relative, ga)
                return [(gi, p[0]), (gc, p[1])]
        bwd_row("bilinear_gather_bwd", name, per_step, fn,
                lambda: [warp.bilinear_gather_plain_vjp(i, co, relative, go)
                         for i, co, go in halves],
                lambda: [f() for f in library], pairs, nbytes, ops,
                "; one launch" if pair else "")

    nb, nf, ps = TRAIN_B, cfg.nf, TRAIN_PS
    gather_case(f"gather bwd pair rel C={nf} 2x{nb} {ps}x{ps}", 2,
                [(ctx.f0.contiguous(), ft0, cot(nb, nf, ps, ps)),
                 (ctx.f1.contiguous(), ft1, cot(nb, nf, ps, ps))], True)
    gather_case(f"gather bwd abs C={nf} B={nb} (FGAC)", 2,
                [(ctx.f0.contiguous(), ctx.flow_01.contiguous(),
                  cot(nb, nf, ps, ps))], False)
    gather_case(f"gather bwd pair rel C=3 2x{nb}", cfg.N_trn,
                [(inputs[:, 0].contiguous(), ft0, cot(nb, 3, ps, ps)),
                 (inputs[:, 1].contiguous(), ft1, cot(nb, 3, ps, ps))], True)

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

    # ---- (b) one full-width train step, card against CPU, 64x64
    with torch.enable_grad():
        small = np.random.RandomState(SEED + 8).uniform(
            -1, 1, (TRAIN_B, 9, TRAIN_SMALL, TRAIN_SMALL, 3)).astype(np.float32)
        gmodel = make_model(cfg, device=dev)
        calibrate_flow_head(gmodel, torch.from_numpy(small[:, :4]).to(dev)
                            .permute(0, 1, 4, 2, 3).contiguous(),
                            FLOW_TARGET_PX)
        weights = {k: v.cpu() for k, v in gmodel.state_dict().items()}

        def grads_of(device, batch):
            """(loss, {name: gradient or None}, the flows [N+1,B,4,H,W])
            of one train step."""
            m = make_model(cfg, device=device)
            m.load_state_dict(weights, strict=True)
            state = create_train_state(cfg, m)
            got, flows = {}, []
            m.register_forward_hook(lambda _m, _in, out: flows.append(
                out.flow_preds.detach().cpu()))

            def snap(phase):
                if phase == "backward":
                    got.update({k: None if p.grad is None
                                else p.grad.detach().cpu().clone()
                                for k, p in m.named_parameters()})
            metrics = make_train_step(cfg)(state, batch, t_np, on_phase=snap)
            return float(metrics["total_loss"]), got, flows[0]
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
            fail(str(e))
        faulty = {}
        for kind in PLANTED_FAULTS:    # the check must catch each
            with planted_fault(kind):
                faulty[kind] = grads_of(dev, small)[1]
    del gmodel
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    say(f"[7 train b] one train step at {TRAIN_SMALL}x{TRAIN_SMALL} B={TRAIN_B}"
        f", full width: loss card {loss_g:.7f} cpu {loss_c:.7f} (rel "
        f"{loss_rel:.2e}, tol {STEP_LOSS_RTOL:.0e})")
    check(loss_rel <= STEP_LOSS_RTOL, f"train step loss: card {loss_g} cpu "
                                      f"{loss_c}")
    check(all((grads_g[k] is None) == (grads_c[k] is None) for k in grads_c),
          "card and CPU differ in which parameters have a gradient")
    say(f"[7 train b] flows, relative Frobenius: card against CPU {gap:.3g}; "
        f"the CPU under the {len(moves)} counted {NUDGE:.0e} nudges of the "
        f"batch {', '.join('%.3g' % v for v in moves)} "
        f"({max(moves) / gap:.2f}x the card's)")
    worst = (0.0, "", 0.0, 0.0)
    for k, b in bound.items():
        err = rel_frobenius(grads_g[k], grads_c[k])
        check(err <= b, f"train step gradient {k}: card against CPU "
                        f"{err:.3g} > {b:.3g}")
        worst = max(worst, (err / b, k, err, b))
    over = sum(1 for k in bound
               if rel_frobenius(grads_g[k], grads_c[k]) > GRAD_TOL)
    say(f"[7 train b] {len(bound)} parameter gradients, card against CPU "
        f"(relative Frobenius error; bound per tensor the larger of "
        f"{GRAD_TOL:.0e} and twice the larger of the CPU's change under the "
        f"nudges and the card's between two runs): worst {worst[1]} "
        f"{worst[2]:.3g} (bound {worst[3]:.3g}, {worst[0]:.2f} of it); "
        f"{over} tensors above {GRAD_TOL:.0e}")
    caught = {}
    for kind, got in faulty.items():
        ratios = [rel_frobenius(torch.zeros_like(grads_c[k]) if got[k] is None
                                else got[k], grads_c[k]) / bound[k]
                  for k in bound]
        caught[kind] = (sum(r > 1 for r in ratios), max(ratios))
        check(caught[kind][0] > 0, f"a planted fault ({kind}) passes the "
                                   f"gradient check")
    say(f"[7 train b] planted faults, one group of warps passing no "
        f"gradient on: tensors beyond their bounds (largest ratio) "
        + ", ".join(f"{k} {n} ({r:.1f}x)" for k, (n, r) in caught.items()))

    # ---- (c) 8 steps on one fixed full-width batch
    with torch.enable_grad():
        state = create_train_state(cfg, model)
        step = make_train_step(cfg)
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
            m = step(state, frames, t_dev,
                     on_phase=lambda phase: ev[phase].record())
            losses.append(float(m["total_loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            split.append([ev["start"].elapsed_time(ev["forward"]),
                          ev["forward"].elapsed_time(ev["backward"]),
                          ev["backward"].elapsed_time(ev["optimizer"])])
        train_counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        if profile:
            say(device_breakdown(torch, lambda: step(state, frames, t_dev),
                                 "[7 profile] one train step"))
    want = {k: v * OVERFIT_STEPS for k, v in TRAIN_LAUNCHES.items()}
    check(train_counts == want, f"train launches {train_counts} != {want} over "
                                f"{OVERFIT_STEPS} steps")
    check(all(np.isfinite(losses)), f"train losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    timed = secs[OVERFIT_WARMUP:]
    s_step = float(np.median(timed))
    split_ms = np.median(np.array(split[OVERFIT_WARMUP:]), axis=0)
    say(f"[7 train c] {OVERFIT_STEPS} steps of DeMFI-Net_rb(5,3) at "
        f"{TRAIN_B}x{TRAIN_PS}x{TRAIN_PS}, float32, one fixed batch, flow head "
        f"{raw_peak:.2f} -> {FLOW_TARGET_PX} px: losses "
        f"{['%.5f' % v for v in losses]}; seconds per step "
        f"{['%.4f' % s for s in secs]}, median after {OVERFIT_WARMUP} warm-up "
        f"{s_step:.4f} s = {TRAIN_B / s_step:.3f} samples/s; device ms per "
        f"step (CUDA events, median): forward {split_ms[0]:.2f}, backward "
        f"{split_ms[1]:.2f}, optimizer {split_ms[2]:.2f}; peak allocated "
        f"{peak / 2 ** 30:.3f} GiB ({(peak - base) / 2 ** 30:.3f} above the "
        f"weights); launches per step "
        f"{ {k: v / OVERFIT_STEPS for k, v in train_counts.items()} }")
    del state, model, frames, inputs
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
    say(f"[7 train d] cli --phase train at {TRAIN_B}x{TRAIN_PS}x{TRAIN_PS} on "
        f"{CLI_TRAIN_SCENES} scenes (written in {write_s:.2f} s): epochs 0-1 in "
        f"{first['wall']:.2f} s, losses "
        f"{['%.5f' % v for v in first['res']['epoch_losses']]}, step seconds "
        f"{['%.4f' % v for v in first['res']['step_seconds']]}; --auto_resume "
        f"from epoch {second['res']['start_epoch']} with {first['steps']} Adam "
        f"steps carried ({second['steps']} after it) in {second['wall']:.2f} s;"
        f" {len(files)} checkpoints; --phase test x2 on the trained latest "
        f"(strict load) in {test_wall:.2f} s: intp PSNR {test_res[1]:.4f}, "
        f"deblur PSNR {test_res[3]:.4f}")
    return dict(bwd_rows=bwd_rows, counts=train_counts, seconds_per_step=s_step,
                step_seconds=secs, losses=losses,
                samples_per_s=TRAIN_B / s_step,
                device_ms_forward_backward_optimizer=split_ms.tolist(),
                peak_bytes=peak, loss_card_cpu=[loss_g, loss_c],
                worst_grad=dict(name=worst[1], err=worst[2],
                                bound=worst[3]),
                flow_gap_nudges=[gap] + moves, planted_faults=caught,
                cli_wall=[first["wall"], second["wall"], test_wall])


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

    if args.profile:
        say(device_breakdown(torch, lambda: engine.forward_windows(frames, ts),
                             "[4 profile] one window"))

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

        # -------------------------------------------------- 7. training
        # (the evaluation tree of phase 6 serves its validation and test)
        train = train_phase(torch, dev, tmp / "data", tmp, args.profile)

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
            launches_train_path=train["counts"][kname],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_win("ms"), plain_ms=per_win("plain_ms"),
            bound_ms=per_win("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in on_path)
            else "operations",
            library_ms=per_win("library_ms"),
            times_are="per window, summed over its launches",
            shapes=mine)

    def bwd_summary(kname, source, replaces):
        """A backward kernel: launches from phase 7(c)'s run of the train
        path, times per train step summed over its launches."""
        mine = [r for r in train["bwd_rows"] if r["kernel"] == kname]
        on_path = [r for r in mine if r["per_step"]]
        check(train["counts"][kname] > 0,
              f"{kname}: never launched on the train path")

        def per_step(key):
            if any(r[key] is None for r in on_path):
                return None
            return sum(r[key] * r["per_step"] for r in on_path)
        return dict(
            name=kname, route="cuda", source=source, replaces=replaces,
            launches=train["counts"][kname],
            launches_per_step=train["counts"][kname] // OVERFIT_STEPS,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            max_rel_err=max(r["max_rel_err"] for r in mine),
            ms=per_step("ms"), plain_ms=per_step("plain_ms"),
            bound_ms=per_step("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in on_path)
            else "operations",
            library_ms=per_step("library_ms"),
            times_are="per train step, summed over its launches",
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
        bwd_summary("bilinear_gather_bwd",
                    "demfi_torch/csrc/bilinear_gather_bwd.cu",
                    "demfi_tpu/ops/warp.py:448 (no Pallas kernel: the vjp of "
                    "_bwarp_xla, and of _bilinear_abs_xla :494)"),
        bwd_summary("fwarp_splat_bwd", "demfi_torch/csrc/fwarp_splat_bwd.cu",
                    "demfi_tpu/ops/warp.py:549 (no Pallas kernel: the vjp of "
                    "_fwarp_xla)"),
    ], "card": card, "splat_tile_spread": tile_spread,
        "windows_per_s": 1 / s_win,
        "frames_per_s": (M - 1) / s_win, "window_seconds": secs,
        "peak_bytes": peak_bytes,
        "bytes_per_pixel_instant": per_pi,
        "eval": {k: [r[k] for r in runs] for k in (
            "wall", "stream_span", "decode", "metrics", "encode",
            "cli_wall")},
        "eval_windows": n_windows,
        "eval_windows_per_s": n_windows / ev["wall"],
        "eval_engine_stream_span_share": ev["stream_span"] / ev["wall"],
        "train": {k: v for k, v in train.items()
                  if k not in ("bwd_rows", "counts")}}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
