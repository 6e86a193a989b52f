#!/usr/bin/env python3
"""Smoke run of the PyTorch port (demfi_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card
    python3 chip_smoke.py --profile [DIR]  # adds a torch.profiler
                                     # breakdown of one window and of one
                                     # train step; keeps the traces in DIR
    python3 chip_smoke.py --kernels-of DIR   # phases 1-3f only, on the
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
  3d. (``--kernels-of`` only) the splat's backward on CFR's two halves at
     the train step's shapes on smooth synthetic flows: medians of cold
     and of back-to-back calls, one launch a half and (where the
     checkout has it) one launch on both, against the plain vjp;
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
     a yardstick; the splat's as CFR takes it, both warps in one launch
     on both halves, on the CFR flows, i.i.d. noise flows and
     non-finite flows (dropped pixels get zero gradients), twice for a
     bitwise comparison, and beside it the same halves as one launch
     each (the parent's count; phase 3d times the parent's kernel
     itself): per step the median of
     21 cold calls and of 21 back-to-back calls of each, whether the two
     give the same bits, and an empty kernel on the pair's grid (the
     launch floor); each with device ms, enqueue us, bound and the
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
     exactly 9 gather, 9 gather-backward, 2 splat, 1 splat-backward (the
     pair) and no stencil launches per step; then steps with
     cudnn.benchmark off
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
     float32 model;
  8. data parallelism: an NCCL process group of one on the card
     (``demfi_torch.parallel.init_distributed`` on a 127.0.0.1 port), 4
     train steps at phase 7(c)'s setting through ``data_parallel`` beside
     two plain runs from the same weights: every gradient DDP leaves
     bitwise the local gradient of the same backward, the launches of
     7(c), whole runs bitwise equal where two plain runs are; seconds per
     step plain, through data_parallel and through DDP with
     find_unused_parameters;
     then ``cli --phase train --coordinator_address 127.0.0.1:<port>
     --num_processes 1 --process_id 0`` for one epoch on 7(d)'s tree;
  9. the last modules: (a) remat, phase 7(c)'s step without it, with the
     whole backbone and with each RDB recomputed, float32 and bfloat16:
     seconds a step, forward / backward device ms, peak memory beside the
     prediction and exactly 7(c)'s launches; then, with
     cudnn.deterministic and the stencil forward warp, each mode's
     gradients bitwise the plain step's where two plain steps agree; (b)
     TrainLoader's samples/s on 1280x720 PNGs with the native augment
     and with the numpy chain, beside the PNG decode seconds a sample and
     the train step's rates; (c) ``demfi_torch.tools`` import_pt ->
     export_pt -> import_pt on phase 6's checkpoint (byte-identical
     msgpack, strict load, a window within 1e-3); (d)
     ``demfi_torch.scripts.repro_table2`` at x8 on phase 6's tree and
     checkpoint, PSNR within 1e-3 dB of phase 6's --phase test; (e)
     ``demfi_torch.scripts.synthetic_sanity`` at its defaults must print
     SANITY PASS;
 10. the spatial axis (``--mesh_spatial``): ranks of its own (this script
     with ``--spatial-rank``), NCCL with one rank a card and S = min(4,
     cards) where there are two cards or more, else two gloo ranks
     sharing the one card (S = 2); (a) phase 4's window and weights with
     the frame's rows split S ways against phase 4's and 4b's unsplit
     results (float32 within 1e-4 of each field's largest value, bfloat16
     by the moments rule), then ``cli --phase test --fwarp_shift_d 8
     --mesh_spatial S`` on phase 6's tree (metrics within 1e-3 of phase
     6's, PNGs within one uint8 step), with exact launches on every rank;
     (c) windows/s split at 352x640 and 1080p beside the unsplit rates,
     each rank's peak memory, the collectives' share of a window (CUDA
     events around each), and UHD untiled at t_chunk 1 where there are
     four cards;
 11. training's spatial axis (``--phase train --mesh_spatial``): ranks
     of its own (``--split-train-rank``), as phase 10; phase 7(c)'s
     step (DeMFI-Net_rb(5,3), batch 2, 256x256, N_trn 5, its weights and
     batch) with the rows split S ways, float32 and bfloat16, against
     the unsplit step on the same weights and batch run here (loss 1e-4,
     bfloat16 1e-2; every float32 gradient within the larger of 1e-3 and
     twice the unsplit step's own spread between two runs; every
     bfloat16 gradient by its moments, mean and std within 0.08 of its
     std, or of its value where it holds one), s/step split beside 7(c)'s
     and 7(c')'s, the collectives' share of a step forward and backward
     (CUDA events, ``halo.timing``), each rank's peak memory, exact
     launches of all five kernels a step on every rank; then ``cli
     --phase train --mesh_spatial S`` for one epoch on phase 7(d)'s tree
     and ``--auto_resume`` for one more;
 12. the bench entry point: ``python -m demfi_torch.bench`` as users run
     it, one process each (BENCH_RUNS): bare (720x1280 bfloat16, the full
     t-batch), 352x640 bfloat16 and float32, 720x1280 float32 (one
     instant a call), ``--t_chunk 3``, ``--readback`` and ``--wb 2``: one
     JSON record, no error, value > 0, exit 0; one run with an injected
     OOM: a failure record that retried one instant a call, exit 1; in
     this process at 352x640 on the bench's weights and frames, its
     window checksum within 1e-5 of ``forward_windows``' four fields, and
     the launches its records name equal to the counters over one window
     (float32 and bfloat16), and in turns the seconds of a window through
     forward_windows (every field or the images fetched) and through the
     bench (the full t-batch and three instants a call), with the busy
     share of one profiled bf16 bench window; the ratio of its 352x640
     values to 7 x phase 4's and 4b's windows/s, printed.
Phase 3e (also under ``--kernels-of``): the three forward kernels on
every shard of 2- and 4-way row splits of the 352x640 frame, against
their plain versions and the unsplit kernel's rows (gather 1e-5, its
bfloat16 image 1e-2, the splat 1e-5 and its summed canvases, the
stencil bit for bit); the kernels line carries them as "row_offset".
Phase 3f (also under ``--kernels-of``): the two backward kernels on
every shard of 2- and 4-way row splits of the train step's frame
(batch 2, 256x256) at its four sites, against their plain vjps and the
unsplit kernel after the group's reduction, with device ms and enqueue
us beside the unsplit launch's; "row_offset" of the backward kernels'
entries.

Prints "[9 summary]", "[11 summary]" and "[12 summary]" lines and a {"kernels":
[...]} line, then as its last line
{"ok": true, "device": {"platform": "gpu", ...}}. Any failed phase exits
non-zero before either is printed; so does a run without a CUDA card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import inspect
import io
import json
import os
import socket
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
# per train step: 2 FGAC + 2 feature pairs + 5 booster pairs; 2 CFR
# splats, whose backwards are one launch on both halves
TRAIN_LAUNCHES = {"bilinear_gather": 9, "fwarp_splat": 2, "fwarp_shift": 0,
                  "bilinear_gather_bwd": 9, "fwarp_splat_bwd": 1}
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
# the splat's backward takes a few microseconds: medians of this many
# calls, cold and back to back
SPLAT_BWD_CALLS = 21
DDP_STEPS = 4                  # phase 8: steps per run (timed after the first)
# phase 9: remat (none, the whole backbone, each RDB) at 7(c)'s setting,
# steps per mode and dtype (timed after the first)
REMAT_STEPS = 4
REMAT_MODES = (None, "backbone", "rdb")
# predicted change of the float32 step's peak, GiB (low, high), against
# no remat: the 12 RDBs' kept activations (~64 MiB a sample each) go,
# the GFF concatenation and the up-sampling head with them for
# "backbone"; written before the first run on the card
REMAT_PREDICTED_GIB = {"backbone": (-1.8, -1.5), "rdb": (-1.3, -1.2)}
LOADER_H, LOADER_W = 720, 1280   # Adobe240's frames
LOADER_SCENES = 16               # scene directories, all links to one
LOADER_EPOCHS = 2                # timed, after one warm-up epoch
HARNESS_PSNR_TOL = 1e-3          # dB: the Table-2 harness against phase 6
# phase 3e: the forward kernels on the rows of a frame split this many ways
ROW_OFFSET_SPLITS = (2, 4)
GATHER_BF16_ROW_TOL = 1e-2     # of the largest value, bfloat16 image
# phase 10: the spatial axis. A split window against the unsplit one: of
# each field's largest value (float32; the convolutions see other shapes
# and may take other algorithms, the splat's sums another order)
SPATIAL_RTOL = 1e-4
SPATIAL_METRIC_TOL = 1e-3      # dB (and loss, SSIM): --mesh_spatial vs phase 6
SPATIAL_REPEATS = 2            # timed windows at 352x640
SPATIAL_TIMEOUT = 600          # s, for all ranks
HD = (1080, 1920)
UHD = (2160, 3840)
# phase 11: training's spatial axis. Split steps a dtype: the first against
# the unsplit step's gradients, the rest timed after SPLIT_WARMUP
SPLIT_STEPS = {"float32": 5, "bfloat16": 4}
SPLIT_WARMUP = 2
SPLIT_TRAIN_TIMEOUT = 420      # s, for all ranks
# predicted for two gloo ranks sharing one card, written before the
# first run of phase 11: s/step (float32 low, high), the collectives'
# share of a float32 step, each rank's peak GiB (float32 low, high)
SPLIT_PREDICTED = {"s_per_step": (1.0, 2.0), "collectives_share": (0.5, 0.75),
                   "peak_gib": (5.5, 8.0)}
# phase 12: ``python -m demfi_torch.bench`` as users run it, one process a
# run: (label, flags, a marker its record's metric must hold). The first
# runs bare (the probe, 720x1280 bfloat16, the full t-batch); the others
# skip the probe and are cut to a few timed windows
BENCH_RUNS = (
    ("default", [], "(720x1280, N_tst=3, bfloat16, wb=1, device (CUDA "
     "events, 4-window timed region), "),
    ("352x640 bfloat16", ["--res", "352x640", "--iters", "2", "--inner", "2"],
     "(352x640, N_tst=3, bfloat16, wb=1, device (CUDA events, 2-window "
     "timed region)"),
    ("352x640 float32", ["--res", "352x640", "--dtype", "float32", "--iters",
                         "2", "--inner", "2"],
     "(352x640, N_tst=3, float32, wb=1, device (CUDA events, 2-window timed "
     "region)"),
    ("720x1280 float32", ["--dtype", "float32", "--iters", "3", "--inner",
                          "1"], "t_map (sequential per-instant)"),
    ("352x640 float32 --t_chunk 3", ["--res", "352x640", "--dtype", "float32",
                                     "--t_chunk", "3", "--iters", "2",
                                     "--inner", "1"], ", t_chunk=3)"),
    ("352x640 bfloat16 --readback", ["--res", "352x640", "--readback",
                                     "--iters", "3"], "e2e+readback"),
    ("352x640 bfloat16 --wb 2", ["--res", "352x640", "--wb", "2", "--iters",
                                 "2", "--inner", "1"], "bfloat16, wb=2, "),
)
BENCH_TIMEOUT = 300            # s, one bench process
BENCH_RTOL = 1e-5              # the bench's checksum against the engine's
BENCH_INNER = 2                # windows a timed region, in this process
# the fields InferenceEngine(fetch="full") copies to the host
BENCH_FULL_FETCH = ("s0_prime", "s1_prime", "st_prime", "s0_final",
                    "s1_final", "st_final", "flow_init", "flow_final",
                    "occ0_init", "occ0_final", "ovlp", "blend_w0", "blend_w1",
                    "diff_10", "diff_01")
EMPTY_KERNEL_SRC = r"""
#include <cuda_runtime.h>
__global__ void demfi_empty_kernel() {}
extern "C" int demfi_empty_launch(int gx, int gy, int gz, int tx, int ty,
                                  void* stream) {
  demfi_empty_kernel<<<dim3(gx, gy, gz), dim3(tx, ty), 0,
                       (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


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

    def times(self, fn, n: int) -> list:
        """Device milliseconds of fn in each of n cold calls."""
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
        return [a.elapsed_time(b) for a, b in pairs]

    def ms(self, fn, n: int) -> float:
        """Mean device milliseconds of fn over n cold calls."""
        return sum(self.times(fn, n)) / n

    def back_to_back(self, fn, n: int) -> list:
        """Device milliseconds of fn in each of n calls queued back to
        back behind one spin that covers the host's enqueue of all of
        them: an event between each two calls, no flush (inputs that fit
        the 50 MB L2 stay there)."""
        torch = self.torch
        spin = int((2 * n * enqueue_us(torch, fn, 1) + 50)
                   * self.cycles_per_us)
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        evs[0].record()
        for e in evs[1:]:
            fn()
            e.record()
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]


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
                        where=None, row0: int = 0) -> int:
    """Pixels of the image that a bilinear gather at coords [B,2,Hq,Wq]
    must read: the union, per batch element, of its in-image taps (of the
    query pixels ``where`` [B,Hq,Wq] marks, if given); relative query
    rows at ``row0`` of the image's."""
    b, _, hq, wq = coords.shape
    px, py = coords[:, 0], coords[:, 1]
    if relative:
        px = px + torch.arange(w, device=coords.device)[None, None]
        py = py + torch.arange(row0, row0 + hq,
                               device=coords.device)[None, :, None]
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


def gather_bwd_counts(torch, warp, coords, relative: bool, h: int, w: int,
                      row0: int = 0):
    """What the gather's vjp at coords [B,2,Hq,Wq] must touch: the
    unmasked query pixels (the relative mode's 0.999 mask zeroes the
    rest, grad_out there is not read) and the image pixels their in-image
    taps reach; relative query rows at ``row0`` of the image's."""
    b, _, hq, wq = coords.shape
    if relative:
        ones = torch.ones((b, 1, h, w), device=coords.device)
        live = warp.bilinear_gather_plain(ones, coords, True,
                                          row0)[1][:, 0] >= 0.999
    else:
        live = torch.ones((b, hq, wq), dtype=torch.bool, device=coords.device)
    return (int(live.sum()),
            gather_image_pixels(torch, coords, relative, h, w, where=live,
                                row0=row0))


def bound_of(nbytes: float, ops: float) -> dict:
    """The least time of a function that moves nbytes and does ops float32
    operations on the card (HBM and float32 peaks of an H100 SXM)."""
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = ops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(bound_b, bound_o),
                bound_by="bytes" if bound_b >= bound_o else "operations")


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


def empty_kernel(torch, tmp: Path):
    """An empty kernel, built with the kernels' nvcc flags, as a function
    of its grid that launches it with 32 x 8 threads on the current
    stream: the launch floor under a kernel of that grid."""
    from demfi_torch.ops import kernels
    src, lib = tmp / "empty_kernel.cu", tmp / "libempty_kernel.so"
    src.write_text(EMPTY_KERNEL_SRC)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                          str(lib), str(src)], capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0, f"empty kernel: {res.stdout}{res.stderr}")
    fn = ctypes.CDLL(str(lib)).demfi_empty_launch
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(grid):
        rc = fn(*grid, 32, 8, torch._C._cuda_getCurrentRawStream(0))
        check(rc == 0, f"empty kernel: cudaError {rc}")
    return launch


def splat_targets(torch, flo, r0: int = 0, ho=None) -> int:
    """Distinct in-image pixels the forward splat of flo [B,2,H,W] lands
    on (the splat's vjp reads grad_out and grad_norm there only); its
    source rows at ``r0`` of a frame of ``ho`` rows (H)."""
    b, _, h, w = flo.shape
    ho = h if ho is None else ho
    r = torch.floor(flo[:, 1]).long() + torch.arange(
        r0, r0 + h, device=flo.device)[None, :, None]
    c = torch.floor(flo[:, 0]).long() + torch.arange(w, device=flo.device)[
        None, None]
    fin = torch.isfinite(flo).all(1)
    reached = torch.zeros(b, ho * w, dtype=torch.bool, device=flo.device)
    rows = torch.arange(b, device=flo.device)[:, None, None].expand(b, h, w)
    for dr in (0, 1):
        for dc in (0, 1):
            ok = (fin & (r + dr >= 0) & (r + dr < ho) & (c + dc >= 0)
                  & (c + dc < w))
            reached[rows[ok], ((r + dr) * w + c + dc)[ok]] = True
    return int(reached.sum())


def device_breakdown(torch, fn, label: str, logdir: str):
    """A torch.profiler trace of fn() (``device_trace``, written under
    ``logdir``): wall time, the device's busy share (the union of the
    intervals of device-side events, profiler bookkeeping rows excluded),
    device seconds by kind and the top kernels. Returns (the text, the
    busy share)."""
    from torch.autograd import DeviceType
    from demfi_torch.utils.profiling import device_trace
    with device_trace(logdir) as prof:
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
                profile: str = "") -> dict:
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
                ops, note="", tols=None, per_step_bf16=0, routes="",
                times=None):
        """One backward case: pairs() gives (kernel result, plain vjp
        result) tensors, ``tols`` their tolerances (BWD_RTOL each by
        default); fn() launches once; ``routes`` ends the printed line.
        ``times()``, where given, returns the row's timing fields in
        place of the mean of 10 cold calls (``ms`` among them)."""
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
                 per_step_bf16=per_step_bf16,
                 **(dict(ms=timer.ms(fn, 10)) if times is None else times()),
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

    # the splat's backward: CFR's two warps (flow_01 by t * flow_01,
    # flow_10 by (1 - t) * flow_10) as one launch on both halves, and the
    # same two halves as one launch each (the parent's count) in the same
    # run
    imgs = (ctx.flow_01.contiguous(), ctx.flow_10.contiguous())
    smooth = ((tt * ctx.flow_01).contiguous(),
              ((1.0 - tt) * ctx.flow_10).contiguous())
    noise = tuple(torch.from_numpy(np.random.RandomState(SEED + 6 + k).uniform(
        -FLOW_TARGET_PX, FLOW_TARGET_PX, tuple(f.shape)).astype(np.float32)
        ).to(dev) for k, f in enumerate(smooth))
    bad, bad_dropped = [], []
    for k, f in enumerate(smooth):
        v = f.cpu().numpy().copy()
        where = (np.random.RandomState(SEED + 7 + 10 * k).rand(*v.shape)
                 < NONFINITE_SHARE)
        v[where] = np.resize(np.array(NONFINITE_VALUES, np.float32),
                             int(where.sum()))
        bad.append(torch.from_numpy(v).to(dev))
        with np.errstate(invalid="ignore"):
            dropped = (~(np.isfinite(v) & (np.abs(v) < 1e8))).any(
                1, keepdims=True)
        bad_dropped.append(torch.from_numpy(
            np.where(dropped, np.float32(1e9), v).astype(np.float32)).to(dev))
    cots = [(cot(*i.shape), cot(i.shape[0], 1, *i.shape[2:])) for i in imgs]
    empty = empty_kernel(torch, tmp)
    b, c, h, w = imgs[0].shape
    # the grid of one launch on both halves (csrc/fwarp_splat_bwd.cu: 32 x
    # 8 threads, a source pixel each, blockIdx.z over both halves)
    pair_grid = (-(-w // 32), -(-h // 8), 2 * b)
    floor = dict(cold=float(np.median(timer.times(
        lambda: empty(pair_grid), SPLAT_BWD_CALLS))),
        back_to_back=float(np.median(timer.back_to_back(
            lambda: empty(pair_grid), SPLAT_BWD_CALLS))))
    say(f"[7 train a] launch floor: an empty kernel on the two halves' grid "
        f"{pair_grid} x (32, 8): median of {SPLAT_BWD_CALLS} cold calls "
        f"{floor['cold']:.4f} ms, of {SPLAT_BWD_CALLS} back to back "
        f"{floor['back_to_back']:.4f} ms")
    repeats, same_as_singles = {}, {}
    for name, flos, want_flos, per_step in (
            ("smooth", smooth, smooth, 1),
            ("noise", noise, noise, 0),
            ("non-finite", tuple(bad), tuple(bad_dropped), 0)):
        halves = [(i, f, go, gn) for i, f, (go, gn) in zip(imgs, flos, cots)]

        def fn(halves=halves):
            return kernels.fwarp_splat_bwd_pair(*halves[0], *halves[1])

        def singles(halves=halves):
            return [kernels.fwarp_splat_bwd(*half) for half in halves]

        def plain(want_flos=want_flos):
            return [warp.fwarp_splat_plain_vjp(i, f, go, gn) for i, f, (go, gn)
                    in zip(imgs, want_flos, cots)]

        def pairs():
            return [(g, p) for got, want in zip(fn(), plain())
                    for g, p in zip(got, want)]

        def times(fn=fn, singles=singles):
            """Per step: the median of cold calls and of back-to-back
            calls, of the pair and of one launch a half (and the
            mean of the pair's cold calls, as earlier runs reported)."""
            cold = timer.times(fn, SPLAT_BWD_CALLS)
            return dict(
                ms=float(np.median(cold)), ms_mean=float(np.mean(cold)),
                ms_cold_range=[min(cold), max(cold)],
                ms_back_to_back=float(np.median(timer.back_to_back(
                    fn, SPLAT_BWD_CALLS))),
                singles_ms=float(np.median(timer.times(
                    singles, SPLAT_BWD_CALLS))),
                singles_ms_back_to_back=float(np.median(timer.back_to_back(
                    singles, SPLAT_BWD_CALLS))),
                launch_floor_ms=floor["cold"],
                launch_floor_ms_back_to_back=floor["back_to_back"])
        nbytes = ops = 0
        for f in flos:
            reached = splat_targets(torch, f)
            live = int(torch.isfinite(f).all(1).sum())
            # read: img, flo, grad_out and grad_norm at the targets;
            # written: grad_img, grad_flo
            nbytes += 4 * (2 * imgs[0].numel() + reached * (c + 1)
                           + 2 * f.numel())
            ops += 4 * live * (4 * c + 10)
        got_want = bwd_row(
            "fwarp_splat_bwd", f"splat bwd pair C={c} 2x{b} {name}", per_step,
            fn, plain, None, pairs, nbytes, ops,
            ("; dropped pixels zero" if name == "non-finite" else "")
            + "; one launch", times=times)
        r = bwd_rows[-1]
        again = [t for half in fn() for t in half]
        repeats[name] = all(torch.equal(a, g) for (a, _), g in
                            zip(got_want, again))
        check(repeats[name], f"splat bwd {name}: two runs differ")
        single = [t for half in singles() for t in half]
        same_as_singles[name] = all(torch.equal(a, g) for (a, _), g in
                                    zip(got_want, single))
        r.update(two_runs_bitwise_equal=repeats[name],
                 bitwise_equal_to_one_launch_a_half=same_as_singles[name])
        say(f"[7 train a] splat bwd {name} per step: pair {r['ms']:.4f} ms "
            f"cold, {r['ms_back_to_back']:.4f} back to back; one launch "
            f"a half {r['singles_ms']:.4f} cold, "
            f"{r['singles_ms_back_to_back']:.4f} back to back (medians of "
            f"{SPLAT_BWD_CALLS}; the pair's cold mean {r['ms_mean']:.4f}, "
            f"range {r['ms_cold_range'][0]:.4f}-{r['ms_cold_range'][1]:.4f}); "
            f"bound {r['bound_ms']:.4f} ms (pair "
            f"{r['ms'] / r['bound_ms']:.2f}x cold, "
            f"{r['ms_back_to_back'] / r['bound_ms']:.2f}x back to back); "
            f"bitwise equal to one launch a half: {same_as_singles[name]}")
    say(f"[7 train a] splat bwd: two runs bitwise equal on every input: "
        f"{all(repeats.values())}; the pair bitwise equal to one launch a "
        f"half: {same_as_singles}")
    del ctx, ft0, ft1, noise, bad, bad_dropped, timer
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
                                     f"{scfg.compute_dtype}", profile)[0])
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
                cli_wall=[first["wall"], second["wall"], test_wall, wall16],
                ddp_inputs=dict(weights=weights0, batch=batch, t=t_np,
                                argv=argv))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ddp_phase(torch, dev, tmp: Path, inputs: dict) -> dict:
    """Phase 8: data parallelism on the card, NCCL at world size 1 (the
    box has one card). DDP_STEPS train steps at phase 7(c)'s setting in
    five runs from the same weights: plain, plain again, twice through
    ``data_parallel`` (DistributedDataParallel leaving out the parameters
    no step reads) and once through DistributedDataParallel with
    ``find_unused_parameters`` instead. In the first data_parallel run
    each gradient DDP leaves must be bitwise the local gradient of the
    same backward, every step (captured by a hook as it is accumulated):
    NCCL's all-reduce of one rank is a copy and DDP divides by 1.0, so
    the DDP step is the plain step on the same gradients. The other runs,
    without those hooks, are timed (the median step after the first).
    Whole runs are compared bitwise where two plain runs are (the
    atomic splat and the gather backward's float flush make them differ
    from run to run otherwise: the spreads are reported). Then ``cli
    --phase train`` for one epoch on phase 7(d)'s tree through a process
    group of one. Returns what the results line reports."""
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    from demfi_torch.checkpoint import load_training_checkpoint
    from demfi_torch.config import config_rb
    from demfi_torch.main import cli
    from demfi_torch.models import make_model
    from demfi_torch.ops import kernels
    from demfi_torch.parallel import (data_parallel, destroy_distributed,
                                      init_distributed)
    from demfi_torch.train import create_train_state, make_train_step

    cfg = config_rb(5, 3, seed=SEED)
    frames = torch.from_numpy(inputs["batch"]).to(dev)
    t_dev = torch.from_numpy(inputs["t"]).to(dev)
    joined = init_distributed(f"127.0.0.1:{free_port()}", 1, 0, "cuda")
    check(joined == (0, 1) and dist.get_backend() == "nccl",
          f"phase 8: joined {joined}, backend {dist.get_backend()}")

    def run(mode: str, capture: bool = False) -> dict:
        """mode: "plain", "ddp" (data_parallel) or "find_unused"."""
        model = make_model(cfg, device=dev)
        model.load_state_dict(inputs["weights"], strict=True)
        net = {"plain": lambda: model,
               "ddp": lambda: data_parallel(model, cfg.N_trn),
               "find_unused": lambda: DistributedDataParallel(
                   model, device_ids=[torch.cuda.current_device()],
                   find_unused_parameters=True)
               }[mode]()
        local = {}
        hooks = [p.register_post_accumulate_grad_hook(
            lambda p, k=k: local.__setitem__(k, p.grad.clone()))
            for k, p in model.named_parameters()] if capture else []
        state = create_train_state(cfg, net)
        step = make_train_step(cfg)
        kernels.reset_launch_counts()
        losses, secs, exact = [], [], []
        with torch.enable_grad():
            for _ in range(DDP_STEPS):
                local.clear()
                t0 = time.perf_counter()
                losses.append(float(step(state, frames, t_dev)["total_loss"]))
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                got = {k: p.grad for k, p in model.named_parameters()
                       if p.grad is not None}
                exact.append(capture and set(got) == set(local) and all(
                    torch.equal(g, local[k]) for k, g in got.items()))
        for h in hooks:
            h.remove()
        out = dict(losses=losses, secs=secs, exact=exact,
                   step_s=float(np.median(secs[1:])),
                   counts=kernels.launch_counts(),
                   params={k: v.detach().clone()
                           for k, v in model.state_dict().items()},
                   no_grad=sorted(k for k, p in model.named_parameters()
                                  if p.grad is None))
        del net, model, state
        torch.cuda.empty_cache()
        return out

    def gap(a, b):
        return max(float((a["params"][k] - b["params"][k]).abs().max())
                   for k in a["params"])
    try:
        plain, again = run("plain"), run("plain")
        ddp, timed = run("ddp", capture=True), run("ddp")
        unused = run("find_unused")
    finally:
        destroy_distributed()
    want = {k: v * DDP_STEPS for k, v in TRAIN_LAUNCHES.items()}
    check(all(ddp["exact"]), f"phase 8: DDP changed a gradient at world size "
                             f"1 (bitwise per step: {ddp['exact']})")
    check(all(r["counts"] == want for r in (ddp, timed, unused)),
          f"phase 8: launches {ddp['counts']}, {timed['counts']}, "
          f"{unused['counts']} != {want}")
    check(ddp["no_grad"] == plain["no_grad"], f"phase 8: parameters without a "
          f"gradient {ddp['no_grad']} (plain: {plain['no_grad']})")
    deterministic = again["losses"] == plain["losses"] and gap(plain, again) == 0
    if deterministic:
        check(all(r["losses"] == plain["losses"] and gap(plain, r) == 0
                  for r in (ddp, timed)),
              "phase 8: two plain runs agree bitwise, a DDP run does not")
    check(all(np.isfinite(ddp["losses"])), f"phase 8: losses {ddp['losses']}")
    say(f"[8 ddp] NCCL, world size 1, {DDP_STEPS} steps of DeMFI-Net_rb(5,3) at "
        f"{TRAIN_B}x{TRAIN_PS}x{TRAIN_PS}, float32, phase 7(c)'s batch and "
        f"weights: every gradient DDP left bitwise the local gradient of the "
        f"same backward in every step: {all(ddp['exact'])}; parameters without "
        f"a gradient (left out of DDP's reduction) {ddp['no_grad']}; losses "
        f"plain {plain['losses']}, plain again {again['losses']}, DDP "
        f"{ddp['losses']}, {timed['losses']}; largest parameter gap after the "
        f"steps: plain to plain {gap(plain, again):.3g}, plain to DDP "
        f"{gap(plain, ddp):.3g}, {gap(plain, timed):.3g} (two plain runs "
        f"bitwise equal: {deterministic}); seconds per step plain "
        f"{['%.4f' % v for v in plain['secs'] + again['secs']]}, DDP "
        f"{['%.4f' % v for v in timed['secs']]}, DDP with "
        f"find_unused_parameters {['%.4f' % v for v in unused['secs']]} "
        f"(and {['%.4f' % v for v in ddp['secs']]} with a hook cloning each "
        f"gradient); medians after the first step: plain "
        f"{plain['step_s']:.4f}, {again['step_s']:.4f}, DDP "
        f"{timed['step_s']:.4f}, find_unused_parameters "
        f"{unused['step_s']:.4f}; launches per step "
        f"{ {k: v / DDP_STEPS for k, v in ddp['counts'].items()} }")

    # the CLI's train phase through a process group of one
    moved = {"--checkpoint_dir": tmp / "ddp_ckpt", "--text_dir": tmp / "ddp_txt",
             "--log_dir": tmp / "ddp_log", "--test_img_dir": tmp / "ddp_img"}
    argv = [str(moved[inputs["argv"][i - 1]])
            if i and inputs["argv"][i - 1] in moved else a
            for i, a in enumerate(inputs["argv"])]
    out = io.StringIO()
    t0 = time.perf_counter()
    with torch.enable_grad(), contextlib.redirect_stdout(out):
        res = cli(argv + ["--epochs", "1", "--coordinator_address",
                          f"127.0.0.1:{free_port()}", "--num_processes", "1",
                          "--process_id", "0"])
    wall = time.perf_counter() - t0
    check(not dist.is_initialized(), "phase 8: the CLI left its process group")
    check("DistributedDataParallel" in out.getvalue(),
          "phase 8: the CLI did not train through DistributedDataParallel")
    check(res["start_epoch"] == 0 and len(res["epoch_losses"]) == 1
          and bool(np.isfinite(res["epoch_losses"]).all())
          and bool(np.isfinite(res["final"][:5]).all()),
          f"phase 8: cli --phase train: {res}")
    sd, _, meta = load_training_checkpoint(str(
        tmp / "ddp_ckpt" / "DeMFInet_exp1" / "DeMFInet_exp1_latest.pt"))
    make_model(cfg, device="cpu").load_state_dict(sd, strict=True)
    say(f"[8 ddp] cli --phase train --coordinator_address 127.0.0.1:<port> "
        f"--num_processes 1 --process_id 0, one epoch on phase 7(d)'s tree in "
        f"{wall:.2f} s: loss {res['epoch_losses'][0]:.5f}, step seconds "
        f"{['%.4f' % v for v in res['step_seconds']]}, final intp PSNR "
        f"{res['final'][1]:.4f}; its checkpoint (epoch {meta['last_epoch']}) "
        f"loads strictly into a plain model")
    return dict(world_size=1, backend="nccl", steps=DDP_STEPS,
                gradients_bitwise_local=ddp["exact"],
                runs_deterministic=deterministic,
                losses=dict(plain=plain["losses"], plain_again=again["losses"],
                            ddp=ddp["losses"], ddp_timed=timed["losses"]),
                param_gap=dict(plain_again=gap(plain, again),
                               ddp=gap(plain, ddp),
                               ddp_timed=gap(plain, timed)),
                step_seconds=dict(plain=plain["secs"] + again["secs"],
                                  ddp=timed["secs"],
                                  find_unused_parameters=unused["secs"],
                                  ddp_with_hooks=ddp["secs"]),
                median_step_seconds=dict(
                    plain=[plain["step_s"], again["step_s"]],
                    ddp=timed["step_s"],
                    find_unused_parameters=unused["step_s"]),
                no_grad=ddp["no_grad"], cli_wall=wall,
                cli_epoch_loss=res["epoch_losses"][0])


def remat_phase(torch, dev, inputs: dict, rates: dict) -> dict:
    """Phase 9(a): phase 7(c)'s train step (DeMFI-Net_rb(5,3), batch 2,
    256x256, N_trn = 5, the same weights and batch) without remat, with
    the whole backbone recomputed and with each RDB recomputed, at
    float32 and at bfloat16: REMAT_STEPS steps each, seconds a step,
    forward / backward device ms, peak memory (reset per mode) and
    exactly 7(c)'s launches. Then the exactness check: with
    cudnn.deterministic and the stencil forward warp (the flow head
    calibrated into its window), one step's gradients of each mode
    against two plain steps' (bitwise where the two plain steps agree
    bitwise, else within gradient_bounds' rule of the card's own
    change between two runs)."""
    from demfi_torch.config import config_rb
    from demfi_torch.models import make_model
    from demfi_torch.ops import kernels
    from demfi_torch.train import create_train_state, make_train_step
    from demfi_torch.utils.grad_check import GRAD_TOL, rel_frobenius
    from demfi_torch.utils.profiling import calibrate_flow_head

    frames = torch.from_numpy(inputs["batch"]).to(dev)
    t_dev = torch.from_numpy(inputs["t"]).to(dev)

    def mode_cfg(dtype, mode, **kw):
        return config_rb(5, 3, seed=SEED, compute_dtype=dtype,
                         remat_backbone=mode is not None,
                         remat_granularity=mode or "backbone", **kw)

    def fresh(cfg, weights):
        m = make_model(cfg, device=dev)
        m.load_state_dict(weights, strict=True)
        return m

    rows = {}
    for dtype in ("float32", "bfloat16"):
        for mode in REMAT_MODES:
            cfg = mode_cfg(dtype, mode)
            model = fresh(cfg, inputs["weights"])
            check(model.remat == mode, f"9(a): model.remat {model.remat}")
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            losses, secs, split = [], [], []
            with torch.enable_grad():
                state = create_train_state(cfg, model)
                step = make_train_step(cfg)
                for _ in range(REMAT_STEPS):
                    ev = {k: torch.cuda.Event(enable_timing=True)
                          for k in ("start", "forward", "backward",
                                    "optimizer")}
                    t0 = time.perf_counter()
                    ev["start"].record()
                    m_ = step(state, frames, t_dev,
                              on_phase=lambda phase: ev[phase].record())
                    losses.append(float(m_["total_loss"]))
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                    split.append([ev["start"].elapsed_time(ev["forward"]),
                                  ev["forward"].elapsed_time(ev["backward"])])
            counts = kernels.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            want = {k: v * REMAT_STEPS for k, v in TRAIN_LAUNCHES.items()}
            check(counts == want, f"9(a) {dtype} remat {mode}: launches "
                                  f"{counts} != {want}")
            check(all(np.isfinite(losses)), f"9(a) {dtype} remat {mode}: "
                                            f"losses {losses}")
            rows[(dtype, mode)] = dict(
                step_s=float(np.median(secs[1:])), step_seconds=secs,
                losses=losses, peak_bytes=peak,
                forward_backward_ms=np.median(np.array(split[1:]),
                                              axis=0).tolist(),
                launches_per_step={k: v / REMAT_STEPS
                                   for k, v in counts.items()})
            del model, state, step
            torch.cuda.empty_cache()
    gib = 2 ** 30
    for dtype in ("float32", "bfloat16"):
        plain = rows[(dtype, None)]
        for mode in REMAT_MODES:
            r = rows[(dtype, mode)]
            d_peak = (r["peak_bytes"] - plain["peak_bytes"]) / gib
            pred = REMAT_PREDICTED_GIB.get(mode)
            rate = rates[dtype]
            say(f"[9a remat] {dtype}, remat {mode or 'none'}: "
                f"{REMAT_STEPS} steps of DeMFI-Net_rb(5,3) at "
                f"{TRAIN_B}x{TRAIN_PS}x{TRAIN_PS} from 7(c)'s weights and "
                f"batch, seconds {['%.4f' % v for v in r['step_seconds']]}, "
                f"median after the first {r['step_s']:.4f} s "
                f"({100 * (r['step_s'] / plain['step_s'] - 1):+.1f} % against "
                f"none; 7(c) {TRAIN_B / rate:.4f} s); device ms forward "
                f"{r['forward_backward_ms'][0]:.2f}, backward "
                f"{r['forward_backward_ms'][1]:.2f}; peak allocated "
                f"{r['peak_bytes'] / gib:.3f} GiB ({d_peak:+.3f} GiB "
                f"against none"
                + (f"; predicted {pred[0]:+.1f} to {pred[1]:+.1f} GiB at "
                   f"float32" if pred else "")
                + f"); launches per step {r['launches_per_step']}")

    # ---- exactness: the stencil forward warp and deterministic cuDNN
    inputs4 = frames[:, :4].permute(0, 1, 4, 2, 3).contiguous()
    exact = {}
    torch.backends.cudnn.deterministic = True
    try:
        for dtype in ("float32", "bfloat16"):
            base = mode_cfg(dtype, None, fwarp_shift_d=SHIFT_D)
            cal = fresh(base, inputs["weights"])
            calibrate_flow_head(cal, inputs4, EVAL_FLOW_PX)
            weights = {k: v.detach().clone()
                       for k, v in cal.state_dict().items()}
            del cal

            def grads(mode):
                cfg = mode_cfg(dtype, mode, fwarp_shift_d=SHIFT_D)
                model = fresh(cfg, weights)
                got = {}

                def snap(phase):
                    if phase == "backward":
                        got.update({k: p.grad.detach().clone()
                                    for k, p in model.named_parameters()
                                    if p.grad is not None})
                kernels.fwarp_served(dev, reset=True)
                with torch.enable_grad():
                    make_train_step(cfg)(create_train_state(cfg, model),
                                         frames, t_dev, on_phase=snap)
                served = kernels.fwarp_served(dev)
                check(served == {"fwarp_shift": SPLATS_PER_WINDOW,
                                 "fwarp_splat": 0},
                      f"9(a) exactness {dtype} {mode}: forward warps served "
                      f"by {served}")
                return got
            a, b = grads(None), grads(None)
            plain_bitwise = a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) for k in a)
            res = {"plain_bitwise": plain_bitwise}
            for mode in REMAT_MODES[1:]:
                g = grads(mode)
                check(g.keys() == a.keys(), f"9(a) {dtype} {mode}: other "
                                            f"parameters have gradients")
                bitwise = all(torch.equal(g[k], a[k]) for k in a)
                worst = max(rel_frobenius(g[k].cpu(), a[k].cpu()) for k in a)
                if plain_bitwise:
                    check(bitwise, f"9(a) {dtype} remat {mode}: gradients "
                                   f"not bitwise the plain step's (worst "
                                   f"{worst:.3g}), while two plain steps are")
                else:
                    for k in a:
                        bound = max(GRAD_TOL, 2 * rel_frobenius(
                            b[k].cpu(), a[k].cpu()))
                        err = rel_frobenius(g[k].cpu(), a[k].cpu())
                        check(err <= bound, f"9(a) {dtype} remat {mode} {k}: "
                                            f"{err:.3g} > {bound:.3g}")
                res[mode] = dict(bitwise=bitwise, worst_rel_frobenius=worst)
            exact[dtype] = res
            say(f"[9a remat] exactness, {dtype}, cudnn.deterministic, "
                f"--fwarp_shift_d {SHIFT_D} (flow head calibrated to "
                f"{EVAL_FLOW_PX} px, every CFR warp on the stencil): two "
                f"plain steps bitwise equal: {plain_bitwise}; "
                + "; ".join(f"remat {m}: gradients bitwise the plain step's "
                            f"{res[m]['bitwise']} (worst relative Frobenius "
                            f"{res[m]['worst_rel_frobenius']:.3g})"
                            for m in REMAT_MODES[1:])
                + ("" if plain_bitwise else
                   f"; held to max({GRAD_TOL:.0e}, twice the plain runs' "
                   f"own change) per tensor"))
    finally:
        torch.backends.cudnn.deterministic = False
    del frames, t_dev, inputs4
    torch.cuda.empty_cache()
    return dict(rows={f"{d} {m or 'none'}": r for (d, m), r in rows.items()},
                exact=exact, predicted_gib=REMAT_PREDICTED_GIB)


def loader_phase(tmp: Path, rates: dict) -> dict:
    """Phase 9(b): TrainLoader's samples/s at 256x256 patches on one
    synthetic scene at Adobe240's 1280x720 (written with imageio; the 15
    frames a sample can read are full PNGs, the others of the scene
    links to one of them; LOADER_SCENES scene directories link to it),
    with the native augment and with the numpy chain, beside the
    seconds a sample spends decoding its 9 PNGs on one thread."""
    from demfi_torch.data import AdobeTrainDataset, TrainLoader, imageio

    rng = np.random.RandomState(SEED + 9)
    root = tmp / "loader_data"
    blur_ids = [17 + 8 * k for k in range(4)]
    # first = 1: S-1 16, S0 24, St 25..31, S1 32, S2 40
    read = {16, 40} | set(range(24, 33))
    sharp0, blur0 = root / "train" / "scene0", root / "train_blur" / "scene0"
    sharp0.mkdir(parents=True)
    blur0.mkdir(parents=True)
    low = rng.uniform(0, 255, (LOADER_H // 16, LOADER_W // 16, 3))
    base = np.repeat(np.repeat(low, 16, 0), 16, 1)

    def frame(i):
        noise = rng.randint(-6, 7, base.shape)
        return np.clip(np.roll(base, i, axis=1) + noise, 0, 255).astype(
            np.uint8)
    t0 = time.perf_counter()
    for i in sorted(read):
        imageio.imwrite(str(sharp0 / f"{i:05d}.png"), frame(i))
    for i in range(blur_ids[-1]):
        if i not in read:
            os.symlink(sharp0 / "00016.png", sharp0 / f"{i:05d}.png")
    for i in blur_ids:
        imageio.imwrite(str(blur0 / f"{i:05d}.png"), frame(i))
    for sc in range(1, LOADER_SCENES):
        for split in ("train", "train_blur"):
            os.symlink(root / split / "scene0", root / split / f"scene{sc}")
    write_s = time.perf_counter() - t0
    png_mb = np.mean([os.path.getsize(sharp0 / f"{i:05d}.png")
                      for i in read]) / 2 ** 20

    sample_files = ([str(blur0 / f"{i:05d}.png") for i in blur_ids]
                    + [str(sharp0 / f"{i:05d}.png") for i in (28, 24, 32,
                                                              16, 40)])

    def per_sample(read_fn):
        t0 = time.perf_counter()
        for f in sample_files:
            read_fn(f)
        return time.perf_counter() - t0
    decode_s = per_sample(imageio.imread)
    zlib_s = per_sample(imageio.read_png)
    # cv2 writes PNGs with row filters, which the zlib route undoes in
    # H + W - 1 numpy steps; the zlib route writes filter 0 only
    route = "cv2" if imageio._cv2() is not None else "zlib"

    out = {}
    for native in (True, False):
        ds = AdobeTrainDataset(str(root), patch_size=TRAIN_PS,
                               use_native=native)
        loader = TrainLoader(ds, TRAIN_B, num_threads=8, seed=SEED)
        for _ in loader.epoch(0):                       # warm-up
            pass
        n, t0 = 0, time.perf_counter()
        for e in range(1, 1 + LOADER_EPOCHS):
            for fr, _ in loader.epoch(e):
                check(fr.shape == (TRAIN_B, 9, TRAIN_PS, TRAIN_PS, 3)
                      and fr.dtype == np.float32,
                      f"9(b): a batch of {fr.shape} {fr.dtype}")
                n += fr.shape[0]
        out["native" if native else "numpy"] = n / (time.perf_counter() - t0)
    say(f"[9b loader] TrainLoader, 8 threads, {TRAIN_PS}x{TRAIN_PS} patches "
        f"from {LOADER_W}x{LOADER_H} PNGs ({png_mb:.2f} MiB each, "
        f"{len(read) + len(blur_ids)} written in {write_s:.2f} s), "
        f"{LOADER_EPOCHS} epochs of {LOADER_SCENES} samples after a warm-up: "
        f"{out['native']:.3f} samples/s with the native augment, "
        f"{out['numpy']:.3f} with the numpy chain; one sample's 9 PNGs "
        f"(written and read by {route}) decode in {decode_s:.4f} s on one "
        f"thread through imageio.imread, {zlib_s:.4f} s through the zlib "
        f"route; against the "
        f"train step's {rates['float32']:.3f} samples/s (7(c), float32) and "
        f"{rates['bfloat16']:.3f} (7(c'), bfloat16)")
    return dict(samples_per_s=out, decode_s_per_sample=decode_s,
                zlib_decode_s_per_sample=zlib_s, decoder=route,
                png_mib=png_mb, step_samples_per_s=rates)


def tools_phase(torch, dev, tmp: Path, ckpt: str) -> dict:
    """Phase 9(c): import_pt -> export_pt -> import_pt on phase 6's
    checkpoint: the two msgpack files (and their json) byte-identical,
    the exported .pt loads strictly with every tensor bitwise the
    original's, and a window through the reloaded model within 1e-3 of
    the original's on the card."""
    from demfi_torch import tools
    from demfi_torch.checkpoint import load_checkpoint
    from demfi_torch.config import config_rb
    from demfi_torch.infer import InferenceEngine, WindowResult
    from demfi_torch.models import make_model
    from demfi_torch.ops import kernels

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        first = tools.import_pt(ckpt, str(tmp / "tools_a"))
        exported = tools.export_pt(first + ".msgpack",
                                   str(tmp / "tools_exported.pt"))
        second = tools.import_pt(exported, str(tmp / "tools_b"))
    wall = time.perf_counter() - t0
    for ext in (".msgpack", ".json"):
        check(Path(first + ext).read_bytes() == Path(second + ext).read_bytes(),
              f"9(c): the two imports' {ext} files differ")
    orig, _ = load_checkpoint(ckpt)
    back, meta = load_checkpoint(exported)
    check(list(back) == list(orig)
          and all(torch.equal(back[k], orig[k]) for k in orig),
          "9(c): the exported .pt's tensors are not the original's")
    cfg = config_rb(5, 3, seed=SEED)
    models = []
    for sd in (orig, back):
        m = make_model(cfg, device=dev)
        m.load_state_dict(sd, strict=True)
        models.append(m)
    rng = np.random.RandomState(SEED + 11)
    small = rng.uniform(-1, 1, (1, 4, SMALL_H, SMALL_W, 3)).astype(np.float32)
    ts = (np.arange(1, M, dtype=np.float32) / M)[None]
    kernels.reset_launch_counts()
    a, b = (InferenceEngine(m, num_update=cfg.N_tst, device=dev)
            .forward_windows(small, ts)[0] for m in models)
    counts = kernels.launch_counts()
    check(counts["bilinear_gather"] == 2 * GATHERS_PER_WINDOW
          and counts["fwarp_splat"] == 2 * SPLATS_PER_WINDOW,
          f"9(c): launches {counts}")
    gap = max(float(np.abs(getattr(a, f.name) - getattr(b, f.name)).max())
              for f in dataclasses.fields(WindowResult))
    check(gap <= PATH_ATOL, f"9(c): the reloaded model's window is {gap} off")
    mib = os.path.getsize(first + ".msgpack") / 2 ** 20
    say(f"[9c tools] import_pt -> export_pt -> import_pt on phase 6's "
        f"checkpoint in {wall:.2f} s: msgpack {mib:.1f} MiB, both imports "
        f"byte-identical (msgpack and json {meta}); the exported .pt loads "
        f"strictly, {len(back)} tensors bitwise the original's; a x{M} "
        f"window at {SMALL_H}x{SMALL_W} through the reloaded model within "
        f"{gap:.3g} of the original's (tol {PATH_ATOL:.0e}); launches "
        f"{counts}")
    del models
    torch.cuda.empty_cache()
    return dict(seconds=wall, msgpack_mib=mib, window_gap=gap)


def harness_phase(torch, dev, tmp: Path, ckpt: str, phase6: tuple,
                  n_windows: int) -> dict:
    """Phase 9(d): ``python -m demfi_torch.scripts.repro_table2``'s main
    on phase 6's tree and checkpoint at x8, --budget_db inf: exit 0,
    finite metrics, the x8 window's launches, and PSNR within
    HARNESS_PSNR_TOL of phase 6's float32 --phase test on the same
    weights."""
    from demfi_torch.ops import kernels
    from demfi_torch.scripts import repro_table2

    wd = tmp / "table2"
    out = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = repro_table2.main(["--data", str(tmp / "data"), "--ckpt", ckpt,
                                "--multiples", str(M), "--budget_db", "inf",
                                "--N_tst", "3", "--workdir", str(wd),
                                "--device", str(dev)])
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(rc == 0, f"9(d): repro_table2 exit {rc}:\n{out.getvalue()}")
    rep = json.loads((wd / "repro_table2.json").read_text())
    r = rep["results"][f"x{M}"]
    check(all(np.isfinite(r[k]) for k in ("interp_psnr", "interp_ssim",
                                          "deblur_psnr", "deblur_ssim")),
          f"9(d): metrics {r}")
    check(counts == {"bilinear_gather": GATHERS_PER_WINDOW * n_windows,
                     "fwarp_splat": SPLATS_PER_WINDOW * n_windows,
                     "fwarp_shift": 0, "bilinear_gather_bwd": 0,
                     "fwarp_splat_bwd": 0}, f"9(d): launches {counts}")
    d_i = r["interp_psnr"] - phase6[1]
    d_d = r["deblur_psnr"] - phase6[3]
    check(abs(d_i) <= HARNESS_PSNR_TOL and abs(d_d) <= HARNESS_PSNR_TOL,
          f"9(d): PSNR {r['interp_psnr']}, {r['deblur_psnr']} against phase "
          f"6's {phase6[1]}, {phase6[3]}")
    table = [ln for ln in out.getvalue().splitlines()
             if ln.startswith(("adobe", "metric"))]
    say(f"[9d table2] python -m demfi_torch.scripts.repro_table2 --multiples "
        f"{M} --budget_db inf --N_tst 3 on phase 6's tree and checkpoint: "
        f"exit {rc} in {wall:.2f} s (x{M} evaluation {r['wall_s']:.2f} s); "
        f"intp PSNR {r['interp_psnr']:.4f} ({d_i:+.2e} dB against phase 6's "
        f"--phase test), deblur PSNR {r['deblur_psnr']:.4f} ({d_d:+.2e}; tol "
        f"{HARNESS_PSNR_TOL:.0e}), SSIM {r['interp_ssim']:.6f} / "
        f"{r['deblur_ssim']:.6f}; launches {counts}; its table:\n"
        + "\n".join(table))
    return dict(rc=rc, wall_s=wall, results=r,
                psnr_gap_db=[d_i, d_d], launches=counts)


def sanity_phase(dev, tmp: Path) -> dict:
    """Phase 9(e): demfi_torch.scripts.synthetic_sanity at its defaults
    on the card: it must pass (+6 dB on both metrics)."""
    from demfi_torch.ops import kernels
    from demfi_torch.scripts import synthetic_sanity

    lines = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # evaluate's tables
        res = synthetic_sanity.run(str(tmp / "sanity"), device=str(dev),
                                   log=lines.append)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check(all(counts[k] > 0 for k in ("bilinear_gather", "fwarp_splat",
                                      "bilinear_gather_bwd",
                                      "fwarp_splat_bwd")),
          f"9(e): launches {counts}")
    check(res["ok"] and "SANITY PASS" in lines,
          "9(e): synthetic_sanity did not pass:\n" + "\n".join(lines))
    (i0, i1), (d0, d1) = res["interp_db"], res["deblur_db"]
    say(f"[9e sanity] synthetic_sanity, {res['steps']} steps of "
        f"DeMFI-Net_rb(1,1) at batch 2, 48x48: interp {i0:.2f} -> {i1:.2f} "
        f"dB ({i1 - i0:+.2f}), deblur {d0:.2f} -> {d1:.2f} dB "
        f"({d1 - d0:+.2f}); SANITY PASS in {wall:.2f} s (data "
        f"{res['generate_s']:.2f} s, one evaluation {res['eval_s']:.2f} s, "
        f"training {res['train_s']:.2f} s); launches {counts}")
    return dict(res, wall_s=wall, launches=counts)


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


def cfr_bwd_halves(torch, dev) -> list:
    """CFR's two splat halves at the train step's shapes (batch 2, C = 2,
    256x256) on smooth synthetic flows of up to ~20 px, each [img, flo,
    grad_out, grad_norm], made from SEED on the card."""
    b, c, h, w = TRAIN_B, 2, TRAIN_PS, TRAIN_PS
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    field = np.stack([3 * np.sin(xx / 40.0 + yy / 30.0),
                      2 * np.cos(yy / 35.0)])[None]
    halves = []
    for seed in (1, 2):
        rng = np.random.RandomState(SEED + seed)
        img = field * rng.uniform(3, 8, (b, 1, 1, 1))
        halves.append([torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(dev) for x in (
            img, 0.4 * img, rng.randn(b, c, h, w), rng.randn(b, 1, h, w))])
    return halves


def splat_bwd_timings(torch, dev, kernels, warp) -> dict:
    """Phase 3d (``--kernels-of`` only): the splat's backward on CFR's two
    halves (cfr_bwd_halves), so that two checkouts compare in one run: per
    step the median of SPLAT_BWD_CALLS cold calls and of as many back to
    back, of one launch a half (every checkout) and of one launch on both
    halves (``fwarp_splat_bwd_pair``, where the checkout has it), each
    against the plain vjp. Returns the times."""
    b, c, h, w = TRAIN_B, 2, TRAIN_PS, TRAIN_PS
    halves = cfr_bwd_halves(torch, dev)
    want = [t for half in halves for t in warp.fwarp_splat_plain_vjp(*half)]
    fns = {"one launch a half": lambda: [kernels.fwarp_splat_bwd(*half)
                                         for half in halves]}
    if hasattr(kernels, "fwarp_splat_bwd_pair"):
        fns["one launch on both halves"] = (
            lambda: kernels.fwarp_splat_bwd_pair(*halves[0], *halves[1]))
    timer = DeviceTimer(torch)
    out = {}
    for name, fn in fns.items():
        got = [t for half in fn() for t in half]
        err = max(float((g - p).abs().max()) / max(1.0, float(p.abs().max()))
                  for g, p in zip(got, want))
        check(err <= BWD_RTOL, f"3d splat bwd {name}: {err} from the plain vjp")
        out[name] = dict(
            ms=float(np.median(timer.times(fn, SPLAT_BWD_CALLS))),
            ms_back_to_back=float(np.median(timer.back_to_back(
                fn, SPLAT_BWD_CALLS))), max_rel_err=err)
        say(f"[3d splat bwd] C={c} 2x{b} {h}x{w} smooth, {name}: per step "
            f"{out[name]['ms']:.4f} ms cold, {out[name]['ms_back_to_back']:.4f}"
            f" back to back (medians of {SPLAT_BWD_CALLS}) | max err "
            f"{err:.3g} of the largest value (tol {BWD_RTOL:.0e})")
    del timer
    torch.cuda.empty_cache()
    return out


def row_offset_checks(torch, dev, kernels, warp, timer, a, b, ft0, ft1,
                      flow_01, t, peak) -> list:
    """Phase 3e: each forward kernel on the rows of a frame split in
    ROW_OFFSET_SPLITS ways, on every shard, at the main path's shapes
    (352x640, x8): the gather pair (C=64, float32 and bfloat16 images) at
    its row offset against its plain version and against the unsplit
    kernel's rows; the splat of a shard's source rows into the whole
    frame's canvas against its plain version, and the shards' canvases
    summed against the unsplit kernel; the stencil on a shard's rows with
    its halo against its plain version and the unsplit kernel's rows, bit
    for bit. Times (device ms, cold) of shard 0 of each split. Returns the
    rows of the kernels line's "row_offset" entries; a checkout whose
    kernels take no row offsets (``--kernels-of``) returns []."""
    rows_arg = "row0" in inspect.signature(kernels.bilinear_gather).parameters
    if not rows_arg:
        say("[3e row offsets] not checked: this checkout's kernels take no "
            "row offsets")
        return []
    out = []
    whole_g = kernels.bilinear_gather_pair(a, b, ft0, ft1, True)[0]
    a16, b16 = a.bfloat16(), b.bfloat16()
    whole_g16 = kernels.bilinear_gather_pair(a16, b16, ft0, ft1, True)[0]
    img_s = flow_01
    flo_s = (t * flow_01).contiguous()
    whole_s = kernels.fwarp_splat(img_s, flo_s)
    img_k = (flow_01 * ((SHIFT_D - 1.1) / peak)).contiguous()
    flo_k = (t * img_k).contiguous()
    whole_k = kernels.fwarp_shift(img_k, flo_k, SHIFT_D)
    for split in ROW_OFFSET_SPLITS:
        rows = H // split
        canvas = [torch.zeros_like(v) for v in whole_s]
        for i in range(split):
            r0, r1 = i * rows, (i + 1) * rows
            c0, c1 = (f[:, :, r0:r1].contiguous() for f in (ft0, ft1))
            timed = i == 0
            # the gather, float32 and bfloat16 images
            for tag, (ia, ib), whole, tol in (
                    ("float32", (a, b), whole_g, GATHER_TOL),
                    ("bfloat16", (a16, b16), whole_g16, GATHER_BF16_ROW_TOL)):
                def call(ia=ia, ib=ib):
                    return kernels.bilinear_gather_pair(ia, ib, c0, c1, True,
                                                        row0=r0)[0]

                def plain(ia=ia, ib=ib):
                    return (warp.bilinear_gather_plain(ia, c0, True, r0)[0],
                            warp.bilinear_gather_plain(ib, c1, True, r0)[0])
                got, want = call(), plain()
                scale = max(float(w.abs().max()) for w in want)
                err = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
                same = all(torch.equal(g, w[:, :, r0:r1])
                           for g, w in zip(got, whole))
                check(err <= tol * scale and same,
                      f"row-offset gather {tag} split {split} shard {i}: err "
                      f"{err} (tol {tol * scale}), equal to the unsplit "
                      f"kernel's rows: {same}")
                out.append(dict(
                    kernel="bilinear_gather", image_dtype=tag, split=split,
                    shard=i, rows=[r0, r1], max_abs_err=err, tol=tol * scale,
                    equal_to_unsplit_rows=same,
                    ms=timer.ms(call, 5) if timed else None,
                    plain_ms=timer.ms(plain, 2) if timed else None))
            # the splat of this shard's source rows into the whole canvas
            il, fl = img_s[:, :, r0:r1].contiguous(), \
                flo_s[:, :, r0:r1].contiguous()

            def call():
                return kernels.fwarp_splat(il, fl, rows=(r0, H))

            def plain():
                return warp.fwarp_splat_plain(il, fl, (r0, H))
            got, want = call(), plain()
            for cv, g in zip(canvas, got):
                cv += g
            scale = max(1.0, float(want[0].abs().max()))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            check(err <= SPLAT_RTOL * scale,
                  f"row-offset splat split {split} shard {i}: err {err}")
            out.append(dict(
                kernel="fwarp_splat", split=split, shard=i, rows=[r0, r1],
                max_abs_err=err, tol=SPLAT_RTOL * scale,
                ms=timer.ms(call, 5) if timed else None,
                plain_ms=timer.ms(plain, 2) if timed else None))
            # the stencil on this shard's rows and its halo
            lo, hi = max(r0 - SHIFT_D - 1, 0), min(r1 + SHIFT_D, H)
            ih, fh = (v[:, :, lo:hi].contiguous() for v in (img_k, flo_k))

            def call():
                return kernels.fwarp_shift(ih, fh, SHIFT_D, rows=(r0 - lo, rows))

            def plain():
                return warp.fwarp_shift_plain(ih, fh, SHIFT_D, (r0 - lo, rows))
            got, want = call(), plain()
            bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
            same = all(torch.equal(g, w[:, :, r0:r1])
                       for g, w in zip(got, whole_k))
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            check(bitwise and same,
                  f"row-offset stencil split {split} shard {i}: bitwise equal "
                  f"to plain {bitwise}, to the unsplit kernel's rows {same}")
            out.append(dict(
                kernel="fwarp_shift", split=split, shard=i, rows=[r0, r1],
                halo=[r0 - lo, hi - r1], max_abs_err=err, tol=0.0,
                bitwise_equal_to_plain=bitwise, equal_to_unsplit_rows=same,
                ms=timer.ms(call, 5) if timed else None,
                plain_ms=timer.ms(plain, 2) if timed else None))
        scale = max(1.0, float(whole_s[0].abs().max()))
        err = max(float((c - w).abs().max()) for c, w in zip(canvas, whole_s))
        check(err <= SPLAT_RTOL * scale,
              f"row-offset splat split {split}: summed canvases err {err}")
        out.append(dict(kernel="fwarp_splat", split=split, shard="sum",
                        max_abs_err=err, tol=SPLAT_RTOL * scale))
    for kname in ("bilinear_gather", "fwarp_splat", "fwarp_shift"):
        mine = [r for r in out if r["kernel"] == kname]
        worst = max(r["max_abs_err"] / max(r["tol"], 1e-30)
                    if r["tol"] else r["max_abs_err"] for r in mine)
        times = ", ".join(
            f"{r['split']}-way shard 0{' ' + r['image_dtype'] if 'image_dtype' in r else ''}"
            f" {r['ms']:.4f} ms (plain {r['plain_ms']:.4f})"
            for r in mine if r.get("ms") is not None)
        say(f"[3e row offsets] {kname}: {len(mine)} checks on {ROW_OFFSET_SPLITS}"
            f"-way splits of {H}x{W}, every shard; worst "
            f"{'err/tol' if kname != 'fwarp_shift' else 'abs err (bitwise)'} "
            f"{worst:.3g}; {times}")
    del whole_g, whole_g16, a16, b16, whole_s, whole_k
    return out


def row_offset_bwd_checks(torch, dev, kernels, warp) -> list:
    """Phase 3f (also under ``--kernels-of``): the two backward kernels at
    their row offsets, on every shard of ROW_OFFSET_SPLITS-way splits of
    the train step's frame (batch 2, 256x256): the gather's backward at
    its three sites (gather_bwd_sites: the C=64 feature pair and the C=3
    booster pair at ``row0``, float32 and bfloat16 images, and FGAC's
    absolute sample of a shard's query rows) and the splat's backward on
    CFR's two halves in one launch (cfr_bwd_halves, ``rows=(r0, H)``, the
    whole frame's cotangents). Each shard against its plain vjp (1e-5 of
    the largest value; a bfloat16 image's gradient 1e-2), and against the
    unsplit kernel after the group's reduction: the shards' image
    gradients summed (the backward of ``allgather_rows``) within the same
    tolerance, the coordinates' and the splat's gradients the unsplit
    rows bit for bit. Device ms and enqueue us of shard 0 beside the
    unsplit launch's, its plain vjp's ms and its bound (7(a)'s count of
    bytes and operations on shard 0's inputs: the gather's image gradient
    is the whole frame's, zero fill included; the splat's cotangents are
    read where shard 0's corners land). Returns the rows (the kernels
    line's "row_offset" entries of the two backward kernels); a checkout
    whose backward kernels take no row offsets returns []."""
    if "row0" not in inspect.signature(kernels.bilinear_gather_bwd).parameters:
        say("[3f row-offset backwards] not counted: this checkout's backward "
            "kernels take no row offsets")
        return []
    timer = DeviceTimer(torch)
    out = []
    ps = TRAIN_PS

    def rows_of(t, r0, r1):
        return t[:, :, r0:r1].contiguous()
    for site, (halves, relative) in gather_bwd_sites(torch, dev).items():
        bf16 = halves[0][0].dtype == torch.bfloat16
        if bf16 and not relative:
            continue            # FGAC samples float32 in the bf16 model
        img_tol = BWD_BF16_IMG_RTOL if bf16 else BWD_RTOL

        def part_of(r0, r1):
            return [(i, rows_of(co, r0, r1), rows_of(go, r0, r1))
                    for i, co, go in halves]

        def call(part=halves, r0=None, plain=False):
            """[grad_img per half] + [grad_coords per half] of the halves'
            query rows ``part``, rows [r0, ...) (all of them for r0
            None)."""
            row0 = {} if r0 is None or not relative else {"row0": r0}
            if plain:
                got = [warp.bilinear_gather_plain_vjp(
                    i, co, relative, go, row0.get("row0", 0))
                    for i, co, go in part]
                return [g[0] for g in got] + [g[1] for g in got]
            if len(part) == 1:
                return list(kernels.bilinear_gather_bwd(
                    *part[0][:2], relative, part[0][2], **row0))
            (a, fa, ga), (b, fb, gb) = part
            gi, gc = kernels.bilinear_gather_pair_bwd(a, b, fa, fb, ga, gb,
                                                      relative, **row0)
            return list(gi) + list(gc)
        n = len(halves)
        whole = call()
        for split in ROW_OFFSET_SPLITS:
            rows = ps // split
            summed = [torch.zeros_like(g, dtype=torch.float32)
                      for g in whole[:n]]
            worst, coords_equal = 0.0, True
            for i in range(split):
                r0, r1 = i * rows, (i + 1) * rows
                part = part_of(r0, r1)
                got, want = call(part, r0), call(part, r0, plain=True)
                for k, (g, p) in enumerate(zip(got, want)):
                    tol = img_tol if k < n else BWD_RTOL
                    err = float((g.float() - p.float()).abs().max()) / max(
                        1e-30, float(p.float().abs().max()))
                    check(err <= tol, f"3f {site} split {split} shard {i} "
                                      f"output {k}: {err:.3g} of the largest "
                                      f"value from the plain vjp (tol {tol})")
                    worst = max(worst, err / tol)
                for acc, g in zip(summed, got[:n]):
                    acc += g.float()
                coords_equal &= all(torch.equal(g, w[:, :, r0:r1])
                                    for g, w in zip(got[n:], whole[n:]))
            sum_err = max(float((acc - w.float()).abs().max())
                          / float(w.float().abs().max())
                          for acc, w in zip(summed, whole[:n]))
            check(sum_err <= img_tol and coords_equal,
                  f"3f {site} split {split}: summed image gradients "
                  f"{sum_err:.3g} from the unsplit kernel's (tol {img_tol}), "
                  f"coordinates' gradients bitwise its rows: {coords_equal}")
            part = part_of(0, rows)
            nbytes = ops = 0
            for img, co, _ in part:
                live, reached = gather_bwd_counts(torch, warp, co, relative,
                                                  ps, ps)
                c = img.shape[1]
                nbytes += (4 * (live * c + 2 * co.numel())
                           + img.element_size() * (reached * c + img.numel()))
                ops += live * (24 * c + 30)
            r = dict(kernel="bilinear_gather_bwd", site=site, split=split,
                     image_dtype="bfloat16" if bf16 else "float32",
                     worst_err_over_tol=worst, summed_err=sum_err,
                     coords_equal_to_unsplit_rows=coords_equal,
                     ms=timer.ms(lambda: call(part, 0), 5),
                     enqueue_us=enqueue_us(torch, lambda: call(part, 0),
                                           ENQUEUE_CALLS),
                     plain_ms=timer.ms(lambda: call(part, 0, plain=True), 2),
                     **bound_of(nbytes, ops),
                     unsplit_ms=timer.ms(call, 5),
                     unsplit_enqueue_us=enqueue_us(torch, call,
                                                   ENQUEUE_CALLS))
            out.append(r)
            say(f"[3f row-offset backwards] gather bwd {site}, {split}-way: "
                f"{split} shards against the plain vjp, worst {worst:.3g} of "
                f"the tolerance; image gradients summed {sum_err:.3g} of the "
                f"largest value from the unsplit kernel's, coordinates' "
                f"bitwise its rows: {coords_equal}; shard 0 {r['ms']:.4f} ms "
                f"device, {r['enqueue_us']:.1f} us enqueue, bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain vjp "
                f"{r['plain_ms']:.4f} ms (unsplit {r['unsplit_ms']:.4f} ms, "
                f"{r['unsplit_enqueue_us']:.1f} us)")
    halves = cfr_bwd_halves(torch, dev)

    def splat_part(r0, r1):
        return [[rows_of(h[0], r0, r1), rows_of(h[1], r0, r1), h[2], h[3]]
                for h in halves]

    def splat(part=halves, r0=None, plain=False):
        rows = {} if r0 is None else {"rows": (r0, ps)}
        if plain:
            return [t for h in part for t in warp.fwarp_splat_plain_vjp(
                *h, rows.get("rows"))]
        return [t for pair in kernels.fwarp_splat_bwd_pair(
            *part[0], *part[1], **rows) for t in pair]
    whole = splat()
    for split in ROW_OFFSET_SPLITS:
        rows = ps // split
        worst, equal = 0.0, True
        for i in range(split):
            r0, r1 = i * rows, (i + 1) * rows
            part = splat_part(r0, r1)
            got, want = splat(part, r0), splat(part, r0, plain=True)
            for g, p in zip(got, want):
                err = float((g - p).abs().max()) / max(
                    1e-30, float(p.abs().max()))
                check(err <= BWD_RTOL, f"3f splat bwd split {split} shard "
                                       f"{i}: {err:.3g} from the plain vjp")
                worst = max(worst, err / BWD_RTOL)
            equal &= all(torch.equal(g, w[:, :, r0:r1])
                         for g, w in zip(got, whole))
        check(equal, f"3f splat bwd split {split}: not the unsplit kernel's "
                     f"rows bit for bit")
        part = splat_part(0, rows)
        nbytes = ops = 0
        for img, flo, _, _ in part:
            reached = splat_targets(torch, flo, 0, ps)
            live = int(torch.isfinite(flo).all(1).sum())
            c = img.shape[1]
            nbytes += 4 * (2 * img.numel() + reached * (c + 1)
                           + 2 * flo.numel())
            ops += 4 * live * (4 * c + 10)
        r = dict(kernel="fwarp_splat_bwd", site="CFR pair", split=split,
                 image_dtype="float32", worst_err_over_tol=worst,
                 equal_to_unsplit_rows=equal,
                 ms=float(np.median(timer.times(lambda: splat(part, 0),
                                                SPLAT_BWD_CALLS))),
                 enqueue_us=enqueue_us(torch, lambda: splat(part, 0),
                                       ENQUEUE_CALLS),
                 plain_ms=timer.ms(lambda: splat(part, 0, plain=True), 2),
                 **bound_of(nbytes, ops),
                 unsplit_ms=float(np.median(timer.times(splat,
                                                        SPLAT_BWD_CALLS))),
                 unsplit_enqueue_us=enqueue_us(torch, splat, ENQUEUE_CALLS))
        out.append(r)
        say(f"[3f row-offset backwards] splat bwd, CFR's two halves in one "
            f"launch, {split}-way: worst {worst:.3g} of the tolerance against "
            f"the plain vjp; bitwise the unsplit kernel's rows: {equal}; "
            f"shard 0 {r['ms']:.4f} ms device (median of {SPLAT_BWD_CALLS} "
            f"cold), {r['enqueue_us']:.1f} us enqueue, bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, plain vjp "
            f"{r['plain_ms']:.4f} ms (unsplit {r['unsplit_ms']:.4f} ms, "
            f"{r['unsplit_enqueue_us']:.1f} us)")
    del timer
    torch.cuda.empty_cache()
    return out


def spatial_rank(work: Path, rank: int) -> int:
    """One rank of phase 10 (chip_smoke.py --spatial-rank R --spatial-dir
    DIR, started by spatial_phase): joins the group spec.json names,
    runs the split engine on phase 4's window and weights at float32 and
    bfloat16, times windows at 352x640 and 1080p (and UHD with four
    cards), then ``cli --phase test`` on phase 6's tree with
    --mesh_spatial; writes rank<R>.json and, on rank 0, the results."""
    spec = json.loads((work / "spec.json").read_text())
    sys.path.insert(0, spec["tree"])
    import torch
    from demfi_torch import disable_tf32
    from demfi_torch.config import config_rb
    from demfi_torch.infer import InferenceEngine
    from demfi_torch.main import cli
    from demfi_torch.models import make_model
    from demfi_torch.ops import kernels
    from demfi_torch.parallel import (destroy_distributed, init_distributed,
                                      make_grid)
    from demfi_torch.parallel import halo

    size, backend = spec["size"], spec["backend"]
    init_distributed(f"127.0.0.1:{spec['port']}", size, rank, "cuda", backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    grid = make_grid(0, size)
    disable_tf32()
    torch.set_grad_enabled(False)
    weights = torch.load(work / "weights.pt")
    frames = np.load(work / "frames.npy")
    ts = np.load(work / "ts.npy")
    out = dict(rank=rank, device=str(dev), runs={})

    def run(tag, engine, fr, n_timed, keep=False):
        engine.forward_windows(fr, ts)                      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        secs = []
        for _ in range(n_timed):
            t0 = time.perf_counter()
            res = engine.forward_windows(fr, ts)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        counts = kernels.launch_counts()
        bf16 = kernels.bf16_launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        # one window more, every collective between CUDA events
        halo.timing = []
        t0 = time.perf_counter()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        engine.forward_windows(fr, ts)
        ev1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        coll_ms = sum(a.elapsed_time(b) for a, b in halo.timing)
        n_coll = len(halo.timing)
        halo.timing = None
        out["runs"][tag] = dict(
            seconds=secs, windows_per_s=n_timed / sum(secs),
            launches=counts, bf16_launches=bf16, peak_bytes=peak,
            collectives=n_coll, collectives_ms=coll_ms,
            window_ms=ev0.elapsed_time(ev1), window_wall_s=wall,
            shape=list(fr.shape[2:4]))
        if keep and rank == 0:
            np.savez(work / f"res_{tag}.npz", **vars(res[0]))

    for dtype in ("float32", "bfloat16"):
        cfg = config_rb(5, 3, seed=SEED, compute_dtype=dtype)
        model = make_model(cfg, device=dev)
        model.load_state_dict(weights, strict=True)
        engine = InferenceEngine(model, cfg.N_tst, device=dev, grid=grid)
        run(f"{dtype} {H}x{W}", engine, frames, SPATIAL_REPEATS, keep=True)
        if dtype == "float32":
            hd = np.random.RandomState(SEED + 10).uniform(
                -1, 1, (1, 4) + HD + (3,)).astype(np.float32)
            run(f"float32 {HD[0]}x{HD[1]}", engine, hd, 1)
            if spec["uhd"]:
                engine.t_chunk = 1
                uhd = np.random.RandomState(SEED + 11).uniform(
                    -1, 1, (1, 4) + UHD + (3,)).astype(np.float32)
                run(f"float32 {UHD[0]}x{UHD[1]} t_chunk 1", engine, uhd, 1)
        del engine, model
        torch.cuda.empty_cache()
    destroy_distributed()

    # the evaluation entry point on phase 6's tree, rows split
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = cli(spec["cli"] + ["--coordinator_address",
                             f"127.0.0.1:{spec['cli_port']}",
                             "--num_processes", str(size),
                             "--process_id", str(rank)])
    out["cli"] = dict(result=list(res[:5]), save_root=res[5],
                      seconds=time.perf_counter() - t0,
                      launches=kernels.launch_counts())
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    print(f"SPATIAL_RANK_DONE {rank}", flush=True)
    return 0


def moments_gap(got, want) -> float:
    """The larger of the gaps of two tensors' means and standard
    deviations, over the second's standard deviation, or over its size
    where it holds one value (bfloat16's rule: never element by
    element)."""
    g, w = got.double(), want.double()
    scale = max(float(w.std(correction=0) if w.numel() > 1
                      else w.abs().max()), 1e-12)
    return max(abs(float(g.mean() - w.mean())),
               abs(float(g.std(correction=0) - w.std(correction=0)))) / scale


def split_train_rank(work: Path, rank: int) -> int:
    """One rank of phase 11 (chip_smoke.py --split-train-rank R
    --spatial-dir DIR, started by split_train_phase): joins the group
    spec.json names and runs the split train step (``make_train_step(cfg,
    grid)``) of phase 7(c)'s weights and batch at float32 and bfloat16:
    the first step's loss, gradients (rank 0; every rank holds the same
    after the step's all-reduce) and flow rows, then timed steps with
    the launches of all five kernels, each rank's peak memory and the
    collectives' CUDA events before and after the forward's end; then
    ``cli --phase train --mesh_spatial S`` for one epoch on phase 7(d)'s
    tree and ``--auto_resume`` for one more. Writes rank<R>.json and
    rank 0's gradients and every rank's flows as .pt files."""
    spec = json.loads((work / "spec.json").read_text())
    sys.path.insert(0, spec["tree"])
    import torch
    from demfi_torch.config import config_rb
    from demfi_torch.main import cli
    from demfi_torch.models import make_model
    from demfi_torch.ops import kernels
    from demfi_torch.parallel import (destroy_distributed, init_distributed,
                                      make_grid)
    from demfi_torch.parallel import halo
    from demfi_torch.train import create_train_state, make_train_step

    size, backend = spec["size"], spec["backend"]
    init_distributed(f"127.0.0.1:{spec['port']}", size, rank, "cuda", backend)
    dev = torch.device("cuda", torch.cuda.current_device())
    grid = make_grid(0, size)
    weights = torch.load(work / "weights.pt")
    frames = torch.from_numpy(np.load(work / "batch.npy")).to(dev)
    t_dev = torch.from_numpy(np.load(work / "t.npy")).to(dev)
    out = dict(rank=rank, device=str(dev), runs={})
    for dtype, n_steps in SPLIT_STEPS.items():
        cfg = config_rb(5, 3, seed=SEED, compute_dtype=dtype)
        model = make_model(cfg, device=dev)
        model.load_state_dict(weights, strict=True)
        state = create_train_state(cfg, model)
        step = make_train_step(cfg, grid)
        flows = []
        hook = model.register_forward_hook(
            lambda _m, _in, o: flows.append(o.flow_preds.detach().cpu()))
        grads = {}

        def snap(phase):
            if phase == "backward":
                grads.update({k: p.grad.detach().cpu().clone()
                              for k, p in model.named_parameters()
                              if p.grad is not None})
        with torch.enable_grad():
            loss0 = float(step(state, frames, t_dev,
                               on_phase=snap)["total_loss"])
        hook.remove()
        torch.save(flows[0], work / f"flows_{dtype}_{rank}.pt")
        if rank == 0:
            torch.save(grads, work / f"grads_{dtype}.pt")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launch_counts()
        losses, secs, step_ms, coll = [loss0], [], [], []
        for _ in range(n_steps - 1):
            halo.timing = []
            mark = {}
            ev = {k: torch.cuda.Event(enable_timing=True)
                  for k in ("start", "optimizer")}

            def on_phase(phase):
                if phase == "forward":
                    mark["forward"] = len(halo.timing)
                if phase in ev:
                    ev[phase].record()
            t0 = time.perf_counter()
            ev["start"].record()
            with torch.enable_grad():
                losses.append(float(step(state, frames, t_dev,
                                         on_phase=on_phase)["total_loss"]))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            step_ms.append(ev["start"].elapsed_time(ev["optimizer"]))
            k = mark["forward"]
            coll.append([sum(a.elapsed_time(b) for a, b in halo.timing[:k]),
                         sum(a.elapsed_time(b) for a, b in halo.timing[k:]),
                         k, len(halo.timing) - k])
            halo.timing = None
        out["runs"][dtype] = dict(
            loss0=loss0, losses=losses, seconds=secs, step_ms=step_ms,
            collectives=coll, launches=kernels.launch_counts(),
            bf16_launches=kernels.bf16_launch_counts(),
            peak_bytes=torch.cuda.max_memory_allocated(dev),
            timed_steps=n_steps - 1)
        del model, state, step
        torch.cuda.empty_cache()
    destroy_distributed()
    runs = []
    for extra, port in ((["--epochs", "1"], spec["cli_ports"][0]),
                        (["--epochs", "2", "--auto_resume"],
                         spec["cli_ports"][1])):
        t0 = time.perf_counter()
        with torch.enable_grad(), contextlib.redirect_stdout(io.StringIO()):
            res = cli(spec["cli"] + extra + [
                "--coordinator_address", f"127.0.0.1:{port}",
                "--num_processes", str(size), "--process_id", str(rank)])
        runs.append(dict(start_epoch=res["start_epoch"],
                         epoch_losses=res["epoch_losses"],
                         final=list(res["final"][:5]),
                         seconds=time.perf_counter() - t0))
    out["cli"] = runs
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    print(f"SPLIT_TRAIN_RANK_DONE {rank}", flush=True)
    return 0


def split_train_phase(torch, dev, tmp: Path, inputs: dict,
                      fixed: dict) -> dict:
    """Phase 11: training's spatial axis (``--phase train --mesh_spatial
    S``) on the card. Ranks of their own (split_train_rank), as phase 10:
    NCCL one rank a card with S = min(4, cards) where there are two cards
    or more, else two gloo ranks sharing the one card. Each runs
    DeMFI-Net_rb(5,3)'s step at the published setting (phase 7(c)'s
    weights and batch) with the batch's rows split S ways, at float32 and
    bfloat16; here, on this process's card, the unsplit step on the same
    weights and batch, twice (the card's own spread). Checks: the split
    loss against the unsplit one and phase 7(c)'s / 7(c')'s first (1e-4,
    bfloat16 1e-2); at float32 every gradient within the larger of
    GRAD_TOL and twice the card's own spread for that tensor (split and
    unsplit run the same kernels on the same card, so no nudge of the
    batch stands for their departure, as it does for phase 7(b)'s); at
    bfloat16, whose roundings are chaotic through the depth (a
    convolution of another shape rounds otherwise), each gradient by its
    moments as tests/test_torch_spatial_train.py holds it (mean and std
    within BF16_MOMENTS_TOL of its std, or of its value where it holds
    one), never element by element; exact launches of all five kernels
    a step on every rank, the CLI's two runs. Reports s/step split and
    unsplit (7(c), 7(c')), the collectives' share of a step forward and
    backward (CUDA events, ``halo.timing``), each rank's peak memory
    beside 7(c)'s."""
    from demfi_torch.checkpoint import load_training_checkpoint
    from demfi_torch.config import config_rb
    from demfi_torch.models import make_model
    from demfi_torch.train import create_train_state, make_train_step
    from demfi_torch.utils.grad_check import GRAD_TOL, rel_frobenius

    cards = torch.cuda.device_count()
    backend, size = (("nccl", min(4, cards)) if cards >= 2 else ("gloo", 2))
    batch, t_np = inputs["batch"], inputs["t"]
    t_dev = torch.from_numpy(t_np).to(dev)
    say(f"[11 split train] {cards} card(s): {size} ranks, backend {backend}"
        + (", one rank a card" if backend == "nccl" else
           ", two gloo ranks sharing the one card (collectives staged "
           "through the host): exactness, the path, memory and the "
           "collectives' cost, no scaling figure"))

    # the unsplit step on the same weights and batch, here, first
    def unsplit_step(dtype, x):
        """(loss, gradients by name, flows) of one unsplit step."""
        cfg = config_rb(5, 3, seed=SEED, compute_dtype=dtype)
        model = make_model(cfg, device=dev)
        model.load_state_dict(inputs["weights"], strict=True)
        state = create_train_state(cfg, model)
        flows, got = [], {}
        model.register_forward_hook(lambda _m, _in, o: flows.append(
            o.flow_preds.detach().cpu()))

        def snap(phase):
            if phase == "backward":
                got.update({k: p.grad.detach().cpu().clone()
                            for k, p in model.named_parameters()
                            if p.grad is not None})
        with torch.enable_grad():
            m = make_train_step(cfg)(state, torch.from_numpy(x).to(dev),
                                     t_dev, on_phase=snap)
        loss = float(m["total_loss"])
        del model, state
        return loss, got, flows[0]
    unsplit = {dtype: unsplit_step(dtype, batch) for dtype in SPLIT_STEPS}
    # the float32 check's yardstick: the card's own spread between two runs
    again = unsplit_step("float32", batch)[1]
    spread = {k: rel_frobenius(again[k], g)
              for k, g in unsplit["float32"][1].items()}
    torch.cuda.empty_cache()

    work = tmp / "split_train"
    work.mkdir()
    torch.save(inputs["weights"], work / "weights.pt")
    np.save(work / "batch.npy", batch)
    np.save(work / "t.npy", t_np)
    argv = [a if a != str(tmp / "train_ckpt") else str(tmp / "split_ckpt")
            for a in inputs["argv"]] + ["--mesh_spatial", str(size)]
    if backend == "gloo":
        argv += ["--dist_backend", "gloo"]
    (work / "spec.json").write_text(json.dumps(dict(
        tree=str(Path(__file__).resolve().parent), size=size,
        backend=backend, port=free_port(),
        cli_ports=[free_port(), free_port()], cli=argv)))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--split-train-rank",
         str(r), "--spatial-dir", str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=dict(os.environ))
        for r in range(size)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=SPLIT_TRAIN_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    spawn_s = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"phase 11 rank {r} failed:\n{text[-3000:]}")
    outs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(size)]

    summary = dict(ranks=size, backend=backend, cards=cards,
                   spawn_seconds=spawn_s, dtypes={})
    for dtype in SPLIT_STEPS:
        loss_u, grads_u, flows_u = unsplit[dtype]
        runs = [o["runs"][dtype] for o in outs]
        loss_s = runs[0]["loss0"]
        rtol = STEP_LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL
        ref_loss = fixed[dtype]["losses"][0]
        for o, run in zip(outs, runs):
            check(run["loss0"] == loss_s, f"11 {dtype}: rank {o['rank']}'s "
                                          f"loss {run['loss0']} != {loss_s}")
        rel = max(abs(loss_s - loss_u) / abs(loss_u),
                  abs(loss_s - ref_loss) / abs(ref_loss))
        phase7 = "7(c)" if dtype == "float32" else "7(c')"
        check(rel <= rtol, f"11 {dtype}: split loss {loss_s}, unsplit "
                           f"{loss_u}, phase {phase7} {ref_loss} (rtol "
                           f"{rtol})")
        grads_s = torch.load(work / f"grads_{dtype}.pt")
        check(set(grads_s) == set(grads_u),
              f"11 {dtype}: split and unsplit differ in which parameters "
              f"have a gradient")
        if dtype == "float32":
            flows_s = torch.cat([torch.load(work / f"flows_{dtype}_{r}.pt")
                                 for r in range(size)], dim=-2)
            gap = rel_frobenius(flows_s, flows_u)
            bound = {k: max(GRAD_TOL, 2 * spread[k]) for k in grads_u}
            ratios = sorted(((rel_frobenius(grads_s[k], grads_u[k]) / b, k,
                              rel_frobenius(grads_s[k], grads_u[k]), b)
                             for k, b in bound.items()), reverse=True)
            rule = (f"worst {ratios[0][1]} {ratios[0][2]:.3g} (bound "
                    f"{ratios[0][3]:.3g}, floor {GRAD_TOL:.0e}, the card's "
                    f"own spread up to {max(spread.values()):.3g}); flows "
                    f"{gap:.3g} from the unsplit step's")
        else:
            ratios = sorted((moments_gap(grads_s[k], g) / BF16_MOMENTS_TOL,
                             k, rel_frobenius(grads_s[k], g), None)
                            for k, g in grads_u.items())[::-1]
            rule = (f"by moments: worst {ratios[0][1]}, {ratios[0][0]:.3f} of "
                    f"the tolerance {BF16_MOMENTS_TOL}; relative Frobenius "
                    f"error up to {max(r[2] for r in ratios):.3g}")
        worst = ratios[0]
        check(worst[0] <= 1.0, f"11 {dtype}: split step gradients beyond "
                               f"their bounds (ratio, name, err, bound): "
                               f"{[r for r in ratios if r[0] > 1]}")
        want = {k: v * runs[0]["timed_steps"]
                for k, v in TRAIN_LAUNCHES.items()}
        want16 = ({k: v * runs[0]["timed_steps"]
                   for k, v in TRAIN_BF16_LAUNCHES.items()}
                  if dtype == "bfloat16"
                  else dict.fromkeys(TRAIN_BF16_LAUNCHES, 0))
        for o, run in zip(outs, runs):
            check(run["launches"] == want and run["bf16_launches"] == want16,
                  f"11 {dtype} rank {o['rank']}: launches {run['launches']}, "
                  f"bfloat16 {run['bf16_launches']}; want {want}, {want16}")
            check(all(np.isfinite(run["losses"])),
                  f"11 {dtype} rank {o['rank']}: losses {run['losses']}")
        timed = slice(SPLIT_WARMUP - 1, None)     # the first was not timed
        per_step = {k: v / runs[0]["timed_steps"]
                    for k, v in runs[0]["launches"].items()}
        s_step = float(np.median(runs[0]["seconds"][timed]))
        step_ms = float(np.median(runs[0]["step_ms"][timed]))
        coll = np.median(np.array(runs[0]["collectives"])[timed], axis=0)
        peaks = [run["peak_bytes"] for run in runs]
        d = dict(loss_split=loss_s, loss_unsplit=loss_u,
                 loss_phase7c=ref_loss, loss_rel=rel, gradient_rule=rule,
                 worst_grad=dict(name=worst[1], ratio=worst[0],
                                 err=worst[2], bound=worst[3]),
                 s_per_step=s_step, s_per_step_unsplit=fixed[dtype][
                     "seconds_per_step"], step_device_ms=step_ms,
                 collectives_ms_forward_backward=coll[:2].tolist(),
                 collectives_forward_backward=coll[2:].tolist(),
                 collectives_share=float((coll[0] + coll[1]) / step_ms),
                 peak_bytes_per_rank=peaks,
                 peak_bytes_unsplit=fixed[dtype]["peak_bytes"],
                 launches_rank0=runs[0]["launches"],
                 bf16_launches_rank0=runs[0]["bf16_launches"],
                 step_seconds=runs[0]["seconds"], losses=runs[0]["losses"])
        summary["dtypes"][dtype] = d
        say(f"[11 split train] {dtype}: DeMFI-Net_rb(5,3) step at "
            f"{TRAIN_B}x{TRAIN_PS}x{TRAIN_PS}, rows {size} ways ({backend}): "
            f"loss {loss_s:.7f}, unsplit {loss_u:.7f}, phase {phase7} "
            f"{ref_loss:.7f} (largest rel {rel:.2e}, tol {rtol:.0e}); "
            f"{len(ratios)} gradients, {rule}")
        say(f"[11 split train] {dtype}: {s_step:.4f} s/step split (median "
            f"of {len(runs[0]['seconds'][timed])} after {SPLIT_WARMUP}; "
            f"seconds {['%.4f' % v for v in runs[0]['seconds']]}) against "
            f"{fixed[dtype]['seconds_per_step']:.4f} unsplit ({phase7}); step "
            f"device span {step_ms:.1f} ms, collectives forward "
            f"{coll[0]:.1f} ms ({int(coll[2])}), backward {coll[1]:.1f} ms "
            f"({int(coll[3])}, the gradients' all-reduce included) = "
            f"{100 * d['collectives_share']:.1f} % (CUDA events, rank 0); "
            f"peak allocated per rank "
            f"{[round(p / 2 ** 30, 3) for p in peaks]} GiB (unsplit "
            f"{fixed[dtype]['peak_bytes'] / 2 ** 30:.3f}); launches per step "
            f"{per_step} on every rank")

    # the CLI: one epoch, then --auto_resume for one more
    res0 = outs[0]["cli"]
    for o in outs:
        check([r["epoch_losses"] for r in o["cli"]]
              == [r["epoch_losses"] for r in res0],
              f"11 cli: rank {o['rank']}'s losses differ from rank 0's")
    first, second = res0
    check(first["start_epoch"] == 0 and second["start_epoch"] == 1
          and all(np.isfinite(r["epoch_losses"]).all()
                  and np.isfinite(r["final"]).all() for r in res0),
          f"11 cli: {res0}")
    ck = tmp / "split_ckpt" / "DeMFInet_exp1"
    _, opt, meta = load_training_checkpoint(
        str(ck / "DeMFInet_exp1_latest.pt"))
    per_epoch = CLI_TRAIN_SCENES // TRAIN_B
    check(int(opt["state"][0]["step"]) == 2 * per_epoch
          and meta["last_epoch"] == 1,
          f"11 cli: {opt['state'][0]['step']} Adam steps, last epoch "
          f"{meta['last_epoch']}")
    summary["cli"] = res0
    say(f"[11 split train] cli --phase train --mesh_spatial {size}: epoch 0 "
        f"in {first['seconds']:.2f} s, losses {first['epoch_losses']}; "
        f"--auto_resume from epoch {second['start_epoch']} in "
        f"{second['seconds']:.2f} s, losses {second['epoch_losses']}, "
        f"{2 * per_epoch} Adam steps in the checkpoint; final x2 metrics "
        f"{[round(v, 4) for v in second['final']]}")
    summary["launches_rank0"] = {
        k: sum(summary["dtypes"][d]["launches_rank0"][k] for d in SPLIT_STEPS)
        for k in TRAIN_LAUNCHES}
    say("[11 summary] " + json.dumps(summary, default=str))
    return summary


def spatial_phase(torch, dev, tmp: Path, weights: dict, frames, ts,
                  ref32, ref16, s_win: float, phase6: dict,
                  eval_argv: list, card: str) -> dict:
    """Phase 10: the spatial axis (--mesh_spatial) on the card. Ranks of
    its own (spatial_rank): with two cards or more NCCL, one rank a
    card, S = min(4, cards); with one card two gloo ranks sharing it,
    S = 2. (a) the split window against phase 4's and 4b's unsplit one
    (same card, weights and frames): float32 within SPATIAL_RTOL of the
    largest value, bfloat16 by the moments rule; cli --phase test
    --fwarp_shift_d 8 --mesh_spatial S on phase 6's tree: metrics within
    SPATIAL_METRIC_TOL of phase 6's, PNGs within one uint8 step; (c)
    windows/s split at 352x640 and 1080p beside the unsplit rates, each
    rank's peak memory, the collectives' share of a window (CUDA events
    around each), and UHD at t_chunk 1 where four cards are there."""
    from demfi_torch.infer import WindowResult
    from demfi_torch.data import imageio

    cards = torch.cuda.device_count()
    backend, size = (("nccl", min(4, cards)) if cards >= 2 else ("gloo", 2))
    say(f"[10 spatial] {cards} card(s): {size} ranks, backend {backend}, "
        + ("one rank a card" if backend == "nccl" else
           "two gloo ranks sharing the one card (their collectives staged "
           "through the host): a check of exactness and of the path, no "
           "scaling figure"))
    work = tmp / "spatial"
    work.mkdir()
    torch.save(weights, work / "weights.pt")
    np.save(work / "frames.npy", frames)
    np.save(work / "ts.npy", ts)

    # the unsplit 1080p rate, on this process's card, for comparison
    from demfi_torch.config import config_rb
    from demfi_torch.infer import InferenceEngine
    from demfi_torch.models import make_model
    model = make_model(config_rb(5, 3, seed=SEED), device=dev)
    model.load_state_dict(weights, strict=True)
    engine = InferenceEngine(model, 3, device=dev)
    hd = np.random.RandomState(SEED + 10).uniform(
        -1, 1, (1, 4) + HD + (3,)).astype(np.float32)
    engine.forward_windows(hd, ts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.forward_windows(hd, ts)
    torch.cuda.synchronize()
    hd_s = time.perf_counter() - t0
    hd_peak = torch.cuda.max_memory_allocated()
    del engine, model
    torch.cuda.empty_cache()
    say(f"[10 spatial] unsplit reference, float32: {H}x{W} {1 / s_win:.4f} "
        f"windows/s (phase 4); {HD[0]}x{HD[1]} {1 / hd_s:.4f} windows/s "
        f"({hd_s:.3f} s, t-chunked by the memory budget), peak "
        f"{hd_peak / 2 ** 30:.2f} GiB")

    argv = eval_argv + ["--mesh_spatial", str(size),
                        "--test_img_dir", str(tmp / "imgs_spatial")]
    if backend == "gloo":
        argv += ["--dist_backend", "gloo"]
    (work / "spec.json").write_text(json.dumps(dict(
        tree=str(Path(__file__).resolve().parent), size=size,
        backend=backend, port=free_port(), cli_port=free_port(),
        uhd=size >= 4, cli=argv)))
    env = dict(os.environ)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--spatial-rank",
         str(r), "--spatial-dir", str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(size)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=SPATIAL_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
    spawn_s = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, texts)):
        check(p.returncode == 0, f"phase 10 rank {r} failed:\n{text[-3000:]}")
    outs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(size)]

    # (a) exactness against phase 4 / 4b (same card, weights, frames)
    fields = [f.name for f in dataclasses.fields(WindowResult)]
    got32 = np.load(work / f"res_float32 {H}x{W}.npz")
    worst = (0.0, "")
    for name in fields:
        want = getattr(ref32, name)
        g = got32[name]
        check(g.shape == want.shape and bool(np.isfinite(g).all()),
              f"10(a) {name}: {g.shape} finite {np.isfinite(g).all()}")
        rel = float(np.abs(g - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)
        worst = max(worst, (rel, name))
    check(worst[0] <= SPATIAL_RTOL,
          f"10(a) float32 split window: {worst[1]} off by {worst[0]:.3g} of "
          f"its largest value (tol {SPATIAL_RTOL})")
    got16 = np.load(work / f"res_bfloat16 {H}x{W}.npz")
    worst16 = (0.0, "")
    for name in fields:
        a, b = got16[name], getattr(ref16, name)
        gap = max(abs(float(a.mean()) - float(b.mean())),
                  abs(float(a.std()) - float(b.std())))
        worst16 = max(worst16, (gap, name))
    check(worst16[0] <= BF16_MOMENTS_TOL,
          f"10(a) bfloat16 split window: {worst16[1]} moments gap "
          f"{worst16[0]:.4g}")
    say(f"[10 spatial] (a) x8 DeMFI-Net_rb(5,3) {H}x{W}, {size}-way rows, "
        f"against phase 4's unsplit window (same weights, frames, card): "
        f"float32 worst field {worst[1]} {worst[0]:.3g} of its largest value "
        f"(tol {SPATIAL_RTOL}); bfloat16 largest gap of mean or std "
        f"{worst16[0]:.4g} ({worst16[1]}; tol {BF16_MOMENTS_TOL})")

    # launches of the split path: every rank runs every kernel
    for o in outs:
        run = o["runs"][f"float32 {H}x{W}"]
        want = {"bilinear_gather": GATHERS_PER_WINDOW * SPATIAL_REPEATS,
                "fwarp_splat": SPLATS_PER_WINDOW * SPATIAL_REPEATS,
                "fwarp_shift": 0, "bilinear_gather_bwd": 0,
                "fwarp_splat_bwd": 0}
        check(run["launches"] == want,
              f"10 rank {o['rank']}: launches {run['launches']} != {want}")
        run16 = o["runs"][f"bfloat16 {H}x{W}"]
        check(run16["launches"] == want and run16["bf16_launches"][
            "bilinear_gather"] == BF16_GATHERS_PER_WINDOW * SPATIAL_REPEATS,
            f"10 rank {o['rank']}: bfloat16 launches {run16['launches']}, "
            f"{run16['bf16_launches']}")

    # the evaluation entry point
    n_windows = phase6["windows"]
    res0 = outs[0]["cli"]
    for o in outs:
        check(o["cli"]["result"] == res0["result"],
              f"10 cli: rank {o['rank']} metrics {o['cli']['result']} differ "
              f"from rank 0's {res0['result']}")
        want_l = {"bilinear_gather": GATHERS_PER_WINDOW * n_windows,
                  "fwarp_shift": SPLATS_PER_WINDOW * n_windows,
                  "fwarp_splat": 0, "bilinear_gather_bwd": 0,
                  "fwarp_splat_bwd": 0}
        check(o["cli"]["launches"] == want_l,
              f"10 cli rank {o['rank']}: launches {o['cli']['launches']} "
              f"!= {want_l}")
    d_metrics = max(abs(a - b) for a, b in zip(res0["result"],
                                               phase6["result"][:5]))
    check(d_metrics <= SPATIAL_METRIC_TOL,
          f"10 cli: metrics {res0['result']} against phase 6's "
          f"{list(phase6['result'][:5])}")
    worst_px, n_png = 0, 0
    for rel in phase6["files"]:
        path = Path(res0["save_root"]) / rel
        check(path.exists(), f"10 cli: {rel} not written")
        a = imageio.imread(str(path)).astype(np.int16)
        b = imageio.imread(str(Path(phase6["result"][5]) / rel)).astype(
            np.int16)
        worst_px = max(worst_px, int(np.abs(a - b).max()))
        n_png += 1
    check(worst_px <= 1, f"10 cli: a PNG differs from phase 6's by {worst_px}")
    say(f"[10 spatial] (a) cli --phase test --fwarp_shift_d {SHIFT_D} "
        f"--mesh_spatial {size} on phase 6's tree: metrics {res0['result']} "
        f"(phase 6 {[round(v, 6) for v in phase6['result'][:5]]}, largest gap "
        f"{d_metrics:.3g}, tol {SPATIAL_METRIC_TOL}); {n_png} PNGs, largest "
        f"pixel gap {worst_px} (tol 1); launches on rank 0 "
        f"{res0['launches']}; {res0['seconds']:.2f} s")

    # (c) times
    # the kernels line's launches on this path: rank 0's float32 windows
    # and its --phase test run (the stencil serves there)
    launches = {k: outs[0]["runs"][f"float32 {H}x{W}"]["launches"][k]
                + res0["launches"][k] for k in res0["launches"]}
    summary = dict(ranks=size, backend=backend, cards=cards,
                   launches_rank0=launches,
                   spawn_seconds=spawn_s, exact_float32=worst[0],
                   exact_bf16_moments=worst16[0], cli_metric_gap=d_metrics,
                   cli_pixel_gap=worst_px, unsplit_windows_per_s={
                       f"{H}x{W}": 1 / s_win, f"{HD[0]}x{HD[1]}": 1 / hd_s},
                   unsplit_hd_peak_bytes=hd_peak, runs={})
    for tag in outs[0]["runs"]:
        r0 = outs[0]["runs"][tag]
        peaks = [o["runs"][tag]["peak_bytes"] for o in outs]
        share = r0["collectives_ms"] / r0["window_ms"]
        summary["runs"][tag] = dict(
            windows_per_s=r0["windows_per_s"], seconds=r0["seconds"],
            peak_bytes_per_rank=peaks, collectives=r0["collectives"],
            collectives_ms=r0["collectives_ms"], window_ms=r0["window_ms"],
            collectives_share=share)
        say(f"[10 spatial] (c) {tag}, {size}-way rows ({backend}): "
            f"{r0['windows_per_s']:.4f} windows/s (seconds "
            f"{['%.3f' % v for v in r0['seconds']]}); peak allocated per rank "
            f"{[round(p / 2 ** 30, 2) for p in peaks]} GiB; {r0['collectives']} "
            f"collectives {r0['collectives_ms']:.1f} ms of a "
            f"{r0['window_ms']:.1f} ms window = {100 * share:.1f} % (CUDA "
            f"events around each, rank 0)")
    if size < 4:
        say(f"[10 spatial] (c) UHD {UHD[0]}x{UHD[1]} float32 untiled at "
            f"t_chunk 1: not run; it waits for four cards ({cards} here)")
    if backend == "gloo":
        say("[10 spatial] (c) two ranks sharing one card: no scaling figure "
            "(each rank's work and the host-staged collectives share one "
            "card and one host)")
    return summary


def _bench_argv(flags):
    """The command of one bench process, run from this checkout."""
    return ([sys.executable, "-m", "demfi_torch.bench"] + flags
            + ([] if not flags else ["--no_probe"]))


def _bench_record(label: str, rc: int, out: str, err: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"12 bench {label}: {len(lines)} JSON lines, rc "
          f"{rc}\n{out[-2000:]}\n{err[-2000:]}")
    return json.loads(lines[0])


def bench_phase(torch, dev, s_win: float, s_win16: float,
                trace_dir: str) -> dict:
    """Phase 12: the bench entry point (``python -m demfi_torch.bench``),
    each run of BENCH_RUNS a process of its own as users run it: one
    record, no error, value > 0, exit 0, its marker. One run with
    DEMFI_BENCH_FAIL_INJECT=oom: a failure record that retried one
    instant a call, exit 1 (it runs beside the work in this process). In
    this process at 352x640 on the bench's weights and frames, float32
    and bfloat16: the launches its records name against the counters over
    one window; its float32 window checksum against the four fields of
    ``InferenceEngine.forward_windows`` (BENCH_RTOL); then, in turns
    (each way once forward and once backward), forward_windows on the
    host clock, fetching every field or the images, and the bench's timed
    region (CUDA events) at the full t-batch and at three instants a call:
    how much of a forward_windows window its host copies take, and what
    the t-batch costs; and, at bfloat16, the device's busy share of one
    profiled bench window."""
    from demfi_torch import bench
    from demfi_torch.config import config_rb
    from demfi_torch.infer import InferenceEngine
    from demfi_torch.models import make_model
    from demfi_torch.ops import kernels
    from demfi_torch.utils.profiling import calibrate_flow_head

    root = Path(__file__).resolve().parent
    records = {}
    for label, flags, marker in BENCH_RUNS:
        t0 = time.perf_counter()
        r = subprocess.run(_bench_argv(flags), cwd=root, capture_output=True,
                           text=True, timeout=BENCH_TIMEOUT)
        wall = time.perf_counter() - t0
        rec = _bench_record(label, r.returncode, r.stdout, r.stderr)
        check(r.returncode == 0 and "error" not in rec and rec["value"] > 0,
              f"12 bench {label}: rc {r.returncode}, {rec}\n"
              f"{r.stderr[-2000:]}")
        check(marker in rec["metric"], f"12 bench {label}: {marker!r} not in "
              f"{rec['metric']!r}")
        records[label] = dict(rec, wall_s=wall)
        say(f"[12 bench] {label}: {rec['value']} frames/s, vs_baseline "
            f"{rec['vs_baseline']}, process wall {wall:.1f} s; "
            f"{rec['metric']}")

    # the injected OOM, beside the work below
    oom = subprocess.Popen(
        _bench_argv(["--res", "352x640"]), cwd=root, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, DEMFI_BENCH_FAIL_INJECT="oom"))
    try:
        model = make_model(config_rb(5, 3), device=dev)     # seed 0
        frames_np, frames = bench.bench_frames(1, H, W, dev)
        calibrate_flow_head(model, frames[:1])
        ts = torch.from_numpy(bench.TS).to(dev)
        model16 = make_model(config_rb(5, 3, compute_dtype="bfloat16"),
                             device=dev)
        model16.load_state_dict(model.state_dict(), strict=True)
        own = {}
        for dtype, m in (("float32", model), ("bfloat16", model16)):
            engine = InferenceEngine(m, 3)
            res = engine.forward_windows(frames_np, bench.TS[None])
            images = InferenceEngine(m, 3, fetch="images")
            images.forward_windows(frames_np, bench.TS[None])

            def window(m=m, chunk=None):
                return bench.window_checksum(m, frames, ts, 3, chunk)
            kernels.reset_launch_counts()
            cs = float(window())
            counts = kernels.launch_counts()
            bf16 = kernels.bf16_launch_counts()
            check(counts == {"bilinear_gather": GATHERS_PER_WINDOW,
                             "fwarp_splat": SPLATS_PER_WINDOW,
                             "fwarp_shift": 0, "bilinear_gather_bwd": 0,
                             "fwarp_splat_bwd": 0}
                  and bf16["bilinear_gather"] == (
                      BF16_GATHERS_PER_WINDOW if dtype == "bfloat16" else 0),
                  f"12 bench {dtype}: one window launched {counts}, of them "
                  f"on bfloat16 values {bf16}")
            text = bench.launches_text(counts, bf16, 1)
            metric = records[f"352x640 {dtype}"]["metric"]
            check(text in metric, f"12 bench {dtype}: {text!r} not in the "
                  f"record's mode {metric!r}")
            ref = bench.host_checksum(res)
            err = abs(cs - ref) / abs(ref)
            if dtype == "float32":
                check(err <= BENCH_RTOL, f"12 bench: window checksum {cs} "
                      f"against the engine's {ref}: {err:.2e} > {BENCH_RTOL}")
            fetched = sum(v.nbytes for r in res for k, v in vars(r).items()
                          if k in BENCH_FULL_FETCH)

            def host_clock(fn):
                t0 = time.perf_counter()
                fn()
                return time.perf_counter() - t0
            ways = {
                "forward_windows": lambda e=engine: host_clock(
                    lambda: e.forward_windows(frames_np, bench.TS[None])),
                "forward_windows fetch=images": lambda e=images: host_clock(
                    lambda: e.forward_windows(frames_np, bench.TS[None])),
                "bench": lambda w=window: bench._timed(
                    w, 1, BENCH_INNER, True)[0],
                "bench t_chunk 3": lambda w=window: bench._timed(
                    lambda: w(chunk=3), 1, BENCH_INNER, True)[0]}
            secs = {k: [] for k in ways}
            for name in list(ways) + list(ways)[::-1]:     # in turns
                secs[name].append(ways[name]())
            busy = None
            if dtype == "bfloat16":
                _, busy = device_breakdown(
                    torch, lambda w=window: bench._timed(w, 1, 1, True),
                    "[12 profile] one bench window, bfloat16", trace_dir)
            own[dtype] = dict(counts=counts, bf16=bf16, text=text,
                              checksum=cs, engine_checksum=ref, rel_err=err,
                              seconds=secs, full_fetch_bytes=fetched,
                              bench_busy=busy)
            mean = {k: sum(v) / len(v) for k, v in secs.items()}
            say(f"[12 bench] 352x640 {dtype} in this process, the bench's "
                f"weights: one window launched {text.split(': ')[1]} (the "
                f"record names the same); checksum {cs:.4f}, forward_windows' "
                f"{ref:.4f} ({err:.2e}"
                + (f", tol {BENCH_RTOL:g}" if dtype == "float32" else
                   ", not held at bfloat16: the splat's atomic sums end "
                   "in other last bits from run to run, and bfloat16 "
                   "roundings carry a flip through the depth")
                + "); s a window in turns (forward_windows on the host "
                f"clock, copying {fetched / 2 ** 20:.0f} MiB of fields to "
                f"the host, or the six images' with fetch=images; the "
                f"bench's {BENCH_INNER}-window region on CUDA events): "
                + ", ".join(f"{k} {['%.4f' % v for v in vs]}"
                            for k, vs in secs.items())
                + f"; forward_windows / bench "
                f"{mean['forward_windows'] / mean['bench']:.3f}, "
                f"fetch=images / bench "
                f"{mean['forward_windows fetch=images'] / mean['bench']:.3f}"
                f", t_chunk 3 / full batch "
                f"{mean['bench t_chunk 3'] / mean['bench']:.3f}"
                + ("" if busy is None else
                   f"; device busy {100 * busy:.1f} % of a profiled bench "
                   f"window"))
            del engine, images, res
        del model, model16
        out, errs = oom.communicate(timeout=BENCH_TIMEOUT)
    finally:
        if oom.poll() is None:          # a failed check, or a hung run
            oom.kill()
            oom.communicate()
    orec = _bench_record("oom", oom.returncode, out, errs)
    check(oom.returncode == 1 and orec.get("error_kind") == "oom"
          and orec.get("retries") == ["oom->t_map"] and orec["value"] == 0.0,
          f"12 bench oom: rc {oom.returncode}, {orec}")
    say(f"[12 bench] DEMFI_BENCH_FAIL_INJECT=oom: rc 1, error_kind oom, "
        f"retries {orec['retries']}")
    ratios = {}
    for dtype, s in (("float32", s_win), ("bfloat16", s_win16)):
        fps = records[f"352x640 {dtype}"]["value"]
        ratios[dtype] = fps / ((M - 1) / s)
        say(f"[12 bench] 352x640 {dtype}: the bench's {fps} frames/s (its "
            f"own process, CUDA events, checksum on the card) against 7 x "
            f"phase {'4' if dtype == 'float32' else '4b'}'s {1 / s:.4f} "
            f"windows/s = {(M - 1) / s:.4f} (host clock, forward_windows "
            f"with its host copies): ratio {ratios[dtype]:.3f}")
    summary = dict(records=records, launches=own, ratios=ratios, oom=orec)
    say("[12 summary] " + json.dumps(summary, default=str))
    return summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", nargs="?", const="profile_trace",
                    default="", metavar="DIR",
                    help="print a torch.profiler breakdown of one window "
                         "and of one train step, and keep every trace "
                         "under DIR (default ./profile_trace)")
    ap.add_argument("--kernels-of", metavar="DIR", default="",
                    help="run phases 1-3f on the checkout of the port at "
                         "DIR and stop ('.' for this one; an earlier "
                         "commit's, to time both in one run: what that "
                         "checkout's kernels lack, the pair entry, the "
                         "stencil's row count and largest window and the "
                         "gather backward's route counts, is then not "
                         "checked)")
    ap.add_argument("--spatial-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--split-train-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--spatial-dir", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs one GPU")
    if args.spatial_rank is not None:       # one rank of phase 10
        return spatial_rank(Path(args.spatial_dir), args.spatial_rank)
    if args.split_train_rank is not None:   # one rank of phase 11
        return split_train_rank(Path(args.spatial_dir), args.split_train_rank)
    # the profiler's traces: kept under --profile's DIR, else in a
    # directory removed at exit
    trace_tmp = (None if args.profile
                 else tempfile.TemporaryDirectory(prefix="demfi_trace_"))
    trace_dir = args.profile or trace_tmp.name
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
    # 3e: the forward kernels on the rows of a split frame; 3f: the
    # backward kernels on the rows of the train step's split frame
    offset_rows = row_offset_checks(torch, dev, kernels, warp, timer, n_f0,
                                    n_f1, ft0, ft1, flow_01, t, peak)
    offset_bwd_rows = row_offset_bwd_checks(torch, dev, kernels, warp)
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
                        "splat_bwd": splat_bwd_timings(
                            torch, dev, kernels, warp),
                        "row_offset": offset_rows,
                        "row_offset_bwd": offset_bwd_rows,
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
        "[4 profile] one window", trace_dir)
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
        "[4b profile] one window, bfloat16", trace_dir)
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

    # phase 10 holds its split window against these, on these weights
    weights10 = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    ref32, ref16 = res[0], res16[0]
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

        # ------------------------------------------- 8. data parallelism
        step_inputs = train.pop("ddp_inputs")
        ddp = ddp_phase(torch, dev, tmp, step_inputs)

        # ------------------------------------------- 9. the last modules
        rates = {d: train[d]["samples_per_s"] for d in ("float32", "bfloat16")}
        last = dict(remat=remat_phase(torch, dev, step_inputs, rates),
                    loader=loader_phase(tmp, rates),
                    tools=tools_phase(torch, dev, tmp, str(ckpt)),
                    table2=harness_phase(torch, dev, tmp, str(ckpt),
                                         runs[1]["result"], n_windows),
                    sanity=sanity_phase(dev, tmp))

        # ------------------------------------------- 10. the spatial axis
        torch.cuda.empty_cache()
        spatial = spatial_phase(
            torch, dev, tmp, weights10, frames, ts, ref32, ref16, s_win,
            dict(result=runs[1]["result"], files=runs[1]["files"],
                 windows=n_windows), argv, card)
        del weights10, ref32, ref16

        # ------------------------------------ 11. training's spatial axis
        torch.cuda.empty_cache()
        split_train = split_train_phase(torch, dev, tmp, step_inputs,
                                        {"float32": train["float32"],
                                         "bfloat16": train["bfloat16"]})
        del step_inputs

    # ---------------------------------------------- 12. the bench entry point
    torch.cuda.empty_cache()
    bench12 = bench_phase(torch, dev, s_win, s_win16, trace_dir)

    if args.profile:
        traces = sorted(Path(args.profile).glob("*.pt.trace.json"))
        check(len(traces) >= 4 and all(p.stat().st_size > 0 for p in traces),
              f"--profile: traces {traces} under {args.profile}")
        say(f"[profile] {len(traces)} torch.profiler traces under "
            f"{args.profile}: "
            + ", ".join(f"{p.name} {p.stat().st_size / 2 ** 20:.1f} MiB"
                        for p in traces))

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

    spatial_launches = spatial["launches_rank0"]
    split_train_launches = split_train["launches_rank0"]
    for kname, n in split_train_launches.items():
        check(n > 0 or TRAIN_LAUNCHES[kname] == 0,
              f"{kname}: never launched on the split train path")

    def offsets(kname, dtype="float32"):
        return [r for r in offset_rows if r["kernel"] == kname
                and r.get("image_dtype", "float32") == dtype]

    def summary(kname, source, replaces, per_window, launches):
        return entry(kname, source, replaces, launches,
                     [r for r in rows if r["kernel"] == kname
                      and r.get("image_dtype", "float32") == "float32"],
                     "per_window", dict(
                         launches_per_window=per_window,
                         launches_eval_path=eval_launches[kname],
                         launches_train_path=train["counts"][kname],
                         launches_spatial_path=spatial_launches[kname],
                         launches_split_train_path=split_train_launches[
                             kname],
                         launches_bench_path=sum(
                             bench12["launches"][d]["counts"][kname]
                             for d in ("float32", "bfloat16")),
                         row_offset=offsets(kname),
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
                         launches_split_train_path=split_train_launches[
                             kname],
                         row_offset=[r for r in offset_bwd_rows
                                     if r["kernel"] == kname
                                     and r["image_dtype"] == "float32"],
                         times_are="per train step, summed over its "
                                   "launches"))

    gather_src = "demfi_torch/csrc/bilinear_gather.cu"
    gather_bwd_src = "demfi_torch/csrc/bilinear_gather_bwd.cu"
    gather_bwd_replaces = ("demfi_tpu/ops/warp.py:448 (no Pallas kernel: the "
                           "vjp of _bwarp_xla, and of _bilinear_abs_xla :494)")
    say("[9 summary] " + json.dumps(last, default=str))
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
                  launches_bench_path=bench12["launches"]["bfloat16"]["bf16"][
                      "bilinear_gather"],
                  row_offset=offsets("bilinear_gather", "bfloat16"),
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
                  row_offset=[r for r in offset_bwd_rows
                              if r["kernel"] == "bilinear_gather_bwd"
                              and r["image_dtype"] == "bfloat16"],
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
                  if k not in ("bwd_rows", "counts", "bf16_counts")},
        "ddp": ddp, "spatial": spatial, "split_train": split_train,
        "bench": {k: v["value"] for k, v in bench12["records"].items()}}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
