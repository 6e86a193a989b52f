"""Benchmark: interpolated frames/s of x8 MFI on DeMFI-Net_rb(5,3), on one
CUDA card.

    python -m demfi_torch.bench [--quick] [--res 720x1280]
        [--dtype bfloat16|float32] [--n_tst 3] [--iters 8] [--inner 4]
        [--wb 1] [--t_chunk 0] [--readback] [--probe_timeout 300] [--cpu]
        [--no_probe] [--raw_flows]

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline"} on
success and on every failure; a failure adds "error" and "error_kind"
(and "retries" where there were any) and exits 1, a success exits 0.

The workload is the root ``bench.py``'s (the JAX package's TPU bench,
whose flags, defaults and record this keeps): one window of 4 blurry
frames interpolated x8 (7 instants, N_tst = 3) on seeded random weights
(seed 0) with the flow head calibrated to 24 px of motion
(``--raw_flows``: uncalibrated). Stage I runs once and the instants go
through ``synthesize`` as one batch, or in chunks where the card's memory
budget for a batch (the inference engine's) does not hold all 7: then one
instant a call (``t_map``), or ``--t_chunk N`` instants a call. The
outputs are reduced to a float32 checksum on the card.

Timing: one untimed warm-up window (kernel build, cuDNN plans), then
``--iters`` regions, each ``--inner`` windows queued back to back on the
current stream between two CUDA events, their checksums summed on the
card and read once after the end event; seconds a window are the regions'
mean over ``--inner``. The host's launch gaps inside a region are in it,
as users get them. ``--readback`` times ``InferenceEngine.forward_windows``
on the host clock instead, results copied to the host. The record's mode
names the card and each kernel's launches in one timed window.

``vs_baseline``: against the reference's Rt = 0.61 s a frame at 640x352
on a TITAN RTX, scaled by the pixel count at other geometries.

Without ``--cpu`` the bench runs on the card or not at all: with no CUDA
device it prints a ``gpu-unavailable`` record. ``--cpu`` is an explicitly
labelled CPU run of the plain PyTorch versions (at 352x640 and 720x1280
it turns on ``--quick``). ``DEMFI_BENCH_TINY=1`` runs 64x64 with one
window (the contract tests); ``DEMFI_BENCH_FAIL_INJECT=oom|generic|nan``
fails on purpose.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from demfi_torch.config import config_rb
from demfi_torch.infer import InferenceEngine, WindowResult
from demfi_torch.models import DeMFINet, make_model
from demfi_torch.ops import kernels
from demfi_torch.utils.profiling import calibrate_flow_head

N_T = 7                                   # x8: instants per window
TS = np.linspace(1 / 8, 7 / 8, N_T, dtype=np.float32)
BASELINE_RT_S = 0.61                      # reference, a frame at 640x352
BASELINE_PIXELS = 352 * 640


def probe_backend(timeout_s: float = 300.0) -> Tuple[bool, str]:
    """Initialise CUDA and run one small op in a subprocess with a hard
    timeout, so that a CUDA start-up that hangs cannot hang this process
    before it prints its record. Returns (ok, detail)."""
    code = ("import torch; x = torch.ones(1, device='cuda') + 1; "
            "torch.cuda.synchronize(); "
            "print('PROBE_OK', float(x), torch.cuda.get_device_name(0))")
    try:
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False, f"probe timeout after {timeout_s:.0f}s"
    if r.returncode == 0 and "PROBE_OK" in r.stdout:
        return True, r.stdout.strip().splitlines()[-1]
    tail = (r.stderr or r.stdout).strip().splitlines()[-1:]
    return False, f"probe rc={r.returncode}: {' '.join(tail)}"


def _strip_ansi(s: str) -> str:
    return re.sub(r"\x1b\[[0-9;]*[A-Za-z]", "", s)


def _failure_record(reason: str, kind: str,
                    retries: Optional[List[str]] = None) -> dict:
    rec = {
        "metric": f"x8 MFI interp frames/sec/chip ({kind})",
        "value": 0.0,
        "unit": "frames/s",
        "vs_baseline": 0.0,
        "error": _strip_ansi(reason)[:2000],
        "error_kind": kind,
    }
    if retries:
        rec["retries"] = retries
    return rec


def _error_kind(e: BaseException) -> str:
    """Classify a failure. An OutOfMemoryError is one by its type; the
    text markers of a kernel build and of a CUDA launch or runtime error
    are read BEFORE the out-of-memory text scan, since a build log or a
    launch message can hold those words incidentally."""
    if isinstance(e, torch.OutOfMemoryError):
        return "oom"
    s = f"{type(e).__name__}: {e}".lower()
    if "kernel build failed" in s or "nvcc not found" in s:
        return "kernel-build"
    if "cuda error" in s or "cudaerror" in s or "cuda launch" in s:
        return "cuda"
    if "out of memory" in s:
        return "oom"
    return type(e).__name__


def _inject(stage: str):
    """Test hook: DEMFI_BENCH_FAIL_INJECT=oom|generic raises at the start
    of a measurement (stage "run"), =nan replaces its checksum (stage
    "checksum"), so that the failure records are testable on the CPU."""
    mode = os.environ.get("DEMFI_BENCH_FAIL_INJECT", "")
    if mode == "oom" and stage == "run":
        raise torch.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 1.15 GiB "
            "[injected by DEMFI_BENCH_FAIL_INJECT]")
    if mode == "generic" and stage == "run":
        raise ValueError("injected generic failure")
    if mode == "nan" and stage == "checksum":
        return float("nan")
    return None


def bench_frames(wb: int, h: int, w: int, device) -> Tuple[np.ndarray,
                                                           torch.Tensor]:
    """The bench's windows from numpy seed 0: numpy [wb, 4, H, W, 3] (the
    engine's layout) and the model's [wb, 4, 3, H, W] on ``device``."""
    frames = np.random.RandomState(0).uniform(
        -1, 1, (wb, 4, h, w, 3)).astype(np.float32)
    return frames, torch.from_numpy(frames).to(device).permute(
        0, 1, 4, 2, 3).contiguous()


def checksum(out) -> torch.Tensor:
    """The outputs' float32 checksum on their device: the sums of the last
    boosting iteration's st, s0, s1 and of st_prime (bfloat16 fields are
    summed in float32)."""
    f32 = torch.float32
    return (out.st_final[-1].sum(dtype=f32) + out.s0_final[-1].sum(dtype=f32)
            + out.s1_final[-1].sum(dtype=f32) + out.st_prime.sum(dtype=f32))


def host_checksum(results: List[WindowResult]) -> float:
    """:func:`checksum` of the engine's host results (float64 sums)."""
    return float(sum(np.sum(getattr(r, k), dtype=np.float64) for r in results
                     for k in ("st_final", "s0_final", "s1_final",
                               "st_prime")))


@torch.inference_mode()
def window_checksum(model: DeMFINet, frames: torch.Tensor, ts: torch.Tensor,
                    n_tst: int, chunk: Optional[int] = None) -> torch.Tensor:
    """One window batch, frames [wb, 4, 3, H, W]: Stage I once, then the
    instants ts [M] through ``synthesize`` in calls of ``chunk`` (None:
    all in one), the Stage-I context repeated per call and each call's
    outputs freed before the next. Returns the summed :func:`checksum`."""
    wb, m = frames.shape[0], ts.numel()
    step = chunk or m
    ctx = model.extract(frames)
    total = None
    for i in range(0, m, step):
        tc = ts[i:i + step]
        out = model.synthesize(ctx.repeat(tc.numel()), tc.repeat(wb), n_tst)
        cs = checksum(out)
        del out
        total = cs if total is None else total + cs
    return total


def launch_counts() -> Dict[str, int]:
    """The port's kernels' launches since the last reset of both
    counters (``kernels.reset_launch_counts`` and
    ``reset_layout_counts``): the warps' (``kernels.launch_counts``) and
    the convolution epilogue's (``conv_epilogue``, the ``fused`` count of
    ``kernels.epilogue_counts``)."""
    return dict(kernels.launch_counts(),
                conv_epilogue=kernels.epilogue_counts()["fused"])


def launches_text(counts: Dict[str, int], bf16_counts: Dict[str, int],
                  windows: int) -> str:
    """The kernels launched, a timed window each, for the record's mode."""
    parts = []
    for name, n in counts.items():
        if n:
            part = f"{name} {n / windows:g}"
            if bf16_counts.get(name):
                part += f" ({bf16_counts[name] / windows:g} on bfloat16 values)"
            parts.append(part)
    return "launches a timed window: " + (", ".join(parts) or "none")


def _timed(window: Callable, iters: int, inner: int,
           cuda: bool) -> Tuple[float, float]:
    """(seconds a window, one window's checksum): ``iters`` regions of
    ``inner`` windows, between CUDA events on the card (no synchronise
    inside a region), on the host clock otherwise."""
    seconds = []
    for _ in range(iters):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        total = window()
        for _ in range(inner - 1):
            total = total + window()
        if cuda:
            end.record()
            end.synchronize()
            seconds.append(start.elapsed_time(end) / 1e3)
        else:
            seconds.append(time.perf_counter() - t0)
        cs = float(total)
    return sum(seconds) / len(seconds) / inner, cs / inner


def run_bench(args) -> dict:
    cuda = not args.cpu
    device = torch.device("cuda" if cuda else "cpu")
    iters, inner = args.iters, args.inner
    quick = args.quick or (args.cpu and args.res in ("352x640", "720x1280"))
    if int(os.environ.get("DEMFI_BENCH_TINY", "0") or "0"):
        h, w = 64, 64            # CPU contract tests: one window
        iters = inner = 1
    elif quick:
        h, w = 128, 256
        iters = 3
    else:
        h, w = (int(x) for x in args.res.split("x"))
    wb = max(1, args.wb)

    model = make_model(config_rb(5, args.n_tst, compute_dtype=args.dtype),
                       device=device)
    # the engine serves --readback and budgets the batch; it also turns
    # TF32 off, as in serving
    engine = InferenceEngine(model, args.n_tst, device=device)
    frames_np, frames = bench_frames(wb, h, w, device)
    # at random init the backbone's flows peak near 76 px, motion no
    # trained window has; the calibration scales the flow head (exact) to
    # the first window's peak, as bench.py's does
    flow_cal = {"flow_calibration": "off (--raw_flows)"}
    if not args.raw_flows:
        raw = calibrate_flow_head(model, frames[:1])
        flow_cal = {"flow_calibration": "target 24 px",
                    "raw_init_max_flow_px": round(raw, 1)}
    ts = torch.from_numpy(TS).to(device)

    def run_once(chunk):
        """One measurement: (seconds a window, checksum, mode, launches)."""
        _inject("run")
        if args.readback:
            ts_nm = np.tile(TS[None], (wb, 1))

            def window():
                return host_checksum(engine.forward_windows(frames_np, ts_nm))
            n_inner, on_card = 1, False
            mode = "e2e+readback"
        else:
            def window():
                return window_checksum(model, frames, ts, args.n_tst, chunk)
            n_inner, on_card = inner, cuda
            shape = {None: "", 1: ", t_map (sequential per-instant)"}.get(
                chunk, f", t_chunk={chunk}")
            mode = (f"device (CUDA events, {inner}-window timed region"
                    f"{shape})" if cuda else
                    f"host clock ({inner}-window timed region{shape})")
        float(window())                 # warm-up: kernel build, cuDNN plans
        kernels.reset_launch_counts()
        kernels.reset_layout_counts()
        dt, cs = _timed(window, iters, n_inner, on_card)
        launches = launches_text(launch_counts(),
                                 kernels.bf16_launch_counts(), iters * n_inner)
        return dt, cs, mode, launches

    # instants a synthesize call: all 7 where the engine's memory budget
    # holds them (no cap on the CPU), else one
    budget = engine._pixel_instant_budget()
    chunk = args.t_chunk or (None if budget is None
                             or budget // (h * w * wb) >= N_T else 1)
    if chunk is not None and chunk >= N_T:
        chunk = None
    retries: List[str] = []
    while True:
        try:
            dt, cs, mode, launches = run_once(chunk)
            break
        except Exception as e:  # noqa: BLE001 -- classified, then recorded
            kind = _error_kind(e)
            if kind != "oom" or chunk == 1 or retries:
                return _failure_record(f"{type(e).__name__}: {e}", kind,
                                       retries)
        # an OOM is bound to the batch's shape: once more one instant a
        # call, the smallest footprint (the failed call's tensors are gone)
        retries.append("oom->t_map")
        chunk = 1
        if cuda:
            torch.cuda.empty_cache()

    injected_nan = _inject("checksum")
    if injected_nan is not None:
        cs = injected_nan
    if not np.isfinite(cs):
        return _failure_record(
            f"non-finite checksum ({cs}) at {h}x{w} {args.dtype}; mode: "
            f"{mode}", "nonfinite-checksum", retries)

    if cuda:
        mode += f", {torch.cuda.get_device_name(device)}, {launches}"
    if retries:
        mode += f", retries={'+'.join(retries)}"
    rec = _record(args, h, w, wb, dt, mode)
    rec.update(flow_cal)
    return rec


def _record(args, h: int, w: int, wb: int, dt: float, mode: str) -> dict:
    """The success record of ``dt`` seconds a window batch of ``wb``."""
    fps = wb * float(N_T) / dt
    # model FLOPs are linear in pixels: the reference's Rt is scaled by the
    # pixel ratio so that vs_baseline compares frames of one geometry
    px_scale = (h * w) / BASELINE_PIXELS
    baseline_fps = 1.0 / (BASELINE_RT_S * px_scale)
    if px_scale != 1.0:
        mode += ", baseline Rt pixel-scaled from 640x352"
    if args.cpu:
        mode += ", CPU (not a GPU number)"
    if not args.raw_flows:
        mode += ", calibrated-motion"
    return {
        "metric": f"x8 MFI interp frames/sec/chip ({h}x{w}, "
                  f"N_tst={args.n_tst}, {args.dtype}, wb={wb}, {mode})",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 2),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="128x256, 3 timed regions")
    ap.add_argument("--res", type=str, default="720x1280",
                    help="HxW (352x640: the reference's Rt geometry)")
    ap.add_argument("--dtype", type=str, default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--n_tst", type=int, default=3)
    ap.add_argument("--iters", type=int, default=8,
                    help="timed regions")
    ap.add_argument("--inner", type=int, default=4,
                    help="windows a timed region")
    ap.add_argument("--wb", type=int, default=1,
                    help="window batch: windows whose instants run as one "
                         "[wb*7] synthesize batch")
    ap.add_argument("--t_chunk", type=int, default=0,
                    help="instants a synthesize call (0: all 7 where the "
                         "engine's memory budget holds them, else 1)")
    ap.add_argument("--readback", action="store_true",
                    help="time InferenceEngine.forward_windows on the host "
                         "clock, results copied to the host")
    ap.add_argument("--probe_timeout", type=float, default=300.0)
    ap.add_argument("--cpu", action="store_true",
                    help="an explicitly labelled CPU run (no CUDA kernels)")
    ap.add_argument("--no_probe", action="store_true")
    ap.add_argument("--raw_flows", action="store_true",
                    help="skip the flow-head calibration (flows near 76 px "
                         "at random init)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """Print the record; 0 on success, 1 after a failure record."""
    args = parse_args(argv)
    if not args.cpu:
        if args.no_probe:
            ok = torch.cuda.is_available()
            detail = "no CUDA device (torch.cuda.is_available() is False)"
        else:
            ok, detail = probe_backend(args.probe_timeout)
        if not ok:
            print(json.dumps(_failure_record(detail, "gpu-unavailable")))
            return 1
    try:
        rec = run_bench(args)
    except Exception as e:  # noqa: BLE001 -- the JSON contract
        rec = _failure_record(f"{type(e).__name__}: {e}", _error_kind(e))
    print(json.dumps(rec), flush=True)
    return 1 if "error" in rec else 0


if __name__ == "__main__":
    sys.exit(main())
