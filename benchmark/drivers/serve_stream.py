"""Serving: a closed loop of x8 windows through the program's inference
engine, pipelined ``depth`` deep.

One client streams a clip: it dispatches window i + 1
(``InferenceEngine.dispatch_windows``: padding, the copy to the card,
Stage I once, the instants in one batch or the engine's own t-chunks,
the copies back) and then fetches window i (``fetch_windows``), the six
output frames of each instant (``fetch="images"``). The window keeps
dispatching until ``--seconds`` have passed, then fetches what is in
flight; every window counts, and so does all the time.

End-to-end: ``interp_fps`` (interpolated frames, ``instants`` a window,
that reached the host, over the window's seconds), ``window_p90_ms``
(90th percentile of a window's time from its dispatch call to the end
of its fetch), ``peak_mem_gib`` (the card's peak allocation over the
program's set-up and the window), ``setup_s`` (process start to the
first measured window, less the benchmark's own making of weights,
clip and calibration: imports, the program's build and load, warm-up).

Correctness: a sample of the windows served, drawn from the seed as
they finish (reservoir sampling, ``check_windows`` of them), is run
again once the window has closed by the float32 reference, one instant
at a time, on the same frames, and each of the six outputs is compared
whole (see :func:`compare`).
"""
from __future__ import annotations

import collections
import contextlib
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import inputs, reference
from benchmark.counts import flops as flop_counts
from benchmark.counts import gather_bytes
from benchmark.harness import (Measured, Run, allocator_note, free_device,
                               peaks, program_model)
from benchmark.trace import Spans, profiled

FIELDS = ("s0_prime", "s1_prime", "st_prime", "s0_final", "s1_final",
          "st_final")
PAD = 32          # the engine's patch boundary: frames pad to multiples


def instants(traffic: dict) -> np.ndarray:
    """The instants of a window: k / (m + 1), k = 1 .. m (x8: 7)."""
    m = traffic["instants"]
    return (np.arange(1, m + 1, dtype=np.float32) / (m + 1))


def padded(n: int) -> int:
    return -(-n // PAD) * PAD


class Keeper:
    """A uniform sample of ``k`` of the windows served, drawn from the seed
    as they finish (reservoir sampling), their six outputs copied into
    buffers made before the window. Copied, not held: a client that
    holds the engine's results keeps their pinned host buffers from its
    pool, and holding them raised a 352x640 window's p90 latency from
    351-352 to 357-360 ms with the rate unchanged (PERF.md, section 6)."""

    def __init__(self, k: int, m: int, h: int, w: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.k = k
        self.seen = 0
        self.index: List[int] = []
        self.out = [{f: np.empty((m, h, w, 3), np.float32) for f in FIELDS}
                    for _ in range(k)]

    def offer(self, i: int, result) -> None:
        slot = self.seen if self.seen < self.k else int(
            self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if slot >= self.k:
            return
        for f in FIELDS:
            np.copyto(self.out[slot][f], getattr(result, f))
        if slot == len(self.index):
            self.index.append(i)
        else:
            self.index[slot] = i


def stream(engine, clip: np.ndarray, ts: np.ndarray, first: int,
           seconds: float, depth: int, spans: Spans,
           keeper: Optional[Keeper] = None, max_windows: int = 0) -> dict:
    """Windows first, first + 1, ... through the engine until ``seconds``
    have passed (or ``max_windows`` were dispatched), ``depth`` in
    flight. Returns the windows, the seconds from the first dispatch to
    the last fetch, each window's latency and the device batches the
    engine cut each window into (its t-chunks under its memory budget)."""
    pending = collections.deque()
    latency: List[float] = []
    batches: List[int] = []
    i = first
    t0 = time.perf_counter()
    while True:
        if max_windows:
            if i - first >= max_windows:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
        with spans("generate"):
            frames = inputs.window_frames(clip, i)
        t_in = time.perf_counter()
        with spans("dispatch"):
            handle = engine.dispatch_windows(frames, ts[None])
        if handle is None:
            raise RuntimeError("the engine cannot pipeline this window: even "
                               "one instant exceeds its memory budget")
        batches.append(len(handle[0]))
        pending.append((i, t_in, handle))
        i += 1
        if len(pending) >= depth:
            _fetch(engine, pending, latency, spans, keeper)
    while pending:
        _fetch(engine, pending, latency, spans, keeper)
    return {"windows": i - first, "seconds": time.perf_counter() - t0,
            "latency": latency, "batches": batches}


def _fetch(engine, pending, latency, spans, keeper):
    j, t_in, handle = pending.popleft()
    with spans("fetch"):
        result = engine.fetch_windows(handle)[0]
    latency.append(time.perf_counter() - t_in)
    if keeper is not None:
        with spans("keep"):
            keeper.offer(j, result)


def to_model(frames: np.ndarray, device) -> torch.Tensor:
    """[1, 4, H, W, 3] numpy -> the model's [1, 4, 3, Hp, Wp] on
    ``device``, reflect-padded at the bottom and right to multiples of
    32 (as the published test code pads)."""
    x = torch.from_numpy(frames).to(device).permute(0, 1, 4, 2, 3)[0]
    h, w = x.shape[-2:]
    x = F.pad(x, (0, padded(w) - w, 0, padded(h) - h), mode="reflect")
    return x[None].contiguous()


@torch.no_grad()
def reference_window(model, frames: np.ndarray, ts: np.ndarray,
                     n_update: int, device) -> Dict[str, np.ndarray]:
    """The reference's six outputs of one window, [m, H, W, 3] each:
    Stage I once, then one instant at a time, cropped back to H x W; the
    final frames are the last boosting step's, or Stage I's where there
    is none (as the engine serves them)."""
    h, w = frames.shape[2:4]
    s1 = model.extract(to_model(frames, device))
    out = {f: [] for f in FIELDS}
    for t in ts:
        o = model.synthesize(s1, torch.tensor([t], device=device), n_update)
        primes = (o["s0_prime"], o["s1_prime"], o["st_prime"])
        finals = ((o["s0"][-1], o["s1"][-1], o["st"][-1]) if o["s0"]
                  else primes)
        vals = primes + finals
        for f, v in zip(FIELDS, vals):
            out[f].append(v[0, :, :h, :w].permute(1, 2, 0).cpu().numpy())
        del o
    return {f: np.stack(v) for f, v in out.items()}


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
            ) -> Dict[str, float]:
    """The worst field's gap of a window: ``final_rel_rms`` over the three
    final frames (the last boosting step's S0, S1, St: what the window
    serves), ``prime_rel_rms`` over Stage I's S0', S1', St', each the
    rms of the difference over the rms of the reference's field (all
    instants, pixels and channels); ``final_rel_max``, the largest
    difference in a final frame over the reference's largest
    magnitude there; :func:`instant_match` of the final St."""
    out = {"final_rel_rms": 0.0, "prime_rel_rms": 0.0, "final_rel_max": 0.0,
           "instant_match": instant_match(got["st_final"], want["st_final"])}
    for f in FIELDS:
        a = got[f].astype(np.float64)
        b = want[f].astype(np.float64)
        d = a - b
        rms = math.sqrt(np.mean(d * d) / np.mean(b * b))
        if f.endswith("_final"):
            out["final_rel_rms"] = max(out["final_rel_rms"], rms)
            out["final_rel_max"] = max(out["final_rel_max"], float(
                np.abs(d).max() / np.abs(b).max()))
        else:
            out["prime_rel_rms"] = max(out["prime_rel_rms"], rms)
    return out


def instant_match(got: np.ndarray, want: np.ndarray) -> float:
    """Over the instants of the final St [m, H, W, 3]: the worst instant's
    rms gap to its own reference over its rms gap to the nearest other
    instant's; under 1 where each served frame lies nearest its own
    instant (a frame served at the wrong t reads over 1)."""
    m = want.shape[0]
    if m < 2:
        return 0.0
    g, w = got.astype(np.float64), want.astype(np.float64)
    d = np.array([[math.sqrt(float(np.mean((g[k] - w[j]) ** 2)))
                   for j in range(m)] for k in range(m)])
    nearest = [min(d[k, j] for j in range(m) if j != k) for k in range(m)]
    return max(float(d[k, k] / nearest[k]) if nearest[k] > 0 else math.inf
               for k in range(m))


def check(cell, sd, clip, ts, windows: List[int],
          outputs: List[Dict[str, np.ndarray]], device,
          precision: str = "float32") -> Dict[str, float]:
    """The comparison's numbers over the given windows: the worst of each
    over them. ``precision``: the reference's, float32 but for a control
    reading, which takes the program's outputs from the reference at a
    lower precision instead (``outputs`` None)."""
    n_update = cell.config["N_tst"]
    model = reference.build(cell.config, sd, device)
    ctl = None if precision == "float32" else reference.build(
        cell.config, sd, device, precision)
    worst: Dict[str, float] = {}
    for k, i in enumerate(windows):
        frames = inputs.window_frames(clip, i)
        want = reference_window(model, frames, ts, n_update, device)
        got = (reference_window(ctl, frames, ts, n_update, device)
               if ctl is not None else outputs[k])
        for name, v in compare(got, want).items():
            worst[name] = max(worst.get(name, 0.0), v)
        del want, got
    return worst


def prepare(run_seed: int, cell, device, clip_windows: Optional[int] = None):
    """Weights, clip and calibration of a run: (state dict, clip, the
    flow peak before calibration)."""
    tr = cell.traffic
    sd = inputs.make_weights(reference.param_shapes(cell.config), run_seed,
                             device)
    n = (clip_windows or tr["clip_windows"]) + 3
    clip = inputs.serve_clip(run_seed, n, tr["height"], tr["width"],
                             tr["max_px"], device)
    with torch.no_grad():
        peak = inputs.calibrate_flow_head(
            reference.build(cell.config, sd, device), sd,
            to_model(inputs.window_frames(clip, 0), device),
            tr["flow_peak_px"])
    free_device()
    return sd, clip, peak


def build_engine(cell, sd, device, plant=None):
    from demfi_torch.infer import InferenceEngine
    model = program_model(cell.config, sd, device)
    engine = InferenceEngine(model, cell.config["N_tst"], fetch="images",
                             device=device)
    return plant(engine) if plant is not None else engine


def measure(run: Run) -> Measured:
    cell, tr, dev = run.cell, run.cell.traffic, run.device
    ts = instants(tr)
    t0 = time.perf_counter()
    sd, clip, _ = prepare(run.seed, cell, dev)
    inputs_s = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    engine = build_engine(cell, sd, dev, run.plant)
    warm = Spans(False)
    stream(engine, clip, ts, 0, 0.0, tr["depth"], warm,
           max_windows=tr["warmup_windows"])
    keeper = Keeper(tr["check_windows"], len(ts), tr["height"], tr["width"],
                    run.seed)
    setup_s = time.perf_counter() - run.started - inputs_s
    seconds = min(run.seconds, tr["trace_seconds"]) if run.traced \
        else run.seconds
    with profiled() if run.traced else contextlib.nullcontext() as holder:
        got = stream(engine, clip, ts, tr["warmup_windows"], seconds,
                     tr["depth"], run.spans, keeper)
    trace = holder.trace if run.traced else None
    peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    alloc = allocator_note(dev)
    del engine
    free_device()

    numbers = check(cell, sd, clip, ts, keeper.index, keeper.out, dev)
    lat = sorted(got["latency"])
    p90 = lat[min(len(lat) - 1, math.ceil(0.9 * len(lat)) - 1)]
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak_flops, hbm = peaks(kind, cell.config["compute_dtype"])
    hp, wp = padded(tr["height"]), padded(tr["width"])
    image_bytes = 2 if cell.config["compute_dtype"] == "bfloat16" else 4
    return Measured(
        kind="serve", attempted=got["windows"], failed=0,
        peak_bytes=peak_bytes,
        end_to_end={"interp_fps": len(ts) * got["windows"] / got["seconds"],
                    "window_p90_ms": p90 * 1e3,
                    "peak_mem_gib": peak_bytes / 2 ** 30,
                    "setup_s": setup_s},
        numbers=numbers, spans=run.spans, units=got["windows"], trace=trace,
        flops_per_unit=flop_counts.serve_window(
            cell.config, hp, wp, len(ts), cell.config["N_tst"]),
        peak_flops=peak_flops, hbm_bytes_s=hbm,
        gather_bytes_per_unit=gather_bytes.serve_window(
            hp, wp, len(ts), cell.config["N_tst"],
            cell.config["architecture"]["nf"], image_bytes),
        notes=[f"window_p90_ms over {len(lat)} windows",
               f"the benchmark's weights, clip and calibration "
               f"{inputs_s:.3f} s, left out of setup_s",
               f"window latency ms: min {lat[0] * 1e3:.1f}, median "
               f"{lat[len(lat) // 2] * 1e3:.1f}, max {lat[-1] * 1e3:.1f}",
               f"device batches a window: {sorted(set(got['batches']))}",
               alloc,
               f"checked windows {sorted(keeper.index)}"])
