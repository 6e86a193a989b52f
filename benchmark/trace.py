"""Spans of the benchmark's own calls, and the reduction of a
``torch.profiler`` trace of the measured window to device numbers.

A span is a host interval around one call into the program (``dispatch``,
``fetch``, ``step``) or one piece of the benchmark's own work
(``generate``), timed by the host clock and, in a traced run, marked in
the trace (``record_function("bench.<name>")``) so that the device's
idle gaps can be named by what the host was doing.

The trace is read from its Chrome export: device activity (kernels,
copies, fills) inside the ``bench.window`` mark; each kernel tied to the
host call that launched it by its correlation id, and that call to the
aten operators around it on its thread, so that a kernel launched under
``aten::convolution`` or ``aten::convolution_backward`` (cuDNN's layout
transposes included) counts as a convolution's, whatever it is named.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
TOP = 10


class Spans:
    """Host seconds of each named span, in order; marked in the trace
    where ``traced``."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = (torch.profiler.record_function("bench." + name)
                if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with mark:
            yield
        self.seconds[name].append(time.perf_counter() - t0)


@dataclasses.dataclass
class DeviceTrace:
    """What the traced window held: its length, the device's busy
    seconds, device seconds by kernel name (summed over launches), the
    seconds in which a convolution's kernel ran (the union of their
    intervals: cuDNN may run two at once), and the longest idle gaps
    named by the host's span."""
    window_s: float
    busy_s: float
    by_name: Dict[str, float]
    conv_s: float
    gaps: List[Tuple[str, float]]     # the longest, named

    def kernel_seconds(self, fragment: str) -> float:
        """Device seconds of the kernels whose name holds ``fragment``."""
        return sum(v for k, v in self.by_name.items() if fragment in k)

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in self.gaps]}


@contextlib.contextmanager
def profiled():
    """Profile the block (host operators and device activity); yields a
    holder whose ``trace`` is the reduced :class:`DeviceTrace` once the
    block has ended."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Holder", (), {"trace": None})()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("bench.window"):
            yield holder
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    holder.trace = reduce_events(events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(spans: List[Tuple[float, float, str]], t: float) -> str:
    """Name of the shortest span containing time t, or "other"."""
    best, name = None, "other"
    for a, b, n in spans:
        if a <= t <= b and (best is None or b - a < best):
            best, name = b - a, n
    return name


def reduce_events(events: List[dict]) -> DeviceTrace:
    """The :class:`DeviceTrace` of a Chrome trace's events (times in
    microseconds)."""
    xs = [e for e in events if e.get("ph") == "X"]
    window = [e for e in xs if e.get("name") == "bench.window"
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace holds no bench.window mark")
    w0 = window[0]["ts"]
    w1 = w0 + window[0]["dur"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len("bench."):])
             for e in xs if e.get("cat") == "user_annotation"
             and e["name"].startswith("bench.")
             and e["name"] != "bench.window"]

    launch_at = {}                       # correlation -> (tid, host time)
    for e in xs:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (e["tid"], e["ts"])
    conv = collections.defaultdict(list)  # tid -> sorted (start, end)
    for e in xs:
        if e.get("cat") == "cpu_op" and e.get("name") in CONV_OPS:
            conv[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    # per thread: the operators' starts in order and the latest end so
    # far; a host time t lies inside one of them iff the latest end of
    # those that started by t reaches t
    reach = {}
    for tid, iv in conv.items():
        iv.sort()
        ends, top = [], float("-inf")
        for _, b in iv:
            top = max(top, b)
            ends.append(top)
        reach[tid] = ([a for a, _ in iv], ends)

    def under_conv(corr) -> bool:
        if corr not in launch_at:
            return False
        tid, t = launch_at[corr]
        if tid not in reach:
            return False
        starts, ends = reach[tid]
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and ends[i] >= t

    by_name: Dict[str, float] = collections.defaultdict(float)
    conv_iv = []
    busy_iv = []
    for e in device:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        secs = (b - a) / 1e6
        by_name[e["name"]] += secs
        busy_iv.append((a, b))
        if e.get("cat") == "kernel" and under_conv(
                (e.get("args") or {}).get("correlation")):
            conv_iv.append((a, b))
    busy = _union(busy_iv)
    gaps = []                            # (seconds, midpoint)
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append(((a - edge) / 1e6, (a + edge) / 2))
        edge = max(edge, b)
    gaps = [(_innermost(spans, mid), secs)
            for secs, mid in sorted(gaps, reverse=True)[:TOP]]
    return DeviceTrace(window_s=(w1 - w0) / 1e6,
                       busy_s=sum(b - a for a, b in busy) / 1e6,
                       by_name=dict(by_name),
                       conv_s=sum(b - a for a, b in _union(conv_iv)) / 1e6,
                       gaps=gaps)
