"""The program's spans, a profiler trace, synthetic-benchmark helpers and
a per-step timer."""
from __future__ import annotations

import contextlib
import os
import time
from typing import TYPE_CHECKING, List

import numpy as np
import torch
from torch.autograd import _profiler_enabled

if TYPE_CHECKING:
    from demfi_torch.models.demfi import DeMFINet

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range ``demfi.<name>`` around a block, in the profiler's
    timeline beside the kernels it launches, while a profiler records on
    this thread (``torch.profiler``, :func:`device_trace`, or
    ``torch.autograd.profiler.emit_nvtx`` under Nsight); otherwise one
    shared null context: a span that is off costs one call that reads
    the profiler's state and allocates nothing. Usage:

        with span("extract"):
            ...

    The program's spans: ``engine.prepare``, ``engine.upload``,
    ``engine.readback`` (the inference engine's host work, its copies
    to the card, and its casts and copies back); ``step.forward``,
    ``step.backward``, ``step.optimizer`` (the train step's phases);
    ``extract``, ``synthesize`` and ``boost`` (the model's Stage I, its
    t-dependent part, and each boosting iteration inside that)."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function("demfi." + name)


@contextlib.contextmanager
def device_trace(logdir: str):
    """A ``torch.profiler`` trace of the block, written under ``logdir``
    when it ends (a Chrome trace, ``<host>_<pid>.<ms>.pt.trace.json``,
    that TensorBoard's profiler plugin and Perfetto open). It records the
    host's operators, the program's ``demfi.`` spans (:func:`span`), and
    the card's kernels and copies where CUDA is present. Yields the
    profiler, whose ``events()`` and ``key_averages()`` the caller may
    read after the block. Usage:

        with device_trace("./log_dir/profile"):
            engine.forward_windows(frames, ts)
    """
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@torch.no_grad()
def calibrate_flow_head(model: DeMFINet, frames: torch.Tensor,
                        target: float = 24.0) -> float:
    """Scale the flow channels of FF_RDB's output head (``UPNet.2``) in
    place so that the backbone's flows on ``frames`` [B,4,3,H,W] (every
    window of the batch, one at a time) peak at ``target`` pixels.

    At random init the backbone emits flows of about 76 px, far beyond
    the motion of real x8 windows; a synthetic benchmark would then time
    warps of implausible motion. The flows are linear in those weight and
    bias slices, so the scaling is exact and changes nothing else.

    Returns the peak |flow| before scaling. No-op when it is already at
    or below ``target`` (or not finite)."""
    m = 0.0
    for i in range(frames.shape[0]):
        ctx = model.extract(frames[i:i + 1])
        m = max(m, float(ctx.flow_01.abs().max()),
                float(ctx.flow_10.abs().max()))
    if m <= target or not np.isfinite(m):
        return m
    nf2 = model.nf * 2
    head = model.FF_RDB_Module.UPNet[2]
    head.weight[nf2:nf2 + 4] *= target / m
    head.bias[nf2:nf2 + 4] *= target / m
    return m


class StepTimer:
    """Per-step seconds, in ``records``. On a CUDA device a step is timed
    by CUDA events on the current stream, so a step's seconds are the
    device's from its start to its end and do not end before its work
    does; on the CPU by the host clock. ``stop`` waits for the step's end
    event."""

    def __init__(self, device=None):
        self.cuda = torch.device(device or "cpu").type == "cuda"
        self.records: List[float] = []
        self._start = None

    def start(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._start
        self.records.append(dt)
        return dt
