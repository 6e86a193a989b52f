"""Synthetic-benchmark helpers and a per-step timer."""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from demfi_torch.models.demfi import DeMFINet


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
    """Per-step seconds with JSONL output. On a CUDA device a step is
    timed by CUDA events on the current stream, so a step's seconds are
    the device's from its start to its end and do not end before its
    work does; on the CPU by the host clock. ``stop`` waits for the
    step's end event."""

    def __init__(self, device=None, path: Optional[str] = None):
        self.cuda = torch.device(device or "cpu").type == "cuda"
        self.path = path
        self.records: List[dict] = []
        self._start = None

    def start(self) -> None:
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def stop(self, **tags) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._start
        rec = {"seconds": dt, **tags}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return dt

    def summary(self) -> Dict[str, float]:
        if not self.records:
            return {}
        xs = sorted(r["seconds"] for r in self.records)
        n = len(xs)
        return {"count": n, "mean": sum(xs) / n, "p50": xs[n // 2],
                "p90": xs[int(n * 0.9)], "min": xs[0], "max": xs[-1]}
