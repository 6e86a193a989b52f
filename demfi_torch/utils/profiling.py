"""Synthetic-benchmark helpers."""
from __future__ import annotations

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
