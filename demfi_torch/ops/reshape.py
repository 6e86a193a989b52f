"""Space-to-depth / depth-to-space with the reference's channel order.

The folded channel axis is ordered (c, ry, rx), c-major: exactly
``F.pixel_unshuffle`` / ``F.pixel_shuffle`` in NCHW, so converted conv
weights line up with no channel permutation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C*r*r, H//r, W//r]."""
    h, w = x.shape[-2:]
    if h % r or w % r:
        raise ValueError(f"space_to_depth: {h}x{w} not divisible by r={r}")
    return F.pixel_unshuffle(x, r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C*r*r, H, W] -> [B, C, H*r, W*r]."""
    if x.shape[1] % (r * r):
        raise ValueError(f"depth_to_space: C={x.shape[1]} not divisible "
                         f"by r^2={r * r}")
    return F.pixel_shuffle(x, r)
