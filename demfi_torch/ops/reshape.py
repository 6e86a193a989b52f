"""Space-to-depth / depth-to-space with the reference's channel order, and
the batch repeat, each in its input's memory format.

The folded channel axis is ordered (c, ry, rx), c-major: exactly
``F.pixel_unshuffle`` / ``F.pixel_shuffle`` in NCHW, so converted conv
weights line up with no channel permutation. A channels_last input
(:func:`channels_last`) gives a channels_last output with the same
values: the fold runs on its NHWC view (on the card the two library
ops return NCHW for it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def channels_last(x: torch.Tensor) -> bool:
    """Whether x [B, C, H, W] holds its channels innermost (channel
    stride 1): ``torch.channels_last``, or a view of such a tensor."""
    return x.dim() == 4 and x.stride(1) == 1 and x.shape[2] * x.shape[3] > 1


def _nhwc_view(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw_view(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, C*r*r, H//r, W//r]."""
    b, c, h, w = x.shape
    if h % r or w % r:
        raise ValueError(f"space_to_depth: {h}x{w} not divisible by r={r}")
    if not channels_last(x):
        return F.pixel_unshuffle(x, r)
    y = _nhwc_view(x).reshape(b, h // r, r, w // r, r, c).permute(
        0, 1, 3, 5, 2, 4)
    return _nchw_view(y.reshape(b, h // r, w // r, c * r * r))


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, C*r*r, H, W] -> [B, C, H*r, W*r]."""
    b, crr, h, w = x.shape
    if crr % (r * r):
        raise ValueError(f"depth_to_space: C={crr} not divisible "
                         f"by r^2={r * r}")
    if not channels_last(x):
        return F.pixel_shuffle(x, r)
    c = crr // (r * r)
    y = _nhwc_view(x).reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return _nchw_view(y.reshape(b, h * r, w * r, c))


def repeat_batch(x: torch.Tensor, m: int) -> torch.Tensor:
    """Each batch element of x repeated m times (element-major), as
    ``torch.repeat_interleave(x, m, dim=0)``, in x's memory format."""
    if not channels_last(x):
        return torch.repeat_interleave(x, m, dim=0)
    return _nchw_view(torch.repeat_interleave(_nhwc_view(x), m, dim=0))
