"""The warps of DeMFI-Net in plain PyTorch, float32, NCHW.

Written from the reference's semantics (XVFI's bwarp and forward splat,
DeMFI's FGAC sampler): the bilinear gather with zero padding and the
hard in-image mask, the Gaussian 4-corner forward splat, Complementary
Flow Reversal. No kernel, no cache, no batching trick. Flows are
[B, 2, H, W], channel 0 along W, channel 1 along H.

Gradients are autograd's through these operations: floor and the
integer indices carry none, the tap validity, the 0.999 mask and CFR's
norm mask are comparisons and carry none.
"""
from __future__ import annotations

from typing import Tuple

import torch


def bilinear(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """img [B,C,H,W] sampled at pixel coordinates px, py [B,Hq,Wq], a tap
    outside the image reading zero. Returns (sampled [B,C,Hq,Wq], the
    same sample of an all-ones image [B,1,Hq,Wq])."""
    b, c, h, w = img.shape
    hq, wq = px.shape[-2:]
    x0f, y0f = torch.floor(px), torch.floor(py)
    fx, fy = px - x0f, py - y0f
    x0, y0 = x0f.long(), y0f.long()
    flat = img.reshape(b, c, h * w)
    out = ones = None
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)).float()
            wgt = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy) * valid
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(
                b, 1, hq * wq)
            tap = torch.gather(flat, 2, idx.expand(b, c, hq * wq))
            term = tap * wgt.reshape(b, 1, hq * wq)
            out = term if out is None else out + term
            ones = wgt if ones is None else ones + wgt
    return out.reshape(b, c, hq, wq), ones[:, None]


def bwarp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = img(p + flow(p)) times the hard mask (the warped all-ones
    image >= 0.999)."""
    _, _, h, w = img.shape
    gx = torch.arange(w, dtype=torch.float32, device=img.device)
    gy = torch.arange(h, dtype=torch.float32, device=img.device)
    out, ones = bilinear(img, gx[None, None] + flow[:, 0],
                         gy[None, :, None] + flow[:, 1])
    return out * (ones >= 0.999).float()


def sample_abs(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """FGAC's sampler: img at the absolute pixel coordinates coords
    [B,2,Hq,Wq] (no base grid is added)."""
    return bilinear(img, coords[:, 0], coords[:, 1])[0]


def fwarp(img: torch.Tensor, flo: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward warp: each source pixel p adds img(p) * wgt, and wgt, to
    the four integer corners around p + flo(p), wgt = exp(-(dr^2 + dc^2))
    of its distance to each corner; corners outside the image are dropped.
    On a card the sums are taken in float64 and rounded to float32 once,
    so that the order in which its atomic adds land cannot change a bit
    of the result (in float32 it did: one window's outputs moved by 5.5 %
    of their largest value between two runs, through the warps' hard
    masks); on the CPU the order is fixed and the sums are float32.
    Returns (warped [B,C,H,W], weight norm [B,1,H,W])."""
    b, c, h, w = img.shape
    c1f, r1f = torch.floor(flo[:, 0]), torch.floor(flo[:, 1])
    fc, fr = flo[:, 0] - c1f, flo[:, 1] - r1f
    c1, r1 = c1f.long(), r1f.long()
    base_r = torch.arange(h, device=img.device)[None, :, None]
    base_c = torch.arange(w, device=img.device)[None, None, :]
    acc_dtype = torch.float64 if img.is_cuda else img.dtype
    vals = torch.cat([img, torch.ones_like(img[:, :1])], 1).reshape(
        b, c + 1, h * w).to(acc_dtype)
    acc = vals.new_zeros((b, c + 1, h * w))
    for dr in (0, 1):
        for dc in (0, 1):
            wgt = torch.exp(-((fr - dr) ** 2 + (fc - dc) ** 2))
            tr, tc = base_r + r1 + dr, base_c + c1 + dc
            valid = ((tr >= 0) & (tr < h) & (tc >= 0) & (tc < w)).float()
            idx = (tr.clamp(0, h - 1) * w + tc.clamp(0, w - 1)).reshape(
                b, 1, h * w)
            acc = acc.scatter_add(2, idx.expand(b, c + 1, h * w),
                                  vals * (wgt * valid).reshape(
                                      b, 1, h * w).to(acc_dtype))
    acc = acc.reshape(b, c + 1, h, w).to(img.dtype)
    return acc[:, :c], acc[:, c:]


def cfr(flow_01: torch.Tensor, flow_10: torch.Tensor, t: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complementary Flow Reversal (XVFI): (flow_t0, flow_t1) from the
    two directions' flows, t [B,1,1,1]. Where the splatted weight is 0
    the flows pass unnormalised."""
    w01, n0 = fwarp(flow_01, t * flow_01)
    w10, n1 = fwarp(flow_10, (1.0 - t) * flow_10)
    flow_t0 = -(1.0 - t) * t * w01 + t * t * w10
    flow_t1 = (1.0 - t) * (1.0 - t) * w01 - t * (1.0 - t) * w10
    norm = (1.0 - t) * n0 + t * n1
    mask = (norm.detach() > 0).float()
    denom = norm + (1.0 - mask)
    return ((1.0 - mask) * flow_t0 + mask * (flow_t0 / denom),
            (1.0 - mask) * flow_t1 + mask * (flow_t1 / denom))
