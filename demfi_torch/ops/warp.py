"""Warping ops (NCHW) and the plain PyTorch versions of the warp kernels.

  - :func:`bwarp` / :func:`bwarp_pair`  backward warp ==
    ``F.grid_sample(align_corners=True, padding_mode='zeros')`` of the
    image at ``grid + flow``, times the reference's hard mask
    (the warped all-ones image >= 0.999);
  - :func:`bilinear_sample_abs`  FGAC's sampler: the same bilinear gather
    at *absolute* pixel coordinates (raw flow values, no base grid); the
    query grid may differ from the image grid;
  - :func:`fwarp`  forward warp: Gaussian-weighted splat of each source
    pixel onto the 4 integer corners around ``p + flo(p)``, by the atomic
    splat kernel or, for ``shift_d > 0`` and motion inside the window, by
    the deterministic stencil kernel;
  - :func:`cfr_flow_t_align`  Complementary Flow Reversal;
  - :func:`fgac_correlate`  FGAC aggregation, point-wise at rr = 0 and the
    reference's window form (with its quirks) at rr > 0.

``bilinear_gather_plain``, ``fwarp_splat_plain`` and
``fwarp_shift_plain`` are the plain versions of the three forward CUDA
kernels (``demfi_torch/ops/kernels.py``), and
``bilinear_gather_plain_vjp`` and ``fwarp_splat_plain_vjp`` (autograd
through the first two) those of the two backward kernels: the kernel
wrappers take them for CPU tensors, the tests hold them against the JAX
package (``jax.vjp`` of its exact ops), and ``chip_smoke.py`` holds each
kernel against them on the card. Gradient semantics, the JAX package's:
floor has derivative 0 and the fractional part 1; tap validity, the
0.999 mask and CFR's norm mask are constants (no gradient), so a tap or
corner outside the image contributes nothing and the mask zeroes both
the image's and the coordinates' gradient where it is 0. The coordinates are computed as ``grid + flow`` in float32, as
the JAX package does; ``F.grid_sample`` is not used (its
normalise/unnormalise round trip differs in the last bits).

Flows: [B, 2, H, W], channel 0 = dx (along W), channel 1 = dy (along H).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from demfi_torch.ops import kernels


def _bilinear_zeros(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample of img [B,C,H,W] at pixel coords px, py [B,Hq,Wq],
    zero padding: a corner tap outside the image contributes zero.

    Returns (sampled [B,C,Hq,Wq], in-image weight [B,1,Hq,Wq]); the
    second is the same sample of an all-ones image."""
    b, c, h, w = img.shape
    hq, wq = px.shape[-2:]
    px = px.float()
    py = py.float()
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    flat = img.reshape(b, c, h * w)

    out = None
    ones = None
    for dy in (0, 1):
        for dx in (0, 1):
            xi = x0 + dx
            yi = y0 + dy
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            wgt = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
            wgt = wgt * valid.float()
            idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(
                b, 1, hq * wq)
            tap = torch.gather(flat, 2, idx.expand(b, c, hq * wq))
            contrib = tap.float() * wgt.reshape(b, 1, hq * wq)
            out = contrib if out is None else out + contrib
            ones = wgt if ones is None else ones + wgt
    return out.reshape(b, c, hq, wq), ones[:, None]


def bilinear_gather_plain(img: torch.Tensor, coords: torch.Tensor,
                          relative: bool
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the ``bilinear_gather`` kernel.

    img [B,C,H,W], coords [B,2,Hq,Wq] (channel 0 = x, channel 1 = y).
    relative: sample at ``grid + coords`` (Hq, Wq == H, W), multiply by
    the hard mask (in-image weight >= 0.999, in float32) and return
    (out, in-image weight). Absolute: sample at ``coords`` and return
    (out, None)."""
    h, w = img.shape[-2:]
    px = coords[:, 0].float()
    py = coords[:, 1].float()
    if relative:
        dev = img.device
        px = torch.arange(w, dtype=torch.float32, device=dev)[None, None] + px
        py = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + py
    out, ones = _bilinear_zeros(img, px, py)
    if not relative:
        return out, None
    return out * (ones >= 0.999).to(out.dtype), ones


def fwarp_splat_plain(img: torch.Tensor, flo: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``fwarp_splat`` kernel: a deterministic
    scatter-add.

    Each source pixel p adds img(p) * wgt and wgt to the 4 integer
    corners (r1 + p_y + dr, c1 + p_x + dc), dr, dc in {0, 1}, where
    r1, c1 = floor(flo) (bucketed by the displacement, then added to the
    integer base grid) and wgt = exp(-((fr - dr)^2 + (fc - dc)^2)) of the
    fractional parts. Corners outside the image are dropped.
    Returns (warped [B,C,H,W], weight norm [B,1,H,W])."""
    b, c, h, w = img.shape
    dc = flo[:, 0]
    dr = flo[:, 1]
    c1f = torch.floor(dc)
    r1f = torch.floor(dr)
    fc = dc - c1f
    fr = dr - r1f
    c1 = c1f.long()
    r1 = r1f.long()
    dev = img.device
    base_r = torch.arange(h, device=dev)[None, :, None]
    base_c = torch.arange(w, device=dev)[None, None, :]

    vals = torch.cat([img, torch.ones_like(img[:, :1])], dim=1).reshape(
        b, c + 1, h * w)
    acc = torch.zeros_like(vals)
    for ddr in (0, 1):
        for ddc in (0, 1):
            wgt = torch.exp(-((fr - ddr) ** 2 + (fc - ddc) ** 2))
            tr = base_r + r1 + ddr
            tc = base_c + c1 + ddc
            valid = (tr >= 0) & (tr < h) & (tc >= 0) & (tc < w)
            wgt = wgt * valid.to(img.dtype)
            idx = (tr.clamp(0, h - 1) * w + tc.clamp(0, w - 1)).reshape(
                b, 1, h * w)
            acc.scatter_add_(2, idx.expand(b, c + 1, h * w),
                             vals * wgt.reshape(b, 1, h * w))
    acc = acc.reshape(b, c + 1, h, w)
    return acc[:, :c], acc[:, c:]


def bilinear_gather_plain_vjp(img: torch.Tensor, coords: torch.Tensor,
                              relative: bool, grad_out: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``bilinear_gather_bwd`` kernel: the vjp of
    :func:`bilinear_gather_plain`'s first output for the cotangent
    grad_out [B,C,Hq,Wq], by autograd. Returns (grad_img [B,C,H,W],
    grad_coords [B,2,Hq,Wq])."""
    with torch.enable_grad():
        img = img.detach().requires_grad_(True)
        coords = coords.detach().requires_grad_(True)
        out, _ = bilinear_gather_plain(img, coords, relative)
        grad_img, grad_coords = torch.autograd.grad(out, (img, coords),
                                                    grad_out)
    return grad_img, grad_coords


def fwarp_splat_plain_vjp(img: torch.Tensor, flo: torch.Tensor,
                          grad_out: torch.Tensor, grad_norm: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``fwarp_splat_bwd`` kernel: the vjp of
    :func:`fwarp_splat_plain` for the cotangents grad_out [B,C,H,W] and
    grad_norm [B,1,H,W], by autograd. Returns (grad_img [B,C,H,W],
    grad_flo [B,2,H,W])."""
    with torch.enable_grad():
        img = img.detach().requires_grad_(True)
        flo = flo.detach().requires_grad_(True)
        out, norm = fwarp_splat_plain(img, flo)
        grad_img, grad_flo = torch.autograd.grad(
            (out, norm), (img, flo), (grad_out, grad_norm))
    return grad_img, grad_flo


def fwarp_shift_plain(img: torch.Tensor, flo: torch.Tensor, d: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``fwarp_shift`` kernel: the forward warp as a
    stencil sum, with no scatter.

    For displacements with floor(flo) in [-d, d] every source pixel's
    4-corner Gaussian splat lands within a (2d+2)^2 neighbourhood, and
    the Gaussian weights are separable, so
        out = sum over dy, dx in [-d, d+1] of
              shift(vals * (MY[dy] * MX[dx]), dy, dx),
        MY[dy] = [r1 == dy] * wy0 + [r1 == dy-1] * wy1  (MX likewise),
    with vals = (img, 1). The terms are added in the kernel's order (dy
    outer, dx inner) in float32, so on one device the two agree bit for
    bit. Equal to :func:`fwarp_splat_plain` to rounding wherever
    max|flo| <= d - 1; splats beyond the window, and outside the image,
    are dropped. Returns (warped [B,C,H,W], weight norm [B,1,H,W])."""
    b, c, h, w = img.shape
    dc = flo[:, 0:1].float()
    dr = flo[:, 1:2].float()
    c1 = torch.floor(dc)
    r1 = torch.floor(dr)
    fc = dc - c1
    fr = dr - r1
    fc1 = fc - 1.0
    fr1 = fr - 1.0
    wy = (torch.exp(-(fr * fr)), torch.exp(-(fr1 * fr1)))
    wx = (torch.exp(-(fc * fc)), torch.exp(-(fc1 * fc1)))
    zero = torch.zeros_like(dc)
    span = range(-d, d + 2)
    my = {dy: torch.where(r1 == dy, wy[0], zero)
          + torch.where(r1 == dy - 1, wy[1], zero) for dy in span}
    mx = {dx: torch.where(c1 == dx, wx[0], zero)
          + torch.where(c1 == dx - 1, wx[1], zero) for dx in span}

    vals = torch.cat([img.float(), torch.ones_like(dc)], dim=1)
    # a canvas with a margin of d + 1 makes every shift a slice; the
    # margin takes the splats that leave the image
    s = d + 1
    acc = vals.new_zeros((b, c + 1, h + 2 * s, w + 2 * s))
    for dy in span:
        for dx in span:
            acc[:, :, s + dy:s + dy + h, s + dx:s + dx + w] += \
                vals * (my[dy] * mx[dx])
    out = acc[:, :, s:s + h, s:s + w]
    return (out[:, :c].to(img.dtype).contiguous(),
            out[:, c:].to(img.dtype).contiguous())


# ---------------------------------------------------------------------------
# Public ops: each goes through a kernel wrapper (plain version on the CPU,
# the CUDA kernel on the card).
# ---------------------------------------------------------------------------
def bwarp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = x(p + flow(p)), bilinear, zero padding, times the hard
    mask (in-image weight >= 0.999)."""
    out, _ = kernels.bilinear_gather(x.contiguous(), flow.contiguous(),
                                     relative=True, want_ones=False)
    return out


def bwarp_pair(a: torch.Tensor, b: torch.Tensor,
               flow_a: torch.Tensor, flow_b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions' backward warps as one gather (one kernel launch
    that takes both halves' pointers: nothing is concatenated). The two
    halves must have equal shapes."""
    if a.shape != b.shape or flow_a.shape != flow_b.shape:
        raise ValueError(f"bwarp_pair: unequal halves {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(flow_a.shape)}, "
                         f"{tuple(flow_b.shape)}")
    outs, _ = kernels.bilinear_gather_pair(
        a.contiguous(), b.contiguous(), flow_a.contiguous(),
        flow_b.contiguous(), relative=True)
    return outs


def bilinear_sample_abs(img: torch.Tensor, coords: torch.Tensor
                        ) -> torch.Tensor:
    """Bilinear sample at absolute pixel coordinates coords [B,2,Hq,Wq]
    (channel 0 = x, channel 1 = y), zero padding; no base grid is added
    (FGAC's trained-in absolute-coordinate behaviour)."""
    out, _ = kernels.bilinear_gather(img.contiguous(), coords.contiguous(),
                                     relative=False)
    return out


def fwarp(img: torch.Tensor, flo: torch.Tensor, shift_d: int = 0
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward warp (Gaussian splat). Returns (warped, weight norm); the
    caller normalises.

    shift_d == 0: the atomic splat kernel. shift_d > 0: the
    deterministic stencil kernel if no |flo| exceeds shift_d - 1, the
    atomic splat otherwise; both are exact, only the first gives the
    same bits every run (``kernels.fwarp_guarded``; which kernel served
    a call is counted on the device, ``kernels.fwarp_served``)."""
    img = img.contiguous()
    flo = flo.contiguous()
    if shift_d <= 0:
        return kernels.fwarp_splat(img, flo)
    return kernels.fwarp_guarded(img, flo, shift_d)


def cfr_flow_t_align(flow_01: torch.Tensor, flow_10: torch.Tensor,
                     t: torch.Tensor, shift_d: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complementary Flow Reversal (from XVFI). flow_01/flow_10
    [B,2,H,W]; t broadcastable to [B,1,1,1]; shift_d as in
    :func:`fwarp`. Returns (flow_t0, flow_t1).

    The mask reads the detached norm (> 0); where it is 0 the flows pass
    through unnormalised (denominator norm + (1 - mask))."""
    t = t.reshape(-1, 1, 1, 1).to(flow_01.dtype)
    w01, n0 = fwarp(flow_01, t * flow_01, shift_d)
    w10, n1 = fwarp(flow_10, (1.0 - t) * flow_10, shift_d)

    flow_t0 = -(1.0 - t) * t * w01 + t * t * w10
    flow_t1 = (1.0 - t) * (1.0 - t) * w01 - t * (1.0 - t) * w10

    norm = (1.0 - t) * n0 + t * n1
    mask = (norm.detach() > 0).to(flow_01.dtype)
    denom = norm + (1.0 - mask)
    flow_t0 = (1.0 - mask) * flow_t0 + mask * (flow_t0 / denom)
    flow_t1 = (1.0 - mask) * flow_t1 + mask * (flow_t1 / denom)
    return flow_t0, flow_t1


def _avg_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """avg_pool2d(kernel=k, stride=1, padding=k//2), padding counted in
    the average. Identity for k == 1."""
    if k == 1:
        return x
    return F.avg_pool2d(x, k, stride=1, padding=k // 2,
                        count_include_pad=True)


def fgac_window_coords(flow: torch.Tensor, rr: int) -> torch.Tensor:
    """The [B, 2, H*G, W*G] query grid (G = 2rr+1) of FGAC's window
    form: the flow field tiled G x G, plus per-pixel window offsets with
    the row index offsetting x and the column index offsetting y."""
    h, w = flow.shape[-2:]
    g = 2 * rr + 1
    rows = torch.arange(h * g, device=flow.device)
    cols = torch.arange(w * g, device=flow.device)
    off_x = ((rows % g) - rr).to(flow.dtype)      # row index -> x offset
    off_y = ((cols % g) - rr).to(flow.dtype)      # col index -> y offset
    fx = flow[:, 0].repeat(1, g, g)               # [B, H*G, W*G]
    fy = flow[:, 1].repeat(1, g, g)
    return torch.stack([fx + off_x[None, :, None],
                        fy + off_y[None, None, :]], dim=1)


def fgac_correlate(ref_k: torch.Tensor, source_k: torch.Tensor,
                   flow: torch.Tensor, rr: int = 0, sr: int = 0
                   ) -> torch.Tensor:
    """Flow-Guided Attentive Correlation aggregation (Eq. 3).

    Samples ref_k at the *absolute* coordinates given by flow (plus window
    offsets for rr > 0), correlates with source_k over channels, softmaxes
    over the (2rr+1)^2 window and returns the attention-weighted sum. At
    rr = sr = 0 (the released model) this is one bilinear gather of ref_k
    at the flow coordinates.

    rr > 0 reproduces the reference's executed code, quirks included: the
    offset grid is transposed (the window row index offsets x, the column
    index offsets y); the centroid canvas tiles the flow field while the
    offsets interleave per-pixel windows; and the strided unfold with
    padding rr re-extracts windows shifted by -rr block cells. All taps
    are gathered in one sample over the (H*G, W*G) query grid."""
    ref_k = _avg_pool_same(ref_k, 2 * sr + 1)
    if rr == 0:
        return bilinear_sample_abs(ref_k, flow)

    source_k = _avg_pool_same(source_k, 2 * sr + 1)
    b, c, h, w = ref_k.shape
    g = 2 * rr + 1
    sampled = bilinear_sample_abs(ref_k, fgac_window_coords(flow, rr))

    bi = sampled.reshape(b, c, h, g, w, g).permute(0, 1, 3, 2, 5, 4)
    bi = bi.reshape(b, c, g * h, g * w)
    bip = F.pad(bi, (rr, rr, rr, rr))
    taps = []
    corrs = []
    for p in range(g):
        for q in range(g):
            tap = bip[:, :, p::g, q::g][:, :, :h, :w]
            taps.append(tap)
            corrs.append(torch.sum(tap * source_k, dim=1))
    taps = torch.stack(taps, dim=2)               # [B, C, K, H, W]
    corr = torch.stack(corrs, dim=1)              # [B, K, H, W]
    attn = torch.softmax(corr, dim=1)
    return torch.sum(taps * attn[:, None], dim=2)
