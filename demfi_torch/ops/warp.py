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
  - :func:`fwarp_pair`  two forward warps of equal shapes, whose
    backward on the card is one launch;
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
The kernels take contiguous NCHW tensors, and each public op hands them
its inputs through ``kernels.nchw``: a channels_last input (the bf16
model's on the card) is copied there, and the copy counted
(``kernels.layout_counts``); the outputs are NCHW.

Rows of a split frame: each public op takes ``shard``, a
:class:`~demfi_torch.parallel.RowShard` (None: the whole frame). Its
tensors are then the shard's rows, and so is its result, those rows of
the whole frame's result. A backward warp gathers the whole source frame
(``allgather_rows``) and samples it for its rows at their own grid rows
(the gather's row offset); a forward warp by the atomic splat splats its
source rows into a zeroed canvas of the whole frame, the ranks' canvases
are summed (``allreduce_sum``) and each keeps its rows; by the stencil
it takes a halo of the window's rows of img and flo, and gives its rows
bit for bit. The choice between the two (``shift_d > 0``) reads every
rank's flows: one flag a half, reduced over the group and read on the
host. FGAC's point-wise sample (rr = 0) samples the whole ref frame at
the shard's coordinates; its window form (rr > 0) is not row-local (the
tiled centroid canvas and shifted unfold), so it runs on the whole
frame's inputs and keeps the shard's rows.

A split frame trains too: every collective has its backward
(``demfi_torch.parallel.halo``), so a gathered source's gradient, the
whole frame's, is summed over the group and each rank keeps its rows,
and a splat's canvases take the whole frame's cotangents (the backward
of their sum), on which the backward kernels run at the same row
offsets (``bilinear_gather_bwd(row0=)``, ``fwarp_splat_bwd(rows=)``).
The stencil's gradient is the splat's, as unsplit: the splat's backward
of its rows and halo for its rows' cotangent, the halo rows' gradient
sent home by the exchange's backward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from demfi_torch.ops import kernels
from demfi_torch.parallel.halo import (allgather_rows, allreduce_max,
                                       allreduce_sum, exchange_rows)


def _bilinear_zeros(img: torch.Tensor, px: torch.Tensor, py: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample of img [B,C,H,W] at pixel coords px, py [B,Hq,Wq],
    zero padding: a corner tap outside the image contributes zero.

    Returns (sampled [B,C,Hq,Wq], in-image weight [B,1,Hq,Wq]), both
    float32; the second is the same sample of an all-ones image. The
    image is read as float32 (a bfloat16 image widens exactly), so under
    autograd its gradient sums in float32 and rounds to its dtype once,
    as the backward kernel does."""
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
    flat = img.float().reshape(b, c, h * w)

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
            contrib = tap * wgt.reshape(b, 1, hq * wq)
            out = contrib if out is None else out + contrib
            ones = wgt if ones is None else ones + wgt
    return out.reshape(b, c, hq, wq), ones[:, None]


def bilinear_gather_plain(img: torch.Tensor, coords: torch.Tensor,
                          relative: bool, row0: int = 0
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the ``bilinear_gather`` kernel.

    img [B,C,H,W] float32 or bfloat16, coords [B,2,Hq,Wq] float32
    (channel 0 = x, channel 1 = y); the outputs are float32.
    relative: sample at ``grid + coords`` (Hq, Wq == H, W), multiply by
    the hard mask (in-image weight >= 0.999, in float32) and return
    (out, in-image weight). Absolute: sample at ``coords`` and return
    (out, None). row0 (relative mode): the query grid is rows [row0,
    row0 + Hq) of the image grid (a card's rows of a frame split by
    rows)."""
    w = img.shape[-1]
    hq = coords.shape[-2]
    px = coords[:, 0].float()
    py = coords[:, 1].float()
    if relative:
        dev = img.device
        px = torch.arange(w, dtype=torch.float32, device=dev)[None, None] + px
        py = torch.arange(row0, row0 + hq, dtype=torch.float32,
                          device=dev)[None, :, None] + py
    out, ones = _bilinear_zeros(img, px, py)
    if not relative:
        return out, None
    return out * (ones >= 0.999).to(out.dtype), ones


def fwarp_splat_plain(img: torch.Tensor, flo: torch.Tensor,
                      rows: Optional[Tuple[int, int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``fwarp_splat`` kernel: a deterministic
    scatter-add.

    Each source pixel p adds img(p) * wgt and wgt to the 4 integer
    corners (r1 + p_y + dr, c1 + p_x + dc), dr, dc in {0, 1}, where
    r1, c1 = floor(flo) (bucketed by the displacement, then added to the
    integer base grid) and wgt = exp(-((fr - dr)^2 + (fc - dc)^2)) of the
    fractional parts. Corners outside the image are dropped.
    Returns (warped [B,C,H,W], weight norm [B,1,H,W]).
    rows=(r0, Ho): img and flo are rows [r0, r0 + H) of a frame of Ho
    rows, and the outputs are that frame's canvases ([B,C,Ho,W],
    [B,1,Ho,W]) with only these rows' splats."""
    b, c, h, w = img.shape
    r0, ho = (0, h) if rows is None else rows
    dc = flo[:, 0]
    dr = flo[:, 1]
    c1f = torch.floor(dc)
    r1f = torch.floor(dr)
    fc = dc - c1f
    fr = dr - r1f
    c1 = c1f.long()
    r1 = r1f.long()
    dev = img.device
    base_r = torch.arange(r0, r0 + h, device=dev)[None, :, None]
    base_c = torch.arange(w, device=dev)[None, None, :]

    vals = torch.cat([img, torch.ones_like(img[:, :1])], dim=1).reshape(
        b, c + 1, h * w)
    acc = vals.new_zeros((b, c + 1, ho * w))
    for ddr in (0, 1):
        for ddc in (0, 1):
            wgt = torch.exp(-((fr - ddr) ** 2 + (fc - ddc) ** 2))
            tr = base_r + r1 + ddr
            tc = base_c + c1 + ddc
            valid = (tr >= 0) & (tr < ho) & (tc >= 0) & (tc < w)
            wgt = wgt * valid.to(img.dtype)
            idx = (tr.clamp(0, ho - 1) * w + tc.clamp(0, w - 1)).reshape(
                b, 1, h * w)
            acc.scatter_add_(2, idx.expand(b, c + 1, h * w),
                             vals * wgt.reshape(b, 1, h * w))
    acc = acc.reshape(b, c + 1, ho, w)
    return acc[:, :c], acc[:, c:]


def bilinear_gather_plain_vjp(img: torch.Tensor, coords: torch.Tensor,
                              relative: bool, grad_out: torch.Tensor,
                              row0: int = 0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``bilinear_gather_bwd`` kernel: the vjp of
    :func:`bilinear_gather_plain`'s first output for the cotangent
    grad_out [B,C,Hq,Wq], by autograd. Returns (grad_img [B,C,H,W] in the
    image's dtype, summed in float32 and rounded once, grad_coords
    [B,2,Hq,Wq] float32). row0 as for :func:`bilinear_gather_plain`: the
    query rows of a shard, the image's gradient the whole image's."""
    with torch.enable_grad():
        img = img.detach().requires_grad_(True)
        coords = coords.detach().requires_grad_(True)
        out, _ = bilinear_gather_plain(img, coords, relative, row0)
        grad_img, grad_coords = torch.autograd.grad(out, (img, coords),
                                                    grad_out)
    return grad_img, grad_coords


def fwarp_splat_plain_vjp(img: torch.Tensor, flo: torch.Tensor,
                          grad_out: torch.Tensor, grad_norm: torch.Tensor,
                          rows: Optional[Tuple[int, int]] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the ``fwarp_splat_bwd`` kernel: the vjp of
    :func:`fwarp_splat_plain` for the cotangents grad_out [B,C,H,W] and
    grad_norm [B,1,H,W], by autograd. Returns (grad_img [B,C,H,W],
    grad_flo [B,2,H,W]). rows=(r0, Ho) as for :func:`fwarp_splat_plain`:
    img and flo are a shard's rows, the cotangents [B,C,Ho,W] and
    [B,1,Ho,W] canvases of the whole frame."""
    with torch.enable_grad():
        img = img.detach().requires_grad_(True)
        flo = flo.detach().requires_grad_(True)
        out, norm = fwarp_splat_plain(img, flo, rows)
        grad_img, grad_flo = torch.autograd.grad(
            (out, norm), (img, flo), (grad_out, grad_norm))
    return grad_img, grad_flo


def fwarp_shift_plain(img: torch.Tensor, flo: torch.Tensor, d: int,
                      rows: Optional[Tuple[int, int]] = None
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
    are dropped. Returns (warped [B,C,H,W], weight norm [B,1,H,W]).
    rows=(row_off, Ho): only output rows [row_off, row_off + Ho), bit for
    bit those rows of the call without rows."""
    b, c, h, w = img.shape
    row_off, ho = (0, h) if rows is None else rows
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
    out = acc[:, :, s + row_off:s + row_off + ho, s:s + w]
    return (out[:, :c].to(img.dtype).contiguous(),
            out[:, c:].to(img.dtype).contiguous())


# ---------------------------------------------------------------------------
# Public ops: each goes through a kernel wrapper (plain version on the CPU,
# the CUDA kernel on the card).
# ---------------------------------------------------------------------------
def bwarp(x: torch.Tensor, flow: torch.Tensor, shard=None) -> torch.Tensor:
    """out(p) = x(p + flow(p)), bilinear, zero padding, times the hard
    mask (in-image weight >= 0.999)."""
    if shard is not None:
        out, _ = kernels.bilinear_gather(
            allgather_rows(x, shard), kernels.nchw(flow), relative=True,
            want_ones=False, row0=shard.r0)
        return out
    out, _ = kernels.bilinear_gather(kernels.nchw(x), kernels.nchw(flow),
                                     relative=True, want_ones=False)
    return out


def bwarp_pair(a: torch.Tensor, b: torch.Tensor,
               flow_a: torch.Tensor, flow_b: torch.Tensor, shard=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions' backward warps as one gather (one kernel launch
    that takes both halves' pointers: nothing is concatenated). The two
    halves must have equal shapes."""
    if a.shape != b.shape or flow_a.shape != flow_b.shape:
        raise ValueError(f"bwarp_pair: unequal halves {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(flow_a.shape)}, "
                         f"{tuple(flow_b.shape)}")
    if shard is not None:
        outs, _ = kernels.bilinear_gather_pair(
            allgather_rows(a, shard), allgather_rows(b, shard),
            kernels.nchw(flow_a), kernels.nchw(flow_b), relative=True,
            row0=shard.r0)
        return outs
    outs, _ = kernels.bilinear_gather_pair(
        kernels.nchw(a), kernels.nchw(b), kernels.nchw(flow_a),
        kernels.nchw(flow_b), relative=True)
    return outs


def bilinear_sample_abs(img: torch.Tensor, coords: torch.Tensor, shard=None
                        ) -> torch.Tensor:
    """Bilinear sample at absolute pixel coordinates coords [B,2,Hq,Wq]
    (channel 0 = x, channel 1 = y), zero padding; no base grid is added
    (FGAC's trained-in absolute-coordinate behaviour)."""
    if shard is not None:
        img = allgather_rows(img, shard)
    out, _ = kernels.bilinear_gather(kernels.nchw(img), kernels.nchw(coords),
                                     relative=False)
    return out


def _fwarp_rows(halves, shift_d: int, shard):
    """:func:`fwarp` of each (img, flo) half of a shard's rows. With
    shift_d > 0 a half takes the stencil where no |flo| of the whole
    frame exceeds shift_d - 1 (one flag a half, reduced over the group
    and read on the host), else the splat. The halves that take one
    kernel go together: one sum of their canvases, or one stencil
    Function, and one backward launch."""
    wide = [True] * len(halves)
    if shift_d > 0:
        with torch.no_grad():
            flags = torch.stack([(f.abs() > float(shift_d - 1)).any()
                                 for _, f in halves]).float()
            wide = [v > 0 for v in allreduce_max(flags, shard).tolist()]
    if len(set(wide)) == 1:
        return (_splat_rows(halves, shard) if wide[0]
                else _shift_rows(halves, shift_d, shard))
    return [_splat_rows([half], shard)[0] if w
            else _shift_rows([half], shift_d, shard)[0]
            for half, w in zip(halves, wide)]


def _splat_rows(halves, shard):
    """The splat of each half's rows of a shard into canvases of the
    whole frame, the group's canvases summed (one all-reduce for every
    half), this shard's rows kept."""
    rows = (shard.r0, shard.h)
    if len(halves) == 2:
        canvases = kernels.fwarp_pair(*halves[0], *halves[1], rows=rows)
    else:
        canvases = [kernels.fwarp_splat(*halves[0], rows=rows)]
    flat = [t for pair in canvases for t in pair]
    both = allreduce_sum(torch.cat([t.reshape(-1) for t in flat]), shard)
    out, at = [], 0
    for t in flat:
        whole = both[at:at + t.numel()].view(t.shape)
        out.append(whole[:, :, shard.r0:shard.r1].contiguous())
        at += t.numel()
    return [tuple(out[k:k + 2]) for k in range(0, len(out), 2)]


def _shift_rows(halves, d: int, shard):
    """The stencil's sum for a shard's rows of each half: the halves' rows
    of img and flo with d + 1 rows above and d below, as far as the frame
    reaches (one ``exchange_rows`` for every half), summed for its rows
    (``kernels.fwarp_pair`` or ``kernels.fwarp_shift`` with rows). The
    gradient of the halo rows goes home through the exchange's
    backward."""
    up, down = d + 1, d
    rows = halves[0][0].shape[2]
    top = up if shard.index > 0 else 0
    bottom = down if shard.index < shard.size - 1 else 0
    flat = [t for half in halves for t in half]
    sizes = [t.shape[1] for t in flat]
    both = exchange_rows(torch.cat(flat, dim=1), up, down, shard)
    parts = [t.contiguous() for t in
             both[:, :, up - top:up + rows + bottom].split(sizes, dim=1)]
    if len(halves) == 2:
        return list(kernels.fwarp_pair(*parts, d=d, rows=(top, rows)))
    return [kernels.fwarp_shift(*parts, d, rows=(top, rows))]


def fwarp(img: torch.Tensor, flo: torch.Tensor, shift_d: int = 0, shard=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward warp (Gaussian splat). Returns (warped, weight norm); the
    caller normalises.

    shift_d == 0: the atomic splat kernel. shift_d > 0: the
    deterministic stencil kernel if no |flo| exceeds shift_d - 1, the
    atomic splat otherwise; both are exact, only the first gives the
    same bits every run (``kernels.fwarp_guarded``; which kernel served
    a call is counted on the device, ``kernels.fwarp_served``)."""
    img = kernels.nchw(img)
    flo = kernels.nchw(flo)
    if shard is not None:
        return tuple(_fwarp_rows([(img, flo)], shift_d, shard)[0])
    if shift_d <= 0:
        return kernels.fwarp_splat(img, flo)
    return kernels.fwarp_guarded(img, flo, shift_d)


def fwarp_pair(img_a: torch.Tensor, flo_a: torch.Tensor,
               img_b: torch.Tensor, flo_b: torch.Tensor, shift_d: int = 0,
               shard=None):
    """:func:`fwarp` of two halves of equal shapes: ((warped_a, norm_a),
    (warped_b, norm_b)), each what :func:`fwarp` returns. On the card the
    forward kernels run once per half and, under autograd, the two
    backwards are one launch (``kernels.fwarp_pair``)."""
    if img_a.shape != img_b.shape or flo_a.shape != flo_b.shape:
        raise ValueError(f"fwarp_pair: unequal halves {tuple(img_a.shape)}, "
                         f"{tuple(img_b.shape)}, {tuple(flo_a.shape)}, "
                         f"{tuple(flo_b.shape)}")
    if shard is not None:
        return tuple(tuple(half) for half in _fwarp_rows(
            [(kernels.nchw(img_a), kernels.nchw(flo_a)),
             (kernels.nchw(img_b), kernels.nchw(flo_b))], shift_d, shard))
    return kernels.fwarp_pair(kernels.nchw(img_a), kernels.nchw(flo_a),
                              kernels.nchw(img_b), kernels.nchw(flo_b),
                              shift_d)


def cfr_flow_t_align(flow_01: torch.Tensor, flow_10: torch.Tensor,
                     t: torch.Tensor, shift_d: int = 0, shard=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complementary Flow Reversal (from XVFI). flow_01/flow_10
    [B,2,H,W]; t broadcastable to [B,1,1,1]; shift_d as in
    :func:`fwarp`. Returns (flow_t0, flow_t1). Its two forward warps go
    through :func:`fwarp_pair`.

    The mask reads the detached norm (> 0); where it is 0 the flows pass
    through unnormalised (denominator norm + (1 - mask))."""
    t = t.reshape(-1, 1, 1, 1).to(flow_01.dtype)
    (w01, n0), (w10, n1) = fwarp_pair(flow_01, t * flow_01,
                                      flow_10, (1.0 - t) * flow_10, shift_d,
                                      shard)

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
                   flow: torch.Tensor, rr: int = 0, sr: int = 0, shard=None
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
    if shard is not None:
        ref_k = allgather_rows(ref_k, shard)
        if rr > 0:
            whole = fgac_correlate(ref_k, allgather_rows(source_k, shard),
                                   allgather_rows(flow, shard), rr, sr)
            return whole[:, :, shard.r0:shard.r1]
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
