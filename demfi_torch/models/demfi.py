"""DeMFI-Net in PyTorch (NCHW).

Stage I (feature-flow warping and blending, FAC-FB, refine U-Net, joint
3-frame decoder) and Stage II (recursive boosting with a separable
ConvGRU). Module attribute names are the reference torch model's, so the
``state_dict`` keys and shapes are the reference's: ``Dec_first``,
``Decoder_res``, ``Dec_last1`` and ``Dec_last2`` keep 5-D Conv3d weights
with temporal extent 1 and run as 2-D convs with the three frames folded
into the batch (identical math).

``extract`` (t-independent: RDN backbone + FAC-FB) is split from
``synthesize`` (t-dependent), so all instants of a window share one
backbone pass. The boosting loop is a plain Python loop; the Mixer's
reference branch is loop-invariant and is encoded once before it.
Flows stay float32 throughout.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from demfi_torch.config import DeMFIConfig
from demfi_torch.ops import (
    bwarp_pair,
    cfr_flow_t_align,
    fgac_correlate,
    space_to_depth,
)


def _conv(cin: int, cout: int, k=3, stride: int = 1, pad=None) -> nn.Conv2d:
    if pad is None:
        pad = tuple((kk - 1) // 2 for kk in k) if isinstance(k, tuple) \
            else (k - 1) // 2
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, bias=True)


class _Conv3dT1(nn.Conv3d):
    """The reference's Conv3d with kernel [1, 3, 3]: keeps the 5-D weight
    (checkpoint keys and shapes) and runs as a 2-D conv on [B*T, C, H, W]
    with the frames folded into the batch."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (1, 3, 3), padding=(0, 1, 1), bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight[:, :, 0], self.bias, padding=1)


def _minmax_norm(v: torch.Tensor) -> torch.Tensor:
    """Per-sample min-max normalisation over C, H, W. The max may be 0,
    and the result is then NaN, as in the reference."""
    lo = torch.amin(v, dim=(1, 2, 3), keepdim=True)
    v = v - lo
    hi = torch.amax(v, dim=(1, 2, 3), keepdim=True)
    return v / hi


def _t_blend(a: torch.Tensor, b: torch.Tensor, occ_0: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """Occlusion-weighted temporal blend, Eq. (2)."""
    occ_1 = 1.0 - occ_0
    num = (1.0 - t) * occ_0 * a + t * occ_1 * b
    den = (1.0 - t) * occ_0 + t * occ_1
    return num / den


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """UpsamplingNearest2d(scale_factor=2)."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(
        b, c, 2 * h, 2 * w)


# --------------------------------------------------------------------------
# Stage I building blocks
# --------------------------------------------------------------------------
class RDBConv(nn.Module):
    """One dense conv of an RDB: conv + relu, concatenated to the input."""

    def __init__(self, cin: int, growth: int):
        super().__init__()
        self.conv = nn.Sequential(_conv(cin, growth, 3), nn.ReLU())

    def forward(self, x):
        return torch.cat([x, self.conv(x)], dim=1)


class RDB(nn.Module):
    """Residual dense block."""

    def __init__(self, g0: int, growth: int, n_convs: int):
        super().__init__()
        self.convs = nn.Sequential(*[RDBConv(g0 + i * growth, growth)
                                     for i in range(n_convs)])
        self.LFF = _conv(g0 + n_convs * growth, g0, 1)

    def forward(self, x):
        return self.LFF(self.convs(x)) + x


class FFRDB(nn.Module):
    """Feature and flow extractor: 4 blurry frames -> space_to_depth(2) ->
    RDN backbone at half resolution -> pixel-shuffle head ->
    (F0, F1, flow_01, flow_10, occ_0_logit) at full resolution."""

    def __init__(self, nf: int, scale_factor: int = 2, g0: int = 96,
                 num_rdb: int = 12, n_convs: int = 4, growth: int = 32,
                 img_ch: int = 3):
        super().__init__()
        self.nf = nf
        self.scale_factor = scale_factor
        self.SFENet1 = _conv(4 * img_ch * scale_factor ** 2, g0, 5)
        self.SFENet2 = _conv(g0, g0, 3)
        self.RDBs = nn.ModuleList([RDB(g0, growth, n_convs)
                                   for _ in range(num_rdb)])
        self.GFF = nn.Sequential(_conv(num_rdb * g0, g0, 1), _conv(g0, g0, 3))
        self.UPNet = nn.Sequential(_conv(g0, 256, 3), nn.PixelShuffle(2),
                                   _conv(64, nf * 2 + 4 + 1, 3))

    def forward(self, frames):
        # frames: [B, 12, H, W] = (B0, B1, Bm1, B2) x 3 channels
        nf = self.nf
        x = space_to_depth(frames, self.scale_factor)
        f1 = self.SFENet1(x)
        x = self.SFENet2(f1)
        rdb_outs = []
        for rdb in self.RDBs:
            x = rdb(x)
            rdb_outs.append(x)
        x = self.GFF(torch.cat(rdb_outs, dim=1)) + f1
        s = self.UPNet(x)
        f0f1 = torch.tanh(s[:, :2 * nf])
        flow_01 = s[:, 2 * nf:2 * nf + 2].float()
        flow_10 = s[:, 2 * nf + 2:2 * nf + 4].float()
        occ = s[:, 2 * nf + 4:2 * nf + 5]
        return f0f1[:, :nf], f0f1[:, nf:], flow_01, flow_10, occ


class ResBlock(nn.Module):
    """conv-relu-conv residual block, no BN."""

    def __init__(self, nf: int, conv3d: bool = False):
        super().__init__()
        mk = _Conv3dT1 if conv3d else (lambda i, o: _conv(i, o, 3))
        self.conv1 = mk(nf, nf)
        self.conv2 = mk(nf, nf)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class FGAC(nn.Module):
    """Flow-Guided Attentive Correlation: correlates source keys with ref
    keys gathered at the raw flow values (absolute coordinates), then
    gates the aggregated feature against the source (Eq. 3-4)."""

    def __init__(self, nf: int, rr: int = 0, sr: int = 0, viz: bool = False):
        super().__init__()
        self.rr, self.sr, self.viz = rr, sr, viz
        self.conv_ref_k = _conv(nf, nf, 1)
        self.conv_source_k = _conv(nf, nf, 1)
        self.fusion = _conv(nf, nf, 1)
        self.w_gen = _conv(2 * nf, nf, 3)
        self.w_gen_2 = _conv(nf, 1, 3)

    def forward(self, ref, source, flow_s2r):
        ref_k = self.conv_ref_k(ref)
        source_k = self.conv_source_k(source)
        fac = fgac_correlate(ref_k, source_k, flow_s2r.float(),
                             rr=self.rr, sr=self.sr)
        e_s = self.fusion(fac)
        w = torch.sigmoid(self.w_gen_2(F.relu(self.w_gen(
            torch.cat([source, e_s], dim=1)))))
        bolstered = w * source + (1.0 - w) * e_s
        diff = _minmax_norm(torch.mean(torch.abs(bolstered - source), dim=1,
                                       keepdim=True))
        if self.viz:
            # min-max-normalised mean-|.| single-channel views of the FGAC
            # internals: source key, initial ref key, aggregated E_s,
            # bolstered ("FCW")
            def norm1(v):
                return _minmax_norm(torch.mean(torch.abs(v), dim=1,
                                               keepdim=True))
            extras = (norm1(source), norm1(ref_k), norm1(e_s),
                      norm1(bolstered))
        else:
            extras = ()
        return bolstered, w, diff, extras


class FACFB(nn.Module):
    """Feature bolstering with (shared) FGAC."""

    def __init__(self, nf: int, num_res_blocks: int, shared: bool = True,
                 rr: int = 0, sr: int = 0, viz: bool = False):
        super().__init__()
        self.nf, self.shared = nf, shared
        self.conv_first = _conv(nf, nf, 3)
        self.feature_extraction = nn.Sequential(
            *[ResBlock(nf) for _ in range(num_res_blocks)])
        if shared:
            self.shared_FGAC = FGAC(nf, rr, sr, viz)
        else:
            self.FGAC_F1toF0 = FGAC(nf, rr, sr, viz)
            self.FGAC_F0toF1 = FGAC(nf, rr, sr, viz)

    def forward(self, f0, f1, flow_10, flow_01):
        b, c, h, w = f0.shape
        x = torch.stack([f0, f1], dim=1).reshape(b * 2, c, h, w)
        x = F.relu(self.conv_first(x))
        x = self.feature_extraction(x)
        enc = x.reshape(b, 2, self.nf, h, w)
        enc0, enc1 = enc[:, 0], enc[:, 1]
        g10 = self.shared_FGAC if self.shared else self.FGAC_F1toF0
        g01 = self.shared_FGAC if self.shared else self.FGAC_F0toF1
        a_f0, bw0, d10, x10 = g10(enc1, enc0, flow_01)   # F1 -> F0
        a_f1, bw1, d01, x01 = g01(enc0, enc1, flow_10)   # F0 -> F1
        return a_f0, a_f1, (bw0, bw1), (d10, d01), (x10, x01)


class RefineUNet(nn.Module):
    """3-level strided-conv U-Net (k=4, stride 2, pad 1 encoders)."""

    def __init__(self, nf: int):
        super().__init__()
        self.enc1 = _conv(3 * nf + 9, nf, 4, 2, 1)
        self.enc2 = _conv(nf, 2 * nf, 4, 2, 1)
        self.enc3 = _conv(2 * nf, 4 * nf, 4, 2, 1)
        self.dec0 = _conv(4 * nf, 4 * nf, 3)
        self.dec1 = _conv(6 * nf, 2 * nf, 3)
        self.dec2 = _conv(3 * nf, nf, 3)
        self.dec3 = _conv(nf, 2 * 2 + 1 + 2 * nf, 3)

    def forward(self, x):
        e1 = F.relu(self.enc1(x))
        e2 = F.relu(self.enc2(e1))
        h = F.relu(self.enc3(e2))
        h = _nearest_up2(F.relu(self.dec0(h)))
        h = _nearest_up2(F.relu(self.dec1(torch.cat([h, e2], dim=1))))
        h = _nearest_up2(F.relu(self.dec2(torch.cat([h, e1], dim=1))))
        return self.dec3(h)


# --------------------------------------------------------------------------
# Stage II (recursive boosting)
# --------------------------------------------------------------------------
class Mixer(nn.Module):
    """Two-branch ref/delta encoder. The ref branch is loop-invariant
    across boosting iterations, so ``encode_ref`` is exposed for the model
    to run once per window (exact, same parameters)."""

    def __init__(self, nf: int, ref_ch: int = 30, delta_ch: int = 5):
        super().__init__()
        self.conv_ref1 = _conv(ref_ch, nf // 2, 7)
        self.conv_ref2 = _conv(nf // 2, nf // 2, 3)
        self.conv_delta1 = _conv(delta_ch, nf // 2, 7)
        self.conv_delta2 = _conv(nf // 2, nf // 2, 3)
        self.conv_blend1 = _conv(nf, nf // 2, 3)
        self.conv_blend2 = _conv(nf // 2, nf, 3)

    def encode_ref(self, ref):
        return F.relu(self.conv_ref2(F.relu(self.conv_ref1(ref))))

    def forward(self, ref, delta, ref_enc=None):
        r = self.encode_ref(ref) if ref_enc is None else ref_enc
        d = F.relu(self.conv_delta2(F.relu(self.conv_delta1(delta))))
        h = F.relu(self.conv_blend1(torch.cat([r, d], dim=1)))
        return F.relu(self.conv_blend2(h))


class SepConvGRU(nn.Module):
    """Separable ConvGRU, (1,5) then (5,1). The z and r gates read the
    same [h, x] input, so their weights run as one conv on that concat;
    the q gate runs one conv on [r*h, x]."""

    def __init__(self, h_dim: int):
        super().__init__()
        hd = h_dim
        for s, k in (("1", (1, 5)), ("2", (5, 1))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", _conv(2 * hd, hd, k))

    def _half(self, h, x, s: str):
        cz, cr, cq = (getattr(self, f"conv{g}{s}") for g in "zrq")
        hd = h.shape[1]
        zr = F.conv2d(torch.cat([h, x], dim=1),
                      torch.cat([cz.weight, cr.weight], dim=0),
                      torch.cat([cz.bias, cr.bias]), padding=cz.padding)
        z = torch.sigmoid(zr[:, :hd])
        r = torch.sigmoid(zr[:, hd:])
        q = torch.tanh(cq(torch.cat([r * h, x], dim=1)))
        return (1.0 - z) * h + z * q

    def forward(self, h, x):
        return self._half(self._half(h, x, "1"), x, "2")


class FlowOcc(nn.Module):
    """Delta flow/occlusion head."""

    def __init__(self, nf: int):
        super().__init__()
        self.conv1 = _conv(nf, nf // 2, 3)
        self.conv2 = _conv(nf // 2, 5, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class Booster(nn.Module):
    """One recursive-boosting step."""

    def __init__(self, nf: int):
        super().__init__()
        self.Mixer = Mixer(nf)
        self.GB = SepConvGRU(nf)
        self.flow_occ = FlowOcc(nf)

    def encode_ref(self, ref):
        return self.Mixer.encode_ref(ref)

    def forward(self, f_rec, ref, delta, ref_enc=None):
        blend = self.Mixer(ref, delta, ref_enc=ref_enc)
        f_rec = self.GB(f_rec, blend)
        d = self.flow_occ(f_rec)
        return f_rec, d[:, :4], d[:, 4:5]


# --------------------------------------------------------------------------
# Outputs
# --------------------------------------------------------------------------
@dataclasses.dataclass
class DeMFIOutputs:
    """Everything the reference forward returns, per-iteration lists
    stacked on axis 0 (NCHW)."""
    s0_prime: torch.Tensor          # [B,3,H,W]
    s1_prime: torch.Tensor
    st_prime: torch.Tensor
    s0_final: torch.Tensor          # [N,B,3,H,W] (N = num_update; may be 0)
    s1_final: torch.Tensor
    st_final: torch.Tensor
    flow_preds: torch.Tensor        # [N+1,B,4,H,W] (init + per iteration)
    occ0_preds: torch.Tensor        # [N+1,B,1,H,W] (sigmoided)
    ovlp_b0b1: torch.Tensor         # [B,3,H,W]
    diff_maps: Tuple[torch.Tensor, torch.Tensor]      # (diff_1to0, diff_0to1)
    blend_weights: Tuple[torch.Tensor, torch.Tensor]  # FGAC gates (w_F0, w_F1)
    # visualization internals: per direction (1to0, 0to1) the normalised
    # maps (source, init ref key, E_s, bolstered) and the flow pair; ()
    # when disabled
    viz_stacks: Tuple = ()


@dataclasses.dataclass
class StageIContext:
    """t-independent intermediates shared by all t-values of a window."""
    f0: torch.Tensor
    f1: torch.Tensor
    flow_01: torch.Tensor
    flow_10: torch.Tensor
    occ_0_logit: torch.Tensor
    a_f0: torch.Tensor
    a_f1: torch.Tensor
    blend_weights: Tuple[torch.Tensor, torch.Tensor]
    diff_maps: Tuple[torch.Tensor, torch.Tensor]
    frames: torch.Tensor            # [B,12,H,W] (B0,B1,Bm1,B2) x 3
    viz_stacks: Tuple = ()

    def repeat(self, m: int) -> "StageIContext":
        """Each batch element repeated m times (element-major), for m
        instants per window."""
        def rep(v):
            if isinstance(v, tuple):
                return tuple(rep(x) for x in v)
            return torch.repeat_interleave(v, m, dim=0)
        return StageIContext(**{f.name: rep(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


# --------------------------------------------------------------------------
# Top-level model
# --------------------------------------------------------------------------
class DeMFINet(nn.Module):
    """DeMFI-Net. ``extract`` takes frames [B, 4, 3, H, W] in reference
    order (B0, B1, B-1, B2); ``synthesize`` takes t_value [B] or [B, 1]
    and a Python int ``num_update``."""

    def __init__(self, nf: int = 64, scale_factor: int = 2,
                 num_res_facfb: int = 5, num_res_dec: int = 5,
                 shared_fgac: bool = True, fgac_rr: int = 0,
                 fgac_sr: int = 0, use_stage2: bool = True,
                 viz_internals: bool = False, img_ch: int = 3,
                 fwarp_shift_d: int = 0):
        super().__init__()
        self.nf = nf
        # window of CFR's deterministic forward warp (0: atomic splat)
        self.fwarp_shift_d = fwarp_shift_d
        self.use_stage2 = use_stage2
        self.viz_internals = viz_internals
        self.FF_RDB_Module = FFRDB(nf, scale_factor, img_ch=img_ch)
        self.FAC_FB_Module = FACFB(nf, num_res_facfb, shared_fgac, fgac_rr,
                                   fgac_sr, viz_internals)
        self.Refine_Module = RefineUNet(nf)
        # decoder D1: the reference's Conv3d layers with temporal extent 1
        self.Dec_first = _Conv3dT1(nf, nf)
        self.Decoder_res = nn.ModuleList([ResBlock(nf, conv3d=True)
                                          for _ in range(num_res_dec)])
        self.Dec_last1 = _Conv3dT1(nf, nf)
        self.Dec_last2 = _Conv3dT1(nf, 3)
        if use_stage2:
            self.Ch_Reducer = _conv(3 * nf, nf, 7)
            self.Booster_Module = Booster(nf)
            self.Dec_first_2 = _conv(nf + 35, nf, 3)
            self.Decoder_res_2 = nn.ModuleList([ResBlock(nf)
                                                for _ in range(num_res_dec)])
            self.Dec_last1_2 = _conv(nf, nf, 3)
            self.Dec_last2_2 = _conv(nf, 9, 3)

    # ---------------------------------------------------- t-independent
    def extract(self, frames: torch.Tensor) -> StageIContext:
        """RDN backbone + FAC-FB; runs once per 4-frame window."""
        b, t, c, h, w = frames.shape
        if t != 4:
            raise ValueError(f"expected 4 input frames, got {t}")
        # frame-major concat: channel index = frame * 3 + colour
        cat = frames.reshape(b, t * c, h, w)
        f0, f1, flow_01, flow_10, occ = self.FF_RDB_Module(cat)
        a_f0, a_f1, bws, diffs, stacks = self.FAC_FB_Module(
            f0, f1, flow_10, flow_01)
        viz_stacks = (stacks + ((flow_01, flow_10),)
                      if self.viz_internals else ())
        return StageIContext(f0, f1, flow_01, flow_10, occ, a_f0, a_f1,
                             bws, diffs, cat, viz_stacks)

    # ------------------------------------------------------ t-dependent
    def synthesize(self, ctx: StageIContext, t_value: torch.Tensor,
                   num_update: int) -> DeMFIOutputs:
        """t-dependent Stage I + Stage II."""
        nf = self.nf
        t = t_value.float().reshape(-1, 1, 1, 1)
        b0 = ctx.frames[:, 0:3]
        b1 = ctx.frames[:, 3:6]

        flow_t0, flow_t1 = cfr_flow_t_align(ctx.flow_01, ctx.flow_10, t,
                                            self.fwarp_shift_d)
        occ_0 = torch.sigmoid(ctx.occ_0_logit.float())
        ft = _t_blend(*bwarp_pair(ctx.f0, ctx.f1, flow_t0, flow_t1), occ_0, t)

        agg1 = torch.cat([ctx.a_f0, ctx.a_f1, ft, flow_t0, flow_t1,
                          ctx.flow_01, ctx.flow_10, ctx.occ_0_logit], dim=1)
        agg1 = self.Refine_Module(agg1) + torch.cat(
            [flow_t0, flow_t1, ctx.occ_0_logit, ctx.a_f0, ctx.a_f1], dim=1)

        rflow_t0 = agg1[:, 0:2].float()
        rflow_t1 = agg1[:, 2:4].float()
        occ_0_logit = agg1[:, 4:5].float()
        occ_0 = torch.sigmoid(occ_0_logit)
        r_f0 = torch.tanh(agg1[:, 5:5 + nf])
        r_f1 = torch.tanh(agg1[:, 5 + nf:5 + 2 * nf])
        r_ft = _t_blend(*bwarp_pair(r_f0, r_f1, rflow_t0, rflow_t1), occ_0, t)

        # D1: joint 3-frame decode (frames folded into the batch)
        bsz, _, h, w = r_f0.shape
        dec_in = torch.stack([r_f0, r_f1, r_ft], dim=1).reshape(
            3 * bsz, nf, h, w)
        out = F.relu(self.Dec_first(dec_in))
        for blk in self.Decoder_res:
            out = blk(out)
        out = F.relu(self.Dec_last1(out))
        out = self.Dec_last2(out).reshape(bsz, 3, 3, h, w)
        s0p, s1p, stp = out[:, 0], out[:, 1], out[:, 2]

        flow_init = torch.cat([rflow_t0, rflow_t1], dim=1)
        if self.use_stage2 and num_update > 0:
            f_rec = torch.tanh(self.Ch_Reducer(
                torch.cat([r_f0, r_f1, r_ft], dim=1)))
            t_ref = torch.cat([flow_init, occ_0_logit], dim=1)
            length1_ref = torch.cat([ctx.flow_10, ctx.flow_01], dim=1)
            sp_ref = torch.cat([s0p, s1p, stp, ctx.frames], dim=1)
            ref = torch.cat([sp_ref, length1_ref, t_ref], dim=1)
            # loop-invariant: encoded once per window
            ref_enc = self.Booster_Module.encode_ref(ref)

            carry = (f_rec, flow_init, occ_0_logit)
            const = (ref_enc, s0p, s1p, occ_0, rflow_t0, rflow_t1,
                     ctx.flow_10, ctx.flow_01, ctx.frames, t)
            ys: List[Tuple[torch.Tensor, ...]] = []
            for _ in range(num_update):
                carry, y = self._boost_step(carry, const)
                ys.append(y)
            flow_iters, occ_iters, s0_fin, s1_fin, st_fin = (
                torch.stack(v, dim=0) for v in zip(*ys))
            flow_preds = torch.cat([flow_init[None], flow_iters], dim=0)
            occ0_preds = torch.cat([occ_0[None], occ_iters], dim=0)
        else:
            def empty(like):
                return like.new_zeros((0,) + tuple(like.shape))
            s0_fin, s1_fin, st_fin = empty(s0p), empty(s1p), empty(stp)
            flow_preds = flow_init[None]
            occ0_preds = occ_0[None]

        return DeMFIOutputs(
            s0_prime=s0p, s1_prime=s1p, st_prime=stp,
            s0_final=s0_fin, s1_final=s1_fin, st_final=st_fin,
            flow_preds=flow_preds, occ0_preds=occ0_preds,
            ovlp_b0b1=(b0 + b1) / 2.0,
            diff_maps=ctx.diff_maps,
            blend_weights=ctx.blend_weights,
            viz_stacks=ctx.viz_stacks)

    def _boost_step(self, carry, const):
        """One recursive-boosting iteration. ``carry`` = (f_rec,
        delta_flow, delta_occ); ``const`` holds the loop invariants."""
        f_rec, delta_flow, delta_occ = carry
        (ref_enc, s0p, s1p, occ_0, rflow_t0, rflow_t1,
         flow_10, flow_01, frames, t) = const

        delta = torch.cat([delta_flow, delta_occ], dim=1)
        f_rec, d_flow, d_occ = self.Booster_Module(f_rec, None, delta,
                                                   ref_enc=ref_enc)
        delta_flow = delta_flow + d_flow
        delta_occ = delta_occ + d_occ

        ft0_f = delta_flow[:, :2]
        ft1_f = delta_flow[:, 2:4]
        occ_0_f = torch.sigmoid(delta_occ)
        st_new = _t_blend(*bwarp_pair(s0p, s1p, ft0_f, ft1_f), occ_0_f, t)

        agg3 = torch.cat([s0p, s1p, st_new, f_rec, occ_0, rflow_t0, rflow_t1,
                          flow_10, flow_01, ft0_f, ft1_f, occ_0_f, frames],
                         dim=1)
        out = F.relu(self.Dec_first_2(agg3))
        for blk in self.Decoder_res_2:
            out = blk(out)
        out = F.relu(self.Dec_last1_2(out))
        out = self.Dec_last2_2(out)
        ys = (delta_flow, occ_0_f, out[:, 0:3] + s0p, out[:, 3:6] + s1p,
              out[:, 6:9] + st_new)
        return (f_rec, delta_flow, delta_occ), ys

    def forward(self, frames, t_value, num_update: int = 1) -> DeMFIOutputs:
        return self.synthesize(self.extract(frames), t_value, num_update)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Xavier-normal conv weights and zero biases, drawn in module order
    from ``generator``."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                nn.init.xavier_normal_(mod.weight, generator=generator)
                nn.init.zeros_(mod.bias)


def make_model(cfg: DeMFIConfig, device=None) -> DeMFINet:
    """Build DeMFI-Net for ``cfg`` with random weights seeded by
    ``cfg.seed``, on ``device`` (the GPU unless the caller asks for the
    CPU)."""
    from demfi_torch import resolve_device

    dev = resolve_device(device)
    model = DeMFINet(
        nf=cfg.nf, scale_factor=cfg.scale_factor,
        num_res_facfb=cfg.num_ResB_FACFB, num_res_dec=cfg.num_ResB_Dec,
        shared_fgac=cfg.shared_FGAC_flag, fgac_rr=cfg.fgac_rr,
        fgac_sr=cfg.fgac_sr, use_stage2=max(cfg.N_trn, cfg.N_tst) > 0,
        viz_internals=cfg.visualization_flag, img_ch=cfg.img_ch,
        fwarp_shift_d=cfg.fwarp_shift_d)
    gen = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, gen)
    return model.to(dev).eval()
