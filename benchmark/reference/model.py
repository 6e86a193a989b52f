"""DeMFI-Net_rb in plain PyTorch, float32, NCHW: the benchmark's reference.

Oh & Kim, "DeMFI: Deep Joint Deblurring and Multi-Frame Interpolation
with Flow-Guided Attentive Correlation and Recursive Boosting", ECCV 2022.
Stage I: an RDN backbone on the 4 blurry frames at half resolution gives
two feature maps, two flows and an occlusion logit; FAC-FB bolsters the
features with the shared FGAC (point-wise correlation, rr = sr = 0);
CFR reverses the flows to t; a refine U-Net and the joint 3-frame
decoder D1 give S0', S1', St'. Stage II: N recursive-boosting steps
(Mixer, separable ConvGRU, flow/occlusion head) warp S0', S1' to t and
decode each step's S0, S1, St with D2.

Module names are the reference torch model's, so ``load_state_dict``
takes the same keys and shapes as the program's (``Dec_first``,
``Decoder_res``, ``Dec_last1``, ``Dec_last2`` keep their 5-D Conv3d
weights of temporal extent 1; the three frames fold into the batch).
Departures from the published code: none in the mathematics; the Mixer's
reference branch, constant over the boosting steps, is encoded once.

``precision``: "float32" (the reference), or the operand rounding of a
lower precision for the benchmark's control: "tf32" rounds every
convolution's input, weight and output gradient to TF32's 10-bit
mantissa, "fp8" scales each of them to e4m3's range per tensor and
rounds it to e4m3 (float32 accumulation either way, as tensor cores do).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import warp

PRECISIONS = ("float32", "tf32", "fp8")
E4M3_MAX = 448.0


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as the given precision holds it, back in float32."""
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    if precision == "fp8":
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x


class _RoundedConv(torch.autograd.Function):
    """conv2d on rounded operands, its two backward products on rounded
    operands too."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, precision):
        xr = round_operand(x, precision)
        wr = round_operand(weight, precision)
        ctx.save_for_backward(xr, wr)
        ctx.conf = (stride, padding, precision, bias is not None)
        return F.conv2d(xr, wr, bias, stride, padding)

    @staticmethod
    def backward(ctx, grad):
        xr, wr = ctx.saved_tensors
        stride, padding, precision, has_bias = ctx.conf
        gr = round_operand(grad, precision)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(xr.shape, wr, gr, stride, padding)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(xr, wr.shape, gr, stride,
                                             padding)
        if has_bias and ctx.needs_input_grad[2]:
            gb = grad.sum((0, 2, 3))
        return gx, gw, gb, None, None, None


class Conv(nn.Module):
    """A 2-D convolution with bias; ``temporal`` keeps a Conv3d weight
    [O, I, 1, kh, kw] (frames folded into the batch)."""

    precision = "float32"

    def __init__(self, cin: int, cout: int, k, stride: int = 1, pad=None,
                 temporal: bool = False):
        super().__init__()
        kh, kw = (k, k) if isinstance(k, int) else k
        self.stride = stride
        self.padding = ((kh - 1) // 2, (kw - 1) // 2) if pad is None \
            else (pad, pad)
        shape = (cout, cin, 1, kh, kw) if temporal else (cout, cin, kh, kw)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        w = self.weight[:, :, 0] if self.weight.dim() == 5 else self.weight
        if self.precision == "float32":
            return F.conv2d(x, w, self.bias, self.stride, self.padding)
        return _RoundedConv.apply(x, w, self.bias, self.stride, self.padding,
                                  self.precision)


class _Seq(nn.Module):
    """Conv then ReLU, under the reference's ``conv.0`` key."""

    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.ModuleList([Conv(cin, cout, 3)])

    def forward(self, x):
        return torch.cat([x, F.relu(self.conv[0](x))], 1)


class RDB(nn.Module):
    def __init__(self, g0, growth, n):
        super().__init__()
        self.convs = nn.ModuleList([_Seq(g0 + i * growth, growth)
                                    for i in range(n)])
        self.LFF = Conv(g0 + n * growth, g0, 1)

    def forward(self, x):
        y = x
        for c in self.convs:
            y = c(y)
        return self.LFF(y) + x


class FFRDB(nn.Module):
    """The RDN backbone: space-to-depth, RDBs, global fusion, a
    pixel-shuffle head to (F0, F1, flow_01, flow_10, occlusion logit)."""

    def __init__(self, nf, scale_factor, g0, num_rdb, rdb_convs, growth):
        super().__init__()
        self.nf = nf
        self.scale_factor = scale_factor
        self.SFENet1 = Conv(12 * scale_factor ** 2, g0, 5)
        self.SFENet2 = Conv(g0, g0, 3)
        self.RDBs = nn.ModuleList([RDB(g0, growth, rdb_convs)
                                   for _ in range(num_rdb)])
        self.GFF = nn.ModuleList([Conv(num_rdb * g0, g0, 1), Conv(g0, g0, 3)])
        self.UPNet = nn.ModuleList([Conv(g0, 256, 3), nn.Identity(),
                                    Conv(64, 2 * nf + 5, 3)])

    def forward(self, cat):
        nf = self.nf
        f1 = self.SFENet1(F.pixel_unshuffle(cat, self.scale_factor))
        x = self.SFENet2(f1)
        outs = []
        for rdb in self.RDBs:
            x = rdb(x)
            outs.append(x)
        x = self.GFF[1](self.GFF[0](torch.cat(outs, 1))) + f1
        s = self.UPNet[2](F.pixel_shuffle(self.UPNet[0](x), 2))
        feats = torch.tanh(s[:, :2 * nf])
        return (feats[:, :nf], feats[:, nf:], s[:, 2 * nf:2 * nf + 2],
                s[:, 2 * nf + 2:2 * nf + 4], s[:, 2 * nf + 4:2 * nf + 5])


class ResBlock(nn.Module):
    def __init__(self, nf, temporal=False):
        super().__init__()
        self.conv1 = Conv(nf, nf, 3, temporal=temporal)
        self.conv2 = Conv(nf, nf, 3, temporal=temporal)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(x)))


class FGAC(nn.Module):
    """Flow-guided attentive correlation, point-wise: the ref key sampled
    at the raw flow values, fused and gated against the source. The
    source key's convolution is in the published layout and unread at
    rr = 0."""

    def __init__(self, nf):
        super().__init__()
        self.conv_ref_k = Conv(nf, nf, 1)
        self.conv_source_k = Conv(nf, nf, 1)
        self.fusion = Conv(nf, nf, 1)
        self.w_gen = Conv(2 * nf, nf, 3)
        self.w_gen_2 = Conv(nf, 1, 3)

    def forward(self, ref, source, flow):
        e_s = self.fusion(warp.sample_abs(self.conv_ref_k(ref), flow))
        w = torch.sigmoid(self.w_gen_2(F.relu(self.w_gen(
            torch.cat([source, e_s], 1)))))
        return w * source + (1.0 - w) * e_s


class FACFB(nn.Module):
    def __init__(self, nf, n_res):
        super().__init__()
        self.nf = nf
        self.conv_first = Conv(nf, nf, 3)
        self.feature_extraction = nn.ModuleList([ResBlock(nf)
                                                 for _ in range(n_res)])
        self.shared_FGAC = FGAC(nf)

    def forward(self, f0, f1, flow_10, flow_01):
        b, c, h, w = f0.shape
        x = F.relu(self.conv_first(torch.stack([f0, f1], 1).reshape(
            2 * b, c, h, w)))
        for blk in self.feature_extraction:
            x = blk(x)
        enc = x.reshape(b, 2, c, h, w)
        a_f0 = self.shared_FGAC(enc[:, 1], enc[:, 0], flow_01)
        a_f1 = self.shared_FGAC(enc[:, 0], enc[:, 1], flow_10)
        return a_f0, a_f1


def up2(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3)


class RefineUNet(nn.Module):
    def __init__(self, nf):
        super().__init__()
        self.enc1 = Conv(3 * nf + 9, nf, 4, 2, 1)
        self.enc2 = Conv(nf, 2 * nf, 4, 2, 1)
        self.enc3 = Conv(2 * nf, 4 * nf, 4, 2, 1)
        self.dec0 = Conv(4 * nf, 4 * nf, 3)
        self.dec1 = Conv(6 * nf, 2 * nf, 3)
        self.dec2 = Conv(3 * nf, nf, 3)
        self.dec3 = Conv(nf, 2 * nf + 5, 3)

    def forward(self, x):
        e1 = F.relu(self.enc1(x))
        e2 = F.relu(self.enc2(e1))
        h = F.relu(self.enc3(e2))
        h = up2(F.relu(self.dec0(h)))
        h = up2(F.relu(self.dec1(torch.cat([h, e2], 1))))
        h = up2(F.relu(self.dec2(torch.cat([h, e1], 1))))
        return self.dec3(h)


class Mixer(nn.Module):
    def __init__(self, nf):
        super().__init__()
        self.conv_ref1 = Conv(30, nf // 2, 7)
        self.conv_ref2 = Conv(nf // 2, nf // 2, 3)
        self.conv_delta1 = Conv(5, nf // 2, 7)
        self.conv_delta2 = Conv(nf // 2, nf // 2, 3)
        self.conv_blend1 = Conv(nf, nf // 2, 3)
        self.conv_blend2 = Conv(nf // 2, nf, 3)

    def encode_ref(self, ref):
        return F.relu(self.conv_ref2(F.relu(self.conv_ref1(ref))))

    def forward(self, ref_enc, delta):
        d = F.relu(self.conv_delta2(F.relu(self.conv_delta1(delta))))
        return F.relu(self.conv_blend2(F.relu(self.conv_blend1(
            torch.cat([ref_enc, d], 1)))))


class SepConvGRU(nn.Module):
    def __init__(self, hd):
        super().__init__()
        for s, k in (("1", (1, 5)), ("2", (5, 1))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", Conv(2 * hd, hd, k))

    def forward(self, h, x):
        for s in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx))
            q = torch.tanh(getattr(self, f"convq{s}")(torch.cat([r * h, x],
                                                                 1)))
            h = (1.0 - z) * h + z * q
        return h


class FlowOcc(nn.Module):
    def __init__(self, nf):
        super().__init__()
        self.conv1 = Conv(nf, nf // 2, 3)
        self.conv2 = Conv(nf // 2, 5, 3)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class Booster(nn.Module):
    def __init__(self, nf):
        super().__init__()
        self.Mixer = Mixer(nf)
        self.GB = SepConvGRU(nf)
        self.flow_occ = FlowOcc(nf)


def t_blend(a, b, occ_0, t):
    """Occlusion-weighted temporal blend, Eq. (2)."""
    occ_1 = 1.0 - occ_0
    return (((1.0 - t) * occ_0 * a + t * occ_1 * b)
            / ((1.0 - t) * occ_0 + t * occ_1))


@dataclasses.dataclass
class StageI:
    """The t-independent part of a window: backbone and FAC-FB."""
    f0: torch.Tensor
    f1: torch.Tensor
    flow_01: torch.Tensor
    flow_10: torch.Tensor
    occ_logit: torch.Tensor
    a_f0: torch.Tensor
    a_f1: torch.Tensor
    frames: torch.Tensor      # [B, 12, H, W]

    def repeat(self, m: int) -> "StageI":
        return StageI(*(torch.repeat_interleave(getattr(self, f.name), m, 0)
                        for f in dataclasses.fields(self)))


class DeMFINet(nn.Module):
    """DeMFI-Net from a configuration's ``architecture`` block (its keys
    are the keyword arguments): DeMFI-Net_rb, or DeMFI-Net_bs where
    ``stage2`` is False (no Stage II modules, no boosting step). This
    reference holds the published point-wise shared FGAC on 3-channel
    frames; another FGAC needs a reference of its own."""

    # the backbone head's parameter whose rows 2 nf .. 2 nf + 3 give the
    # Stage-I flows (the inputs' calibration scales them)
    flow_head = "FF_RDB_Module.UPNet.2"

    def __init__(self, nf: int, scale_factor: int, G0: int, num_rdb: int,
                 rdb_convs: int, growth: int, num_ResB_FACFB: int,
                 num_ResB_Dec: int, shared_FGAC: bool = True,
                 fgac_rr: int = 0, fgac_sr: int = 0, img_ch: int = 3,
                 stage2: bool = True, precision: str = "float32"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        if not shared_FGAC or fgac_rr or fgac_sr or img_ch != 3:
            raise NotImplementedError(
                "this reference is the point-wise shared FGAC on 3-channel "
                "frames")
        self.nf = nf
        self.FF_RDB_Module = FFRDB(nf, scale_factor, G0, num_rdb, rdb_convs,
                                   growth)
        self.FAC_FB_Module = FACFB(nf, num_ResB_FACFB)
        self.Refine_Module = RefineUNet(nf)
        self.Dec_first = Conv(nf, nf, 3, temporal=True)
        self.Decoder_res = nn.ModuleList([ResBlock(nf, temporal=True)
                                          for _ in range(num_ResB_Dec)])
        self.Dec_last1 = Conv(nf, nf, 3, temporal=True)
        self.Dec_last2 = Conv(nf, 3, 3, temporal=True)
        self.stage2 = stage2
        if stage2:
            self.Ch_Reducer = Conv(3 * nf, nf, 7)
            self.Booster_Module = Booster(nf)
            self.Dec_first_2 = Conv(nf + 35, nf, 3)
            self.Decoder_res_2 = nn.ModuleList([ResBlock(nf)
                                                for _ in range(num_ResB_Dec)])
            self.Dec_last1_2 = Conv(nf, nf, 3)
            self.Dec_last2_2 = Conv(nf, 9, 3)
        for m in self.modules():
            if isinstance(m, Conv):
                m.precision = precision

    def extract(self, frames: torch.Tensor) -> StageI:
        """frames [B, 4, 3, H, W] in the order B0, B1, B-1, B2."""
        b, t, c, h, w = frames.shape
        cat = frames.reshape(b, t * c, h, w)
        f0, f1, flow_01, flow_10, occ = self.FF_RDB_Module(cat)
        a_f0, a_f1 = self.FAC_FB_Module(f0, f1, flow_10, flow_01)
        return StageI(f0, f1, flow_01, flow_10, occ, a_f0, a_f1, cat)

    def _decode1(self, r_f0, r_f1, r_ft):
        b, nf, h, w = r_f0.shape
        x = torch.stack([r_f0, r_f1, r_ft], 1).reshape(3 * b, nf, h, w)
        x = F.relu(self.Dec_first(x))
        for blk in self.Decoder_res:
            x = blk(x)
        x = self.Dec_last2(F.relu(self.Dec_last1(x))).reshape(b, 3, 3, h, w)
        return x[:, 0], x[:, 1], x[:, 2]

    def synthesize(self, s1: StageI, t: torch.Tensor, n_update: int
                   ) -> Dict[str, object]:
        """The instants t [B] of the windows in ``s1`` (one per element).
        Returns S0', S1', St' and the lists of each boosting step's S0,
        S1, St."""
        nf = self.nf
        t = t.reshape(-1, 1, 1, 1)
        flow_t0, flow_t1 = warp.cfr(s1.flow_01, s1.flow_10, t)
        occ_0 = torch.sigmoid(s1.occ_logit)
        ft = t_blend(warp.bwarp(s1.f0, flow_t0), warp.bwarp(s1.f1, flow_t1),
                     occ_0, t)
        agg = self.Refine_Module(torch.cat(
            [s1.a_f0, s1.a_f1, ft, flow_t0, flow_t1, s1.flow_01, s1.flow_10,
             s1.occ_logit], 1)) + torch.cat(
            [flow_t0, flow_t1, s1.occ_logit, s1.a_f0, s1.a_f1], 1)
        rflow_t0, rflow_t1 = agg[:, 0:2], agg[:, 2:4]
        occ_logit = agg[:, 4:5]
        occ_0 = torch.sigmoid(occ_logit)
        r_f0 = torch.tanh(agg[:, 5:5 + nf])
        r_f1 = torch.tanh(agg[:, 5 + nf:5 + 2 * nf])
        r_ft = t_blend(warp.bwarp(r_f0, rflow_t0), warp.bwarp(r_f1, rflow_t1),
                       occ_0, t)
        s0p, s1p, stp = self._decode1(r_f0, r_f1, r_ft)
        out: Dict[str, object] = {"s0_prime": s0p, "s1_prime": s1p,
                                  "st_prime": stp, "s0": [], "s1": [],
                                  "st": []}
        if n_update == 0 or not self.stage2:
            return out
        flow = torch.cat([rflow_t0, rflow_t1], 1)
        f_rec = torch.tanh(self.Ch_Reducer(torch.cat([r_f0, r_f1, r_ft], 1)))
        booster = self.Booster_Module
        ref_enc = booster.Mixer.encode_ref(torch.cat(
            [s0p, s1p, stp, s1.frames, s1.flow_10, s1.flow_01, flow,
             occ_logit], 1))
        d_occ = occ_logit
        for _ in range(n_update):
            f_rec = booster.GB(f_rec, booster.Mixer(
                ref_enc, torch.cat([flow, d_occ], 1)))
            d = booster.flow_occ(f_rec)
            flow = flow + d[:, :4]
            d_occ = d_occ + d[:, 4:5]
            occ_i = torch.sigmoid(d_occ)
            st_new = t_blend(warp.bwarp(s0p, flow[:, :2]),
                             warp.bwarp(s1p, flow[:, 2:4]), occ_i, t)
            x = F.relu(self.Dec_first_2(torch.cat(
                [s0p, s1p, st_new, f_rec, occ_0, rflow_t0, rflow_t1,
                 s1.flow_10, s1.flow_01, flow, occ_i, s1.frames], 1)))
            for blk in self.Decoder_res_2:
                x = blk(x)
            x = self.Dec_last2_2(F.relu(self.Dec_last1_2(x)))
            out["s0"].append(x[:, 0:3] + s0p)
            out["s1"].append(x[:, 3:6] + s1p)
            out["st"].append(x[:, 6:9] + st_new)
        return out

    def forward(self, frames, t, n_update: int):
        return self.synthesize(self.extract(frames), t, n_update)

