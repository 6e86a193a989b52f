"""DeMFI-Net in PyTorch ([B, C, H, W] tensors).

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
reference branch is loop-invariant and is encoded once before it. While
a profiler records, ``extract``, ``synthesize`` and each boosting
iteration inside it run in the ranges ``demfi.extract``,
``demfi.synthesize`` and ``demfi.boost``
(:func:`demfi_torch.utils.profiling.span`).

Compute dtype (``DeMFIConfig.compute_dtype``), as the JAX model places
it: every convolution casts its input, weight and bias to the model's
compute dtype inside ``forward`` (flax's ``nn.Conv(dtype=...)``), so the
parameters, their gradients and the ``state_dict`` stay float32. Flows,
occlusion logits and t stay float32 (taken from a compute-dtype tensor
where the JAX model takes them, so they carry its rounding); FGAC's
correlation runs in float32; the warps gather compute-dtype values with
float32 weights and return float32, and the blends that follow run in
float32 and are cast back only where the JAX model casts them. Pieces
are cast before each ``torch.cat`` where the JAX model concatenates cast
operands (``torch.cat`` promotes a mixed list to float32).

Memory format (:func:`activation_format`): where the convolutions run
in bfloat16 on a CUDA device, the activations are ``torch.channels_last``
from the model's input (converted once in ``extract``) to its outputs,
and each convolution gets its input and its weight's compute-dtype cast
in NHWC, which cuDNN's bfloat16 engines compute in; NCHW would cost a
transpose in and out of every convolution. Every other run (float32,
and every CPU run) is NCHW. The ops between convolutions keep their
input's format: the folds of frames into the batch concatenate along
it, space-to-depth, the pixel shuffle and the instants' repeat follow
their input (``demfi_torch.ops.reshape``), and the warps' float32 NCHW
outputs are cast into the format where they join a concatenation. The
warp kernels take NCHW: their inputs are copied there
(``kernels.nchw``). ``kernels.layout_counts`` counts the convolutions,
those whose input arrived in the format, and those copies.

Convolution epilogues: at each convolution the step that follows it
(a ReLU, a residual add, or nothing) is passed to the convolution
(``relu=True``, ``residual=x``) rather than applied by the caller, so
that a bfloat16 model on the card adds the bias and takes that step in
one in-place pass of its output (``kernels.conv_epilogue``, under
:func:`_conv_in`'s conditions); every other run applies the same ops
one by one, as before. ``kernels.epilogue_counts`` counts the sites by
form and those that took the kernel.

Rows of a split frame (``--mesh_spatial``, :meth:`DeMFINet.rows`): the
model may run on rows [r0, r1) of a frame whose other rows other ranks
hold (a :class:`~demfi_torch.parallel.RowShard`), and its outputs are
then those rows of the whole frame's, which is what XLA SPMD computes
for the JAX model on a ('data', 'spatial') mesh. Every convolution first
takes the rows its kernel reads beyond the shard from the neighbours
(``exchange_rows``: zeros at the frame's edges, where its padding reads
zeros) and convolves them with no row padding; the warps sample the
whole source frame (``demfi_torch.ops.warp``); the min-max
normalisations reduce over the whole frame. Space-to-depth, the pixel
shuffle and the nearest up-sampling are row-local when the shard's rows
and first row are multiples of the network's total stride
(:attr:`DeMFINet.row_stride`). Without a shard (the attribute ``shard``
is None on every module) the code is the unsplit model's. The split
model trains as well as it serves: every collective it makes has a
backward (``demfi_torch.parallel.halo``), so the gradients of a shard's
rows, summed over the group, are the unsplit model's. A remat'd backbone
recomputes its convolutions, halo exchanges included, in the backward
pass, which must therefore run inside :meth:`DeMFINet.rows` as the
forward did (``make_train_step`` does so).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from demfi_torch.config import DeMFIConfig
from demfi_torch.ops import (
    bwarp_pair,
    cfr_flow_t_align,
    depth_to_space,
    fgac_correlate,
    kernels,
    space_to_depth,
)
from demfi_torch.ops.reshape import repeat_batch
from demfi_torch.parallel.halo import (allreduce_max, allreduce_min,
                                       exchange_rows)
from demfi_torch.utils.profiling import span


COMPUTE_DTYPES: Dict[str, torch.dtype] = {"float32": torch.float32,
                                           "bfloat16": torch.bfloat16}
REMAT_GRANULARITIES = ("backbone", "rdb")


def _remat(fn, *args):
    """``fn(*args)``, recomputed in the backward pass where autograd
    records (training) instead of keeping its activations. The
    non-reentrant form: the backbone's input frames need no gradient, and
    the reentrant form would then return none for the parameters."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def activation_format(dtype: torch.dtype,
                      device: torch.device) -> torch.memory_format:
    """The memory format of the model's activations when its convolutions
    compute in ``dtype`` on ``device``: channels_last for bfloat16 on a
    CUDA device (cuDNN's bfloat16 engines compute in NHWC, and transpose
    NCHW tensors in and out), NCHW (``torch.contiguous_format``)
    otherwise (cuDNN's float32 kernels with TF32 off compute in NCHW)."""
    if dtype == torch.bfloat16 and device.type == "cuda":
        return torch.channels_last
    return torch.contiguous_format


def _as(x: torch.Tensor, dt: torch.dtype,
        fmt: torch.memory_format) -> torch.Tensor:
    """``x.to(dt)``, and in channels_last where that is the model's format
    ``fmt`` (one copy that casts and lays out; none where x already is)."""
    if fmt == torch.contiguous_format:
        return x.to(dt)
    return x.to(dt, memory_format=fmt)


def _conv_in(dt: torch.dtype, conv, x: torch.Tensor, weight: torch.Tensor,
             bias: torch.Tensor, relu: bool = False,
             residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv(x, weight, bias)`` in the compute dtype ``dt``, its input and
    weight in the model's memory format (:func:`activation_format`;
    counted in ``kernels.layout_counts``), then the one step its site
    applies to it: ``F.relu`` (``relu``) or ``residual + y``
    (``residual``), or neither (the forms are counted in
    ``kernels.epilogue_counts``). At float32 the bias is fused into the
    convolution. At bfloat16 the bias is cast and added after the
    convolution, in bfloat16, as flax's ``nn.Conv(dtype=bfloat16)`` does:
    the convolution rounds once and the bias add once more. Fusing the
    bias rounds once, and that one rounding moves the bfloat16 network's
    outputs as far from the JAX model's as bfloat16 moves them from
    float32. Where the bfloat16 output may be updated in place
    (``kernels.conv_epilogue_takes``: on the card, dense channels_last,
    autograd not recording) the bias add and the step after it are one
    pass of ``kernels.conv_epilogue``, with the same roundings and the
    same bits; every other run takes the separate ops."""
    fmt = activation_format(dt, x.device)
    kernels.count_conv(x.is_contiguous(memory_format=fmt),
                       "bias_relu" if relu else "bias" if residual is None
                       else "bias_residual")
    x, weight = _as(x, dt, fmt), _as(weight, dt, fmt)
    if dt == torch.float32:
        y = conv(x, weight, bias)
    else:
        y = conv(x, weight, None)
        if kernels.conv_epilogue_takes(y, bias, residual):
            # in place: y is this convolution's own new output, which
            # nothing else holds
            return kernels.conv_epilogue(y, bias, relu, residual)
        y = y + bias.to(dt)[:, None, None]
    if relu:
        return F.relu(y)
    return y if residual is None else residual + y


def _rows_conv(shard, stride, padding):
    """A convolution ``(x, weight, bias) -> y`` over a shard's rows: the
    rows its kernel reads above and below them from the neighbours
    (output row j reads input rows stride j - pad ... stride j - pad +
    k - 1), then no row padding. Equal to the unsplit convolution's rows
    when the shard's rows and first row are multiples of the stride."""
    def conv(x, weight, bias):
        k = weight.shape[-2]
        above = padding[0]
        x = exchange_rows(x, above, k - stride[0] - above, shard)
        return F.conv2d(x, weight, bias, stride, (0, padding[1]))
    return conv


class _Conv(nn.Conv2d):
    """nn.Conv2d in the model's compute dtype (:func:`_conv_in`); the
    parameters stay float32. Over a shard's rows where ``shard`` is
    set. ``relu`` and ``residual`` as for :func:`_conv_in`: the step the
    caller applies to the output (called with ``x`` alone, the module
    returns the convolution with its bias, as nn.Conv2d does)."""

    compute_dtype = torch.float32     # DeMFINet sets it on each instance
    shard = None                      # DeMFINet.rows sets it

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv = self._conv_forward if self.shard is None else _rows_conv(
            self.shard, self.stride, self.padding)
        return _conv_in(self.compute_dtype, conv, x, self.weight, self.bias,
                        relu, residual)


def _conv(cin: int, cout: int, k=3, stride: int = 1, pad=None) -> _Conv:
    if pad is None:
        pad = tuple((kk - 1) // 2 for kk in k) if isinstance(k, tuple) \
            else (k - 1) // 2
    return _Conv(cin, cout, k, stride=stride, padding=pad, bias=True)


class _Conv3dT1(nn.Conv3d):
    """The reference's Conv3d with kernel [1, 3, 3]: keeps the 5-D weight
    (checkpoint keys and shapes) and runs as a 2-D conv on [B*T, C, H, W]
    with the frames folded into the batch, in the compute dtype."""

    compute_dtype = torch.float32
    shard = None

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, (1, 3, 3), padding=(0, 1, 1), bias=True)

    def forward(self, x: torch.Tensor, relu: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        conv = ((lambda i, k, b: F.conv2d(i, k, b, padding=1))
                if self.shard is None
                else _rows_conv(self.shard, (1, 1), (1, 1)))
        return _conv_in(self.compute_dtype, conv, x, self.weight[:, :, 0],
                        self.bias, relu, residual)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic as the JAX model computes it: at float32
    ``torch.sigmoid``; at bfloat16 ``1 / (1 + exp(-x))`` with every step
    rounded to bfloat16, which is what XLA lowers ``jax.nn.sigmoid`` of a
    bfloat16 array to (``torch.sigmoid`` rounds once, and differs in 30 %
    of the values)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


def _minmax_norm(v: torch.Tensor, shard=None) -> torch.Tensor:
    """Per-sample min-max normalisation over C, H, W (over the whole
    frame's rows where v holds a shard's). The max may be 0, and the
    result is then NaN, as in the reference."""
    lo = torch.amin(v, dim=(1, 2, 3), keepdim=True)
    if shard is not None:
        lo = allreduce_min(lo, shard)
    v = v - lo
    hi = torch.amax(v, dim=(1, 2, 3), keepdim=True)
    if shard is not None:
        hi = allreduce_max(hi, shard)
    return v / hi


def _t_blend(a: torch.Tensor, b: torch.Tensor, occ_0: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """Occlusion-weighted temporal blend, Eq. (2)."""
    occ_1 = 1.0 - occ_0
    num = (1.0 - t) * occ_0 * a + t * occ_1 * b
    den = (1.0 - t) * occ_0 + t * occ_1
    return num / den


@contextlib.contextmanager
def rows_of(module: nn.Module, shard):
    """Within the block every convolution, FGAC and the model under
    ``module`` (itself included) compute on ``shard``'s rows (a
    :class:`~demfi_torch.parallel.RowShard`, or None for whole frames).
    :meth:`DeMFINet.rows` checks the shard against the model's stride
    first."""
    mods = [m for m in module.modules()
            if isinstance(m, (DeMFINet, _Conv, _Conv3dT1, FGAC, SepConvGRU))]
    for m in mods:
        m.shard = shard
    try:
        yield module
    finally:
        for m in mods:
            m.shard = None


def _nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """UpsamplingNearest2d(scale_factor=2), in x's memory format."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class _DepthToSpace(nn.Module):
    """nn.PixelShuffle in its input's memory format (``depth_to_space``;
    no parameters, so the ``state_dict`` keys are the reference's)."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x):
        return depth_to_space(x, self.r)


# --------------------------------------------------------------------------
# Stage I building blocks
# --------------------------------------------------------------------------
class RDBConv(nn.Module):
    """One dense conv of an RDB: conv + relu, concatenated to the input.
    ``conv`` is a ``Sequential`` so that its parameters keep the
    reference's ``state_dict`` keys (``conv.0.weight``); the ReLU is
    passed to the convolution (:func:`_conv_in`)."""

    def __init__(self, cin: int, growth: int):
        super().__init__()
        self.conv = nn.Sequential(_conv(cin, growth, 3))

    def forward(self, x):
        return torch.cat([x, self.conv[0](x, relu=True)], dim=1)


class RDB(nn.Module):
    """Residual dense block."""

    def __init__(self, g0: int, growth: int, n_convs: int):
        super().__init__()
        self.convs = nn.Sequential(*[RDBConv(g0 + i * growth, growth)
                                     for i in range(n_convs)])
        self.LFF = _conv(g0 + n_convs * growth, g0, 1)

    def forward(self, x):
        return self.LFF(self.convs(x), residual=x)


class FFRDB(nn.Module):
    """Feature and flow extractor: 4 blurry frames -> space_to_depth(2) ->
    RDN backbone at half resolution -> pixel-shuffle head ->
    (F0, F1, flow_01, flow_10, occ_0_logit) at full resolution."""

    def __init__(self, nf: int, scale_factor: int = 2, g0: int = 96,
                 num_rdb: int = 12, n_convs: int = 4, growth: int = 32,
                 img_ch: int = 3, remat_rdb: bool = False):
        super().__init__()
        self.nf = nf
        self.scale_factor = scale_factor
        self.remat_rdb = remat_rdb     # recompute each RDB in training
        self.SFENet1 = _conv(4 * img_ch * scale_factor ** 2, g0, 5)
        self.SFENet2 = _conv(g0, g0, 3)
        self.RDBs = nn.ModuleList([RDB(g0, growth, n_convs)
                                   for _ in range(num_rdb)])
        self.GFF = nn.Sequential(_conv(num_rdb * g0, g0, 1), _conv(g0, g0, 3))
        self.UPNet = nn.Sequential(_conv(g0, 256, 3), _DepthToSpace(2),
                                   _conv(64, nf * 2 + 4 + 1, 3))

    def forward(self, frames):
        # frames: [B, 12, H, W] = (B0, B1, Bm1, B2) x 3 channels
        nf = self.nf
        x = space_to_depth(frames, self.scale_factor)
        f1 = self.SFENet1(x)
        x = self.SFENet2(f1)
        rdb_outs = []
        for rdb in self.RDBs:
            x = _remat(rdb, x) if self.remat_rdb else rdb(x)
            rdb_outs.append(x)
        x = self.GFF[1](self.GFF[0](torch.cat(rdb_outs, dim=1)), residual=f1)
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
        return self.conv2(self.conv1(x, relu=True), residual=x)


class FGAC(nn.Module):
    """Flow-Guided Attentive Correlation: correlates source keys with ref
    keys gathered at the raw flow values (absolute coordinates), then
    gates the aggregated feature against the source (Eq. 3-4). The
    correlation runs in float32 and its result goes back to the compute
    dtype."""

    compute_dtype = torch.float32
    shard = None

    def __init__(self, nf: int, rr: int = 0, sr: int = 0, viz: bool = False):
        super().__init__()
        self.rr, self.sr, self.viz = rr, sr, viz
        self.conv_ref_k = _conv(nf, nf, 1)
        self.conv_source_k = _conv(nf, nf, 1)
        self.fusion = _conv(nf, nf, 1)
        self.w_gen = _conv(2 * nf, nf, 3)
        self.w_gen_2 = _conv(nf, 1, 3)

    def forward(self, ref, source, flow_s2r):
        dt = self.compute_dtype
        ref_k = self.conv_ref_k(ref)
        source_k = self.conv_source_k(source)
        fac = _as(fgac_correlate(ref_k.float(), source_k.float(),
                                 flow_s2r.float(), rr=self.rr, sr=self.sr,
                                 shard=self.shard),
                  dt, activation_format(dt, ref.device))
        e_s = self.fusion(fac)
        w = _sigmoid(self.w_gen_2(self.w_gen(torch.cat([source, e_s], dim=1),
                                             relu=True)))
        bolstered = w * source + (1.0 - w) * e_s
        diff = _minmax_norm(torch.mean(torch.abs(bolstered - source), dim=1,
                                       keepdim=True), self.shard)
        if self.viz:
            # min-max-normalised mean-|.| single-channel views of the FGAC
            # internals: source key, initial ref key, aggregated E_s,
            # bolstered ("FCW")
            def norm1(v):
                return _minmax_norm(torch.mean(torch.abs(v.float()), dim=1,
                                               keepdim=True), self.shard)
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
        b = f0.shape[0]
        # both frames folded into the batch (frame-major), in their format
        x = self.conv_first(torch.cat([f0, f1], dim=0), relu=True)
        x = self.feature_extraction(x)
        enc0, enc1 = x[:b], x[b:]
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
        e1 = self.enc1(x, relu=True)
        e2 = self.enc2(e1, relu=True)
        h = self.enc3(e2, relu=True)
        h = _nearest_up2(self.dec0(h, relu=True))
        h = _nearest_up2(self.dec1(torch.cat([h, e2], dim=1), relu=True))
        h = _nearest_up2(self.dec2(torch.cat([h, e1], dim=1), relu=True))
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
        return self.conv_ref2(self.conv_ref1(ref, relu=True), relu=True)

    def forward(self, ref, delta, ref_enc=None):
        r = self.encode_ref(ref) if ref_enc is None else ref_enc
        d = self.conv_delta2(self.conv_delta1(delta, relu=True), relu=True)
        h = self.conv_blend1(torch.cat([r, d], dim=1), relu=True)
        return self.conv_blend2(h, relu=True)


class SepConvGRU(nn.Module):
    """Separable ConvGRU, (1,5) then (5,1). The z and r gates read the
    same [h, x] input, so their weights run as one conv on that concat;
    the q gate runs one conv on [r*h, x]. The fused conv runs in the
    compute dtype (:func:`_conv_in`), as the gates' convs do."""

    compute_dtype = torch.float32
    shard = None

    def __init__(self, h_dim: int):
        super().__init__()
        hd = h_dim
        for s, k in (("1", (1, 5)), ("2", (5, 1))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", _conv(2 * hd, hd, k))

    def _half(self, h, x, s: str):
        cz, cr, cq = (getattr(self, f"conv{g}{s}") for g in "zrq")
        hd = h.shape[1]
        dt = self.compute_dtype
        conv = ((lambda i, k, b: F.conv2d(i, k, b, padding=cz.padding))
                if self.shard is None
                else _rows_conv(self.shard, (1, 1), cz.padding))
        zr = _conv_in(dt, conv,
                      torch.cat([h.to(dt), x.to(dt)], dim=1),
                      torch.cat([cz.weight, cr.weight], dim=0),
                      torch.cat([cz.bias, cr.bias]))
        z = _sigmoid(zr[:, :hd])
        r = _sigmoid(zr[:, hd:])
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
        return self.conv2(self.conv1(x, relu=True))


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
    stacked on axis 0 ([..., C, H, W]; in the model's memory format where
    not stacked)."""
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
        instants per window, each tensor in its memory format."""
        def rep(v):
            if isinstance(v, tuple):
                return tuple(rep(x) for x in v)
            return repeat_batch(v, m)
        return StageIContext(**{f.name: rep(getattr(self, f.name))
                                for f in dataclasses.fields(self)})


# --------------------------------------------------------------------------
# Top-level model
# --------------------------------------------------------------------------
class DeMFINet(nn.Module):
    """DeMFI-Net. ``extract`` takes frames [B, 4, 3, H, W] in reference
    order (B0, B1, B-1, B2); ``synthesize`` takes t_value [B] or [B, 1]
    and a Python int ``num_update``. ``compute_dtype``: the convolutions'
    dtype (float32 or bfloat16); the parameters are float32 either
    way. ``remat``: None, or the granularity ("backbone" or "rdb") at
    which a train step recomputes the RDN backbone in its backward pass
    (the same values and gradients, less memory)."""

    def __init__(self, nf: int = 64, scale_factor: int = 2,
                 num_res_facfb: int = 5, num_res_dec: int = 5,
                 shared_fgac: bool = True, fgac_rr: int = 0,
                 fgac_sr: int = 0, use_stage2: bool = True,
                 viz_internals: bool = False, img_ch: int = 3,
                 fwarp_shift_d: int = 0,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: Optional[str] = None):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                             f"got {compute_dtype}")
        if remat is not None and remat not in REMAT_GRANULARITIES:
            raise ValueError(f"remat granularity must be one of "
                             f"{REMAT_GRANULARITIES}, got {remat!r}")
        self.remat = remat
        self.nf = nf
        self.fgac_rr = fgac_rr
        # window of CFR's deterministic forward warp (0: atomic splat)
        self.fwarp_shift_d = fwarp_shift_d
        self.use_stage2 = use_stage2
        self.viz_internals = viz_internals
        self.FF_RDB_Module = FFRDB(nf, scale_factor, img_ch=img_ch,
                                   remat_rdb=remat == "rdb")
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
        self.compute_dtype = compute_dtype
        for mod in self.modules():
            if isinstance(mod, (_Conv, _Conv3dT1, FGAC, SepConvGRU)):
                mod.compute_dtype = compute_dtype
        # the rows a shard holds must be a multiple of this, and so must
        # its first row: space-to-depth and RefineUNet's three stride-2
        # encoders
        self.row_stride = math.lcm(scale_factor, 2 ** 3)

    shard = None        # the RowShard that :meth:`rows` sets, or None

    @contextlib.contextmanager
    def rows(self, shard):
        """Within the block the model computes on ``shard``'s rows of a
        frame (a :class:`~demfi_torch.parallel.RowShard`; None: the whole
        frame): its inputs are those rows, and so are its outputs, those
        of the whole frame's forward, for serving and for training (a
        backward pass, remat's recomputation included, runs inside the
        block too). ``Grid.shard`` cuts frames at multiples of
        :attr:`row_stride`; a shard made by hand whose rows or first row
        are not is refused."""
        if shard is not None and (shard.rows % self.row_stride
                                  or shard.r0 % self.row_stride):
            raise ValueError(
                f"rows [{shard.r0}, {shard.r1}) of a {shard.h}-row frame "
                f"cannot be split exactly: each card's rows and first row "
                f"must be multiples of the network's total stride "
                f"{self.row_stride} (space-to-depth "
                f"{self.FF_RDB_Module.scale_factor}, three stride-2 "
                f"encoders), as demfi_torch.parallel.Grid.shard cuts them")
        with rows_of(self, shard):
            yield self

    # the modules built for use_stage2, read only when num_update > 0
    STAGE2 = ("Ch_Reducer", "Booster_Module", "Dec_first_2", "Decoder_res_2",
              "Dec_last1_2", "Dec_last2_2")

    def unread_parameters(self, num_update: int) -> List[str]:
        """Names of the parameters that a forward with ``num_update``
        boosting iterations never reads, so that their gradients stay
        None: every FGAC's ``conv_source_k`` at fgac_rr = 0 (the
        point-wise correlation never reads the source key, though the
        reference's layout keeps its weights) and, at num_update = 0, the
        second stage. DistributedDataParallel leaves them out of its
        gradient reduction (``demfi_torch.parallel.data_parallel``)."""
        names = []
        for name, _ in self.named_parameters():
            module = name.split(".")[0]
            fgac = name.split(".")[-2] == "conv_source_k"
            if ((fgac and self.fgac_rr == 0)
                    or (num_update == 0 and module in self.STAGE2)):
                names.append(name)
        return names

    # ---------------------------------------------------- t-independent
    def extract(self, frames: torch.Tensor) -> StageIContext:
        """RDN backbone + FAC-FB; runs once per 4-frame window."""
        with span("extract"):
            b, t, c, h, w = frames.shape
            if t != 4:
                raise ValueError(f"expected 4 input frames, got {t}")
            # frame-major concat: channel index = frame * 3 + colour, in
            # the model's memory format from here to the outputs
            cat = frames.reshape(b, t * c, h, w).contiguous(
                memory_format=activation_format(self.compute_dtype,
                                                frames.device))
            if self.remat == "backbone":
                f0, f1, flow_01, flow_10, occ = _remat(self.FF_RDB_Module, cat)
            else:
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
        with span("synthesize"):
            nf = self.nf
            dt = self.compute_dtype
            fmt = activation_format(dt, t_value.device)

            def cast(v):          # a cat's piece, in the model's format
                return _as(v, dt, fmt)
            # [B,1,1,1], not 0-dim: a 0-dim float32 tensor times a bfloat16 one
            # would stay bfloat16
            t = t_value.float().reshape(-1, 1, 1, 1)
            b0 = ctx.frames[:, 0:3]
            b1 = ctx.frames[:, 3:6]

            flow_t0, flow_t1 = cfr_flow_t_align(ctx.flow_01, ctx.flow_10, t,
                                                self.fwarp_shift_d, self.shard)
            occ_0 = torch.sigmoid(ctx.occ_0_logit.float())
            # the features warp in the compute dtype; the gather returns
            # float32 and the blend runs in float32
            ft = _t_blend(*bwarp_pair(ctx.f0, ctx.f1, flow_t0, flow_t1,
                                      self.shard), occ_0, t)

            agg1 = torch.cat([ctx.a_f0, ctx.a_f1, cast(ft), cast(flow_t0),
                              cast(flow_t1), cast(ctx.flow_01),
                              cast(ctx.flow_10), cast(ctx.occ_0_logit)],
                             dim=1)
            agg1 = self.Refine_Module(agg1) + torch.cat(
                [cast(flow_t0), cast(flow_t1), cast(ctx.occ_0_logit),
                 ctx.a_f0, ctx.a_f1], dim=1)

            rflow_t0 = agg1[:, 0:2].float()
            rflow_t1 = agg1[:, 2:4].float()
            occ_0_logit = agg1[:, 4:5].float()
            occ_0 = torch.sigmoid(occ_0_logit)
            r_f0 = torch.tanh(agg1[:, 5:5 + nf])
            r_f1 = torch.tanh(agg1[:, 5 + nf:5 + 2 * nf])
            r_ft = cast(_t_blend(*bwarp_pair(r_f0, r_f1, rflow_t0, rflow_t1,
                                             self.shard), occ_0, t))

            # D1: joint 3-frame decode (frames folded into the batch,
            # frame-major)
            bsz = r_f0.shape[0]
            out = self.Dec_first(torch.cat([r_f0, r_f1, r_ft], dim=0),
                                 relu=True)
            for blk in self.Decoder_res:
                out = blk(out)
            out = self.Dec_last1(out, relu=True)
            out = self.Dec_last2(out)
            s0p, s1p, stp = out[:bsz], out[bsz:2 * bsz], out[2 * bsz:]

            flow_init = torch.cat([rflow_t0, rflow_t1], dim=1)
            if self.use_stage2 and num_update > 0:
                f_rec = torch.tanh(self.Ch_Reducer(
                    torch.cat([r_f0, r_f1, r_ft], dim=1)))
                t_ref = torch.cat([cast(flow_init), cast(occ_0_logit)],
                                  dim=1)
                length1_ref = cast(torch.cat([ctx.flow_10, ctx.flow_01],
                                             dim=1))
                # the float32 frames promote this concatenation to float32, as
                # in the JAX model; the conv that reads it casts it back
                sp_ref = torch.cat([s0p, s1p, stp, ctx.frames], dim=1)
                ref = torch.cat([sp_ref, length1_ref, t_ref], dim=1)
                # loop-invariant: encoded once per window
                ref_enc = self.Booster_Module.encode_ref(ref)

                carry = (f_rec, cast(flow_init), cast(occ_0_logit))
                const = (ref_enc, s0p, s1p, cast(occ_0), cast(rflow_t0),
                         cast(rflow_t1), cast(ctx.flow_10),
                         cast(ctx.flow_01), ctx.frames, t)
                ys: List[Tuple[torch.Tensor, ...]] = []
                for _ in range(num_update):
                    carry, y = self._boost_step(carry, const, cast)
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

    def _boost_step(self, carry, const, cast):
        """One recursive-boosting iteration. ``carry`` = (f_rec,
        delta_flow, delta_occ) in the compute dtype; ``const`` holds the
        loop invariants; ``cast`` takes a tensor to the compute dtype and
        the model's memory format."""
        with span("boost"):
            f_rec, delta_flow, delta_occ = carry
            (ref_enc, s0p, s1p, occ_0, rflow_t0, rflow_t1,
             flow_10, flow_01, frames, t) = const

            delta = torch.cat([delta_flow, delta_occ], dim=1)
            f_rec, d_flow, d_occ = self.Booster_Module(f_rec, None, delta,
                                                       ref_enc=ref_enc)
            delta_flow = delta_flow + d_flow
            delta_occ = delta_occ + d_occ

            ft0_f = delta_flow[:, :2].float()
            ft1_f = delta_flow[:, 2:4].float()
            occ_0_f = torch.sigmoid(delta_occ.float())
            st_new = cast(_t_blend(*bwarp_pair(s0p, s1p, ft0_f, ft1_f,
                                               self.shard), occ_0_f, t))

            # float32 like the JAX model's (the frames promote it); the conv
            # that reads it casts it to the compute dtype
            agg3 = torch.cat([s0p, s1p, st_new, f_rec, occ_0, rflow_t0,
                              rflow_t1, flow_10, flow_01, cast(ft0_f),
                              cast(ft1_f), cast(occ_0_f), frames], dim=1)
            out = self.Dec_first_2(agg3, relu=True)
            for blk in self.Decoder_res_2:
                out = blk(out)
            out = self.Dec_last1_2(out, relu=True)
            out = self.Dec_last2_2(out)
            ys = (delta_flow.float(), occ_0_f, out[:, 0:3] + s0p,
                  out[:, 3:6] + s1p, out[:, 6:9] + st_new)
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
    CPU), computing in ``cfg.compute_dtype`` with float32 parameters,
    recomputing the backbone in training where ``cfg.remat_backbone``."""
    from demfi_torch import resolve_device

    dev = resolve_device(device)
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of "
                         f"{sorted(COMPUTE_DTYPES)}, got {cfg.compute_dtype!r}")
    if cfg.remat_granularity not in REMAT_GRANULARITIES:
        raise ValueError(f"remat_granularity must be one of "
                         f"{REMAT_GRANULARITIES}, got "
                         f"{cfg.remat_granularity!r}")
    model = DeMFINet(
        nf=cfg.nf, scale_factor=cfg.scale_factor,
        num_res_facfb=cfg.num_ResB_FACFB, num_res_dec=cfg.num_ResB_Dec,
        shared_fgac=cfg.shared_FGAC_flag, fgac_rr=cfg.fgac_rr,
        fgac_sr=cfg.fgac_sr, use_stage2=max(cfg.N_trn, cfg.N_tst) > 0,
        viz_internals=cfg.visualization_flag, img_ch=cfg.img_ch,
        fwarp_shift_d=cfg.fwarp_shift_d,
        compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype],
        remat=cfg.remat_granularity if cfg.remat_backbone else None)
    gen = torch.Generator().manual_seed(cfg.seed)
    init_weights(model, gen)
    return model.to(dev).eval()
