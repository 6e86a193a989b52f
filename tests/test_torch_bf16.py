"""The port's bfloat16 mode (``compute_dtype="bfloat16"``) against the JAX
package's, on the CPU.

DeMFI-Net_rb(2,2) at the golden geometry of tests/test_torch_model.py
(32x48, t = 0.375, weights from ``jax_param_tree``), the JAX model at
``compute_dtype="bfloat16"`` (its booster unrolled, the same parameter
tree, so each convolution's call can be seen).

Per-pixel checks between two bfloat16 runs mean little: bfloat16
rounding is chaotic through the network's depth. Each convolution of the
port equals JAX's on the same input in all but a few elements per 10^4
(the two frameworks' float32 sums end in different last bits, which
flips a bfloat16 rounding), and each flip spreads through every 3x3 conv
after it. Measured at this geometry (the port and JAX each in bfloat16,
from the same frames), the relative L2 gap of the whole outputs is 0.79
to 0.97 of the gap between JAX's bfloat16 and its float32 outputs. So:

  (a) the gather and its vjp at bfloat16 against ``_bwarp_xla`` /
      ``_bilinear_abs_xla`` and their ``jax.vjp``: out, ones and
      grad_coords within 1e-5, grad_img within 1e-2 of its largest
      value (JAX's vjp scatter-adds bfloat16 contributions; the port sums
      in float32 and rounds once), and JAX's dtypes;
  (b) where the dtypes are: every convolution computes on bfloat16 input,
      weight and bias and returns bfloat16; the blends after the warps
      run in float32 with a [B,1,1,1] t; flows and occlusions are
      float32; every output has JAX's dtype. Planted faults (a model that
      ignores the flag, one convolution or the GRU at float32) fail it;
  (c) the half rule where the chaos cannot reach: every convolution and
      GRU call of JAX's bfloat16 forward, fed to the port's module on
      JAX's own input, lies at most half as far from JAX's output as the
      float32 module does (a port that ignores the flag sits at 1); so
      does the refinement's input (agg1) when synthesize is fed JAX's
      Stage-I context. The whole outputs, from the frames: JAX's dtypes,
      NaN where JAX has NaN, mean and std within 0.08;
  (d) a train step against JAX's bfloat16 ``value_and_grad``: the loss
      within 1e-2 (relative); each gradient within the larger of 1e-2
      and twice JAX's own change under a 1e-6 nudge of the batch (the
      rule of tests/test_torch_train.py). A bias's JAX reference is its
      conv output's cotangent summed in float64: JAX's CPU vjp of the
      bfloat16 bias broadcast sums in bfloat16 (4.8 % off the exact sum
      on 2048 elements, 83 % where the sum cancels), the port's in
      float32. Parameters, gradients and Adam's state stay float32;
  (e) a checkpoint written by a bfloat16 ``--phase train`` loads
      ``strict=True`` into a float32 model;
  (f) ``--compute_dtype bfloat16`` on the CPU CLI: ``--phase test`` and
      ``test_custom`` on a float32 checkpoint (strict), finite metrics;
  (g) the kernels' dtype checks refuse rather than convert.
"""
import contextlib
import os

import cv2
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp

from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.models import demfi as jdemfi
from demfi_tpu.models import make_model as jax_make_model
from demfi_tpu.ops import warp as jwarp
from demfi_tpu.train import loop as jloop
from demfi_torch.checkpoint import (checkpoint_path, flax_params_to_state_dict,
                                    load_checkpoint, save_checkpoint)
from demfi_torch.checkpoint.convert import flax_path_to_torch_key
from demfi_torch.config import DeMFIConfig, config_rb
from demfi_torch.main import cli, parse_args
from demfi_torch.models import demfi, make_model
from demfi_torch.ops import kernels
from demfi_torch.train import create_train_state, make_train_step

from test_torch_model import jax_param_tree

H, W, T = 32, 48, 0.375
BF = jnp.bfloat16
HALF = 0.5          # the half rule
MOMENTS = 0.08      # mean and std, whole outputs (docs/PERF.md:216-218)
GRU_BIASES = (("convz1", "convr1"), ("convq1",), ("convz2", "convr2"),
              ("convq2",))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def nhwc(x: torch.Tensor) -> np.ndarray:
    """A port tensor [..., C, H, W] as float64 numpy [..., H, W, C]."""
    x = x.detach().float()
    nd = x.dim()
    return x.permute(*range(nd - 3), nd - 2, nd - 1, nd - 3).numpy().astype(
        np.float64)


def nchw(x, dtype=torch.float32) -> torch.Tensor:
    """A JAX array [..., H, W, C] as a port tensor [..., C, H, W]."""
    x = np.array(jnp.asarray(x).astype(jnp.float32))
    nd = x.ndim
    return torch.from_numpy(np.ascontiguousarray(
        x.transpose(*range(nd - 3), nd - 1, nd - 3, nd - 2))).to(dtype)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    keep = np.isfinite(got) & np.isfinite(want)
    return float(np.linalg.norm((got - want)[keep])
                 / np.linalg.norm(want[keep]))


def torch_dtype(jax_dtype) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        str(jax_dtype)]


# ------------------------------------------------------------ (a) gather
@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("c", [3, 64])
def test_gather_and_vjp_at_bf16_equal_jax(relative, c):
    rng = np.random.RandomState(c + 2 * relative)
    b, h, w = 2, 17, 23
    img = rng.randn(b, h, w, c).astype(np.float32)
    if relative:
        coords = (rng.randn(b, h, w, 2) * 6).astype(np.float32)
    else:
        coords = np.stack([rng.uniform(-3, w + 3, (b, h, w)),
                           rng.uniform(-3, h + 3, (b, h, w))],
                          -1).astype(np.float32)
    gout = rng.randn(b, h, w, c).astype(np.float32)
    jimg = jnp.asarray(img).astype(BF)
    fn = jwarp._bwarp_xla if relative else jwarp._bilinear_abs_xla
    jout, vjp = jax.vjp(fn, jimg, jnp.asarray(coords))
    jgi, jgc = vjp(jnp.asarray(gout))

    timg = nchw(jimg, torch.bfloat16)
    tco = nchw(coords)
    out, ones = kernels.bilinear_gather(timg, tco, relative)
    gi, gc = kernels.bilinear_gather_bwd(timg, tco, relative, nchw(gout))
    for port, ref in ((out, jout), (gi, jgi), (gc, jgc)):
        assert port.dtype == torch_dtype(ref.dtype)
    assert out.dtype == gc.dtype == torch.float32
    assert gi.dtype == torch.bfloat16
    np.testing.assert_allclose(nhwc(out), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    if relative:
        gx = jnp.arange(w, dtype=jnp.float32)[None, None, :]
        gy = jnp.arange(h, dtype=jnp.float32)[None, :, None]
        _, jones = jwarp._bilinear_zeros(jimg, gx + coords[..., 0],
                                         gy + coords[..., 1])
        assert ones.dtype == torch.float32
        np.testing.assert_allclose(nhwc(ones), np.asarray(jones), atol=1e-5,
                                   rtol=1e-5)
    want_gc = np.asarray(jgc, np.float64)
    np.testing.assert_allclose(nhwc(gc), want_gc, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want_gc).max()))
    want_gi = np.asarray(jgi.astype(jnp.float32), np.float64)
    np.testing.assert_allclose(nhwc(gi), want_gi, rtol=0,
                               atol=1e-2 * np.abs(want_gi).max())


# ----------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def golden():
    """(frames NHWC, t, JAX parameter tree, its state_dict)."""
    rng = np.random.RandomState(42)
    frames = rng.uniform(-1, 1, (1, 4, H, W, 3)).astype(np.float32)
    t = np.array([[T]], np.float32)
    params = jax_param_tree(jax_make_model(jax_config_rb(2, 2)),
                            jnp.asarray(frames), jnp.asarray(t), 42)
    return frames, t, params, flax_params_to_state_dict(params)


def port_model(sd, dtype: str):
    model = make_model(config_rb(2, 2, compute_dtype=dtype), device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


@pytest.fixture(scope="module")
def jax_bf16(golden):
    """JAX's bfloat16 extract and synthesize on the golden frames, with
    every convolution's and GRU's call (module path, inputs, output) and
    the refinement's input."""
    frames, t, params, _ = golden
    jm = jax_make_model(jax_config_rb(2, 2, compute_dtype="bfloat16",
                                      scan_booster=False))
    calls, agg1 = [], []

    def spy(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            if isinstance(context.module, (nn.Conv, jdemfi.SepConvGRU)):
                calls.append((tuple(context.module.path), args, out))
            elif isinstance(context.module, jdemfi.RefineUNet):
                agg1.append(args[0])
        return out
    with nn.intercept_methods(spy):
        ctx = jm.apply(params, jnp.asarray(frames), method=jm.extract)
        out = jm.apply(params, ctx, jnp.asarray(t), 2, method=jm.synthesize)
    return ctx, out, calls, agg1[0]


@pytest.fixture(scope="module")
def port_bf16(golden):
    frames, t, _, sd = golden
    model = port_model(sd, "bfloat16")
    with torch.no_grad():
        ctx = model.extract(torch.from_numpy(frames).permute(0, 1, 4, 2, 3))
        out = model.synthesize(ctx, torch.from_numpy(t), 2)
    return model, ctx, out


CTX_FIELDS = ("f0", "f1", "flow_01", "flow_10", "occ_0_logit", "a_f0",
              "a_f1")
OUT_FIELDS = ("s0_prime", "s1_prime", "st_prime", "s0_final", "s1_final",
              "st_final", "flow_preds", "occ0_preds", "ovlp_b0b1")


def _pairs(port_ctx, port_out, jctx, jout):
    """(name, port tensor, JAX array) of every output of extract and
    synthesize."""
    yield from ((n, getattr(port_ctx, n), getattr(jctx, n))
                for n in CTX_FIELDS)
    for n in ("blend_weights", "diff_maps"):
        for k in range(2):
            yield (f"{n}[{k}]", getattr(port_ctx, n)[k],
                   getattr(jctx, n)[k])
    yield from ((n, getattr(port_out, n), getattr(jout, n))
                for n in OUT_FIELDS)


# ---------------------------------------------------------- (b) dtypes
def dtype_violations(model, frames, t) -> list:
    """Run extract and synthesize and list every place where the bfloat16
    model's dtypes depart from the JAX model's: a convolution computing
    on anything but bfloat16 (input, weight, bias, result), a blend after
    the warps not in float32 or with a t that is not [B,1,1,1], flows or
    occlusions not float32."""
    bad, seen = [], set()
    conv2d, t_blend = F.conv2d, demfi._t_blend

    def conv_spy(x, weight, bias=None, *args, **kwargs):
        dts = (x.dtype, weight.dtype, None if bias is None else bias.dtype)
        if any(d not in (torch.bfloat16, None) for d in dts):
            bad.append(("conv operands", dts))
        return conv2d(x, weight, bias, *args, **kwargs)

    def blend_spy(a, b, occ, tt):
        if any(v.dtype != torch.float32 for v in (a, b, occ, tt)) \
                or tt.dim() != 4:
            bad.append(("blend", a.dtype, b.dtype, occ.dtype, tt.dtype,
                        tt.dim()))
        return t_blend(a, b, occ, tt)

    def out_hook(mod, _inp, out):
        seen.add(mod)
        if out.dtype != torch.bfloat16:
            bad.append(("conv result", type(mod).__name__, out.dtype))
    convs = [m for m in model.modules()
             if isinstance(m, (demfi._Conv, demfi._Conv3dT1))]
    hooks = [m.register_forward_hook(out_hook) for m in convs]
    F.conv2d, demfi._t_blend = conv_spy, blend_spy
    try:
        with torch.no_grad():
            ctx = model.extract(torch.from_numpy(frames).permute(0, 1, 4, 2, 3))
            out = model.synthesize(ctx, torch.from_numpy(t), 2)
    finally:
        F.conv2d, demfi._t_blend = conv2d, t_blend
        for h in hooks:
            h.remove()
    # the GRU's z and r gates run as one fused conv, not as modules
    fused = {getattr(g, n) for g in model.modules()
             if isinstance(g, demfi.SepConvGRU)
             for n in ("convz1", "convr1", "convz2", "convr2")}
    unused = [m for m in convs if m not in seen and m not in fused]
    if unused:
        bad.append(("convs never called", len(unused)))
    for v in (ctx.flow_01, ctx.flow_10, out.flow_preds, out.occ0_preds):
        if v.dtype != torch.float32:
            bad.append(("flow or occlusion", v.dtype))
    return bad


def test_bf16_dtype_sites(golden, port_bf16):
    frames, t, _, _ = golden
    assert dtype_violations(port_bf16[0], frames, t) == []


@pytest.mark.parametrize("fault", ["float32 model", "one conv", "gru"])
def test_dtype_sites_catch_a_model_that_ignores_the_flag(golden, fault):
    frames, t, _, sd = golden
    model = port_model(sd, "float32" if fault == "float32 model"
                       else "bfloat16")
    if fault == "one conv":         # computes in float32 whatever it gets
        conv = model.Refine_Module.dec1

        def float32_conv(x, relu=False):     # its site passes the ReLU
            y = torch.nn.Conv2d.forward(conv, x.float())
            return F.relu(y) if relu else y
        conv.forward = float32_conv
    elif fault == "gru":
        model.Booster_Module.GB.compute_dtype = torch.float32
    assert dtype_violations(model, frames, t) != []


def test_bf16_output_dtypes_equal_jax(port_bf16, jax_bf16):
    _, ctx, out = port_bf16
    jctx, jout = jax_bf16[:2]
    for name, got, want in _pairs(ctx, out, jctx, jout):
        assert got.dtype == torch_dtype(want.dtype), name


# ------------------------------------------------- (c) against JAX bf16
GROUPS = {"FF_RDB_Module": ("FF_RDB_Module.",),
          "FAC_FB_Module": ("FAC_FB_Module.",),
          "Refine_Module": ("Refine_Module.",),
          "D1": ("Dec_first.", "Decoder_res.", "Dec_last1.", "Dec_last2."),
          "Stage II": ("Ch_Reducer.", "Booster_Module.", "Dec_first_2.",
                       "Decoder_res_2.", "Dec_last1_2.", "Dec_last2_2.")}


@pytest.mark.parametrize("group", list(GROUPS))
def test_each_conv_on_jax_input_within_half_the_bf16_gap(golden, port_bf16,
                                                         jax_bf16, group):
    """Every call of JAX's bfloat16 forward to a convolution (or the
    GRU) of the group, replayed through the port's module on JAX's own
    input: the port's bfloat16 result lies at most half as far from
    JAX's as the float32 module's does."""
    m16 = port_bf16[0]
    m32 = port_model(golden[3], "float32")
    n, worst = 0, (0.0, "")
    for path, args, jout in jax_bf16[2]:
        gru = path[-1] == "GB"
        key = flax_path_to_torch_key(path + (("convz1",) if gru else ())
                                     + ("kernel",))
        key = key[:key.rindex(".convz1" if gru else ".weight")]
        if not (key + ".").startswith(GROUPS[group]):
            continue
        x16 = [nchw(a, torch.bfloat16) for a in args]
        with torch.no_grad():
            got = m16.get_submodule(key)(*x16)
            f32 = m32.get_submodule(key)(*(a.float() for a in x16))
        assert got.dtype == torch.bfloat16, key
        want = np.asarray(jout.astype(jnp.float32))
        ratio = rel(nhwc(got), want) / rel(nhwc(f32), want)
        worst = max(worst, (ratio, key))
        n += 1
    # FFRDB 2 + 12 x 5 + 4; FAC-FB 11 + FGAC 2 x 5; Stage II at two
    # boosting iterations 1 + 2 + 2 x (4 Mixer + 1 GRU + 2 + 13)
    assert n == {"FF_RDB_Module": 66, "FAC_FB_Module": 21,
                 "Refine_Module": 7, "D1": 13, "Stage II": 43}[group]
    assert worst[0] <= HALF, worst


def test_agg1_on_jax_context_within_half_the_bf16_gap(golden, jax_bf16):
    """synthesize fed JAX's bfloat16 Stage-I context: the refinement's
    input (the casts of the blended features and the float32 flows
    before the concatenation) lies at most half as far from JAX's as
    the float32 model's."""
    frames, t, _, sd = golden
    jctx, _, _, jagg1 = jax_bf16
    got = {}

    def run(dtype):
        model = port_model(sd, dtype)
        dt = model.compute_dtype
        ctx = demfi.StageIContext(
            **{n: nchw(getattr(jctx, n),
                       torch.float32 if n.startswith("flow") else dt)
               for n in CTX_FIELDS},
            blend_weights=tuple(nchw(v, dt) for v in jctx.blend_weights),
            diff_maps=tuple(nchw(v, dt) for v in jctx.diff_maps),
            frames=torch.from_numpy(frames).permute(0, 1, 4, 2, 3).reshape(
                1, 12, H, W).contiguous())
        hook = model.Refine_Module.register_forward_pre_hook(
            lambda _m, inp: got.__setitem__(dtype, inp[0]))
        with torch.no_grad():
            model.synthesize(ctx, torch.from_numpy(t), 2)
        hook.remove()
    run("bfloat16")
    run("float32")
    want = np.asarray(jagg1.astype(jnp.float32))
    assert got["bfloat16"].dtype == torch.bfloat16
    assert rel(nhwc(got["bfloat16"]), want) <= HALF * rel(
        nhwc(got["float32"]), want)


def test_whole_outputs_moments_equal_jax(port_bf16, jax_bf16):
    """From the frames, each framework in bfloat16: every output of
    extract and synthesize has JAX's NaN sites, mean and std."""
    _, ctx, out = port_bf16
    jctx, jout = jax_bf16[:2]
    for name, got, want in _pairs(ctx, out, jctx, jout):
        got = nhwc(got)
        want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                      err_msg=name)
        ok = ~np.isnan(want)
        assert abs(got[ok].mean() - want[ok].mean()) <= MOMENTS, name
        assert abs(got[ok].std() - want[ok].std()) <= MOMENTS, name


# --------------------------------------------------------- (d) training
def _rel_frobenius(got: np.ndarray, want: np.ndarray) -> float:
    scale = float(np.linalg.norm(want.astype(np.float64)))
    err = float(np.linalg.norm(got.astype(np.float64) - want))
    return err / scale if scale > 0 else err


def _jax_bf16_loss():
    """(loss(params, frames, t, zeros), the zeros' shapes, their biases):
    JAX's bfloat16 train loss with a zero added to every convolution's
    output (of nn.Conv after its bias, of the GRU's lax convolutions
    before theirs), so that the zeros' gradients are the convolutions'
    output cotangents, which sum to their biases' gradients."""
    cfg = jax_config_rb(2, 2, compute_dtype="bfloat16", scan_booster=False)
    jm = jax_make_model(cfg)

    def loss(params, frames, t, zeros, log=None):
        k, where = [0], [None]

        def add(out, path, names):
            i = k[0]
            k[0] += 1
            if log is not None:
                log.append((path, names, out.shape))
            return out if zeros is None else out + zeros[i].astype(out.dtype)

        def spy(next_fun, args, kwargs, context):
            if context.method_name == "__call__":
                if isinstance(context.module, nn.Conv):
                    where[0] = (tuple(context.module.path), None)
                elif isinstance(context.module, jdemfi.SepConvGRU):
                    where[0] = (tuple(context.module.path), 0)
            return next_fun(*args, **kwargs)
        lax_conv = jax.lax.conv_general_dilated

        def conv(*args, **kwargs):     # every conv of the model calls it
            out = lax_conv(*args, **kwargs)
            path, j = where[0]
            if j is None:
                return add(out, path, ("",))
            where[0] = (path, j + 1)
            return add(out, path, GRU_BIASES[j % 4])
        jax.lax.conv_general_dilated = conv
        try:
            with nn.intercept_methods(spy):
                out = jm.apply(params, frames[:, :4], t, num_update=cfg.N_trn)
        finally:
            jax.lax.conv_general_dilated = lax_conv
        return jloop.demfi_loss(cfg, out, frames[:, 5], frames[:, 6],
                                frames[:, 4])[0]
    return loss


def _bias_sums(log, cotangents):
    sums = {}
    for (path, names, _), c in zip(log, cotangents):
        parts = np.split(np.asarray(c, np.float64).sum((0, 1, 2)), len(names))
        for name, part in zip(names, parts):
            key = flax_path_to_torch_key(path + ((name,) if name else ())
                                         + ("bias",))
            sums[key] = sums.get(key, 0.0) + part
    return sums


def test_train_step_bf16_equals_jax():
    h = w = 32
    rng = np.random.RandomState(21)
    frames = rng.uniform(-1, 1, (2, 9, h, w, 3)).astype(np.float32)
    nudged = frames + (rng.randn(*frames.shape) * 1e-6).astype(np.float32)
    t = np.array([[0.25], [0.625]], np.float32)
    params = jax_param_tree(jax_make_model(jax_config_rb(2, 2)),
                            jnp.asarray(frames[:, :4]), jnp.asarray(t), 21)
    loss, log = _jax_bf16_loss(), []
    jax.eval_shape(lambda p, f: loss(p, f, jnp.asarray(t), None, log),
                   params, frames)
    zeros = [jnp.zeros(shape, jnp.float32) for _, _, shape in log]
    value_and_grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 3)))
    jl, (jgrads, jcots) = value_and_grad(params, frames, jnp.asarray(t), zeros)
    _, (jnudged, ncots) = value_and_grad(params, nudged, jnp.asarray(t), zeros)
    want, moved = (flax_params_to_state_dict(g) for g in (jgrads, jnudged))
    want_bias, moved_bias = _bias_sums(log, jcots), _bias_sums(log, ncots)

    cfg = config_rb(2, 2, compute_dtype="bfloat16")
    model = make_model(cfg, device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    grads = {}

    def snapshot(phase):
        if phase == "backward":
            grads.update({k: None if p.grad is None else p.grad.clone()
                          for k, p in model.named_parameters()})
    m1 = step(state, frames, t, on_phase=snapshot)
    step(state, frames, t)
    np.testing.assert_allclose(float(m1["total_loss"]), float(jl), rtol=1e-2)
    assert set(want) == set(grads) and set(want_bias) <= set(want)
    for k, g in grads.items():
        ref, ref_moved = ((want_bias[k], moved_bias[k]) if k in want_bias
                          else (want[k].numpy(), moved[k].numpy()))
        # at rr = 0 FGAC reads no source key: no gradient here, zeros there
        got = np.zeros_like(want[k].numpy()) if g is None else g.numpy()
        assert g is None or g.dtype == torch.float32, k
        err = _rel_frobenius(got, ref)
        bound = max(1e-2, 2 * _rel_frobenius(ref_moved, ref))
        assert err <= bound, (k, err, bound)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    adam = [v for s in state.optimizer.state.values() for v in s.values()
            if torch.is_tensor(v) and v.is_floating_point()]
    assert adam and all(v.dtype == torch.float32 for v in adam)


# ----------------------------------------------- (e), (f) checkpoints, CLI
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One train and one test scene at 32x32 (blur frames 17..41 stride 8,
    sharp frames 0..49), a clip of four frames, and a float32 checkpoint
    of DeMFI-Net_rb(1,1) at nf 16."""
    root = tmp_path_factory.mktemp("bf16")
    rng = np.random.RandomState(0)
    for split in ("train", "test"):
        sharp = root / "data" / split / "scene0"
        blur = root / "data" / f"{split}_blur" / "scene0"
        sharp.mkdir(parents=True)
        blur.mkdir(parents=True)
        for i in range(50):
            cv2.imwrite(str(sharp / f"{i:05d}.png"),
                        rng.randint(0, 255, (32, 32, 3), np.uint8))
        for k in range(4):
            cv2.imwrite(str(blur / f"{17 + 8 * k:05d}.png"),
                        rng.randint(0, 255, (32, 32, 3), np.uint8))
    clip = root / "clips" / "clipA"
    clip.mkdir(parents=True)
    for i in range(4):
        cv2.imwrite(str(clip / f"{i:05d}.png"),
                    rng.randint(0, 255, (32, 32, 3), np.uint8))
    model = make_model(config_rb(1, 1, nf=16, seed=5), device="cpu")
    save_checkpoint(checkpoint_path(DeMFIConfig(
        checkpoint_dir=str(root / "f32")), "latest"), model.state_dict())
    return root


SMALL = ["--N_trn", "1", "--N_tst", "1", "--nf", "16", "--device", "cpu",
         "--compute_dtype", "bfloat16"]


def test_parse_compute_dtype():
    assert parse_args([]).compute_dtype == "float32"
    assert parse_args(["--compute_dtype", "bfloat16"]).compute_dtype == \
        "bfloat16"
    with pytest.raises(SystemExit):
        parse_args(["--compute_dtype", "float16"])
    with pytest.raises(ValueError):
        make_model(config_rb(1, 1, nf=16, compute_dtype="float16"),
                   device="cpu")


def test_bf16_train_checkpoint_loads_into_float32(tree, tmp_path):
    dirs = ["--checkpoint_dir", str(tmp_path / "ck"),
            "--text_dir", str(tmp_path / "txt"),
            "--log_dir", str(tmp_path / "log"),
            "--test_img_dir", str(tmp_path / "img"),
            "--train_data_path", str(tree / "data"),
            "--test_data_path", str(tree / "data")]
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        res = cli(["--phase", "train", "--epochs", "1", "--patch_size", "32",
                   "--batch_size", "1", "--num_thrds", "1",
                   "--multiple_MFI", "2", *SMALL, *dirs])
    assert np.isfinite(res["epoch_losses"]).all()
    assert np.isfinite(res["final"][:5]).all()
    path = tmp_path / "ck" / "DeMFInet_exp1" / "DeMFInet_exp1_latest.pt"
    sd, _ = load_checkpoint(str(path))
    assert all(v.dtype == torch.float32 for v in sd.values())
    model = make_model(config_rb(1, 1, nf=16), device="cpu")
    model.load_state_dict(sd, strict=True)
    opt = torch.load(path, weights_only=False)["state_dict_Optimizer"]
    assert all(v.dtype == torch.float32 for s in opt["state"].values()
               for k, v in s.items() if k != "step")


def test_cli_bf16_on_a_float32_checkpoint(tree, capsys):
    args = [*SMALL, "--checkpoint_dir", str(tree / "f32"),
            "--test_data_path", str(tree / "data"),
            "--test_img_dir", str(tree / "imgs")]
    out = cli(["--phase", "test", "--multiple_MFI", "2", *args])
    assert np.isfinite(out[:5]).all()
    assert sorted(os.listdir(os.path.join(out[5], "scene0"))) == \
        ["00025.png", "00029.png", "00033.png"]
    assert cli(["--phase", "test_custom", "--multiple_MFI", "2",
                "--custom_path", str(tree / "clips"), *args]) is None
    assert sorted(os.listdir(tree / "clips" /
                             "clipA_sharply_interpolated_x2")) == [
        "00001.png", "00001_000.png", "00002.png"]
    assert "# compute_dtype : bfloat16" in capsys.readouterr().out


# ------------------------------------------------------- (g) refusals
@pytest.mark.parametrize("name,tensors,images", [
    ("fwarp_splat", ("bf16", "f32"), ()),
    ("fwarp_shift", ("f32", "bf16"), ()),
    ("fwarp_splat_bwd", ("bf16", "f32", "f32", "f32"), ()),
    ("bilinear_gather", ("bf16",), ("bf16",)),
    ("bilinear_gather", ("f32",), ("f16",)),
    ("bilinear_gather", ("f32", "f32"), ("bf16", "f32")),
])
def test_kernel_dtype_checks_refuse(name, tensors, images):
    """The splat, the stencil and the splat's backward take float32 only;
    the gather takes a float32 or bfloat16 image (both halves of one
    type) and float32 coordinates. A refusal is a TypeError, raised
    before anything is launched or converted."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}
    mk = [torch.zeros((1, 2, 4, 4), dtype=dt[d]) for d in tensors]
    imgs = tuple(torch.zeros((1, 2, 4, 4), dtype=dt[d]) for d in images)
    with pytest.raises(TypeError):
        kernels._check(name, *mk, images=imgs)
