"""The port's DeMFI-Net against the JAX model, on the CPU.

A JAX parameter tree for DeMFI-Net_rb(2,2) (structure from the JAX model
itself, values from a numpy seed) is carried across by the port's
converter and loaded with ``strict=True``. Modules and the whole
``extract`` / ``synthesize`` are then held against JAX at the golden
geometry of tests/test_regression.py (32x48, t = 0.375) at atol 2e-4 /
rtol 2e-4 (float32; the two frameworks sum convolutions in different
orders). NaN must sit where JAX has NaN.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demfi_tpu.checkpoint.convert import flax_to_torch_state_dict
from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.models import demfi as jdemfi
from demfi_tpu.models import make_model as jax_make_model
from demfi_torch import nchw_to_nhwc, nhwc_to_nchw
from demfi_torch.checkpoint import flax_params_to_state_dict
from demfi_torch.config import config_bs, config_rb
from demfi_torch.models import demfi, make_model


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL = dict(atol=2e-4, rtol=2e-4)
H, W, T = 32, 48, 0.375


def jax_param_tree(jmodel, frames, t, seed):
    """The JAX model's parameter tree (its structure from eval_shape), with
    xavier-normal kernels and small random biases drawn from numpy."""
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, frames, t, num_update=1),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(s):
        if len(s.shape) == 4:   # HWIO
            kh, kw, ci, co = s.shape
            std = np.sqrt(2.0 / (kh * kw * (ci + co)))
            return (rng.randn(*s.shape) * std).astype(np.float32)
        return (rng.randn(*s.shape) * 0.01).astype(np.float32)
    return jax.tree_util.tree_map(fill, shapes)


def to_t(x):
    return nhwc_to_nchw(torch.from_numpy(np.array(x, np.float32)))


def to_np(x):
    return nchw_to_nhwc(x.detach()).numpy()


def close(port, ref, **tol):
    np.testing.assert_allclose(to_np(port), np.asarray(ref), **(tol or TOL))


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, frames NHWC, t)."""
    rng = np.random.RandomState(42)
    frames = rng.uniform(-1, 1, (1, 4, H, W, 3)).astype(np.float32)
    t = np.array([[T]], np.float32)
    jmodel = jax_make_model(jax_config_rb(2, 2))
    params = jax_param_tree(jmodel, jnp.asarray(frames), jnp.asarray(t), 42)
    model = make_model(config_rb(2, 2), device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return jmodel, params, model, frames, t


@pytest.fixture(scope="module")
def staged(pair):
    """JAX's and the port's extract + synthesize outputs."""
    jmodel, params, model, frames, t = pair
    jctx = jmodel.apply(params, jnp.asarray(frames), method=jmodel.extract)
    jout = jmodel.apply(params, jctx, jnp.asarray(t), 2,
                        method=jmodel.synthesize)
    with torch.no_grad():
        ctx = model.extract(torch.from_numpy(frames).permute(0, 1, 4, 2, 3))
        out = model.synthesize(ctx, torch.from_numpy(t), 2)
    return jctx, jout, ctx, out


def test_converter_keys_shapes_values(pair):
    """The port's state_dict equals the JAX package's own conversion
    (the oracle) key for key, shape for shape and value for value."""
    _, params, model, _, _ = pair
    ours = flax_params_to_state_dict(params)
    oracle = flax_to_torch_state_dict(params)
    assert set(ours) == set(oracle) == set(model.state_dict())
    for k, v in oracle.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
        assert tuple(model.state_dict()[k].shape) == tuple(np.shape(v)), k


@pytest.mark.parametrize("cfg,expect", [(config_rb(5, 3), 7.41e6),
                                        (config_bs(), 5.96e6)])
def test_param_counts(cfg, expect):
    """Table 2: DeMFI-Net_rb has 7.41 M parameters, DeMFI-Net_bs 5.96 M."""
    n = sum(p.numel() for p in make_model(cfg, device="cpu").parameters())
    assert abs(n - expect) < 0.02e6, n


def test_minmax_norm_and_t_blend():
    """_minmax_norm divides by a max that may be 0 (NaN where JAX has
    NaN); _t_blend broadcasts [B,1,H,W] occlusion and [B,1,1,1] t."""
    rng = np.random.RandomState(0)
    v = rng.randn(3, 6, 8, 2).astype(np.float32)
    v[1] = 0.5                                  # constant sample -> 0/0
    got = to_np(demfi._minmax_norm(to_t(v)))
    want = np.asarray(jdemfi._minmax_norm(jnp.asarray(v)))
    assert np.isnan(want[1]).all()
    np.testing.assert_allclose(got, want, **TOL)
    a, b = rng.randn(2, 3, 6, 8, 4).astype(np.float32)
    occ = rng.uniform(0, 1, (3, 6, 8, 1)).astype(np.float32)
    t = rng.uniform(0, 1, (3, 1, 1, 1)).astype(np.float32)
    close(demfi._t_blend(to_t(a), to_t(b), to_t(occ), torch.from_numpy(t)),
          jdemfi._t_blend(jnp.asarray(a), jnp.asarray(b), jnp.asarray(occ),
                          jnp.asarray(t)))


def test_ffrdb(pair):
    jmodel, params, model, frames, _ = pair
    cat = frames.transpose(0, 2, 3, 1, 4).reshape(1, H, W, 12)
    want = jdemfi.FFRDB(64).apply(
        {"params": params["params"]["FF_RDB_Module"]}, jnp.asarray(cat))
    with torch.no_grad():
        got = model.FF_RDB_Module(
            torch.from_numpy(frames).permute(0, 1, 4, 2, 3).reshape(1, 12, H, W))
    for g, w in zip(got, want):
        close(g, w)


def test_facfb(pair, staged):
    jmodel, params, model, _, _ = pair
    jctx = staged[0]
    args = (jctx.f0, jctx.f1, jctx.flow_10, jctx.flow_01)
    want = jdemfi.FACFB(64, 5).apply(
        {"params": params["params"]["FAC_FB_Module"]}, *args)
    with torch.no_grad():
        got = model.FAC_FB_Module(*(to_t(a) for a in args))
    close(got[0], want[0])
    close(got[1], want[1])
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        close(g, w)


def test_refine_unet(pair):
    _, params, model, _, _ = pair
    x = np.random.RandomState(5).randn(2, H, W, 201).astype(np.float32)
    want = jdemfi.RefineUNet(64).apply(
        {"params": params["params"]["Refine_Module"]}, jnp.asarray(x))
    with torch.no_grad():
        close(model.Refine_Module(to_t(x)), want)


def test_booster(pair):
    _, params, model, _, _ = pair
    rng = np.random.RandomState(6)
    f_rec = np.tanh(rng.randn(2, H, W, 64)).astype(np.float32)
    ref = rng.randn(2, H, W, 30).astype(np.float32)
    delta = rng.randn(2, H, W, 5).astype(np.float32)
    want = jdemfi.Booster(64).apply(
        {"params": params["params"]["Booster_Module"]},
        jnp.asarray(f_rec), jnp.asarray(ref), jnp.asarray(delta))
    with torch.no_grad():
        got = model.Booster_Module(to_t(f_rec), to_t(ref), to_t(delta))
    for g, w in zip(got, want):
        close(g, w)


def test_extract(staged):
    jctx, _, ctx, _ = staged
    for name in ("f0", "f1", "flow_01", "flow_10", "occ_0_logit", "a_f0",
                 "a_f1"):
        close(getattr(ctx, name), getattr(jctx, name))
    for g, w in zip(ctx.blend_weights + ctx.diff_maps,
                    jctx.blend_weights + jctx.diff_maps):
        close(g, w)


@pytest.mark.parametrize("name", [
    "s0_prime", "s1_prime", "st_prime", "s0_final", "s1_final", "st_final",
    "flow_preds", "occ0_preds", "ovlp_b0b1"])
def test_synthesize(staged, name):
    _, jout, _, out = staged
    close(getattr(out, name), getattr(jout, name))


def test_visualization_internals(pair):
    """With visualization on, extract also returns the normalised FGAC
    maps per direction and the flow pair."""
    _, params, _, frames, _ = pair
    jmodel = jax_make_model(jax_config_rb(2, 2, visualization_flag=True))
    model = make_model(config_rb(2, 2, visualization_flag=True), device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    want = jmodel.apply(params, jnp.asarray(frames),
                        method=jmodel.extract).viz_stacks
    with torch.no_grad():
        got = model.extract(
            torch.from_numpy(frames).permute(0, 1, 4, 2, 3)).viz_stacks
    flat_got = [x for grp in got for x in grp]
    flat_want = [x for grp in want for x in grp]
    assert len(flat_got) == len(flat_want) == 10
    for g, w in zip(flat_got, flat_want):
        close(g, w)
