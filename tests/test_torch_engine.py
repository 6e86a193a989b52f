"""The port's InferenceEngine against the JAX engine, on the CPU.

Every WindowResult field at 32x48, x4 (three instants), on the same
weights (a JAX parameter tree from a numpy seed, carried across by the
port's converter): untiled with two windows in one batch, tiled at
test_patch=(2,2) with an 8 px halo, and fetch="images". Tolerance atol
2e-4 / rtol 2e-4 (float32 convolutions summed in different orders).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.infer import InferenceEngine as JaxEngine
from demfi_tpu.models import make_model as jax_make_model
from demfi_torch.checkpoint import flax_params_to_state_dict
from demfi_torch.config import config_rb
from demfi_torch.infer import InferenceEngine, WindowResult
from demfi_torch.models import make_model


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

TOL = dict(atol=2e-4, rtol=2e-4)
H, W = 32, 48
TS = np.array([0.25, 0.5, 0.75], np.float32)
FIELDS = [f.name for f in dataclasses.fields(WindowResult)]


def jax_param_tree(jmodel, seed):
    """The JAX model's parameter tree (its structure from eval_shape), with
    xavier-normal kernels and small random biases drawn from numpy."""
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1, 4, H, W, 3)),
                              jnp.full((1, 1), 0.5), num_update=1),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(s):
        if len(s.shape) == 4:   # HWIO
            kh, kw, ci, co = s.shape
            std = np.sqrt(2.0 / (kh * kw * (ci + co)))
            return (rng.randn(*s.shape) * std).astype(np.float32)
        return (rng.randn(*s.shape) * 0.01).astype(np.float32)
    return jax.tree_util.tree_map(fill, shapes)


@pytest.fixture(scope="module")
def setup():
    jmodel = jax_make_model(jax_config_rb(2, 2))
    params = jax_param_tree(jmodel, 3)
    model = make_model(config_rb(2, 2), device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    frames = np.random.RandomState(11).uniform(
        -1, 1, (2, 4, H, W, 3)).astype(np.float32)
    return jmodel, params, model, frames


def assert_results_close(got: WindowResult, want, fields=FIELDS):
    for name in fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_untiled_two_windows(setup):
    jmodel, params, model, frames = setup
    ts = np.stack([TS, TS])
    want = JaxEngine(jmodel, params, 2).forward_windows(frames, ts)
    got = InferenceEngine(model, 2, device="cpu").forward_windows(frames, ts)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_results_close(g, w)


def test_tiled_2x2(setup):
    jmodel, params, model, frames = setup
    kw = dict(test_patch=(2, 2), patch_boundary=8)
    want = JaxEngine(jmodel, params, 2).forward_window(frames[:1], TS, **kw)
    got = InferenceEngine(model, 2, device="cpu").forward_window(
        frames[:1], TS, **kw)
    assert_results_close(got, want)


def test_fetch_images(setup):
    jmodel, params, model, frames = setup
    want = JaxEngine(jmodel, params, 2, fetch="images").forward_window(
        frames[:1], TS)
    got = InferenceEngine(model, 2, fetch="images",
                          device="cpu").forward_window(frames[:1], TS)
    assert_results_close(got, want)
    assert not got.flow_init.any() and got.flow_init.shape == (3, H, W, 4)


def test_t_chunk_matches_one_batch(setup):
    """Chunking the t axis (two calls of 2 + 1 instants) changes nothing
    but the batch the convolutions see."""
    _, _, model, frames = setup
    ts = np.stack([TS, TS])
    one = InferenceEngine(model, 2, device="cpu").forward_windows(frames, ts)
    chunked = InferenceEngine(model, 2, t_chunk=2,
                              device="cpu").forward_windows(frames, ts)
    for a, b in zip(chunked, one):
        for name in FIELDS:
            np.testing.assert_allclose(getattr(a, name), getattr(b, name),
                                       atol=1e-5, rtol=1e-5, err_msg=name)


def test_visualization_fields(setup):
    """A model built with visualization on fills the fgac_* and flow
    fields of WindowResult."""
    _, params, _, frames = setup
    jmodel = jax_make_model(jax_config_rb(2, 2, visualization_flag=True))
    model = make_model(config_rb(2, 2, visualization_flag=True), device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    want = JaxEngine(jmodel, params, 2).forward_window(frames[:1], TS)
    got = InferenceEngine(model, 2, device="cpu").forward_window(frames[:1], TS)
    assert_results_close(got, want)
    assert got.fgac_fcw_01.any() and got.flow_10.any()
