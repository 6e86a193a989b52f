"""Recomputing the backbone in training (``remat_backbone``), on the CPU.

Either granularity must leave a train step's outputs and every parameter
gradient bitwise equal to the step without it, at float32 and at
bfloat16 (the recompute runs the same operations on the same inputs, and
the CPU's convolutions are deterministic), and leave the state_dict's
keys as they were. Against the JAX package's remat model (config_rb(1,1)
at 32x32, the setting of tests/test_train.py's remat test) the tolerance
is that of the port's train-step test (tests/test_torch_train.py): the
outputs atol/rtol 2e-4, each parameter's gradient a relative Frobenius
error of at most the larger of 1e-3 and twice the change of JAX's own
gradient of that tensor when its inputs move by 1e-6.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.models import make_model as jax_make_model
from demfi_torch.checkpoint import flax_params_to_state_dict
from demfi_torch.config import config_rb
from demfi_torch.models import make_model
from demfi_torch.models.demfi import DeMFINet

from test_torch_model import jax_param_tree
from test_torch_train import _rel_frobenius


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _step(cfg, weights, frames, t, gt):
    """Outputs and every parameter's gradient of one loss over both
    stages' frames; ``model.calls`` counts the forward runs of the
    backbone and of its first RDB (a recompute runs one again)."""
    model = make_model(cfg, device="cpu").train()
    model.load_state_dict(weights, strict=True)
    model.calls = {"backbone": 0, "rdb": 0}
    for name, mod in (("backbone", model.FF_RDB_Module),
                      ("rdb", model.FF_RDB_Module.RDBs[0])):
        mod.register_forward_pre_hook(
            lambda *_, name=name: model.calls.__setitem__(
                name, model.calls[name] + 1))
    out = model(frames, t, num_update=cfg.N_trn)
    loss = ((out.st_prime.float() - gt).abs().mean()
            + (out.st_final.float() - gt).abs().mean()
            + (out.s0_final.float() - gt).abs().mean())
    loss.backward()
    grads = {k: None if p.grad is None else p.grad.clone()
             for k, p in model.named_parameters()}
    return ({k: getattr(out, k).detach() for k in
             ("st_prime", "st_final", "s0_final", "flow_preds")}, grads,
            model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_is_bitwise_no_remat(dtype):
    cfg = config_rb(1, 1, nf=16, seed=2, compute_dtype=dtype)
    rng = np.random.RandomState(3)
    frames = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 3, 32, 32)).astype(
        np.float32))
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32))
    t = torch.tensor([[0.25], [0.625]])
    weights = make_model(cfg, device="cpu").state_dict()
    out0, grads0, model0 = _step(cfg, weights, frames, t, gt)
    assert sum(g is not None for g in grads0.values()) > 0
    assert model0.calls == {"backbone": 1, "rdb": 1}
    for gran in ("backbone", "rdb"):
        rcfg = dataclasses.replace(cfg, remat_backbone=True,
                                   remat_granularity=gran)
        out, grads, model = _step(rcfg, weights, frames, t, gt)
        assert model.remat == gran
        # the checkpointed part started again in the backward pass
        assert model.calls == {"backbone": 2 if gran == "backbone" else 1,
                               "rdb": 2}, model.calls
        assert list(model.state_dict()) == list(model0.state_dict())
        assert model.unread_parameters(1) == model0.unread_parameters(1)
        for k in out0:
            assert torch.equal(out[k], out0[k]), (gran, k)
        assert grads.keys() == grads0.keys()
        for k, g in grads0.items():
            assert (g is None) == (grads[k] is None), (gran, k)
            if g is not None:
                assert torch.equal(grads[k], g), (gran, k)


def test_remat_serving_is_plain():
    """Without autograd recording (serving) the model runs no
    checkpoint, and gives the same bits."""
    cfg = config_rb(1, 1, nf=16, seed=5)
    frames = torch.from_numpy(np.random.RandomState(1).uniform(
        -1, 1, (1, 4, 3, 32, 32)).astype(np.float32))
    t = torch.tensor([[0.5]])
    plain = make_model(cfg, device="cpu")
    remat = make_model(dataclasses.replace(cfg, remat_backbone=True),
                       device="cpu")
    remat.load_state_dict(plain.state_dict(), strict=True)
    with torch.no_grad():
        a, b = plain(frames, t, 1), remat(frames, t, 1)
    assert torch.equal(a.st_final, b.st_final)


def test_unknown_granularity_is_refused():
    with pytest.raises(ValueError, match="remat_granularity"):
        make_model(config_rb(1, 1, nf=16, remat_backbone=True,
                             remat_granularity="layer"), device="cpu")
    with pytest.raises(ValueError, match="remat_granularity"):
        make_model(config_rb(1, 1, nf=16, remat_granularity="Backbone"),
                   device="cpu")
    with pytest.raises(ValueError, match="remat granularity"):
        DeMFINet(nf=16, remat="all")


def test_remat_equals_jax_remat():
    """The port's remat model (both granularities) against demfi_tpu's
    remat model, config_rb(1,1), 32x32: st_final and the gradient of its
    sum, as tests/test_train.py::test_remat_matches_no_remat takes
    them."""
    rng = np.random.RandomState(0)
    frames = rng.uniform(-1, 1, (1, 4, 32, 32, 3)).astype(np.float32)
    nudged = frames + (rng.randn(*frames.shape) * 1e-6).astype(np.float32)
    t = np.full((1, 1), 0.5, np.float32)
    jcfg = dataclasses.replace(jax_config_rb(1, 1), remat_backbone=True)
    jmodel = jax_make_model(jcfg)
    params = jax_param_tree(jmodel, jnp.asarray(frames), jnp.asarray(t), 9)

    @jax.jit
    def value_and_grad(p, f):
        def loss(p):
            out = jmodel.apply(p, f, jnp.asarray(t), num_update=1)
            return jnp.sum(out.st_final), out.st_final
        return jax.value_and_grad(loss, has_aux=True)(p)
    (_, jst), jgrads = value_and_grad(params, jnp.asarray(frames))
    _, jmoved = value_and_grad(params, jnp.asarray(nudged))
    want = flax_params_to_state_dict(jgrads)
    moved = flax_params_to_state_dict(jmoved)
    weights = flax_params_to_state_dict(params)

    x = torch.from_numpy(frames).permute(0, 1, 4, 2, 3).contiguous()
    for gran in ("backbone", "rdb"):
        model = make_model(config_rb(1, 1, remat_backbone=True,
                                     remat_granularity=gran), device="cpu")
        model.load_state_dict(weights, strict=True)
        out = model(x, torch.from_numpy(t), num_update=1)
        out.st_final.sum().backward()
        np.testing.assert_allclose(
            out.st_final.detach().permute(0, 1, 3, 4, 2).numpy(),
            np.asarray(jst), atol=2e-4, rtol=2e-4)
        for k, p in model.named_parameters():
            got = (np.zeros_like(want[k].numpy()) if p.grad is None
                   else p.grad.numpy())
            err = _rel_frobenius(got, want[k].numpy())
            bound = max(1e-3, 2 * _rel_frobenius(moved[k].numpy(),
                                                 want[k].numpy()))
            assert err <= bound, (gran, k, err, bound)
