"""The port's training path against the JAX package's, on the CPU.

The loss, the lr schedules and the optimizer against ``demfi_tpu.train``;
one train step of DeMFI-Net_rb(2,2) at 32x32, B = 2, on weights carried
across from a JAX parameter tree (values from a numpy seed); the train
sampler and loader against ``demfi_tpu.data`` (numpy route) on a fixture
tree; the experiment manager's checkpoints; the debug sheet; and the
``--phase train`` CLI end to end at a tiny size.

Tolerances: the losses and the optimizer 1e-6 relative (float32, the same
formulas). The train step: loss rtol 1e-4; each parameter's gradient a
relative Frobenius error of at most the larger of 1e-3 and twice the
change of the JAX package's own gradient of that tensor when its inputs
move by 1e-6. The second term binds only upstream of the warps (the RDN
backbone, FAC-FB): at these random weights the gradient there is that
ill-conditioned in float32 (a flow within rounding of an integer moves a
floor, a tap near the image's edge flips the 0.999 mask), and the JAX
gradient moves by 2-3e-3 under the 1e-6 perturbation (the port's under
another thread count alike), so no two float32 implementations that sum
in different orders agree to 1e-3 there. Downstream (decoders, booster,
refinement) 1e-3 binds. After two steps, loss rtol 1e-3. The loader's
batches: bitwise.
"""
import os
import random
import sys
import threading
import types

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from demfi_tpu.config import DeMFIConfig as JaxConfig
from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.data import AdobeTrainDataset as JaxTrainDataset
from demfi_tpu.data import TrainLoader as JaxTrainLoader
from demfi_tpu.models import make_model as jax_make_model
from demfi_tpu.train import loop as jloop
from demfi_tpu.utils.viz import train_debug_sheet as jax_debug_sheet
from demfi_torch.checkpoint import (AsyncExperimentManager, ExperimentManager,
                                    flax_params_to_state_dict)
from demfi_torch.config import DeMFIConfig, config_rb
from demfi_torch.data import AdobeTrainDataset, TrainLoader, device_prefetch
from demfi_torch.main import cli
from demfi_torch.models import make_model
from demfi_torch.models.demfi import DeMFIOutputs
from demfi_torch.train import (create_train_state, demfi_loss, make_optimizer,
                               make_train_step, set_epoch)
from demfi_torch.utils.viz import train_debug_sheet

from test_torch_model import jax_param_tree


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The layout of tests/test_data.py: blur frames named by absolute
    sharp index with stride 8 from 00017.png, sharp frames 0..79, 64x96;
    2 train and 2 test scenes."""
    root = tmp_path_factory.mktemp("adobe")
    rng = np.random.RandomState(0)
    for split in ("train", "test"):
        for s in range(2):
            sharp = root / split / f"scene{s}"
            blur = root / f"{split}_blur" / f"scene{s}"
            sharp.mkdir(parents=True)
            blur.mkdir(parents=True)
            for i in range(80):
                cv2.imwrite(str(sharp / f"{i:05d}.png"),
                            rng.randint(0, 255, (64, 96, 3), np.uint8))
            for k in range(8):
                cv2.imwrite(str(blur / f"{17 + 8 * k:05d}.png"),
                            rng.randint(0, 255, (64, 96, 3), np.uint8))
    return root


# ------------------------------------------------------------ loss, lr, opt
def _outputs(rng, n, b=2, h=8, w=12):
    """A port DeMFIOutputs (NCHW tensors) and the same values NHWC for
    JAX, for the six fields the loss reads."""
    vals = {k: rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
            for k in ("s0_prime", "s1_prime", "st_prime")}
    vals.update({k: rng.uniform(-1, 1, (n, b, h, w, 3)).astype(np.float32)
                 for k in ("s0_final", "s1_final", "st_final")})
    port = types.SimpleNamespace(**{k: torch.from_numpy(
        np.moveaxis(v, -1, -3).copy()) for k, v in vals.items()})
    return port, types.SimpleNamespace(**{k: jnp.asarray(v)
                                          for k, v in vals.items()})


@pytest.mark.parametrize("loss_type", ["L1", "MSE", "L1_Charbonnier_loss"])
def test_loss_equals_jax(loss_type):
    rng = np.random.RandomState(1)
    port, jout = _outputs(rng, 3)
    gts = [rng.uniform(-1, 1, (2, 8, 12, 3)).astype(np.float32)
           for _ in range(3)]
    kw = dict(loss_type=loss_type, rec_D1_lambda=0.7, rec_D2_lambda=1.3)
    total, parts = demfi_loss(DeMFIConfig(**kw), port, *[
        torch.from_numpy(np.moveaxis(g, -1, -3).copy()) for g in gts])
    jtotal, jparts = jloop.demfi_loss(JaxConfig(**kw), jout,
                                      *[jnp.asarray(g) for g in gts])
    for k in ("total_loss", "rec_D1", "rec_D2"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-6, err_msg=k)
    assert float(total) == float(parts["total_loss"])


@pytest.mark.parametrize("lr_type", ["stair_decay", "linear_decay",
                                     "no_decay"])
def test_lr_at_epoch_equals_jax(lr_type):
    kw = dict(lr_type=lr_type, epochs=100, lr_milestones=(10, 40, 41),
              lr_dec_start=30, lr_dec_fac=0.3, init_lr=2e-4)
    port, ref = DeMFIConfig(**kw), JaxConfig(**kw)
    for e in range(0, 101):
        assert port.lr_at_epoch(e) == ref.lr_at_epoch(e), e
    model = make_model(config_rb(1, 1, nf=8), device="cpu")
    state = create_train_state(DeMFIConfig(**kw), model)
    assert set_epoch(port, state, 41) == port.lr_at_epoch(41)
    assert all(g["lr"] == port.lr_at_epoch(41)
               for g in state.optimizer.param_groups)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_optimizer_equals_optax(wd):
    """make_optimizer against the JAX package's adam_l2 (L2-coupled
    decay) over 5 steps, with the lr of a later epoch set in between."""
    w0 = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    cfg_kw = dict(init_lr=1e-2, weight_decay=wd, lr_milestones=(3,))
    net = torch.nn.Linear(4, 3, bias=False)
    net.weight.data = torch.tensor(w0)
    state = types.SimpleNamespace(optimizer=make_optimizer(
        DeMFIConfig(**cfg_kw), net), epoch=0)
    tx = jloop.make_optimizer(JaxConfig(**cfg_kw))
    params = {"w": jnp.asarray(w0)}
    opt_state = tx.init(params)
    rng = np.random.RandomState(11)
    for k in range(5):
        set_epoch(DeMFIConfig(**cfg_kw), state, k)
        opt_state.hyperparams["learning_rate"] = JaxConfig(
            **cfg_kw).lr_at_epoch(k)
        g = rng.randn(3, 4).astype(np.float32)
        net.weight.grad = torch.tensor(g)
        state.optimizer.step()
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state,
                                       params)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(net.weight.detach().numpy(),
                               np.asarray(params["w"]), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- train step
def _rel_frobenius(got: np.ndarray, want: np.ndarray) -> float:
    scale = float(np.linalg.norm(want.astype(np.float64)))
    err = float(np.linalg.norm(got.astype(np.float64) - want))
    return err / scale if scale > 0 else err


def test_train_step_equals_jax():
    """One config_rb(2,2) step at 32x32, B = 2, on converted weights
    against JAX: the loss and every parameter's gradient (against
    jax.value_and_grad of the same loss), then the loss after each of two
    steps (against JAX's make_train_step)."""
    h = w = 32
    rng = np.random.RandomState(21)
    frames = rng.uniform(-1, 1, (2, 9, h, w, 3)).astype(np.float32)
    nudged = frames + (rng.randn(*frames.shape) * 1e-6).astype(np.float32)
    t = np.array([[0.25], [0.625]], np.float32)
    jcfg = jax_config_rb(2, 2)
    jmodel = jax_make_model(jcfg)
    params = jax_param_tree(jmodel, jnp.asarray(frames[:, :4]),
                            jnp.asarray(t), 21)

    def jloss(p, f):
        out = jmodel.apply(p, f[:, :4], jnp.asarray(t),
                           num_update=jcfg.N_trn)
        return jloop.demfi_loss(jcfg, out, f[:, 5], f[:, 6], f[:, 4])[0]
    value_and_grad = jax.jit(jax.value_and_grad(jloss))
    jl, jgrads = value_and_grad(params, frames)
    _, jnudged = value_and_grad(params, nudged)
    weights = {k: v.clone() for k, v in flax_params_to_state_dict(
        params).items()}
    tx = jloop.make_optimizer(jcfg)
    jstep = jloop.make_train_step(jcfg, jmodel, tx)
    jstate = jloop.TrainState(params=params, opt_state=tx.init(params),
                              epoch=jnp.zeros((), jnp.int32))
    jstate, jm1 = jstep(jstate, jnp.asarray(frames), jnp.asarray(t))
    jstate, jm2 = jstep(jstate, jnp.asarray(frames), jnp.asarray(t))

    cfg = config_rb(2, 2)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(weights, strict=True)
    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    grads = {}

    def snapshot(phase):
        if phase == "backward":
            grads.update({k: None if p.grad is None else p.grad.clone()
                          for k, p in model.named_parameters()})
    m1 = step(state, frames, t, on_phase=snapshot)
    m2 = step(state, frames, t)
    np.testing.assert_allclose(float(m1["total_loss"]), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(m1["total_loss"]),
                               float(jm1["total_loss"]), rtol=1e-4)
    assert m1["lr"] == cfg.init_lr
    np.testing.assert_allclose(float(jm1["lr"]), cfg.init_lr, rtol=1e-7)
    want = flax_params_to_state_dict(jgrads)
    moved = flax_params_to_state_dict(jnudged)
    assert set(want) == set(grads)
    for k, g in grads.items():
        # at rr = 0 FGAC reads no source key: no gradient here, zeros there
        got = np.zeros_like(want[k].numpy()) if g is None else g.numpy()
        err = _rel_frobenius(got, want[k].numpy())
        bound = max(1e-3, 2 * _rel_frobenius(moved[k].numpy(),
                                             want[k].numpy()))
        assert err <= bound, (k, err, bound)
    assert sum(float(np.abs(v.numpy()).sum()) for v in want.values()) > 0
    np.testing.assert_allclose(float(m2["total_loss"]),
                               float(jm2["total_loss"]), rtol=1e-3)


@pytest.fixture(scope="module")
def bounded_step():
    """The card's gradient check (tests/test_torch_cuda.py, chip_smoke.py
    phase 7) at DeMFI-Net_rb(2,2), 32x48, flows of about 6 px, run on the
    CPU: grads(frames) gives every parameter's gradient of one loss, and
    each tensor's bound is the larger of 1e-3 and twice the larger of
    its change under two 1e-6 nudges of the batch (the rule of
    ``grad_check.gradient_bounds`` where the card's flows lie no further
    from the CPU's than such a nudge moves them)."""
    from demfi_torch.utils.profiling import calibrate_flow_head

    cfg = config_rb(2, 2, seed=3)
    rng = np.random.RandomState(6)
    frames = torch.from_numpy(rng.uniform(-1, 1, (2, 4, 3, 32, 48)).astype(
        np.float32))
    nudges = [torch.from_numpy((rng.randn(2, 4, 3, 32, 48) * 1e-6).astype(
        np.float32)) for _ in range(2)]
    gt = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 48)).astype(
        np.float32))
    t = torch.tensor([[0.25], [0.625]])
    model = make_model(cfg, device="cpu")
    calibrate_flow_head(model, frames, 6.0)
    weights = model.state_dict()

    def grads(x):
        m = make_model(cfg, device="cpu")
        m.load_state_dict(weights)
        out = m(x, t, num_update=2)
        ((out.st_prime - gt).abs().mean()
         + (out.st_final - gt).abs().mean()).backward()
        return {k: p.grad for k, p in m.named_parameters()
                if p.grad is not None}
    want = grads(frames)
    moved = [grads(frames + n) for n in nudges]
    bound = {k: max(1e-3, 2 * max(_rel_frobenius(m[k].numpy(), w.numpy())
                                  for m in moved))
             for k, w in want.items()}
    return types.SimpleNamespace(grads=lambda: grads(frames), want=want,
                                 bound=bound)


@pytest.mark.parametrize("kind", ["every_warp", "cfr_splats", "booster_pairs",
                                  "feature_pairs", "fgac_samples"])
def test_gradient_bound_catches_a_warp_without_gradient(monkeypatch,
                                                        bounded_step, kind):
    """The gradient check catches the fault it exists for, warps whose
    outputs carry no gradient (the kernels' outputs before their autograd
    Functions), emulated by detaching the inputs of one group of warps:
    every warp, the CFR splats, the C=3 booster pairs, the C=64 feature
    pairs or FGAC's absolute samples. Some tensor upstream moves beyond
    its bound; with every warp cut, most tensors do, the flow head by
    more than 5x."""
    from demfi_torch.ops import kernels

    every = kind == "every_warp"
    gather, pair, splat = (kernels.bilinear_gather,
                           kernels.bilinear_gather_pair, kernels.fwarp_splat)

    def cut_gather(i, c, relative, want_ones=True, row0=None):
        if every or (kind == "fgac_samples" and not relative):
            i, c = i.detach(), c.detach()
        return gather(i, c, relative, want_ones, row0=row0)

    def cut_pair(a, b, ca, cb, relative, want_ones=False, row0=None):
        group = "booster_pairs" if a.shape[1] == 3 else "feature_pairs"
        if every or kind == group:
            a, b, ca, cb = a.detach(), b.detach(), ca.detach(), cb.detach()
        return pair(a, b, ca, cb, relative, want_ones, row0=row0)

    def cut_splat(i, f, rows=None):
        if every or kind == "cfr_splats":
            i, f = i.detach(), f.detach()
        return splat(i, f, rows=rows)
    monkeypatch.setattr(kernels, "bilinear_gather", cut_gather)
    monkeypatch.setattr(kernels, "bilinear_gather_pair", cut_pair)
    monkeypatch.setattr(kernels, "fwarp_splat", cut_splat)
    faulty = bounded_step.grads()
    want, bound = bounded_step.want, bounded_step.bound

    def rel(k):
        got = faulty[k].numpy() if k in faulty else np.zeros_like(
            want[k].numpy())
        return _rel_frobenius(got, want[k].numpy())
    beyond = [k for k in want if rel(k) > bound[k]]
    assert beyond
    if every:
        head = "FF_RDB_Module.UPNet.2.weight"
        assert rel(head) > 5 * bound[head]
        assert len(beyond) > len(want) // 2


# ------------------------------------------------------------------ data
def test_train_samples_equal_jax(tree):
    port = AdobeTrainDataset(str(tree), t_sampling_num=8, patch_size=32)
    ref = JaxTrainDataset(str(tree), t_sampling_num=8, patch_size=32,
                          use_native=False)
    assert len(port) == len(ref) == 2
    for idx in range(2):
        for seed in range(6):
            a = port.sample(idx, random.Random(seed))
            b = ref.sample(idx, random.Random(seed))
            np.testing.assert_array_equal(a.frames, b.frames)
            np.testing.assert_array_equal(a.t_value, b.t_value)
    whole = AdobeTrainDataset(str(tree), need_patch=False).sample(
        1, random.Random(3))
    assert whole.frames.shape == (9, 64, 64, 3)


@pytest.mark.parametrize("batch_size,drop_last", [(2, True), (1, False)])
def test_train_loader_equals_jax(tree, batch_size, drop_last):
    """Two epochs, batch for batch, bit for bit; then the batches through
    device_prefetch (on the CPU: wrapped, not copied)."""
    ds = AdobeTrainDataset(str(tree), t_sampling_num=8, patch_size=32)
    jds = JaxTrainDataset(str(tree), t_sampling_num=8, patch_size=32,
                          use_native=False)
    port = TrainLoader(ds, batch_size, num_threads=3, seed=5,
                       drop_last=drop_last)
    ref = JaxTrainLoader(jds, batch_size, num_threads=3, seed=5,
                         drop_last=drop_last)
    assert len(port) == len(ref)
    for epoch in range(2):
        got = list(port.epoch(epoch))
        want = list(ref.epoch(epoch))
        assert len(got) == len(want) == len(port)
        for (f, t), (jf, jt) in zip(got, want):
            assert f.dtype == np.float32 and f.shape[1:] == (9, 32, 32, 3)
            np.testing.assert_array_equal(f, jf)
            np.testing.assert_array_equal(t, jt)
        moved = list(device_prefetch(iter(got), "cpu", depth=1))
        for (f, t), (mf, mt) in zip(got, moved):
            assert torch.equal(mf, torch.from_numpy(f))
            assert torch.equal(mt, torch.from_numpy(t))
    with pytest.raises(ValueError, match="divisible"):
        TrainLoader(ds, 3, process_count=2)


def test_train_loader_under_thread_switches(tree):
    """More decode threads than samples and cores, with the interpreter
    switching threads every microsecond: the same batches as one thread;
    a generator closed after its first batch stops its threads."""
    ds = AdobeTrainDataset(str(tree), t_sampling_num=8, patch_size=16)
    want = list(TrainLoader(ds, 1, num_threads=1, seed=9,
                            drop_last=False).epoch(3))
    before = sys.getswitchinterval()
    threads = threading.active_count()
    try:
        sys.setswitchinterval(1e-6)
        loader = TrainLoader(ds, 1, num_threads=16, seed=9, drop_last=False,
                             prefetch=1)
        for _ in range(3):
            got = list(loader.epoch(3))
            assert len(got) == len(want)
            for (f, t), (wf, wt) in zip(got, want):
                np.testing.assert_array_equal(f, wf)
                np.testing.assert_array_equal(t, wt)
        gen = loader.epoch(4)
        next(gen)
        gen.close()
    finally:
        sys.setswitchinterval(before)
    assert threading.active_count() == threads


# ----------------------------------------------------------- checkpoints
@pytest.mark.parametrize("manager", [ExperimentManager,
                                     AsyncExperimentManager])
def test_experiment_manager_round_trip(tmp_path, manager):
    """Model, optimizer and metadata come back as saved (a later step does
    not reach a save already made); latest is copied to best_PSNR on
    improvement only; load_epoch(N) reads epc{N-1}; the args snapshot and
    the info log are written."""
    cfg = DeMFIConfig(checkpoint_dir=str(tmp_path / "ck"),
                      text_dir=str(tmp_path / "txt"),
                      log_dir=str(tmp_path / "log"),
                      test_img_dir=str(tmp_path / "img"), exp_num=4)
    model = make_model(config_rb(1, 1, nf=8), device="cpu")
    state = create_train_state(cfg, model)
    x = torch.rand(1, 4, 3, 16, 16)
    model(x, torch.tensor([[0.5]]), num_update=1).st_final.mean().backward()
    state.optimizer.step()
    em = manager(cfg)
    em.write_info("Epoch\tPSNR\n")
    saved_model = {k: v.clone() for k, v in model.state_dict().items()}
    em.save_latest(model.state_dict(), state.optimizer.state_dict(),
                   {"last_epoch": 3, "best_PSNR": 30.5}, best_psnr_flag=True)
    em.save_epoch(3, model.state_dict(), state.optimizer.state_dict(),
                  {"last_epoch": 3})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    em.save_latest(model.state_dict(), None, {"last_epoch": 4},
                   best_psnr_flag=False)
    sd, opt, meta = em.load_epoch(4)
    assert meta == {"last_epoch": 3}
    assert all(torch.equal(sd[k], v) for k, v in saved_model.items())
    assert opt["state"][0]["step"] == 1
    sd, opt, meta = em.load_best_psnr()
    assert meta["best_PSNR"] == 30.5 and opt is not None
    assert all(torch.equal(sd[k], v) for k, v in saved_model.items())
    sd, opt, meta = em.load_latest()
    assert meta == {"last_epoch": 4} and opt is None
    fresh = make_model(config_rb(1, 1, nf=8), device="cpu")
    fresh.load_state_dict(sd, strict=True)
    em.wait()
    assert em.has("latest") and em.has("epc3") and not em.has("epc4")
    text = (tmp_path / "txt" / f"{cfg.model_dir}.txt").read_text()
    assert "exp_num : 4" in text and "Epoch\tPSNR" in text
    if manager is AsyncExperimentManager:
        em.close()


# ----------------------------------------------------------------- viz
def test_train_debug_sheet_equals_jax():
    """The same values (NCHW tensors for the port, NHWC arrays for JAX):
    the same sheet, bit for bit."""
    rng = np.random.RandomState(4)
    b, h, w, n = 2, 8, 10, 2

    def arr(*shape):
        return rng.uniform(-1, 1, shape).astype(np.float32)
    nhwc = dict(s0_prime=arr(b, h, w, 3), s1_prime=arr(b, h, w, 3),
                st_prime=arr(b, h, w, 3), s0_final=arr(n, b, h, w, 3),
                s1_final=arr(n, b, h, w, 3), st_final=arr(n, b, h, w, 3),
                flow_preds=arr(n + 1, b, h, w, 4) * 5,
                occ0_preds=(arr(n + 1, b, h, w, 1) + 1) / 2,
                ovlp_b0b1=arr(b, h, w, 3),
                diff_maps=(arr(b, h, w, 1), arr(b, h, w, 1)),
                blend_weights=(arr(b, h, w, 1), arr(b, h, w, 1)))

    def nchw(v):
        if isinstance(v, tuple):
            return tuple(nchw(x) for x in v)
        return torch.from_numpy(np.moveaxis(v, -1, -3).copy())
    port = DeMFIOutputs(**{k: nchw(v) for k, v in nhwc.items()})
    frames = arr(b, 9, h, w, 3)
    t = np.array([[0.5], [0.25]], np.float32)
    got = train_debug_sheet(frames, t, port)
    want = jax_debug_sheet(frames, t, types.SimpleNamespace(**nhwc))
    assert got.shape == (b * h, 20 * w, 3)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ CLI
def test_cli_train_resume_and_test(tree, tmp_path, capsys):
    """--phase train on the CPU at a tiny size writes latest, best_PSNR
    and the epoch checkpoint, the info log and the debug sheets;
    --auto_resume continues at the next epoch with the optimizer's state;
    --phase test then loads the result strictly."""
    dirs = ["--train_data_path", str(tree), "--test_data_path", str(tree),
            "--checkpoint_dir", str(tmp_path / "ck"),
            "--text_dir", str(tmp_path / "txt"),
            "--log_dir", str(tmp_path / "log"),
            "--test_img_dir", str(tmp_path / "img")]
    small = ["--device", "cpu", "--nf", "16", "--N_trn", "1", "--N_tst", "1",
             "--patch_size", "32", "--batch_size", "1", "--num_thrds", "2",
             "--freq_display", "2", "--epoch_freq_save", "1",
             "--multiple_MFI", "2"]
    first = cli(["--phase", "train", "--epochs", "1", *small, *dirs])
    assert first["start_epoch"] == 0 and len(first["epoch_losses"]) == 1
    assert np.isfinite(first["epoch_losses"]).all()
    assert len(first["step_seconds"]) == 2
    assert np.isfinite(first["final"][:5]).all()
    ck = tmp_path / "ck" / "DeMFInet_exp1"
    assert sorted(os.listdir(ck)) == ["DeMFInet_exp1_best_PSNR.pt",
                                      "DeMFInet_exp1_epc0.pt",
                                      "DeMFInet_exp1_latest.pt"]
    sheets = sorted(os.listdir(tmp_path / "img" / "DeMFInet_exp1"
                               / "while_training"))
    assert "trainIdx_00000_Bx20.png" in sheets
    assert "trainIdx_00001_Bx20.png" in sheets
    sheet = cv2.imread(str(tmp_path / "img" / "DeMFInet_exp1" / "while_training"
                           / "trainIdx_00000_Bx20.png"))
    assert sheet.shape == (32, 20 * 32, 3)
    log = (tmp_path / "txt" / "DeMFInet_exp1.txt").read_text()
    assert "N_trn : 1" in log and log.rstrip().split("\n")[-1].startswith("0\t")
    assert "[*] Training starts" in capsys.readouterr().out

    second = cli(["--phase", "train", "--epochs", "2", "--auto_resume",
                  *small, *dirs])
    assert second["start_epoch"] == 1 and len(second["epoch_losses"]) == 1
    out = capsys.readouterr().out
    assert "resumed at epoch 1" in out and "Start epoch 1" in out
    assert "Start epoch 0" not in out
    state = torch.load(ck / "DeMFInet_exp1_latest.pt", weights_only=False)
    assert state["last_epoch"] == 1
    assert state["state_dict_Optimizer"]["state"][0]["step"] == 4
    assert (ck / "DeMFInet_exp1_epc1.pt").exists()

    result = cli(["--phase", "test", "--multiple_MFI", "2", "--device", "cpu",
                  "--nf", "16", "--N_trn", "1", "--N_tst", "1", *dirs])
    assert np.isfinite(result[:5]).all()
    assert "epoch: 1" in capsys.readouterr().out
