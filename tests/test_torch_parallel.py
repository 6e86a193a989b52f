"""Data parallelism of the port on the CPU: the loader's per-process
slices against ``demfi_tpu``'s, and two gloo processes against the port's
single process.

One spawn of two processes (the ``two_processes`` fixture) serves three
tests: (b) one DistributedDataParallel train step on a global batch of 4
against the one-process step on the same 4 samples: the loss, every
gradient and the parameters (only the order of the sums differs: DDP
averages two local means; tolerances at LOSS_RTOL); (c)
a scene-sharded ``evaluate`` against the one-process meters, headline
and per slot, within 1e-9 (float64 sums in another order); (d) ``cli
--phase train --auto_resume`` where only process 0 has a checkpoint:
process 1 resumes from process 0's state.
"""
import hashlib
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from demfi_tpu.data import AdobeTrainDataset as JaxTrainDataset
from demfi_tpu.data import TrainLoader as JaxTrainLoader
from demfi_torch.checkpoint import ExperimentManager
from demfi_torch.config import config_rb
from demfi_torch.data import AdobeTrainDataset, TrainLoader
from demfi_torch.infer import InferenceEngine
from demfi_torch.infer import driver
from demfi_torch.main import cli, parse_args
from demfi_torch.models import make_model
from demfi_torch.train import create_train_state, make_train_step

ROOT = Path(__file__).resolve().parent.parent
H, W = 48, 64
TRAIN_SCENES = 4
# a tiny DeMFI-Net_rb(1, 1): every path of the model, seconds a step
SMALL = dict(nf=16, num_ResB_FACFB=1, num_ResB_Dec=1, batch_size=4,
             patch_size=32, seed=3)
SMALL_ARGS = ["--nf", "16", "--num_ResB_FACFB", "1", "--num_ResB_Dec", "1",
              "--N_trn", "1", "--N_tst", "1", "--patch_size", "32",
              "--seed", "3", "--device", "cpu"]
SPAWN_TIMEOUT = 300
# two processes against one: the loss and the parameters to 1e-6 of the
# largest value; each gradient to 1e-5 of its largest value, since not
# only the all-reduce sums in another order: every convolution's backward
# sums over two samples, not four, and the rounding gap grows through the
# depth and where a sum cancels (the decoder's last bias sums the signs
# of 4,096 pixels)
LOSS_RTOL = PARAM_RTOL = 1e-6
GRAD_RTOL = 1e-5
# Adam's first step moves a component by lr * g / (|g| + eps): where |g|
# is within a few eps of 0 it turns the gradients' rounding gap into a
# step of any size up to 2 lr, so the one-process comparison of the
# parameters leaves out the components whose gradient is below this many
# eps in either run (0.26 % of them here; at most ADAM_FLAT_SHARE)
ADAM_FLAT_EPS = 10
ADAM_FLAT_SHARE = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once, and
    the two processes sum as the test process does."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """4 train scenes (41 sharp frames, 4 blur frames at stride 8 from
    00017) and 2 test scenes of 2 windows each, 48x64."""
    root = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(0)
    for split, scenes, n_sharp, n_blur in (("train", TRAIN_SCENES, 41, 4),
                                           ("test", 2, 60, 5)):
        for s in range(scenes):
            sharp = root / split / f"scene{s}"
            blur = root / f"{split}_blur" / f"scene{s}"
            sharp.mkdir(parents=True)
            blur.mkdir(parents=True)
            for i in range(n_sharp):
                cv2.imwrite(str(sharp / f"{i:05d}.png"),
                            rng.randint(0, 255, (H, W, 3), np.uint8))
            for k in range(n_blur):
                cv2.imwrite(str(blur / f"{17 + 8 * k:05d}.png"),
                            rng.randint(0, 255, (H, W, 3), np.uint8))
    return root


def dirs(root: Path, sub: str) -> dict:
    return dict(train_data_path=str(root), test_data_path=str(root),
                checkpoint_dir=str(root / sub / "ck"),
                text_dir=str(root / sub / "txt"), log_dir=str(root / sub / "log"),
                test_img_dir=str(root / sub / "img"))


def dir_args(d: dict) -> list:
    return [a for k, v in d.items() for a in (f"--{k}", v)]


def digest(state: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------- (a) loader
@pytest.mark.parametrize("batch_size", [2, 4])
def test_loader_slices_make_up_the_stream_and_equal_jax(tree, batch_size):
    """Each process's slice is bitwise demfi_tpu's slice for that process;
    the two slices, put together batch by batch, are the one-process
    stream."""
    ds = AdobeTrainDataset(str(tree), t_sampling_num=8, patch_size=32)
    jds = JaxTrainDataset(str(tree), t_sampling_num=8, patch_size=32,
                          use_native=False)
    whole = list(TrainLoader(ds, batch_size, num_threads=2, seed=5).epoch(1))
    parts = []
    for p in range(2):
        got = list(TrainLoader(ds, batch_size, num_threads=2, seed=5,
                               process_id=p, process_count=2).epoch(1))
        want = list(JaxTrainLoader(jds, batch_size, num_threads=2, seed=5,
                                   process_id=p, process_count=2).epoch(1))
        assert len(got) == len(want) == TRAIN_SCENES // batch_size
        for (f, t), (jf, jt) in zip(got, want):
            assert f.shape[0] == batch_size // 2
            np.testing.assert_array_equal(f, jf)
            np.testing.assert_array_equal(t, jt)
        parts.append(got)
    for (f, t), (f0, t0), (f1, t1) in zip(whole, *parts):
        np.testing.assert_array_equal(f, np.concatenate([f0, f1]))
        np.testing.assert_array_equal(t, np.concatenate([t0, t1]))


# ---------------------------------------------------------- (e) refusals
def test_flag_refusals(tree, capsys):
    """--phase train --mesh_spatial 2 (training's spatial axis,
    tests/test_torch_spatial_train.py) is parsed, and refused in one
    process when the run starts, as --mesh_data 2 is (the data axis spans
    every process); a global batch the processes cannot share, or a last
    partial batch, when the loader is built; incomplete coordinator flags
    when the process group is joined."""
    base = ["--phase", "train", *SMALL_ARGS, *dir_args(dirs(tree, "refuse"))]
    assert parse_args(base + ["--mesh_spatial", "2"]).mesh_spatial == 2
    with pytest.raises(ValueError, match="--mesh_spatial 2 splits rows "
                                         "across 2 processes of one data "
                                         "group, but the run has 1 process"):
        cli(base + ["--mesh_spatial", "2"])
    with pytest.raises(ValueError, match="--mesh_data 2 does not match the "
                                         "process group: 1 processes"):
        cli(base + ["--mesh_data", "2"])
    ds = AdobeTrainDataset(str(tree), t_sampling_num=8, patch_size=32)
    with pytest.raises(ValueError, match="divisible"):
        TrainLoader(ds, 3, process_id=0, process_count=2)
    with pytest.raises(ValueError, match="drop_last"):
        TrainLoader(ds, 4, drop_last=False, process_id=0, process_count=2)
    with pytest.raises(ValueError, match="coordinator_address"):
        cli(base + ["--num_processes", "2", "--process_id", "0"])
    with pytest.raises(RuntimeError, match="process group"):
        cfg = config_rb(1, 1, device="cpu", **{**SMALL, **dirs(tree, "ev")})
        driver.evaluate(cfg, InferenceEngine(make_model(cfg, device="cpu"), 1,
                                             device="cpu"),
                        multiple=2, shard=(0, 2))


@pytest.mark.parametrize("n_trn,rr,shared", [(1, 0, True), (1, 1, True),
                                             (0, 0, True), (1, 0, False)])
def test_unread_parameters_are_those_without_gradient(n_trn, rr, shared):
    """What data_parallel leaves out of DDP's reduction: exactly the
    parameters a plain train step leaves without a gradient (FGAC's
    source-key convolutions at rr = 0, one shared or two; the second
    stage when no boosting iteration runs)."""
    cfg = config_rb(n_trn, 1, nf=8, num_ResB_FACFB=1, num_ResB_Dec=1,
                    fgac_rr=rr, shared_FGAC_flag=shared, device="cpu")
    model = make_model(cfg, device="cpu")
    rng = np.random.RandomState(n_trn + 2 * rr)
    make_train_step(cfg)(create_train_state(cfg, model),
                         rng.uniform(-1, 1, (1, 9, 32, 32, 3)).astype(
                             np.float32), np.array([[0.5]], np.float32))
    no_grad = sorted(k for k, p in model.named_parameters() if p.grad is None)
    assert sorted(model.unread_parameters(n_trn)) == no_grad
    assert bool(no_grad) == (rr == 0 or n_trn == 0)


# ------------------------------------------- (b)-(d): two gloo processes
_WORKER = r"""
import json, sys
from pathlib import Path
pid, port_a, port_b, root = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             Path(sys.argv[4]))
spec = json.loads((root / "spec.json").read_text())
import numpy as np
import torch
torch.set_num_threads(1)
import demfi_torch.models as models
from demfi_torch.config import config_rb
from demfi_torch.infer import InferenceEngine, driver
from demfi_torch.main import cli
from demfi_torch.parallel import (data_parallel, destroy_distributed,
                                  init_distributed)
from demfi_torch.train import create_train_state, make_train_step

out = {}
assert init_distributed(f"127.0.0.1:{port_a}", 2, pid, "cpu") == (pid, 2)
# (b) one step on this process's half of the global batch
cfg = config_rb(1, 1, device="cpu", **spec["small"])
batch = np.load(root / "batch.npz")
model = models.make_model(cfg, device="cpu")
state = create_train_state(cfg, data_parallel(model, cfg.N_trn))
half = slice(2 * pid, 2 * pid + 2)
m = make_train_step(cfg)(state, batch["frames"][half], batch["t"][half])
out["loss"] = float(m["total_loss"])
torch.save({"params": model.state_dict(),
            "grads": {k: p.grad for k, p in model.named_parameters()}},
           root / f"step{pid}.pt")
# (c) a scene-sharded evaluation; the per-slot totals are the first two
# slot meters evaluate makes
slots = []
class Slots(driver._SlotMeters):
    def __init__(self, tag):
        super().__init__(tag)
        slots.append(self)
driver._SlotMeters = Slots
ecfg = config_rb(1, 1, device="cpu", **spec["eval"])
engine = InferenceEngine(models.make_model(ecfg, device="cpu"), 1,
                         fetch="images", device="cpu")
res = driver.evaluate(ecfg, engine, multiple=2, save_images=False,
                      shard=(pid, 2))
out["eval"] = list(res[:5])
out["slots"] = [[x.avg for x in t.psnr.values()]
                + [x.avg for x in t.ssim.values()] for t in slots[:2]]
destroy_distributed()
# (d) the CLI's train phase in a group of its own; only process 0 has a
# checkpoint to resume from
made = []
make_model = models.make_model
def recording(*args, **kw):
    made.append(make_model(*args, **kw))
    return made[-1]
models.make_model = recording
res = cli(spec["train_argv"][pid] + ["--coordinator_address",
          f"127.0.0.1:{port_b}", "--num_processes", "2", "--process_id",
          str(pid)])
out["train"] = dict(start_epoch=res["start_epoch"],
                    epoch_losses=res["epoch_losses"], final=list(res["final"][:5]))
import hashlib
h = hashlib.sha256()
for k, v in sorted(made[0].state_dict().items()):
    h.update(k.encode())
    h.update(v.detach().cpu().numpy().tobytes())
out["digest"] = h.hexdigest()
(root / f"out{pid}.json").write_text(json.dumps(out))
print("WORKER_DONE", pid, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _train_argv(tree: Path, sub: str) -> list:
    return ["--phase", "train", "--epochs", "2", "--auto_resume",
            "--batch_size", "4", "--num_thrds", "1", "--freq_display", "1",
            "--epoch_freq_save", "1", "--epoch_freq_display", "1",
            "--multiple_MFI", "2", *SMALL_ARGS, *dir_args(dirs(tree, sub))]


@pytest.fixture(scope="module")
def two_processes(tree, tmp_path_factory):
    """Runs the worker in two gloo processes; returns (their outputs,
    their text, the work directory, the batch)."""
    work = tmp_path_factory.mktemp("dp_work")
    rng = np.random.RandomState(11)
    batch = dict(frames=rng.uniform(-1, 1, (4, 9, 32, 32, 3)).astype(
        np.float32), t=np.array([[0.125], [0.375], [0.625], [0.875]],
                                np.float32))
    np.savez(work / "batch.npz", **batch)
    # process 0's checkpoint of epoch 0: weights and Adam's state after one
    # step; process 1's directories stay empty
    cfg0 = config_rb(1, 1, device="cpu", **{**SMALL, **dirs(tree, "rank0")})
    model = make_model(cfg0, device="cpu")
    state = create_train_state(cfg0, model)
    make_train_step(cfg0)(state, batch["frames"], batch["t"])
    em = ExperimentManager(cfg0)
    em.save_latest(model.state_dict(), state.optimizer.state_dict(),
                   dict(last_epoch=0, best_PSNR=1.5))
    (work / "spec.json").write_text(json.dumps(dict(
        small=SMALL, eval={**SMALL, **dirs(tree, "eval2")},
        train_argv=[_train_argv(tree, "rank0"), _train_argv(tree, "rank1")])))
    worker = work / "worker.py"
    worker.write_text(_WORKER)
    ports = [str(_free_port()), str(_free_port())]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(worker), str(p), *ports,
                               str(work)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for p in range(2)]
    texts = []
    try:
        for proc in procs:
            texts.append(proc.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for proc in procs:
            proc.kill()
            proc.wait(timeout=30)
    for proc, text in zip(procs, texts):
        assert proc.returncode == 0, text[-4000:]
    outs = [json.loads((work / f"out{p}.json").read_text()) for p in range(2)]
    return outs, texts, work, batch


def test_ddp_step_equals_one_process_step(two_processes):
    """Two processes, two samples each: the mean of their losses and every
    gradient (DDP's average) are the one-process step's on all four; each
    process's parameters are Adam's first step on those averaged
    gradients (replayed here on the same initial weights), and the
    one-process step's wherever neither gradient is within ADAM_FLAT_EPS
    eps of 0; the two processes hold the same parameters; FGAC's
    source-key convolution, unread at rr = 0, has no gradient in either
    (data_parallel leaves it out of DDP's reduction)."""
    outs, _, work, batch = two_processes
    cfg = config_rb(1, 1, device="cpu", **SMALL)
    model = make_model(cfg, device="cpu")
    state = create_train_state(cfg, model)
    loss = float(make_train_step(cfg)(state, batch["frames"],
                                      batch["t"])["total_loss"])
    got = np.mean([o["loss"] for o in outs])
    assert abs(got - loss) <= LOSS_RTOL * abs(loss)
    ranks = [torch.load(work / f"step{p}.pt") for p in range(2)]
    assert digest(ranks[0]["params"]) == digest(ranks[1]["params"])
    no_grad = sorted(k for k, p in model.named_parameters() if p.grad is None)
    assert no_grad == ["FAC_FB_Module.shared_FGAC.conv_source_k.bias",
                       "FAC_FB_Module.shared_FGAC.conv_source_k.weight"]
    replay = make_model(cfg, device="cpu")
    replay_state = create_train_state(cfg, replay)
    for k, p in replay.named_parameters():
        g = ranks[0]["grads"][k]
        p.grad = None if g is None else g.clone()
    replay_state.optimizer.step()
    replayed = dict(replay.named_parameters())
    flat_eps = ADAM_FLAT_EPS * state.optimizer.defaults["eps"]
    flat = total = 0
    for k, p in model.named_parameters():
        g = ranks[0]["grads"][k]
        assert (g is None) == (p.grad is None), k
        if g is None:
            continue
        gap = (g - p.grad).abs()
        assert float(gap.max()) <= GRAD_RTOL * float(p.grad.abs().max()), k
        mine = ranks[0]["params"][k]
        tol = PARAM_RTOL * float(p.detach().abs().max())
        assert float((mine - replayed[k].detach()).abs().max()) <= tol, k
        steep = torch.minimum(g.abs(), p.grad.abs()) < flat_eps
        flat += int(steep.sum())
        total += steep.numel()
        moved = (mine - p.detach()).abs()[~steep]
        assert moved.numel() == 0 or float(moved.max()) <= tol, k
    assert flat <= ADAM_FLAT_SHARE * total, (flat, total)


def test_scene_sharded_evaluate_equals_one_process(two_processes, tree):
    """Each process evaluates one of the two scenes; the five headline
    meters and the 2x2x8 per-slot totals, summed across processes, are
    the one-process evaluation's within 1e-9, on both processes."""
    outs, _, _, _ = two_processes
    slots = []

    class Slots(driver._SlotMeters):
        def __init__(self, tag):
            super().__init__(tag)
            slots.append(self)
    cfg = config_rb(1, 1, device="cpu", **{**SMALL, **dirs(tree, "eval1")})
    engine = InferenceEngine(make_model(cfg, device="cpu"), 1, fetch="images",
                             device="cpu")
    orig = driver._SlotMeters
    driver._SlotMeters = Slots
    try:
        want = driver.evaluate(cfg, engine, multiple=2, save_images=False)
    finally:
        driver._SlotMeters = orig
    want_slots = [[x.avg for x in t.psnr.values()]
                  + [x.avg for x in t.ssim.values()] for t in slots[:2]]
    assert np.isfinite(want[:5]).all()
    for o in outs:
        np.testing.assert_allclose(o["eval"], want[:5], rtol=1e-9, atol=0)
        np.testing.assert_allclose(o["slots"], want_slots, rtol=1e-9,
                                   atol=0)


def test_cli_train_resumes_every_process_from_process_0(two_processes, tree):
    """``cli --phase train --auto_resume`` in two processes where only
    process 0's checkpoint directory holds a checkpoint (epoch 0): both
    resume at epoch 1 with process 0's weights and Adam state, end with
    the same weights, and only process 0 writes checkpoints and debug
    sheets; the final evaluation, shared out by scenes, gives both
    processes the same meters."""
    outs, texts, _, _ = two_processes
    for o, text in zip(outs, texts):
        assert o["train"]["start_epoch"] == 1
        assert "resumed at epoch 1 (best_PSNR 1.5)" in text
        assert "Start epoch 0" not in text
        assert np.isfinite(o["train"]["epoch_losses"]).all()
    assert outs[0]["digest"] == outs[1]["digest"]
    assert outs[0]["train"]["final"] == outs[1]["train"]["final"]
    assert np.isfinite(outs[0]["train"]["final"]).all()
    ck = tree / "rank0" / "ck" / "DeMFInet_exp1"
    latest = torch.load(ck / "DeMFInet_exp1_latest.pt", weights_only=False)
    # one step in epoch 0, one (4 scenes, a global batch of 4) in epoch 1
    assert latest["last_epoch"] == 1
    assert latest["state_dict_Optimizer"]["state"][0]["step"] == 2
    assert (ck / "DeMFInet_exp1_epc1.pt").exists()
    assert not (tree / "rank1" / "ck").exists()
    assert not (tree / "rank1" / "txt").exists()
    assert (tree / "rank0" / "img" / "DeMFInet_exp1" / "while_training"
            ).is_dir()
    assert not (tree / "rank1" / "img" / "DeMFInet_exp1" / "while_training"
                ).exists()
