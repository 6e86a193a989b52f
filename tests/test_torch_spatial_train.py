"""Training's spatial axis on the CPU (``--phase train --mesh_spatial S``):
a train step on frame rows split across gloo processes, against the
port's unsplit step and JAX's train step on a ('data', 'spatial') mesh of
the conftest's host devices.

Two spawns: two processes (the ``two_ranks`` fixture) and four
(``four_ranks``). Each rank runs the worker below and saves what it
computed; the tests hold it against what is computed here, on the same
numpy-seeded inputs and weights (a JAX parameter tree carried across by
the port's converter, the flow head calibrated to 4 px so that the
stencil's window covers CFR's flows):

  - the collectives' backwards against autograd through the unsplit op:
    ``exchange_rows`` (frame edges included, float32 and bfloat16),
    ``allgather_rows`` on unequal blocks, ``allreduce_sum``, and
    ``allreduce_min`` / ``allreduce_max`` with a tie planted across two
    ranks: bit for bit, float32 sums of four ranks within 1e-6;
  - a DeMFI-Net_rb(1,1) step (nf 16, N_trn 1, batch 2, 32x32; 8 rows a
    rank at four) against the unsplit port's: the loss within 1e-5
    (relative), every gradient within the larger of ``GRAD_TOL`` and
    twice the unsplit step's change between two runs (the rule of
    ``grad_check.gradient_bounds`` where both steps run the same code on
    one device, so that no nudge of the batch stands for their
    departure);
  - at two ranks, against JAX's ``make_train_step`` on
    ``Mesh(devices[:2].reshape(1, 2), ('data', 'spatial'))``: the loss
    within 1e-4, every gradient (JAX's, read from its Adam state's first
    moment after the step) within the larger of ``GRAD_TOL`` and twice
    JAX's own change under a 1e-6 nudge of the batch, as
    ``tests/test_torch_train.py`` holds the unsplit step, and the updated
    parameters within the same bounds;
  - at two ranks: remat's gradients bitwise the split step's without it;
    ``--fwarp_shift_d 8`` split against unsplit; a bfloat16 step (loss
    1e-2, gradients by moments);
  - ``cli --phase train --mesh_spatial 2`` for one step, then
    ``--auto_resume`` for one more, then ``--phase test --mesh_spatial
    2``, against the same run in one process: the losses, the
    checkpoint's parameters and Adam's first moments (one step's
    gradients times 0.1), the test metrics within 1e-3 dB.

The row-offset plain vjps (the backward kernels' yardsticks) are held
here too, on every shard of 2- and 4-way splits, against the whole
frame's vjp: the shards' image gradients summed, the coordinates' and
flows' gradients the whole frame's rows.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding

from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.models import make_model as jax_make_model
from demfi_tpu.train import loop as jloop
from demfi_torch.checkpoint import (flax_params_to_state_dict,
                                    load_training_checkpoint,
                                    state_dict_to_flax_params)
from demfi_torch.config import config_rb
from demfi_torch.main import cli
from demfi_torch.models import make_model
from demfi_torch.ops import warp
from demfi_torch.train import create_train_state, make_train_step
from demfi_torch.utils.grad_check import GRAD_TOL, NUDGE, rel_frobenius
from demfi_torch.utils.profiling import calibrate_flow_head

from test_torch_model import jax_param_tree
from test_torch_train import tree  # noqa: F401  (the CLI's data tree)

ROOT = Path(__file__).resolve().parent.parent
PS = 32                     # the train step's patch: 8 rows a rank at four
SMALL = dict(nf=16, num_ResB_FACFB=1, num_ResB_Dec=1)
T = np.array([[0.25], [0.625]], np.float32)
FLOW_PX = 4.0               # inside the stencil's window (SHIFT_D - 1)
SHIFT_D = 8
SPAWN_TIMEOUT = 300
LOSS_RTOL = 1e-5            # split against unsplit port
JAX_LOSS_RTOL = 1e-4
BF16_LOSS_RTOL = 1e-2
BF16_MOMENTS_TOL = 0.08     # of a gradient's mean and std, in its std
SUM_TOL = 1e-6              # a float32 sum over ranks in another order
METRIC_TOL = 1e-3           # dB
CLI_SMALL = ["--device", "cpu", "--nf", "16", "--num_ResB_FACFB", "1",
             "--num_ResB_Dec", "1", "--N_trn", "1", "--N_tst", "1",
             "--patch_size", str(PS), "--batch_size", "2", "--num_thrds",
             "2", "--freq_display", "1", "--epoch_freq_save", "1",
             "--multiple_MFI", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**kw):
    return config_rb(1, 1, device="cpu", **SMALL, **kw)


def _collective_inputs(size: int) -> dict:
    """Every rank's operands and cotangents, [size, ...] (rank r takes
    index r): exchange on a frame of 8 rows a rank, a gather on unequal
    blocks, a sum, and a minimum and maximum whose element 0 ties ranks 0
    and 1 (element 1 ties every rank)."""
    rng = np.random.RandomState(size)
    f32 = np.float32
    h = 8 * size
    hg = 8 * (2 * size - 2) if size > 2 else 24
    ext = rng.randn(size, 3).astype(f32)
    ext[1, 0] = ext[0, 0] = ext[:, 0].max() + 1.0    # ranks 0, 1 tie on max
    ext[:, 1] = 0.5                                   # every rank ties
    low = rng.randn(size, 3).astype(f32)
    low[1, 0] = low[0, 0] = low[:, 0].min() - 1.0
    low[:, 1] = -0.5
    return dict(
        frame=rng.randn(2, 3, h, 5).astype(f32),
        g_frame=rng.randn(size, 2, 3, 8 + 5, 5).astype(f32),
        gather=rng.randn(2, 3, hg, 5).astype(f32),
        g_gather=rng.randn(size, 2, 3, hg, 5).astype(f32),
        sum=rng.randn(size, 2, 7).astype(f32),
        g_sum=rng.randn(size, 2, 7).astype(f32),
        max=ext, min=low, g_ext=rng.randn(size, 3).astype(f32))


# ------------------------------------------------------------------ worker
_WORKER = r"""
import json, sys
from pathlib import Path
pid, size, port, work = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                         Path(sys.argv[4]))
spec = json.loads((work / "spec.json").read_text())
import numpy as np
import torch
torch.set_num_threads(1)
from demfi_torch.config import config_rb
from demfi_torch.main import cli
from demfi_torch.models import make_model
from demfi_torch.parallel import (destroy_distributed, init_distributed,
                                  make_grid)
from demfi_torch.parallel.halo import (allgather_rows, allreduce_max,
                                       allreduce_min, allreduce_sum,
                                       exchange_rows)
from demfi_torch.train import create_train_state, make_train_step

init_distributed(f"127.0.0.1:{port}", size, pid, "cpu")
grid = make_grid(0, size)
c = {k: torch.from_numpy(v) for k, v in np.load(work / "coll.npz").items()}
out = {}


def grad_of(name, fn, x, g):
    x = x.clone().requires_grad_()
    fn(x).backward(g)
    out[name] = x.grad.float().numpy()


shard = grid.shard(c["frame"].shape[2])
rows = slice(shard.r0, shard.r1)
for tag, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
    grad_of("exchange" + tag, lambda x: exchange_rows(x, 2, 3, shard),
            c["frame"][:, :, rows].to(dt), c["g_frame"][pid].to(dt))
gshard = grid.shard(c["gather"].shape[2])
out["gather_rows"] = np.array([gshard.r0, gshard.r1])
grad_of("gather", lambda x: allgather_rows(x, gshard),
        c["gather"][:, :, gshard.r0:gshard.r1], c["g_gather"][pid])
grad_of("sum", lambda x: allreduce_sum(x, shard), c["sum"][pid],
        c["g_sum"][pid])
grad_of("max", lambda x: allreduce_max(x, shard), c["max"][pid],
        c["g_ext"][pid])
grad_of("min", lambda x: allreduce_min(x, shard), c["min"][pid],
        c["g_ext"][pid])
np.savez(work / f"coll{pid}.npz", **out)

weights = torch.load(work / "weights.pt")
frames = np.load(work / "frames.npy")
t = np.load(work / "t.npy")
small = spec["small"]


def split_step(tag, **kw):
    cfg = config_rb(1, 1, device="cpu", **small, **kw)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(weights, strict=True)
    state = create_train_state(cfg, model)
    got, flows = {}, []
    model.register_forward_hook(lambda _m, _in, o: flows.append(
        o.flow_preds.detach().float()))

    def snap(phase):
        if phase == "backward":
            got.update({"grad:" + k: p.grad.clone().numpy()
                        for k, p in model.named_parameters()
                        if p.grad is not None})
    m = make_train_step(cfg, grid)(state, frames, t, on_phase=snap)
    got["loss"] = np.float64(m["total_loss"])
    got["flows"] = flows[0].numpy()
    got.update({"param:" + k: p.detach().numpy()
                for k, p in model.named_parameters()})
    np.savez(work / f"{tag}{pid}.npz", **got)


for tag, kw in spec["steps"].items():
    split_step(tag, **kw)
destroy_distributed()
for phase, argv in spec["cli"]:
    res = cli(argv + ["--coordinator_address", f"127.0.0.1:{spec[phase]}",
                      "--num_processes", str(size), "--process_id", str(pid)])
    (work / f"{phase}{pid}.json").write_text(json.dumps(
        list(res) if phase == "test" else res["epoch_losses"]))
print("WORKER_DONE", pid, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights (a JAX parameter tree through the converter, the flow head
    calibrated to FLOW_PX on the batch), the batch, and JAX's model."""
    root = tmp_path_factory.mktemp("spatial_train")
    rng = np.random.RandomState(31)
    frames = rng.uniform(-1, 1, (2, 9, PS, PS, 3)).astype(np.float32)
    jmodel = jax_make_model(jax_config_rb(1, 1, **SMALL))
    params = jax_param_tree(jmodel, jnp.asarray(frames[:, :4]),
                            jnp.asarray(T), 31)
    model = make_model(_cfg(), device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        calibrate_flow_head(model, torch.from_numpy(np.ascontiguousarray(
            frames[:, :4].transpose(0, 1, 4, 2, 3))), FLOW_PX)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save(sd, root / "weights.pt")
    np.save(root / "frames.npy", frames)
    np.save(root / "t.npy", T)
    return root, frames, sd, jmodel, state_dict_to_flax_params(sd)


def _spawn(root: Path, size: int, steps: dict, cli_runs: list):
    work = root / f"work{size}"
    work.mkdir()
    for name in ("weights.pt", "frames.npy", "t.npy"):
        (work / name).write_bytes((root / name).read_bytes())
    np.savez(work / "coll.npz", **_collective_inputs(size))
    spec = dict(small=SMALL, steps=steps, cli=cli_runs)
    spec.update({phase: _free_port() for phase, _ in cli_runs})
    (work / "spec.json").write_text(json.dumps(spec))
    (work / "worker.py").write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(work / "worker.py"),
                               str(p), str(size), port, str(work)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for p in range(size)]
    return procs, work


def _join(procs, work):
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
    return work, texts


def _cli_dirs(root: Path, tree_root: Path, sub: str) -> list:
    return ["--train_data_path", str(tree_root),
            "--test_data_path", str(tree_root),
            "--checkpoint_dir", str(root / sub / "ck"),
            "--text_dir", str(root / sub / "txt"),
            "--log_dir", str(root / sub / "log"),
            "--test_img_dir", str(root / sub / "img")]


def _cli_runs(root: Path, tree_root: Path, sub: str, split: bool) -> list:
    """One step (--epochs 1 at batch 2 on two train scenes), one more
    from --auto_resume, then --phase test on the checkpoint."""
    mesh = ["--mesh_spatial", "2"] if split else []
    dirs = _cli_dirs(root, tree_root, sub)
    return [("train", ["--phase", "train", "--epochs", "1", *CLI_SMALL,
                       *mesh, *dirs]),
            ("resume", ["--phase", "train", "--epochs", "2",
                        "--auto_resume", *CLI_SMALL, *mesh, *dirs]),
            ("test", ["--phase", "test", "--multiple_MFI", "2", "--device",
                      "cpu", "--nf", "16", "--num_ResB_FACFB", "1",
                      "--num_ResB_Dec", "1", "--N_trn", "1", "--N_tst", "1",
                      *mesh, *dirs])]


def _unsplit_step(frames, sd, **kw):
    """(loss, gradients by name, flows, updated parameters) of the port's
    unsplit step."""
    cfg = _cfg(**kw)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    state = create_train_state(cfg, model)
    got, flows = {}, []
    model.register_forward_hook(lambda _m, _in, o: flows.append(
        o.flow_preds.detach().float()))

    def snap(phase):
        if phase == "backward":
            got.update({k: p.grad.clone() for k, p in model.named_parameters()
                        if p.grad is not None})
    m = make_train_step(cfg)(state, frames, T, on_phase=snap)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return float(m["total_loss"]), got, flows[0], params


def _jax_mesh_step(frames, jmodel, jparams):
    """(loss, gradients, updated parameters, gradients at a 1e-6 nudge of
    the batch), as state dicts, of JAX's train step on a 1x2 ('data',
    'spatial') mesh, the batch placed by train_batch_specs. The
    gradients are read from Adam's first moment after the step, (1 -
    b1) g with b1 = 0.9 (no weight decay)."""
    jcfg = jax_config_rb(1, 1, **SMALL)
    assert jcfg.weight_decay == 0
    tx = jloop.make_optimizer(jcfg)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                ("data", "spatial"))
    step = jloop.make_train_step(jcfg, jmodel, tx, mesh=mesh)
    fspec, tspec = jloop.train_batch_specs(mesh)
    nudge = np.random.RandomState(40).randn(*frames.shape).astype(
        np.float32) * np.float32(NUDGE)
    got = []
    for x in (frames, frames + nudge):
        state = jloop.TrainState(params=jparams, opt_state=tx.init(jparams),
                                 epoch=jnp.zeros((), jnp.int32))
        state, metrics = step(
            state, jax.device_put(x, NamedSharding(mesh, fspec)),
            jax.device_put(T, NamedSharding(mesh, tspec)))
        adam = next(s for s in state.opt_state.inner_state
                    if hasattr(s, "mu"))
        got.append((float(metrics["total_loss"]),
                    {k: v / np.float32(0.1) for k, v in
                     flax_params_to_state_dict(
                         jax.device_get(adam.mu)).items()},
                    flax_params_to_state_dict(jax.device_get(state.params))))
    (loss, grads, params), (_, nudged, _) = got
    return loss, grads, params, nudged


@pytest.fixture(scope="module")
def runs(setup, tree):  # noqa: F811
    """Both spawns, and while their ranks work everything they are held
    against: the single-process CLI runs, JAX's mesh step, the unsplit
    steps and the unsplit float32 step's rerun."""
    root, frames, sd, jmodel, jparams = setup
    steps = {"f32": {}, "remat": {"remat_backbone": True},
             "shift": {"fwarp_shift_d": SHIFT_D},
             "bf16": {"compute_dtype": "bfloat16"}}
    two = _spawn(root, 2, steps, _cli_runs(root, tree, "split", True))
    four = _spawn(root, 4, {"f32": {}}, [])
    cli_whole = {}
    for phase, argv in _cli_runs(root, tree, "whole", False):
        res = cli(argv)
        cli_whole[phase] = (list(res) if phase == "test"
                            else res["epoch_losses"])
    unsplit = {tag: _unsplit_step(frames, sd, **kw)
               for tag, kw in steps.items() if tag != "remat"}
    again = _unsplit_step(frames, sd)[1]
    want = unsplit["f32"][1]
    bound = {k: max(GRAD_TOL, 2 * rel_frobenius(again[k], w))
             for k, w in want.items()}
    jax_step = _jax_mesh_step(frames, jmodel, jparams)
    return dict(two=_join(*two), four=_join(*four), cli_whole=cli_whole,
                unsplit=unsplit, bound=bound, jax=jax_step)


def _ranks(work: Path, tag: str, size: int) -> list:
    return [dict(np.load(work / f"{tag}{p}.npz")) for p in range(size)]


def _split_grads(ranks):
    """Every rank's gradients (the same after the step's all-reduce) and
    flows (each its rows), as the unsplit step gives them."""
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            if k.startswith("grad:"):
                np.testing.assert_array_equal(r[k], v, err_msg=k)
    grads = {k[5:]: torch.from_numpy(v) for k, v in ranks[0].items()
             if k.startswith("grad:")}
    flows = torch.from_numpy(np.concatenate([r["flows"] for r in ranks],
                                            axis=-2))
    return grads, flows


# --------------------------------------------------------------- the tests
@pytest.mark.parametrize("size", [2, 4])
def test_collective_backwards(size, runs):
    """Each collective's backward against autograd through the unsplit
    op: bit for bit, float32 sums over four ranks within 1e-6."""
    work = runs["two" if size == 2 else "four"][0]
    got = [dict(np.load(work / f"coll{p}.npz")) for p in range(size)]
    c = {k: torch.from_numpy(v) for k, v in _collective_inputs(size).items()}
    tol = dict(atol=0, rtol=0) if size == 2 else dict(atol=SUM_TOL, rtol=0)

    def whole_grad(x, ys):
        x = x.clone().requires_grad_()
        sum((y * g).sum() for y, g in ys(x)).backward()
        return x.grad.float().numpy()
    # exchange_rows: each rank's rows padded by 2 above and 3 below
    for tag, dt in (("", torch.float32), ("_bf16", torch.bfloat16)):
        want = whole_grad(c["frame"].to(dt), lambda x: [
            (torch.nn.functional.pad(x, (0, 0, 2, 3))[:, :, 8 * r:8 * r + 13],
             c["g_frame"][r].to(dt)) for r in range(size)])
        for r, g in enumerate(got):
            np.testing.assert_array_equal(g["exchange" + tag],
                                          want[:, :, 8 * r:8 * r + 8])
    # allgather_rows on unequal blocks: every rank uses the whole frame
    want = whole_grad(c["gather"], lambda x: [(x, c["g_gather"][r])
                                              for r in range(size)])
    spans = [tuple(g["gather_rows"]) for g in got]
    assert len({b - a for a, b in spans}) == 2       # unequal blocks
    for g, (a, b) in zip(got, spans):
        np.testing.assert_allclose(g["gather"], want[:, :, a:b], **tol)
    # the sum, the maximum and the minimum over ranks
    for name, red in (("sum", lambda s: s.sum(0)),
                      ("max", lambda s: s.amax(0)),
                      ("min", lambda s: s.amin(0))):
        gs = c["g_sum"] if name == "sum" else c["g_ext"]
        want = whole_grad(c[name], lambda x: [(red(x), gs[r])
                                              for r in range(size)])
        for r, g in enumerate(got):
            np.testing.assert_allclose(g[name], want[r], err_msg=name, **tol)
    assert got[0]["max"][0] == got[1]["max"][0] != 0     # the tie shares


@pytest.mark.parametrize("size", [2, 4])
def test_split_step_equals_unsplit(size, runs):
    """The split step's loss within 1e-5 of the unsplit port's, every
    gradient within the larger of GRAD_TOL and twice the unsplit step's
    change between two runs, identical on every rank."""
    work = runs["two" if size == 2 else "four"][0]
    got = _ranks(work, "f32", size)
    loss, want, _, _ = runs["unsplit"]["f32"]
    for r in got:
        assert abs(float(r["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    grads, _ = _split_grads(got)
    assert set(grads) == set(want)
    for k, b in runs["bound"].items():
        assert rel_frobenius(grads[k], want[k]) <= b, k


def test_split_step_equals_jax_mesh(runs):
    """Two ranks against JAX's make_train_step on a 1x2 ('data',
    'spatial') mesh: the loss within 1e-4, every gradient within the
    larger of GRAD_TOL and twice JAX's own change under a 1e-6 nudge of
    the batch (a fault of scale or sign shows here), and every updated
    parameter within the same bound. FGAC's source key, which no step
    reads at rr = 0, has no gradient here and zeros in JAX."""
    jloss, jgrads, jparams, jnudged = runs["jax"]
    ranks = _ranks(runs["two"][0], "f32", 2)
    got = ranks[0]
    assert abs(float(got["loss"]) - jloss) <= JAX_LOSS_RTOL * abs(jloss)
    grads, _ = _split_grads(ranks)
    assert set(grads) <= set(jgrads)
    for k, w in jgrads.items():
        bound = max(GRAD_TOL, 2 * rel_frobenius(jnudged[k], w))
        g = grads.get(k, torch.zeros_like(w))
        assert rel_frobenius(g, w) <= bound, (k, rel_frobenius(g, w), bound)
        assert rel_frobenius(torch.from_numpy(got["param:" + k]),
                             jparams[k]) <= bound, k
    assert all(float(jgrads[k].abs().sum()) > 0 for k in grads)


def test_split_remat_and_stencil(runs):
    """At two ranks: remat's gradients bitwise the split step's without
    it (its recomputation exchanges rows again in the backward); with
    --fwarp_shift_d 8 (CFR's flows inside the window, so the stencil
    serves) the split step against the unsplit one: loss 1e-5, gradients
    within the float32 step's bounds (the stencil's halo rows' gradient
    goes home through the exchange's backward)."""
    work = runs["two"][0]
    plain, remat = _ranks(work, "f32", 2)[0], _ranks(work, "remat", 2)[0]
    grads = [k for k in plain if k.startswith("grad:")]
    assert grads and grads == [k for k in remat if k.startswith("grad:")]
    for k in grads + ["loss"]:
        np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)
    assert float(np.abs(runs["unsplit"]["f32"][2].numpy()).max()) <= \
        SHIFT_D - 1
    loss, want, _, _ = runs["unsplit"]["shift"]
    got = _ranks(work, "shift", 2)
    assert abs(float(got[0]["loss"]) - loss) <= LOSS_RTOL * abs(loss)
    split, _ = _split_grads(got)
    assert set(split) == set(want)
    for k, b in runs["bound"].items():
        assert rel_frobenius(split[k], want[k]) <= b, k


def test_split_step_bf16(runs):
    """A bfloat16 step at two ranks against the unsplit bfloat16 step: the
    loss within 1e-2, each gradient's mean and std within 0.08 of its
    std, or of its value where it holds one (bf16 is chaotic through the
    depth: never per element)."""
    loss, want, _, _ = runs["unsplit"]["bf16"]
    got = _ranks(runs["two"][0], "bf16", 2)
    assert abs(float(got[0]["loss"]) - loss) <= BF16_LOSS_RTOL * abs(loss)
    grads, _ = _split_grads(got)
    assert set(grads) == set(want)
    for k, w in want.items():
        g, w = grads[k].double(), w.double()
        # a tensor's spread, or its size where it holds one value
        scale = max(float(w.std(correction=0) if w.numel() > 1
                          else w.abs().max()), 1e-12)
        assert abs(float(g.mean() - w.mean())) <= BF16_MOMENTS_TOL * scale, k
        assert abs(float(g.std(correction=0) - w.std(correction=0))) <= \
            BF16_MOMENTS_TOL * scale, k


def test_cli_train_mesh_spatial(runs, setup):
    """``cli --phase train --mesh_spatial 2`` for one step, --auto_resume
    for one more, then --phase test --mesh_spatial 2, in two gloo
    processes, against the same runs in one process: both ranks log the
    losses of the single process (1e-5), rank 0 alone writes the
    checkpoints, whose parameters and Adam first moments (the first
    step's gradients times 0.1) lie within the gradient rule's bounds of
    the single run's, and the test metrics agree within 1e-3 dB."""
    work, texts = runs["two"]
    whole = runs["cli_whole"]
    root = setup[0]
    for phase in ("train", "resume"):
        for p in range(2):
            got = json.loads((work / f"{phase}{p}.json").read_text())
            np.testing.assert_allclose(got, whole[phase], rtol=LOSS_RTOL)
    split_ck = root / "split" / "ck" / "DeMFInet_exp1"
    whole_ck = root / "whole" / "ck" / "DeMFInet_exp1"
    assert sorted(os.listdir(split_ck)) == sorted(os.listdir(whole_ck))
    a, opt_a, _ = load_training_checkpoint(
        str(split_ck / "DeMFInet_exp1_epc0.pt"))
    b, opt_b, _ = load_training_checkpoint(
        str(whole_ck / "DeMFInet_exp1_epc0.pt"))
    assert set(a) == set(b)
    bound = runs["bound"]
    for k in a:
        assert rel_frobenius(a[k], b[k]) <= bound.get(k, GRAD_TOL), k
    # the optimizer's state is by parameter index, in the model's order
    names = [k for k, _ in make_model(_cfg(), device="cpu").named_parameters()]
    moments_a, moments_b = opt_a["state"], opt_b["state"]
    assert {names[i] for i in moments_a} == {names[i] for i in moments_b} \
        == set(bound)
    for i in moments_a:
        assert int(moments_a[i]["step"]) == 1
        assert rel_frobenius(moments_a[i]["exp_avg"], moments_b[i][
            "exp_avg"]) <= bound[names[i]], names[i]
    got = [json.loads((work / f"test{p}.json").read_text()) for p in range(2)]
    assert got[0][:5] == got[1][:5]
    np.testing.assert_allclose(got[0][:5], whole["test"][:5],
                               atol=METRIC_TOL, rtol=0)
    assert "mesh: 1 data group(s) x 2 ranks" in texts[0]


@pytest.mark.parametrize("split", [2, 4])
def test_row_offset_plain_vjps(split):
    """The backward kernels' plain versions at row offsets, on every shard
    of a split frame: the gather's (relative, row0) image gradients
    summed over the shards, and the splat's (rows=(r0, Ho)) on the whole
    frame's cotangents, against the whole frame's vjp (1e-6); the
    coordinates' and flows' gradients the whole frame's rows."""
    rng = np.random.RandomState(40 + split)
    b, c, h, w = 2, 3, 8 * split, 11

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))
    img, coords, gout = t(b, c, h, w), t(b, 2, h, w, scale=4), t(b, c, h, w)
    src, flo = t(b, c, h, w), t(b, 2, h, w, scale=3)
    g_out, g_norm = t(b, c, h, w), t(b, 1, h, w)
    whole_gi, whole_gc = warp.bilinear_gather_plain_vjp(img, coords, True,
                                                        gout)
    whole_si, whole_sf = warp.fwarp_splat_plain_vjp(src, flo, g_out, g_norm)
    summed = torch.zeros_like(whole_gi)
    rows = h // split
    for i in range(split):
        r0, r1 = i * rows, (i + 1) * rows
        gi, gc = warp.bilinear_gather_plain_vjp(
            img, coords[:, :, r0:r1].contiguous(), True,
            gout[:, :, r0:r1].contiguous(), r0)
        assert gi.shape == img.shape
        summed += gi
        torch.testing.assert_close(gc, whole_gc[:, :, r0:r1], atol=1e-6,
                                   rtol=0)
        si, sf = warp.fwarp_splat_plain_vjp(
            src[:, :, r0:r1].contiguous(), flo[:, :, r0:r1].contiguous(),
            g_out, g_norm, (r0, h))
        torch.testing.assert_close(si, whole_si[:, :, r0:r1], atol=1e-6,
                                   rtol=0)
        torch.testing.assert_close(sf, whole_sf[:, :, r0:r1], atol=1e-6,
                                   rtol=0)
    torch.testing.assert_close(summed, whole_gi, atol=1e-6, rtol=0)
