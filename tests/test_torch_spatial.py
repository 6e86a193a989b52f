"""The spatial axis of the port on the CPU (``--mesh_spatial``): frame
rows split across gloo processes, against the port's unsplit run and the
JAX engine on a ('data', 'spatial') mesh of the conftest's host devices.

Two spawns: two processes (the ``two_ranks`` fixture) and four
(``four_ranks``). Each rank runs the worker below on its rows and saves
what it computed; the tests hold it against the unsplit computation made
here, on the same numpy-seeded inputs and weights (a JAX parameter tree
carried across by the port's converter):

  - the engine: every WindowResult field of a x4 DeMFI-Net_rb(1,1)
    window at 64x96 (visualisation maps included) within 1e-5 of the
    largest value of the unsplit port's, and within 1e-3 of the JAX
    engine's on Mesh(devices[:2].reshape(1, 2)), the CPU parity bar;
  - ``exchange_rows`` (zeros at the frame's edges) and ``_minmax_norm``
    (the frame's minimum and maximum on other ranks) bit for bit;
  - the stencil forward warp on a shard bit for bit the unsplit one, and
    the atomic splat's canvases summed within 1e-5;
  - RefineUNet's stride-2 encoders at the smallest legal rows a rank (8);
  - ``cli --phase test --mesh_spatial 2`` against the unsplit CLI: the
    metrics within 1e-3 dB and the PNGs within one uint8 step (JAX's own
    bar, tests/test_driver_cli.py), and ``test_custom``;
  - the tiled ``forward_window``, each tile's rows split;
  - unequal row blocks: a 48-row frame at patch_boundary 16 on four ranks
    (16/16/8/8 rows) against the unsplit port (1e-5) and the JAX engine
    on Mesh(devices[:4].reshape(1, 4)) (1e-3);
  - the refusals that remain: a --mesh_data that is not P / S, more
    ranks than processes (also for --phase train, which splits rows
    since training's spatial axis: tests/test_torch_spatial_train.py), a
    hand-made shard off the network's stride, a halo that needs a
    neighbour's neighbour; and the halo exchange under autograd, which
    now has its backward.
"""
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

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.infer import InferenceEngine as JaxEngine
from demfi_tpu.models import make_model as jax_make_model
from demfi_torch.checkpoint import (checkpoint_path, flax_params_to_state_dict,
                                    save_checkpoint)
from demfi_torch.config import DeMFIConfig, config_rb
from demfi_torch.infer import InferenceEngine, WindowResult
from demfi_torch.main import cli, parse_args
from demfi_torch.models import make_model
from demfi_torch.models.demfi import RefineUNet, _minmax_norm
from demfi_torch.ops import kernels
from demfi_torch.parallel import Grid, RowShard
from demfi_torch.parallel.halo import exchange_rows

ROOT = Path(__file__).resolve().parent.parent
H, W = 64, 96
TS = np.array([[0.25, 0.5, 0.75]], np.float32)
FIELDS = [f.name for f in __import__("dataclasses").fields(WindowResult)]
SMALL = dict(nf=16, num_ResB_FACFB=1, num_ResB_Dec=1)
SMALL_ARGS = ["--nf", "16", "--num_ResB_FACFB", "1", "--num_ResB_Dec", "1",
              "--N_trn", "1", "--N_tst", "1", "--device", "cpu"]
SPLIT_RTOL = 1e-5       # split against unsplit port, of the largest value
JAX_ATOL = 1e-3         # the port against JAX on the CPU
SPAWN_TIMEOUT = 300
SHIFT_D = 8
ODD_H = 48              # six blocks of 8 rows: 16/16/8/8 on four ranks


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_params(jmodel, seed):
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


def _inputs():
    """Frames, stencil and splat operands, the exchange and norm tensors:
    every rank and the tests make them alike from one seed."""
    rng = np.random.RandomState(5)
    f32 = np.float32
    return dict(
        frames=rng.uniform(-1, 1, (1, 4, H, W, 3)).astype(f32),
        img=rng.randn(2, 2, H, W).astype(f32),
        flo_in=rng.uniform(-SHIFT_D + 1.5, SHIFT_D - 1.5,
                           (2, 2, H, W)).astype(f32),
        flo_out=(rng.randn(2, 2, H, W) * 12).astype(f32),
        rows=np.arange(2 * 3 * H * 5, dtype=f32).reshape(2, 3, H, 5),
        norm=(rng.rand(2, 1, H, W) * 5).astype(f32),
        unet=rng.randn(1, 3 * 8 + 9, 8, 16).astype(f32),
        odd=rng.uniform(-1, 1, (1, 4, ODD_H, W, 3)).astype(f32),
    )


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
from demfi_torch.infer import InferenceEngine
from demfi_torch.main import cli
from demfi_torch.models import make_model
from demfi_torch.models.demfi import RefineUNet, _minmax_norm, rows_of
from demfi_torch.ops import warp
from demfi_torch.parallel import (destroy_distributed, init_distributed,
                                  make_grid)
from demfi_torch.parallel.halo import exchange_rows

SHIFT_D = spec["shift_d"]
inp = {k: torch.from_numpy(v) for k, v in np.load(work / "inputs.npz").items()}
out = {}
init_distributed(f"127.0.0.1:{port}", size, pid, "cpu")
grid = make_grid(0, size)
shard = grid.shard(inp["img"].shape[2])
rows = slice(shard.r0, shard.r1)
with torch.no_grad():
    # the engine on this rank's rows
    cfg = config_rb(1, 1, device="cpu", visualization_flag=True,
                    **spec["small"])
    model = make_model(cfg, device="cpu")
    model.load_state_dict(torch.load(work / "weights.pt"), strict=True)
    engine = InferenceEngine(model, 1, device="cpu", grid=grid)
    res = engine.forward_windows(inp["frames"].numpy(), np.asarray(
        spec["ts"], np.float32))[0]
    out.update({"engine_" + k: v for k, v in vars(res).items()})
    if spec["tiled"]:
        res = engine.forward_window(inp["frames"].numpy(), np.asarray(
            spec["ts"][0], np.float32), test_patch=(2, 1),
            patch_boundary=16)
        out.update({"tiled_" + k: v for k, v in vars(res).items()})
    if spec["odd"]:
        odd = engine.shard(inp["odd"].shape[2])
        out["odd_rows"] = np.array([odd.r0, odd.r1])
        res = engine.forward_windows(inp["odd"].numpy(), np.asarray(
            spec["ts"], np.float32), patch_boundary=16)[0]
        out.update({"odd_" + k: v for k, v in vars(res).items()})
    # the collectives and the warps at shard edges
    out["exchange"] = exchange_rows(inp["rows"][:, :, rows], 2, 3, shard)
    out["exchange_bf16"] = exchange_rows(
        inp["rows"][:, :, rows].bfloat16(), 2, 3, shard).float()
    out["norm"] = _minmax_norm(inp["norm"][:, :, rows], shard)
    for tag, flo in (("in", inp["flo_in"]), ("out", inp["flo_out"])):
        o, n = warp.fwarp(inp["img"][:, :, rows], flo[:, :, rows], SHIFT_D,
                          shard)
        out[f"fwarp_{tag}"], out[f"fwarp_{tag}_norm"] = o, n
    # RefineUNet at 8 rows a rank, the smallest multiple of its stride
    unet = RefineUNet(8)
    unet.load_state_dict(torch.load(work / "unet.pt"))
    x = inp["unet"].repeat(1, 1, size, 1)
    ushard = grid.shard(x.shape[2])
    with rows_of(unet, ushard):
        out["unet"] = unet(x[:, :, ushard.r0:ushard.r1])
with torch.enable_grad():
    x = inp["rows"][:, :, rows].clone().requires_grad_()
    exchange_rows(x, 1, 1, shard).sum().backward()
    out["grad_ones"] = x.grad
np.savez(work / f"rank{pid}.npz", **{k: np.asarray(v) for k, v in out.items()})
destroy_distributed()
for phase, argv in spec["cli"].items():
    res = cli(argv + ["--coordinator_address", f"127.0.0.1:{spec[phase]}",
                      "--num_processes", str(size), "--process_id", str(pid)])
    if phase == "test":
        (work / f"cli{pid}.json").write_text(json.dumps(list(res)))
print("WORKER_DONE", pid, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_tree(root: Path):
    """One test scene of 5 blur frames (2 windows at x2) and a custom clip
    of 4 frames, 64x96 PNGs."""
    rng = np.random.RandomState(7)
    sharp = root / "data" / "test" / "scene0"
    blur = root / "data" / "test_blur" / "scene0"
    clip = root / "clips" / "clipA"
    for d in (sharp, blur, clip):
        d.mkdir(parents=True)
    for i in range(17, 17 + 8 * 4 + 1):
        cv2.imwrite(str(sharp / f"{i:05d}.png"),
                    rng.randint(0, 255, (H, W, 3), np.uint8))
    for k in range(5):
        cv2.imwrite(str(blur / f"{17 + 8 * k:05d}.png"),
                    rng.randint(0, 255, (H, W, 3), np.uint8))
    for i in range(4):
        cv2.imwrite(str(clip / f"{i:05d}.png"),
                    rng.randint(0, 255, (H, W, 3), np.uint8))


def _cli_args(root: Path, sub: str) -> list:
    return ["--multiple_MFI", "2", *SMALL_ARGS, "--fwarp_shift_d",
            str(SHIFT_D), "--test_data_path", str(root / "data"),
            "--checkpoint_dir", str(root / "ckpt"),
            "--test_img_dir", str(root / sub)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The weights (a JAX parameter tree, converted), the evaluation tree
    and its checkpoint."""
    root = tmp_path_factory.mktemp("spatial")
    jmodel = jax_make_model(jax_config_rb(1, 1, visualization_flag=True,
                                          **SMALL))
    params = _jax_params(jmodel, 3)
    sd = flax_params_to_state_dict(params)
    torch.save(sd, root / "weights.pt")
    unet = RefineUNet(8)
    torch.save(unet.state_dict(), root / "unet.pt")
    _write_tree(root)
    save_checkpoint(checkpoint_path(DeMFIConfig(
        checkpoint_dir=str(root / "ckpt")), "latest"), sd)
    return root, jmodel, params, sd, unet


def _spawn(root: Path, size: int, tiled: bool, with_cli: bool,
           odd: bool = False):
    work = root / f"work{size}"
    work.mkdir()
    for name in ("weights.pt", "unet.pt"):
        (work / name).write_bytes((root / name).read_bytes())
    np.savez(work / "inputs.npz", **_inputs())
    spec = dict(shift_d=SHIFT_D, small=SMALL, ts=TS.tolist(),
                tiled=tiled, odd=odd, cli={}, test=_free_port(),
                test_custom=_free_port())
    if with_cli:
        spec["cli"] = {
            "test": ["--phase", "test", "--mesh_spatial", str(size),
                     *_cli_args(root, f"img_split{size}")],
            "test_custom": ["--phase", "test_custom", "--mesh_spatial",
                            str(size), *_cli_args(root, "unused"),
                            "--custom_path", str(root / "clips")]}
    (work / "spec.json").write_text(json.dumps(spec))
    (work / "worker.py").write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, str(work / "worker.py"),
                               str(p), str(size), port, str(work)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for p in range(size)]
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
    ranks = [dict(np.load(work / f"rank{p}.npz")) for p in range(size)]
    return ranks, texts, work


@pytest.fixture(scope="module")
def two_ranks(setup):
    root = setup[0]
    return _spawn(root, 2, tiled=True, with_cli=True)


@pytest.fixture(scope="module")
def four_ranks(setup):
    root = setup[0]
    return _spawn(root, 4, tiled=False, with_cli=False, odd=True)


@pytest.fixture(scope="module")
def whole(setup):
    """The unsplit port's engine results on the same weights."""
    _, _, _, sd, _ = setup
    cfg = config_rb(1, 1, device="cpu", visualization_flag=True, **SMALL)
    model = make_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    engine = InferenceEngine(model, 1, device="cpu")
    frames = _inputs()["frames"]
    untiled = engine.forward_windows(frames, TS)[0]
    tiled = engine.forward_window(frames, TS[0], test_patch=(2, 1),
                                  patch_boundary=16)
    odd = engine.forward_windows(_inputs()["odd"], TS, patch_boundary=16)[0]
    return untiled, tiled, odd


def _close(got, want, rtol, name):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert got.shape == want.shape, name
    assert err <= rtol * scale, (name, err, scale)


# --------------------------------------------------------------- the tests
@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_split_engine_equals_whole(ranks, whole, request):
    """Every field, on every rank (each gets the whole frame back), within
    1e-5 of its largest value of the unsplit engine's."""
    got, _, _ = request.getfixturevalue(ranks)
    want = whole[0]
    for r in got:
        for name in FIELDS:
            _close(r["engine_" + name], getattr(want, name), SPLIT_RTOL, name)


def test_split_engine_equals_jax_mesh(two_ranks, setup):
    """The port on two ranks against the JAX engine with frame rows on a
    1x2 ('data', 'spatial') mesh: every field within 1e-3."""
    _, jmodel, params, _, _ = setup
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2),
                ("data", "spatial"))
    want = JaxEngine(jmodel, params, 1, mesh=mesh).forward_windows(
        _inputs()["frames"], TS)[0]
    got = two_ranks[0][0]
    for name in FIELDS:
        np.testing.assert_allclose(got["engine_" + name],
                                   np.asarray(getattr(want, name)),
                                   atol=JAX_ATOL, rtol=JAX_ATOL,
                                   err_msg=name)


def test_split_tiled_forward_window(two_ranks, whole):
    """forward_window at test_patch (2, 1) with a 16-row halo: each 48-row
    tile's rows split over two ranks, the stitched window within 1e-5."""
    got = two_ranks[0][0]
    for name in FIELDS:
        _close(got["tiled_" + name], getattr(whole[1], name), SPLIT_RTOL,
               name)


@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_exchange_rows_and_minmax_norm_at_edges(ranks, request):
    """exchange_rows: each rank's rows with 2 rows of the rank above and 3
    of the rank below, zeros beyond the frame, in float32 and bfloat16
    (which gloo gathers as bytes); _minmax_norm: the rows of
    the whole frame's normalisation, bit for bit."""
    got, _, _ = request.getfixturevalue(ranks)
    inp = _inputs()
    size = len(got)
    rows = H // size
    padded = np.pad(inp["rows"], ((0, 0), (0, 0), (2, 3), (0, 0)))
    norm = _minmax_norm(torch.from_numpy(inp["norm"])).numpy()
    for s, r in enumerate(got):
        np.testing.assert_array_equal(
            r["exchange"], padded[:, :, s * rows:(s + 1) * rows + 5])
        np.testing.assert_array_equal(
            r["exchange_bf16"], torch.from_numpy(padded).bfloat16().float()[
                :, :, s * rows:(s + 1) * rows + 5].numpy())
        np.testing.assert_array_equal(
            r["norm"], norm[:, :, s * rows:(s + 1) * rows])


@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_split_forward_warps(ranks, request):
    """Flows inside the stencil's window: every rank takes the stencil on
    its rows plus a halo, and its rows are the unsplit stencil's bit for
    bit. Flows beyond it: every rank takes the atomic splat into a canvas
    of the whole frame, and the summed canvases' rows are the unsplit
    splat's within 1e-5."""
    got, _, _ = request.getfixturevalue(ranks)
    inp = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    shift = kernels.fwarp_shift(inp["img"], inp["flo_in"], SHIFT_D)
    splat = kernels.fwarp_splat(inp["img"], inp["flo_out"])
    assert float(inp["flo_out"].abs().max()) > SHIFT_D - 1
    rows = H // len(got)
    for s, r in enumerate(got):
        sl = slice(s * rows, (s + 1) * rows)
        np.testing.assert_array_equal(r["fwarp_in"], shift[0][:, :, sl])
        np.testing.assert_array_equal(r["fwarp_in_norm"], shift[1][:, :, sl])
        _close(r["fwarp_out"], splat[0][:, :, sl].numpy(), SPLIT_RTOL, "out")
        _close(r["fwarp_out_norm"], splat[1][:, :, sl].numpy(), SPLIT_RTOL,
               "norm")


@pytest.mark.parametrize("ranks", ["two_ranks", "four_ranks"])
def test_refine_unet_stride_two_halo(ranks, setup, request):
    """RefineUNet's k=4, stride-2, pad-1 encoders read one row beyond a
    rank's rows on each side, at every level: at 8 rows a rank (the
    smallest legal multiple) its rows equal the whole frame's within
    1e-5."""
    got, _, _ = request.getfixturevalue(ranks)
    unet = setup[4]
    size = len(got)
    x = torch.from_numpy(_inputs()["unet"]).repeat(1, 1, size, 1)
    with torch.no_grad():
        want = unet(x).numpy()
    for s, r in enumerate(got):
        _close(r["unet"], want[:, :, 8 * s:8 * (s + 1)], SPLIT_RTOL, "unet")


def test_cli_mesh_spatial_equals_unsplit(two_ranks, setup):
    """``cli --phase test --mesh_spatial 2 --fwarp_shift_d 8`` in two gloo
    processes against the unsplit CLI: both ranks return the same
    metrics, within 1e-3 dB of the unsplit run's; only rank 0 writes
    PNGs, each within one uint8 step of the unsplit run's; test_custom
    writes the clip's frames once."""
    root = setup[0]
    _, texts, work = two_ranks
    want = cli(["--phase", "test", *_cli_args(root, "img_whole")])
    got = [json.loads((work / f"cli{p}.json").read_text()) for p in range(2)]
    assert got[0][:5] == got[1][:5]
    np.testing.assert_allclose(got[0][:5], want[:5], atol=1e-3, rtol=0)
    assert np.isfinite(want[:5]).all()
    d_want, d_got = Path(want[5]), Path(got[0][5])
    names = sorted(p.relative_to(d_want) for p in d_want.rglob("*.png"))
    assert names and names == sorted(p.relative_to(d_got)
                                     for p in d_got.rglob("*.png"))
    for n in names:
        a = cv2.imread(str(d_want / n)).astype(np.int16)
        b = cv2.imread(str(d_got / n)).astype(np.int16)
        assert np.abs(a - b).max() <= 1, n
    assert "mesh: 1 data group(s) x 2 ranks" in texts[0]
    out = root / "clips" / "clipA_sharply_interpolated_x2"
    assert sorted(os.listdir(out)) == ["00001.png", "00001_000.png",
                                       "00002.png"]


def test_refusals(two_ranks, setup, capsys):
    """What stays refused: a --mesh_data that is not P / S, more ranks
    than processes (--phase test, and --phase train, whose flag is
    accepted now that training splits rows), a hand-made shard whose rows
    the network's stride cannot take (Grid.shard cuts none such), a halo
    that needs a neighbour's neighbour. The halo exchange under autograd
    is no longer refused: on every rank the gradient of its sum is one
    per row plus one on each edge row a neighbour read."""
    root = setup[0]
    got, _, _ = two_ranks
    for s, r in enumerate(got):
        want = np.ones_like(r["grad_ones"])
        want[:, :, -1] += s < len(got) - 1
        want[:, :, 0] += s > 0
        np.testing.assert_array_equal(r["grad_ones"], want)
    with pytest.raises(ValueError, match="--mesh_data 3 does not match"):
        cli(["--phase", "test", "--mesh_data", "3",
             *_cli_args(root, "refuse")])
    assert parse_args(["--phase", "train", "--mesh_spatial", "2"]
                      ).mesh_spatial == 2
    for phase in ("test", "train"):
        with pytest.raises(ValueError, match="--mesh_spatial 2 splits rows "
                                             "across 2 processes"):
            cli(["--phase", phase, "--mesh_spatial", "2",
                 *_cli_args(root, "refuse")])
    model = make_model(config_rb(1, 1, device="cpu", **SMALL), device="cpu")
    # split in two by hand: 36 rows a rank
    with pytest.raises(ValueError, match="total stride 8"):
        with model.rows(RowShard(h=72, r0=0, r1=36, index=0, size=2)):
            pass
    cut = Grid(world=2, spatial=2).shard(72)    # nine blocks: 5 + 4
    assert (cut.r0, cut.r1) == (0, 40)
    shard = RowShard(h=H, r0=0, r1=1, index=0, size=H)
    x = torch.zeros(1, 1, 1, 4, requires_grad=True)
    with pytest.raises(ValueError, match="a neighbour's neighbour"):
        exchange_rows(x, 2, 2, shard)


def test_unequal_row_blocks(four_ranks, whole, setup):
    """A 48-row frame at patch_boundary 16 on four ranks: six blocks of 8
    rows, 16/16/8/8 rows a rank (each a multiple of the network's
    stride, so no rank refuses it), every field within 1e-5 of the
    largest value of the unsplit port's and within 1e-3 of the JAX
    engine's on a 1x4 ('data', 'spatial') mesh."""
    got, _, _ = four_ranks
    assert [tuple(r["odd_rows"]) for r in got] == [(0, 16), (16, 32),
                                                   (32, 40), (40, 48)]
    for r in got:
        for name in FIELDS:
            _close(r["odd_" + name], getattr(whole[2], name), SPLIT_RTOL,
                   name)
    _, jmodel, params, _, _ = setup
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4),
                ("data", "spatial"))
    want = JaxEngine(jmodel, params, 1, mesh=mesh).forward_windows(
        _inputs()["odd"], TS, patch_boundary=16)[0]
    for name in FIELDS:
        np.testing.assert_allclose(got[0]["odd_" + name],
                                   np.asarray(getattr(want, name)),
                                   atol=JAX_ATOL, rtol=JAX_ATOL,
                                   err_msg=name)


def test_unsplit_height_runs_whole(capsys):
    """A padded height that the spatial axis does not divide runs whole on
    every rank, as the JAX engine leaves it unsharded, and the engine
    says so once."""
    engine = InferenceEngine(make_model(config_rb(1, 1, device="cpu",
                                                  **SMALL), device="cpu"),
                             1, device="cpu",
                             grid=Grid(world=3, data=1, spatial=3))
    assert engine.shard(64) is None and engine.shard(64) is None
    assert capsys.readouterr().out.count("does not split into 3") == 1
    shard = engine.shard(96)
    assert (shard.r0, shard.r1, shard.above, shard.below) == (0, 32, None, 1)
