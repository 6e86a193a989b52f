"""The port's evaluation loops against the JAX package's, on the CPU.

One synthetic dataset tree (2 scenes, 2 windows each, 48x64), one set of
weights (a JAX parameter tree of DeMFI-Net_rb(1,1) drawn from a numpy
seed, carried across by the port's converter). Tolerances: the two
networks agree to about 2e-4 (float32 convolutions summed in different
orders), which moves a rounded 8-bit output by at most one level at a
few pixels: PSNR to 1e-3 dB, SSIM to 1e-4, PNG values within 1 level.
The forward warp buckets each displacement by its floor: with some
86,000 displacements per x8 window and flows that differ by about 1e-5
between the two packages, one or two buckets per window flip, and with
random weights (flows of tens of pixels) each flip moves CFR's flow
there by pixels, which RefineUNet spreads over a neighbourhood. So at
most 2 % of a file's values may differ by more than 1 level; the ops
themselves are held to 1e-5 and the engine to 2e-4 in their own tests.
"""
import dataclasses
import math
import os

import cv2
import numpy as np
import pytest
import torch

import jax

from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.infer import InferenceEngine as JaxEngine
from demfi_tpu.infer.driver import evaluate as jax_evaluate
from demfi_tpu.models import make_model as jax_make_model
from demfi_torch.checkpoint import flax_params_to_state_dict
from demfi_torch.config import config_rb
from demfi_torch.data.datasets import EvalDataset
from demfi_torch.infer import InferenceEngine, WindowResult
from demfi_torch.infer import driver
from demfi_torch.infer.driver import _load_window, evaluate, evaluate_custom
from demfi_torch.models import make_model

from test_torch_engine import jax_param_tree

H, W = 48, 64
FIELDS = [f.name for f in dataclasses.fields(WindowResult)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def write_tree(root, h, w, lo=0, hi=255):
    rng = np.random.RandomState(0)
    for s in range(2):
        sharp = root / "test" / f"scene{s}"
        blur = root / "test_blur" / f"scene{s}"
        sharp.mkdir(parents=True)
        blur.mkdir(parents=True)
        for i in range(60):
            cv2.imwrite(str(sharp / f"{i:05d}.png"),
                        rng.randint(lo, hi, (h, w, 3), np.uint8))
        for k in range(5):  # 2 windows per scene
            cv2.imwrite(str(blur / f"{17 + 8 * k:05d}.png"),
                        rng.randint(lo, hi, (h, w, 3), np.uint8))


def dirs(root, sub):
    return dict(test_data_path=str(root), test_img_dir=str(root / sub / "imgs"),
                text_dir=str(root / sub / "text"),
                checkpoint_dir=str(root / sub / "ckpt"),
                log_dir=str(root / sub / "log"))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    write_tree(root, H, W)
    jmodel = jax_make_model(jax_config_rb(1, 1))
    params = jax_param_tree(jmodel, 7)
    model = make_model(config_rb(1, 1), device="cpu")
    model.load_state_dict(flax_params_to_state_dict(params), strict=True)
    return root, jmodel, params, model


@pytest.mark.parametrize("multiple", [2, 8])
def test_evaluate_matches_jax(setup, multiple):
    root, jmodel, params, model = setup
    jcfg = jax_config_rb(1, 1, **dirs(root, f"jax{multiple}"))
    cfg = config_rb(1, 1, device="cpu", **dirs(root, f"torch{multiple}"))
    want = jax_evaluate(jcfg, JaxEngine(jmodel, params, 1, fetch="images"),
                        multiple=multiple, epoch=3, post_fix="_t")
    engine = InferenceEngine(model, 1, fetch="images", device="cpu")
    got = evaluate(cfg, engine, multiple=multiple, epoch=3, post_fix="_t")
    assert engine.dispatched_windows == 4
    assert np.isfinite(got[:5]).all()
    assert got[0] == pytest.approx(want[0], rel=1e-5)          # loss
    assert got[1] == pytest.approx(want[1], abs=1e-3)          # intp PSNR
    assert got[2] == pytest.approx(want[2], abs=1e-4)          # intp SSIM
    assert got[3] == pytest.approx(want[3], abs=1e-3)          # deblur PSNR
    assert got[4] == pytest.approx(want[4], abs=1e-4)          # deblur SSIM
    assert os.path.relpath(got[5], cfg.test_img_dir) == \
        os.path.relpath(want[5], jcfg.test_img_dir)
    n_files = 0
    for scene in ("scene0", "scene1"):
        names = sorted(os.listdir(os.path.join(got[5], scene)))
        assert names == sorted(os.listdir(os.path.join(want[5], scene)))
        for name in names:
            a = cv2.imread(os.path.join(got[5], scene, name))
            b = cv2.imread(os.path.join(want[5], scene, name))
            far = np.abs(a.astype(int) - b.astype(int)) > 1
            assert far.mean() <= 0.02, (name, far.mean())
            n_files += 1
    # per scene: St of every instant, and S0/S1 of each window (the two
    # windows share one frame)
    assert n_files == 2 * (2 * (multiple - 1) + 3)


def test_window_batch_two_equals_one(setup):
    root, _, _, model = setup
    cfg = config_rb(1, 1, device="cpu", **dirs(root, "wb"))
    engine = InferenceEngine(model, 1, fetch="images", device="cpu")
    one = evaluate(cfg, engine, multiple=8, save_images=False)
    two = evaluate(cfg, engine, multiple=8, save_images=False, window_batch=2)
    assert engine.dispatched_windows == 8
    assert two[:5] == pytest.approx(one[:5], abs=1e-4)


def test_tiled_route_and_visualization(setup, capsys):
    """test_patch=(2,2) cannot be dispatched: the windows go through
    forward_window, and the result tables are printed all the same;
    visualization_flag writes one component grid per instant."""
    root, _, _, _ = setup
    cfg = config_rb(1, 1, device="cpu", visualization_flag=True,
                    patch_boundary=8, **dirs(root, "tiled"))
    model = make_model(cfg, device="cpu")
    engine = InferenceEngine(model, 1, device="cpu")
    out = evaluate(cfg, engine, multiple=2, epoch=0, test_patch=(2, 2))
    assert engine.dispatched_windows == 0 and np.isfinite(out[:5]).all()
    text = capsys.readouterr().out
    assert "x2 MFI results" in text
    assert text.count("[PSNR Stage") == 2 and text.count("[SSIM Stage") == 2
    assert "Average Inference Time per Window" in text
    stats = driver.last_eval_stats
    assert stats.windows == 4 and stats.dispatched == 0
    assert stats.stream_seconds == 0
    assert 0 < stats.decode + stats.metrics + stats.encode < stats.wall_seconds * 2
    grid = cv2.imread(os.path.join(out[5] + "_visualizations", "scene0",
                                   "00029.png"))
    assert grid.shape == (3 * H, 10 * W, 3)


def test_evaluate_refuses_what_it_does_not_do(setup):
    root, _, _, model = setup
    cfg = config_rb(1, 1, device="cpu", **dirs(root, "refuse"))
    engine = InferenceEngine(model, 1, device="cpu")
    # sharded by scenes across processes only inside their process group
    with pytest.raises(RuntimeError, match="process group"):
        evaluate(cfg, engine, multiple=8, shard=(0, 2))
    with pytest.raises(ValueError):
        evaluate(cfg, engine, multiple=4)


# ------------------------------------------------------------ accounting
D_ST, D_S0, D_S1 = 4.0, 8.0, 16.0  # [0,255]-scale offsets


def psnr_of(delta):
    return 20 * math.log10(255.0 / delta)


class StubEngine:
    """Returns GT minus fixed [0,255]-scale offsets, per output kind."""

    def __init__(self, cfg, multiple):
        self.ds = EvalDataset(cfg.test_data_path, multiple, cfg.t_step_size)
        self.w = 0

    def forward_window(self, frames, ts, **kw):
        _, s0_gt, s1_gt, sts_gt, _ = _load_window(self.ds, self.w)
        self.w += 1
        m = len(ts)
        st = np.stack([sts_gt[j] - D_ST / 127.5 for j in range(m)])
        s0 = np.broadcast_to(s0_gt - D_S0 / 127.5, st.shape).copy()
        s1 = np.broadcast_to(s1_gt - D_S1 / 127.5, st.shape).copy()
        z1 = np.zeros(st.shape[:3] + (1,), np.float32)
        z4 = np.zeros(st.shape[:3] + (4,), np.float32)
        return WindowResult(
            s0_prime=s0, s1_prime=s1, st_prime=st,
            s0_final=s0, s1_final=s1, st_final=st,
            flow_init=z4, flow_final=z4, occ0_init=z1, occ0_final=z1,
            ovlp=st, blend_w0=z1, blend_w1=z1, diff_10=z1, diff_01=z1)


@pytest.mark.parametrize("multiple", [8, 2])
def test_slot_accounting(tmp_path, multiple):
    """With outputs at known PSNR offsets from GT the meters reproduce
    the reference's accounting: interp slots per t-index, deblur updates
    at the t = 0.5 sample (x8: once per window; x2: every sample) plus
    the trailing S1 of each scene."""
    write_tree(tmp_path, 24, 32, 32, 224)
    cfg = config_rb(1, 1, device="cpu", **dirs(tmp_path, "acc"))
    loss, ip, _, dp, _ = evaluate(cfg, StubEngine(cfg, multiple),
                                  multiple=multiple, save_images=False)[:5]
    assert ip == pytest.approx(psnr_of(D_ST), abs=1e-4)
    want_dp = (4 * psnr_of(D_S0) + 2 * psnr_of(D_S1)) / 6
    assert dp == pytest.approx(want_dp, abs=1e-4)
    assert loss == pytest.approx(D_ST / 127.5, rel=1e-5)


# ---------------------------------------------------------------- custom
def write_clips(root, names):
    rng = np.random.RandomState(1)
    for name in names:
        (root / name).mkdir(parents=True)
        for i in range(5):
            cv2.imwrite(str(root / name / f"{i:05d}.png"),
                        rng.randint(0, 255, (H, W, 3), np.uint8))


def test_evaluate_custom_writes_the_files(setup, tmp_path):
    _, _, _, model = setup
    write_clips(tmp_path, ["clipA"])
    cfg = config_rb(1, 1, device="cpu", custom_path=str(tmp_path))
    evaluate_custom(cfg, InferenceEngine(model, 1, device="cpu"), multiple=4)
    out = sorted(os.listdir(tmp_path / "clipA_sharply_interpolated_x4"))
    # windows at idx 1, 2: S0, S1 per window + 3 St each
    assert out == ["00001.png", "00001_000.png", "00001_001.png",
                   "00001_002.png", "00002.png", "00002_000.png",
                   "00002_001.png", "00002_002.png", "00003.png"]


def test_evaluate_custom_scene_sharded(setup, tmp_path):
    """Two processes own disjoint scenes; their union is the unsharded
    output, file for file."""
    _, _, _, model = setup
    engine = InferenceEngine(model, 1, fetch="images", device="cpu")
    outs = {}
    for sub, shards in (("full", [(0, 1)]), ("part", [(0, 2), (1, 2)])):
        write_clips(tmp_path / sub, ["clipA", "clipB"])
        cfg = config_rb(1, 1, device="cpu", custom_path=str(tmp_path / sub))
        for s in shards:
            evaluate_custom(cfg, engine, multiple=4, shard=s)
        outs[sub] = tmp_path / sub
    for name in ("clipA", "clipB"):
        od = f"{name}_sharply_interpolated_x4"
        files = sorted(os.listdir(outs["full"] / od))
        assert files and files == sorted(os.listdir(outs["part"] / od))
        for f in files:
            assert (outs["full"] / od / f).read_bytes() == \
                (outs["part"] / od / f).read_bytes(), f


# -------------------------------------------------------- dispatch / fetch
@pytest.mark.parametrize("t_chunk,fetch,hw", [(None, "full", (32, 64)),
                                              (2, "images", (32, 64)),
                                              (None, "images", (24, 40))])
def test_dispatch_fetch_equals_forward_windows(setup, t_chunk, fetch, hw):
    """Bit for bit, with and without t-chunking and with frames that
    need the reflect pad."""
    _, _, _, model = setup
    frames = np.random.RandomState(11).uniform(
        -1, 1, (2, 4) + hw + (3,)).astype(np.float32)
    ts = np.tile(np.array([0.25, 0.5, 0.75], np.float32), (2, 1))
    engine = InferenceEngine(model, 1, t_chunk=t_chunk, fetch=fetch,
                             device="cpu")
    want = engine.forward_windows(frames, ts)
    handle = engine.dispatch_windows(frames, ts)
    assert handle is not None and engine.dispatched_windows == 2
    got = engine.fetch_windows(handle)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for name in FIELDS:
            assert getattr(g, name).shape == (3,) + hw + (
                getattr(w, name).shape[-1],), name
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name),
                                          err_msg=name)
