"""The port's command line against the JAX package's, on the CPU: the
flag surface of the evaluation phases, and ``cli`` end to end on a tiny
dataset with checkpoints in each ``.pt`` layout."""
import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from demfi_tpu.main import parse_args as jax_parse_args
from demfi_tpu.main import str2bool as jax_str2bool
from demfi_torch.checkpoint import (checkpoint_path, eval_checkpoint_tag,
                                    load_checkpoint, save_checkpoint)
from demfi_torch.config import DeMFIConfig, config_rb
from demfi_torch.main import cli, parse_args, str2bool
from demfi_torch.models import make_model

SMALL = ["--N_trn", "1", "--N_tst", "1", "--nf", "16", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def shared_fields():
    import demfi_tpu.config as jc
    names = {f.name for f in dataclasses.fields(jc.DeMFIConfig)}
    return sorted(names & {f.name for f in dataclasses.fields(DeMFIConfig)})


@pytest.mark.parametrize("argv", [
    [],
    ["--phase", "test", "--multiple_MFI", "8", "--test_patch", "2", "2",
     "--exp_num", "3"],
    ["--phase", "test_custom", "--custom_path", "/data/clips",
     "--multiple_MFI", "4", "--visualization_flag", "--load_best_PSNR_flag",
     "--shared_FGAC_flag", "false", "--compute_tOF", "--t_chunk", "3",
     "--eval_window_batch", "2", "--test_epoch_point", "100",
     "--loss_type", "MSE", "--N_tst", "5", "--gpu", "1"],
])
def test_parse_args_equals_jax_on_shared_fields(argv):
    got, want = parse_args(argv), jax_parse_args(argv)
    fields = shared_fields()
    assert len(fields) >= 30
    for name in fields:
        assert getattr(got, name) == getattr(want, name), name
    assert got.model_dir == want.model_dir


def test_port_flags_and_bools():
    cfg = parse_args([])
    assert cfg.device == "cuda" and cfg.fwarp_shift_d == 0
    cfg = parse_args(["--device", "cpu", "--fwarp_shift_d", "8"])
    assert cfg.device == "cpu" and cfg.fwarp_shift_d == 8
    for v in ("yes", "True", "t", "1", "no", "FALSE", "f", "0", True, False):
        assert str2bool(v) == jax_str2bool(v)
    with pytest.raises(Exception):
        str2bool("maybe")
    for bad in (["--img_ch", "1"], ["--fwarp_shift_d", "-1"],
                ["--phase", "serve"]):
        with pytest.raises(SystemExit):
            parse_args(bad)


def test_checkpoint_paths():
    cfg = DeMFIConfig(checkpoint_dir="/c", exp_num=2)
    assert eval_checkpoint_tag(cfg) == "latest"
    assert checkpoint_path(cfg, "latest") == \
        "/c/DeMFInet_exp2/DeMFInet_exp2_latest.pt"
    assert eval_checkpoint_tag(dataclasses.replace(
        cfg, load_best_PSNR_flag=True)) == "best_PSNR"
    # --test_epoch_point N loads the save of epoch N - 1, as the reference
    assert eval_checkpoint_tag(dataclasses.replace(
        cfg, test_epoch_point=50, load_best_PSNR_flag=True)) == "epc49"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.RandomState(0)
    sharp = root / "data" / "test" / "scene0"
    blur = root / "data" / "test_blur" / "scene0"
    clip = root / "clips" / "clipA"
    for d in (sharp, blur, clip):
        d.mkdir(parents=True)
    for i in range(16, 50):
        cv2.imwrite(str(sharp / f"{i:05d}.png"),
                    rng.randint(0, 255, (32, 32, 3), np.uint8))
    for k in range(4):      # one window
        cv2.imwrite(str(blur / f"{17 + 8 * k:05d}.png"),
                    rng.randint(0, 255, (32, 32, 3), np.uint8))
    for i in range(4):
        cv2.imwrite(str(clip / f"{i:05d}.png"),
                    rng.randint(0, 255, (32, 32, 3), np.uint8))
    model = make_model(config_rb(1, 1, nf=16, seed=5), device="cpu")
    return root, model.state_dict()


def dirs(root, sub):
    return ["--test_data_path", str(root / "data"),
            "--test_img_dir", str(root / sub / "imgs"),
            "--checkpoint_dir", str(root / sub / "ckpt")]


@pytest.fixture(scope="module")
def numbers_of_the_model(tree):
    """evaluate's five numbers for the fixture's weights, without a
    checkpoint file in between."""
    from demfi_torch.infer import InferenceEngine
    from demfi_torch.infer.driver import evaluate
    root, sd = tree
    cfg = config_rb(1, 1, nf=16, device="cpu",
                    test_data_path=str(root / "data"),
                    test_img_dir=str(root / "direct" / "imgs"))
    model = make_model(cfg, device="cpu")
    model.load_state_dict(sd, strict=True)
    engine = InferenceEngine(model, 1, fetch="images", device="cpu")
    return evaluate(cfg, engine, multiple=2, save_images=False)[:5]


@pytest.mark.parametrize("layout", ["save_checkpoint", "combined", "bare"])
def test_cli_test_phase_loads_each_layout(tree, numbers_of_the_model, layout,
                                          capsys):
    root, sd = tree
    cfg = DeMFIConfig(checkpoint_dir=str(root / layout / "ckpt"))
    path = checkpoint_path(cfg, "latest")
    if layout == "save_checkpoint":
        save_checkpoint(path, sd, {"last_epoch": 7, "best_PSNR": 30.5})
    else:
        os.makedirs(os.path.dirname(path))
        torch.save(sd if layout == "bare" else {
            "last_epoch": 7, "best_PSNR": np.float64(30.5),
            "state_dict_Model": sd,
            "state_dict_Optimizer": {"state": {}, "param_groups": []},
            "state_dict_Scheduler": {"last_epoch": 7}}, path)
    loaded, meta = load_checkpoint(path)
    assert loaded.keys() == sd.keys()
    assert meta == ({} if layout == "bare"
                    else {"last_epoch": 7, "best_PSNR": 30.5})
    out = cli(["--phase", "test", "--multiple_MFI", "2", *SMALL,
               *dirs(root, layout)])
    assert np.isfinite(out[:5]).all()
    text = capsys.readouterr().out
    assert "# fwarp_shift_d : 0" in text and "x2 MFI results" in text
    assert f"epoch: {'?' if layout == 'bare' else 7}" in text
    assert sorted(os.listdir(os.path.join(out[5], "scene0"))) == \
        ["00025.png", "00029.png", "00033.png"]
    # the loaded weights are the saved ones, whatever the layout
    assert out[:5] == numbers_of_the_model


def test_cli_with_shift_window_and_custom_phase(tree, capsys):
    root, sd = tree
    save_checkpoint(checkpoint_path(DeMFIConfig(
        checkpoint_dir=str(root / "shift" / "ckpt")), "latest"), sd)
    args = [*SMALL, *dirs(root, "shift"), "--fwarp_shift_d", "8"]
    a = cli(["--phase", "test", "--multiple_MFI", "2", *args])
    b = cli(["--phase", "test", "--multiple_MFI", "2", *args])
    assert a == b and np.isfinite(a[:5]).all()
    assert cli(["--phase", "test_custom", "--multiple_MFI", "4",
                "--custom_path", str(root / "clips"), *args]) is None
    assert sorted(os.listdir(
        root / "clips" / "clipA_sharply_interpolated_x4")) == [
        "00001.png", "00001_000.png", "00001_001.png", "00001_002.png",
        "00002.png"]
    assert "png for predicted St frame" in capsys.readouterr().out


def test_cli_refuses(tree, capsys):
    root, sd = tree
    save_checkpoint(checkpoint_path(DeMFIConfig(
        checkpoint_dir=str(root / "refuse" / "ckpt")), "latest"), sd)
    # training runs (tests/test_torch_train.py), on one process or more
    # (tests/test_torch_parallel.py); the JAX package's mesh flags are
    # accepted in every phase, and --mesh_spatial 2 needs two processes
    # (tests/test_torch_spatial.py and, for training,
    # tests/test_torch_spatial_train.py run them)
    for phase in ("test", "train"):
        cfg = parse_args(["--phase", phase, "--device", "cpu",
                          "--mesh_spatial", "2", "--mesh_data", "1"])
        assert (cfg.mesh_spatial, cfg.mesh_data) == (2, 1)
    with pytest.raises(ValueError, match="--mesh_spatial 2 splits rows "
                                         "across 2 processes of one data "
                                         "group, but the run has 1 process"):
        cli(["--phase", "test", "--mesh_spatial", "2", *SMALL,
             *dirs(root, "refuse")])
    if not torch.cuda.is_available():
        # no card and no --device cpu: the run fails, it does not carry on
        with pytest.raises(RuntimeError, match="CUDA"):
            cli(["--phase", "test", *dirs(root, "refuse")])
    with pytest.raises(FileNotFoundError):
        cli(["--phase", "test", *SMALL, *dirs(root, "nowhere")])
    with pytest.raises(RuntimeError):       # other widths: strict load
        cli(["--phase", "test", "--N_trn", "1", "--N_tst", "1", "--nf", "8",
             "--device", "cpu", *dirs(root, "refuse")])
