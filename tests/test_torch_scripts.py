"""The port's harnesses against the JAX package's, on the CPU.

``demfi_torch.scripts.repro_table2`` on the fixture of
tests/test_repro_harness.py (random DeMFI-Net_rb(1,1) weights in a
reference-format .pt, ``--budget_db inf``): the report's PSNRs within
1e-3 dB of the JAX harness's and its SSIMs within 1e-5 (float32, two
frameworks that sum convolutions in different orders), the same
dataset_info, rows' verdicts and pass; the preflight's messages as
JAX's. ``synthetic_sanity``'s numpy generator against the JAX script's
OpenCV one: the same files, each pixel within 2 uint8 levels and the
mean absolute difference within 0.5 level (the box blurs sum in another
order, and a value within rounding of an integer truncates to either
side; OpenCV 4's warpAffine would round positions to 1/32 pixel, the
OpenCV here does not). ``--steps 2`` runs to its verdict on a smaller
tree of the same generator. ``iter_eval``
yields JAX's order; ``device_trace`` writes a trace.
"""
import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.data import EvalDataset as JaxEvalDataset
from demfi_tpu.data.pipeline import iter_eval as jax_iter_eval
from demfi_torch.config import config_rb
from demfi_torch.data import EvalDataset, imageio, iter_eval
from demfi_torch.scripts import repro_table2, synthetic_sanity
from demfi_torch.utils.profiling import device_trace

from test_repro_harness import fixture_tree  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _harness_args(root, pt, wd, budget="inf"):
    return ["--data", root, "--ckpt", pt, "--N_tst", "1", "--multiples",
            "2", "--budget_db", budget, "--workdir", str(wd)]


def test_repro_report_equals_jax(fixture_tree, tmp_path):  # noqa: F811
    import repro_table2 as jax_harness

    root, pt = fixture_tree
    assert jax_harness.main(_harness_args(root, pt, tmp_path / "jwd") + [
        "--out", str(tmp_path / "jax.json")]) == 0
    assert repro_table2.main(_harness_args(root, pt, tmp_path / "pwd") + [
        "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    # the default report lies under the work directory
    got = json.loads((tmp_path / "pwd" / "repro_table2.json").read_text())
    assert set(got) == set(want)
    for k in ("dataset", "N_tst", "dtype", "budget_db", "dataset_info",
              "pass"):
        assert got[k] == want[k], k
    g, w = got["results"]["x2"], want["results"]["x2"]
    for k in ("interp_psnr", "deblur_psnr"):
        assert abs(g[k] - w[k]) <= 1e-3, (k, g[k], w[k])
    for k in ("interp_ssim", "deblur_ssim"):
        assert abs(g[k] - w[k]) <= 1e-5, (k, g[k], w[k])
    assert [(r[0], r[-1]) for r in got["rows"]] == [
        (r[0], r[-1]) for r in want["rows"]]
    # a tight budget against random weights fails, as JAX's does
    assert repro_table2.main(_harness_args(root, pt, tmp_path / "pwd2",
                                           "0.05") + ["--device", "cpu"]) == 1


def test_preflight_messages_equal_jax(fixture_tree, tmp_path):  # noqa: F811
    import repro_table2 as jax_harness

    root, pt = fixture_tree
    with pytest.raises(SystemExit) as want:
        jax_harness.preflight_dataset(str(tmp_path / "nope"))
    with pytest.raises(SystemExit) as got:
        repro_table2.preflight_dataset(str(tmp_path / "nope"))
    assert str(got.value) == str(want.value)
    assert "missing directory" in str(got.value)
    assert repro_table2.preflight_dataset(root) == \
        jax_harness.preflight_dataset(root)

    # the checkpoint of nf 64 against a model of nf 32: the same kinds of
    # lines, as many of each
    with pytest.raises(SystemExit) as want:
        jax_harness.preflight_checkpoint(pt, jax_config_rb(1, 1, nf=32))
    with pytest.raises(SystemExit) as got:
        repro_table2.preflight_checkpoint(pt, config_rb(1, 1, nf=32))
    gl, wl = str(got.value).splitlines(), str(want.value).splitlines()
    assert gl[0] == wl[0]
    assert [ln.split()[0] for ln in gl[1:]] == [ln.split()[0]
                                               for ln in wl[1:]]
    assert all(ln.startswith("  shape ") and ": ckpt (" in ln
               and ") != model (" in ln for ln in gl[1:])
    # an experiment directory without its latest checkpoint
    with pytest.raises(SystemExit, match="no checkpoint file"):
        repro_table2.preflight_checkpoint(str(tmp_path), config_rb(1, 1))


def test_sanity_generator_close_to_jax(tmp_path):
    pytest.importorskip("cv2")
    import synthetic_sanity as jax_sanity

    jax_sanity.make_dataset(str(tmp_path / "jax"))
    synthetic_sanity.make_dataset(str(tmp_path / "port"))

    def pngs(d):
        return sorted(os.path.relpath(p, d) for p in glob.glob(
            os.path.join(d, "**", "*.png"), recursive=True))
    names = pngs(str(tmp_path / "jax"))
    assert names == pngs(str(tmp_path / "port")) and len(names) == 396
    total, count = 0.0, 0
    for n in names:
        a = imageio.imread(str(tmp_path / "jax" / n)).astype(np.int16)
        b = imageio.imread(str(tmp_path / "port" / n)).astype(np.int16)
        d = np.abs(a - b)
        assert d.max() <= 2, (n, d.max())
        total += float(d.sum())
        count += d.size
    assert total / count <= 0.5


def test_sanity_runs_to_its_verdict(tmp_path, capsys):
    # 2 scenes a split of 50 sharp frames: one batch an epoch, 2
    # evaluation windows
    synthetic_sanity.make_dataset(str(tmp_path), n_sharp=50)
    rc = synthetic_sanity.main(["--steps", "2", "--root", str(tmp_path),
                                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "untrained: interp" in out and "trained(2 steps): interp" in out
    verdict = [ln for ln in out.splitlines() if ln.startswith("SANITY ")]
    assert verdict in (["SANITY PASS"], ["SANITY FAIL"])
    assert rc == (0 if verdict == ["SANITY PASS"] else 1)


def test_iter_eval_order_equals_jax(fixture_tree):  # noqa: F811
    root, _ = fixture_tree
    got = list(iter_eval(EvalDataset(root, 2), prefetch=2))
    want = list(jax_iter_eval(JaxEvalDataset(root, 2)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


def test_iter_eval_raises_a_failed_load(fixture_tree):  # noqa: F811
    root, _ = fixture_tree
    ds = EvalDataset(root, 2)
    ds.items[2].st_path += ".missing"
    it = iter_eval(ds)
    assert next(it)["scene"] == "scene_a" and next(it)
    with pytest.raises(FileNotFoundError):
        next(it)


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                                   torch.ones(4, 3, 3, 3)).sum()
    files = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    events = json.loads(open(files[0]).read())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    assert any("conv" in e.key for e in prof.key_averages())
