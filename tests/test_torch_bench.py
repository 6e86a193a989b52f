"""``python -m demfi_torch.bench`` (the port's counterpart of the root
``bench.py``) on the CPU.

(1) The contract of tests/test_bench_contract.py on ``--cpu --no_probe``
    at DEMFI_BENCH_TINY=1 (64x64, one window): one JSON record on success
    and on every failure class, exit 0 after a success and 1 after a
    failure record. The success record comes from a real subprocess with
    jax, flax and demfi_tpu blocked; the failure classes and the chunk
    shapes call ``main(argv)`` in process.
(2) The bench's window against JAX's ``extract`` + ``synthesize`` summed as
    ``bench.py`` sums them, DeMFI-Net_rb(5,3) at full width on JAX's
    parameters (from a numpy seed, carried across by the port's
    converter), 64x64 frames from RandomState(0), each side's flow head
    calibrated to 24 px by its own ``calibrate_flow_head``: at float32
    the full t-batch, chunk 1, chunk 3 and two windows within 1e-5
    (relative) of JAX's full batch; at bfloat16 each summed field by its
    moments (mean and std within 0.08 of JAX's std); the calibration's
    raw peak within 1e-4 and the scaled head within 1e-6 of JAX's.
(3) The record's arithmetic at 352x640 and 720x1280.
(4) No silent CPU: without ``--cpu`` and with no card, a
    ``gpu-unavailable`` record and exit 1.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demfi_tpu.config import config_rb as jax_config_rb
from demfi_tpu.models import make_model as jax_make_model
from demfi_tpu.utils.profiling import calibrate_flow_head as jax_calibrate
from demfi_torch import bench
from demfi_torch.checkpoint import flax_params_to_state_dict
from demfi_torch.config import config_rb
from demfi_torch.models import make_model
from demfi_torch.utils.profiling import calibrate_flow_head

from test_torch_model import jax_param_tree

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "demfi_tpu", "msgpack")
TINY = 64                   # DEMFI_BENCH_TINY's geometry
RTOL = 1e-5                 # float32 checksum against JAX's
MOMENTS = 0.08              # bfloat16 fields: of JAX's std
RAW_RTOL = 1e-4             # the calibration's raw peak
HEAD_RTOL = 1e-6            # the calibrated head's weights


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------ (1) contract
def _record(text: str) -> dict:
    lines = [ln for ln in text.strip().splitlines() if ln.startswith("{")]
    assert len(lines) == 1, text
    return json.loads(lines[0])


def _main(monkeypatch, capsys, argv, inject=""):
    """``main(argv)`` at the tiny geometry: (exit code, record)."""
    monkeypatch.setenv("DEMFI_BENCH_TINY", "1")
    monkeypatch.setenv("DEMFI_BENCH_FAIL_INJECT", inject)
    rc = bench.main(["--cpu", "--no_probe"] + argv)
    return rc, _record(capsys.readouterr().out)


def test_success_record_without_jax():
    """``python -m demfi_torch.bench --cpu --no_probe`` as users run it,
    with jax, flax and demfi_tpu blocked in the child."""
    code = ("import sys, runpy\n"
            "for m in %r: sys.modules[m] = None\n"
            "sys.argv = ['demfi_torch.bench', '--cpu', '--no_probe']\n"
            "runpy.run_module('demfi_torch.bench', run_name='__main__')\n"
            % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(ROOT), DEMFI_BENCH_TINY="1",
               OMP_NUM_THREADS="1")
    env.pop("DEMFI_BENCH_FAIL_INJECT", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = _record(r.stdout)
    assert rec["unit"] == "frames/s"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert "error" not in rec
    assert "CPU (not a GPU number)" in rec["metric"]
    assert f"({TINY}x{TINY}, N_tst=3, bfloat16, wb=1, " in rec["metric"]
    assert "calibrated-motion" in rec["metric"]
    assert rec["flow_calibration"] == "target 24 px"
    assert rec["raw_init_max_flow_px"] > 24


def test_oom_retries_one_instant_a_call(monkeypatch, capsys):
    rc, rec = _main(monkeypatch, capsys, [], "oom")
    assert rc == 1
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert rec["error_kind"] == "oom"
    assert "out of memory" in rec["error"] and "injected" in rec["error"]
    assert rec["retries"] == ["oom->t_map"]


def test_nonfinite_checksum_is_a_failure_record(monkeypatch, capsys):
    rc, rec = _main(monkeypatch, capsys, [], "nan")
    assert rc == 1
    assert rec["value"] == 0.0
    assert rec["error_kind"] == "nonfinite-checksum"
    assert "retries" not in rec


def test_generic_exception_is_a_failure_record(monkeypatch, capsys):
    rc, rec = _main(monkeypatch, capsys, [], "generic")
    assert rc == 1
    assert rec["value"] == 0.0
    assert rec["error_kind"] == "ValueError"
    assert "injected generic failure" in rec["error"]


@pytest.mark.parametrize("t_chunk,marker", [(1, "t_map"), (3, "t_chunk=3")])
def test_chunk_shapes_run_and_label(monkeypatch, capsys, t_chunk, marker):
    rc, rec = _main(monkeypatch, capsys, ["--t_chunk", str(t_chunk)])
    assert rc == 0, rec
    assert rec["value"] > 0
    assert marker in rec["metric"]


def test_error_kinds():
    """Build and launch failures keep their kind though their text names
    memory; an OutOfMemoryError is one by its type."""
    build = RuntimeError("kernel build failed:\nptxas: out of memory")
    launch = RuntimeError("bilinear_gather: CUDA launch failed with "
                          "cudaError 2")
    assert bench._error_kind(build) == "kernel-build"
    assert bench._error_kind(launch) == "cuda"
    assert bench._error_kind(RuntimeError("CUDA error: an illegal memory "
                                          "access was encountered")) == "cuda"
    assert bench._error_kind(torch.OutOfMemoryError("x")) == "oom"
    assert bench._error_kind(RuntimeError("DefaultCPUAllocator: not enough "
                                          "memory: you tried to allocate; "
                                          "out of memory")) == "oom"
    assert bench._error_kind(KeyError("boom")) == "KeyError"


# ------------------------------------------------- (2) the slice against JAX
def _jax_fields(jmodel, params, frames: np.ndarray):
    """JAX's window as ``bench.py`` runs it: extract, the context repeated
    7 times per window, one synthesize (jitted: its compile takes less
    time than eager dispatch); the four summed fields as float64 numpy,
    batch first ([wb*7, H, W, 3])."""
    def window(params, x, t):
        ctx = jmodel.apply(params, x, method=jmodel.extract)
        cc = jax.tree_util.tree_map(
            lambda v: jnp.repeat(v, bench.N_T, axis=0), ctx)
        out = jmodel.apply(params, cc, t, 3, method=jmodel.synthesize)
        return dict(st_final=out.st_final[-1], s0_final=out.s0_final[-1],
                    s1_final=out.s1_final[-1], st_prime=out.st_prime)
    t = jnp.tile(jnp.asarray(bench.TS), frames.shape[0])[:, None]
    fields = jax.jit(window)(params, jnp.asarray(frames), t)
    return {k: np.asarray(v.astype(jnp.float32), np.float64)
            for k, v in fields.items()}


def _port_model(dtype: str, state_dict) -> torch.nn.Module:
    model = make_model(config_rb(5, 3, compute_dtype=dtype), device="cpu")
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def slice_setup():
    """JAX's DeMFI-Net_rb(5,3) parameters, both calibrations on the first
    of two bench windows (JAX's reads ``frames[:1]`` of what it is given,
    the port's every window, so the bench passes it the first), JAX's
    float32 fields of both windows and bfloat16 fields of the first, and
    the port's calibrated float32 model."""
    frames, frames_t = bench.bench_frames(2, TINY, TINY, "cpu")
    cfg = dict(compute_dtype="float32", scan_booster=False)
    jmodel = jax_make_model(jax_config_rb(5, 3, **cfg))
    params = jax.tree_util.tree_map(jnp.asarray, jax_param_tree(
        jmodel, jnp.asarray(frames[:1]), jnp.full((1, 1), 0.5), 5))
    jparams, jraw = jax_calibrate(params, jmodel, jnp.asarray(frames))
    model = _port_model("float32", flax_params_to_state_dict(params))
    raw = calibrate_flow_head(model, frames_t[:1])     # as the bench calls it
    jmodel16 = jax_make_model(jax_config_rb(
        5, 3, **dict(cfg, compute_dtype="bfloat16")))
    return dict(frames=frames, frames_t=frames_t, jraw=jraw, raw=raw,
                jparams=jparams, model=model,
                jax32=_jax_fields(jmodel, jparams, frames),
                jax16=_jax_fields(jmodel16, jparams, frames[:1]))


@pytest.mark.parametrize("wb,chunk", [(1, None), (1, 1), (1, 3), (2, None)],
                         ids=["full", "t_map", "t_chunk3", "wb2"])
def test_window_checksum_equals_jax(slice_setup, wb, chunk):
    s = slice_setup
    ts = torch.from_numpy(bench.TS)
    got = float(bench.window_checksum(s["model"], s["frames_t"][:wb], ts, 3,
                                      chunk))
    want = sum(float(v[:wb * bench.N_T].sum()) for v in s["jax32"].values())
    assert abs(got - want) <= RTOL * abs(want), (got, want)


def test_window_at_bf16_moments_equal_jax(slice_setup, monkeypatch):
    """The bench's bfloat16 window: each summed field, caught where the
    bench sums it, by its moments against JAX's bfloat16 field; the
    checksum is the float32 sum of exactly those fields."""
    s = slice_setup
    model16 = _port_model("bfloat16", s["model"].state_dict())
    seen = []
    plain = bench.checksum

    def spy(out):
        seen.append(out)
        return plain(out)
    monkeypatch.setattr(bench, "checksum", spy)
    got = float(bench.window_checksum(model16, s["frames_t"][:1],
                                      torch.from_numpy(bench.TS), 3))
    (out,) = seen
    fields = dict(st_final=out.st_final[-1], s0_final=out.s0_final[-1],
                  s1_final=out.s1_final[-1], st_prime=out.st_prime)
    assert all(v.dtype == torch.bfloat16 for v in fields.values())
    total = sum(float(v.sum(dtype=torch.float32)) for v in fields.values())
    assert abs(got - total) <= 1e-6 * sum(
        float(v.float().abs().sum()) for v in fields.values())
    for name, v in fields.items():
        mine = v.float().permute(0, 2, 3, 1).numpy().astype(np.float64)
        want = s["jax16"][name]
        assert mine.shape == want.shape, name
        assert np.isfinite(mine).all(), name
        sd = want.std()
        assert abs(mine.mean() - want.mean()) <= MOMENTS * sd, name
        assert abs(mine.std() - sd) <= MOMENTS * sd, name


def test_calibration_equals_jax(slice_setup):
    """The port's calibrate_flow_head on JAX's weights and the bench's
    frames: JAX's raw peak, and its scaled flow head."""
    s = slice_setup
    assert s["raw"] > 24
    assert abs(s["raw"] - s["jraw"]) <= RAW_RTOL * s["jraw"]
    want = flax_params_to_state_dict(s["jparams"])
    mine = s["model"].state_dict()
    for k in ("FF_RDB_Module.UPNet.2.weight", "FF_RDB_Module.UPNet.2.bias"):
        w = want[k].numpy() if hasattr(want[k], "numpy") else np.asarray(
            want[k])
        np.testing.assert_allclose(mine[k].numpy(), w, rtol=HEAD_RTOL,
                                   atol=HEAD_RTOL * np.abs(w).max(),
                                   err_msg=k)


# ------------------------------------------------- (3) the record's arithmetic
@pytest.mark.parametrize("h,w,scale", [(352, 640, 1.0),
                                       (720, 1280, 720 * 1280 / (352 * 640))])
def test_record_arithmetic(h, w, scale):
    args = bench.parse_args(["--dtype", "float32"])
    dt = 0.125                           # seconds a window
    rec = bench._record(args, h, w, 1, dt, "device (x)")
    fps = 7 / dt
    assert rec["value"] == round(fps, 3)
    baseline = 1 / (0.61 * scale)        # 1.639 frames/s at 352x640
    assert rec["vs_baseline"] == round(fps / baseline, 2)
    if scale == 1.0:
        assert round(baseline, 3) == 1.639 and rec["vs_baseline"] == 34.16
        assert "pixel-scaled" not in rec["metric"]
    else:
        assert "baseline Rt pixel-scaled from 640x352" in rec["metric"]
    assert rec["metric"].startswith(
        f"x8 MFI interp frames/sec/chip ({h}x{w}, N_tst=3, float32, wb=1, "
        "device (x)")
    two = bench._record(args, h, w, 2, dt, "m")
    assert two["value"] == round(2 * fps, 3)


# ------------------------------------------------------- (4) no silent CPU
def test_no_cpu_run_without_cpu_flag(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    rc = bench.main(["--no_probe"])
    rec = _record(capsys.readouterr().out)
    assert rc == 1
    assert rec["error_kind"] == "gpu-unavailable" and rec["value"] == 0.0
