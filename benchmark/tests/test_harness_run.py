"""The result's line, and what the benchmark may import."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import run, spec
from benchmark.harness import Measured
from benchmark.trace import DeviceTrace, Spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
JAX_SIDE = {"jax", "jaxlib", "flax", "demfi_tpu"}


def _measured(kind="serve"):
    spans = Spans(False)
    spans.seconds["dispatch"] = [0.010, 0.012]
    trace = DeviceTrace(window_s=2.0, busy_s=1.5,
                        by_name={"bilinear_gather_kernel<3, float>": 0.01,
                                 "cudnn_conv": 0.9},
                        conv_s=0.9, gaps=[("fetch", 0.2)])
    return Measured(kind=kind, attempted=9, failed=0, peak_bytes=3 * 2 ** 30,
                    end_to_end={"interp_fps": 30.5, "window_p90_ms": 420.0,
                                "peak_mem_gib": 3.0, "setup_s": 12.0},
                    numbers={"final_rel_rms": 0.01, "prime_rel_rms": 0.02,
                             "final_rel_max": 0.1},
                    spans=spans, units=8, trace=trace, flops_per_unit=10 ** 12,
                    peak_flops=989e12, hbm_bytes_s=3.35e12,
                    gather_bytes_per_unit=10 ** 6)


def test_result_line_shape():
    cell = spec.find_cell(spec.load(ROOT / "BENCHMARK.json"),
                          "rb53-bf16.serve-sd", BENCH)
    m = _measured()
    out = run.result(cell, m, False, "NVIDIA H100 80GB HBM3")
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(out["metrics"]) == {"interp_fps", "window_p90_ms",
                                   "peak_mem_gib", "setup_s"}
    assert out["metrics"]["interp_fps"] == {"value": 30.5,
                                            "unit": "frames/s"}
    assert out["device"] == {"platform": "gpu",
                             "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                             "memory_peak_bytes": 3 * 2 ** 30}
    assert set(out["checks"]) == set(cell.limits)
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)

    traced = run.result(cell, m, True, "NVIDIA H100 80GB HBM3")
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert traced["device"]["busy_s"] == 1.5
    assert traced["device"]["window_s"] == 2.0
    assert set(traced["metrics"]) == {
        "enqueue_ms.serve", "conv_ms.serve", "gather_roofline.serve",
        "mfu.serve", "idle_pct.serve"}
    assert abs(traced["metrics"]["idle_pct.serve"]["value"] - 25.0) < 1e-9
    assert abs(traced["metrics"]["enqueue_ms.serve"]["value"] - 11.0) < 1e-9
    assert traced["breakdown"]["idle_gaps"] == [["fetch", 0.2]]


def test_the_keeper_holds_k_windows_drawn_from_the_seed():
    import numpy as np

    from benchmark.drivers.serve_stream import FIELDS, Keeper

    class Window:
        def __init__(self, i):
            for f in FIELDS:
                setattr(self, f, np.full((1, 2, 2, 3), i, np.float32))

    def kept(k, n, seed):
        keeper = Keeper(k, 1, 2, 2, seed)
        for i in range(n):
            keeper.offer(i, Window(i))
        assert [int(o["st_final"][0, 0, 0, 0])
                for o in keeper.out[:len(keeper.index)]] == keeper.index
        return keeper.index
    assert kept(3, 2, 7) == [0, 1]
    assert all(len(kept(k, 171, s)) == k for k in (2, 3) for s in range(20))
    assert kept(3, 171, 2 ** 31 + 5) == kept(3, 171, 2 ** 31 + 5)
    # every window has its chance: the sample reaches past the first ones
    assert max(max(kept(2, 43, s)) for s in range(20)) > 30


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    cell = spec.find_cell(spec.load(ROOT / "BENCHMARK.json"),
                          "rb53-bf16.serve-hd", BENCH)
    m = _measured()
    m.trace = None
    m.spans.seconds.clear()
    assert run.result(cell, m, True, "x")["metrics"] == {}


def _imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not \
                node.level:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_the_jax_side_and_the_reference_not_the_program():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not (_imports(p) & JAX_SIDE), p
    for p in (BENCH / "reference").rglob("*.py"):
        assert "demfi_torch" not in _imports(p), p
        assert "jax" not in p.read_text()
    # top-level names are compared whole: the port's name starts with
    # the JAX package's prefix and is allowed
    assert "demfi_torch" not in JAX_SIDE and "demfi_torch"[:5] == "demfi"


def test_a_run_process_loads_nothing_of_the_jax_side():
    code = ("import sys; import benchmark.run as r, benchmark.readings, "
            "benchmark.faults; from benchmark import spec; "
            "from pathlib import Path; root = Path('benchmark').resolve(); "
            "b = spec.load(root.parent / 'BENCHMARK.json'); "
            "[spec.find_cell(b, w['name'], root).driver() for w in "
            "b['workloads']]; import demfi_torch.infer, demfi_torch.train; "
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "rb53-bf16.serve-sd", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
