"""A whole run on the CPU at a tiny size, the look for a card skipped:
sound, it comes out correct; with the timed path broken underneath, or
with the lower-precision control in the program's place, it does not."""
import json
import time
from pathlib import Path

import pytest
import torch

from benchmark import faults, spec
from benchmark.harness import Run, verdict

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 17
# float32 serving (the published precision; on the CPU the program's
# plain path and the reference agree to rounding) is the serving cell's
# traffic on the rb53-f32 configuration, held to the limit that its chip
# readings support (PERF.md, section 7)
F32_SERVE = "rb53-f32.serve"
F32_SERVE_LIMITS = {"final_rel_rms": {"limit": 2.5e-3}}
SERVE_CELLS = [F32_SERVE, "rb53-bf16.serve-sd"]


def _cell(name):
    if name == F32_SERVE:
        cell = _cell("rb53-bf16.serve-sd")
        with open(ROOT / "benchmark" / "configs" / "rb53-f32.json") as f:
            cell.config = json.load(f)
        cell.name, cell.limits = name, F32_SERVE_LIMITS
        return cell
    cell = spec.find_cell(spec.load(ROOT / "BENCHMARK.json"), name,
                          ROOT / "benchmark")
    if cell.traffic["kind"] == "serve_stream":
        cell.traffic.update(height=40, width=72, clip_windows=4,
                            warmup_windows=1, check_windows=2)
    else:
        cell.traffic.update(size=32, samples=10, warmup_steps=1)
    return cell


def _run(cell, plant=None):
    run = Run(cell=cell, seed=SEED, seconds=0.5, traced=False,
              device=torch.device("cpu"), started=time.perf_counter(),
              plant=plant)
    m = cell.driver().measure(run)
    return verdict(m.numbers, cell.limits)[0], m


@pytest.mark.parametrize("name", SERVE_CELLS)
def test_sound_serving_run_is_correct(name):
    ok, m = _run(_cell(name))
    assert ok, m.numbers
    assert m.attempted >= 1 and m.end_to_end["interp_fps"] > 0


@pytest.mark.parametrize("name", SERVE_CELLS)
@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_is_caught(fault, name):
    ok, m = _run(_cell(name), faults.SERVE[fault])
    assert not ok, m.numbers


def test_sound_training_run_is_correct():
    ok, m = _run(_cell("rb53-f32.train"))
    assert ok, m.numbers
    assert m.end_to_end["train_samples_s"] > 0


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_training_fault_is_caught(fault):
    ok, m = _run(_cell("rb53-f32.train"), faults.TRAIN[fault])
    assert not ok, m.numbers


@pytest.mark.parametrize("name", [F32_SERVE, "rb53-bf16.serve-sd"])
def test_serving_control_is_caught(name):
    """The reference at the precision below the configuration's (TF32
    for float32, fp8 for bfloat16) in the program's place."""
    from benchmark import readings
    cell = _cell(name)
    drv = cell.driver()
    numbers, _ = readings.serve_reading(
        drv, cell, SEED, torch.device("cpu"),
        readings.CONTROL[cell.config["compute_dtype"]])
    assert not verdict(numbers, cell.limits)[0], numbers


def test_training_control_is_caught():
    from benchmark import readings
    cell = _cell("rb53-f32.train")
    numbers, _ = readings.train_reading(cell.driver(), cell, SEED,
                                        torch.device("cpu"), "tf32")
    assert not verdict(numbers, cell.limits)[0], numbers
