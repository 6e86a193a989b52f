"""The readings that the limits of ``correct`` are set from, at a cell's
own sizes on the card (``benchmark/limits/<cell>.json`` keeps them):

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,...
        [--control-seeds a,b,c] [--fault-seeds a,b,c]

One JSON line a reading. ``program``: the timed path as a run drives it
(the engine's pipelined windows, or the train state's first steps),
compared as a run compares it. ``control``: the reference computed at the
precision below the configuration's (float32 -> TF32, bfloat16 -> fp8
e4m3 with a scale a tensor) put in the program's place. ``fault``: the
program with each planted fault of the cell's kind
(``benchmark/faults.py``; a state left unchanged reads 1 and is not run).
Not part of a run; it reads no limit.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from benchmark import faults, spec
from benchmark.harness import free_device
from benchmark.trace import Spans

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def serve_reading(drv, cell, seed, device, precision=None, fault=None):
    tr = cell.traffic
    k = tr["check_windows"]
    ts = drv.instants(tr)
    sd, clip, peak = drv.prepare(seed, cell, device, clip_windows=k + 1)
    windows = list(range(1, k + 1))
    if precision:
        return drv.check(cell, sd, clip, ts, windows, None, device,
                         precision), peak
    engine = drv.build_engine(cell, sd, device,
                              faults.SERVE[fault] if fault else None)
    keeper = drv.Keeper(k + 1, len(ts), tr["height"], tr["width"], seed)
    drv.stream(engine, clip, ts, 0, 0.0, tr["depth"], Spans(False), keeper,
               max_windows=k + 1)
    del engine
    free_device()
    outs = [keeper.out[keeper.index.index(i)] for i in windows]
    return drv.check(cell, sd, clip, ts, windows, outs, device), peak


def train_reading(drv, cell, seed, device, precision=None, fault=None):
    n = drv.CHECK_STEPS * cell.traffic["batch"]
    sd, frames, t = drv.prepare(seed, cell, device, samples=n)
    want = drv.reference_steps(cell, sd, frames, t, device)
    if precision:
        got = drv.reference_steps(cell, sd, frames, t, device, precision)
    else:
        plant = faults.TRAIN[fault] if fault else None
        got = drv.program_steps(cell, sd, frames, t, device, plant)[2:]
    free_device()
    return drv.compare(got, want), None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent
    cell = spec.find_cell(spec.load(root.parent / "BENCHMARK.json"),
                          args.workload, root)
    device = torch.device("cuda", 0)
    drv = cell.driver()
    serve = cell.traffic["kind"] == "serve_stream"
    control = CONTROL[cell.config["compute_dtype"]]
    jobs = [("program", int(s), None, None)
            for s in args.seeds.split(",") if s]
    jobs += [("control", int(s), control, None)
             for s in args.control_seeds.split(",") if s]
    planted = faults.SERVE if serve else faults.TRAIN
    jobs += [("fault", int(s), None, f)
             for s in args.fault_seeds.split(",") if s
             for f in planted if f != "unchanged_state"]
    for what, seed, precision, fault in jobs:
        t0 = time.perf_counter()
        if serve:
            numbers, peak = serve_reading(drv, cell, seed, device, precision,
                                          fault)
        else:
            numbers, peak = train_reading(drv, cell, seed, device, precision,
                                          fault)
        print(json.dumps({"workload": cell.name, "what": what,
                          "precision": precision, "fault": fault,
                          "seed": seed, "numbers": numbers,
                          "raw_flow_peak_px": peak,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
