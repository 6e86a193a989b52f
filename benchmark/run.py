"""One run of one cell of the benchmark of demfi_torch (DeMFI-Net in
PyTorch and CUDA) on the card this process finds.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix,
limits and metric readers are found by name (``benchmark/spec.py``).
The run makes its weights and inputs from the seed on the card, sets the
program up and warms up every shape the cell uses, measures for
``--seconds`` (a traced run: the traffic's ``trace_seconds`` at most,
under ``torch.profiler``), and then compares what the timed path
produced with the float32 reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or its per-layer ones with ``--trace 1``),
``device``, ``breakdown`` (traced) and ``checks``, each compared number
beside its limit, which are also the last lines of standard error.

Exits 2 without a result where CUDA is absent or the card count is short
of the cell's, and 3 where JAX, flax or the JAX package got loaded.
"""
import time

_PERF_AT_START = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux: its start tick against
    the uptime clock, 10 ms steps), else 0."""
    import os
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


STARTED = _PERF_AT_START - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from benchmark import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "demfi_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name (whole) is JAX's, flax's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result(cell, measured, traced: bool, device_kind: str) -> dict:
    """The result's line (``checks`` last) and the check lines."""
    from benchmark.harness import verdict
    correct, checks = verdict(measured.numbers, cell.limits)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            v = cell.reader(m["name"])(measured)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": int(measured.peak_bytes)}
    out = {"correct": correct, "attempted": measured.attempted,
           "failed": measured.failed, "metrics": metrics, "device": device}
    if traced and measured.trace is not None:
        device["busy_s"] = measured.trace.busy_s
        device["window_s"] = measured.trace.window_s
        out["breakdown"] = measured.trace.breakdown()
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path(__file__).resolve().parent
    cell = spec.find_cell(spec.load(root.parent / "BENCHMARK.json"),
                          args.workload, root)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from benchmark.harness import Run
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              traced=bool(args.trace), device=dev, started=STARTED)
    measured = cell.driver().measure(run)
    out = result(cell, measured, run.traced, torch.cuda.get_device_name(dev))
    bad = forbidden_modules()
    if bad:
        print(f"no result: modules loaded in the run's process: {bad}",
              file=sys.stderr)
        return 3
    for note in measured.notes:
        print(note, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
