"""What a driver is given and what it gives back, and the verdict."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

import torch

from benchmark.spec import Cell
from benchmark.trace import DeviceTrace, Spans


@dataclasses.dataclass
class Run:
    """One run of a cell: its seed, the measured window's seconds, whether
    it is traced, its device, and the host-clock time (perf_counter) at
    which the process started."""
    cell: Cell
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    started: float
    spans: Spans = None
    # test hook: wraps the program's objects, for planted faults
    plant: Optional[Callable] = None

    def __post_init__(self):
        if self.spans is None:
            self.spans = Spans(self.traced)


@dataclasses.dataclass
class Measured:
    """A driver's result. ``end_to_end``: every end-to-end metric the
    driver measures, by name. ``numbers``: the comparison's numbers by
    name (the limits file says which decide ``correct``). The rest feeds
    the per-layer readers of a traced run: ``units`` windows or steps in
    the traced window, its :class:`DeviceTrace`, the FLOPs and gather
    bytes of one unit, the program's phase times."""
    kind: str                          # "serve" or "train"
    attempted: int
    failed: int
    peak_bytes: int
    end_to_end: Dict[str, float]
    numbers: Dict[str, float]
    spans: Spans
    units: int = 0
    trace: Optional[DeviceTrace] = None
    flops_per_unit: int = 0
    peak_flops: Optional[float] = None
    gather_bytes_per_unit: int = 0
    gather_bwd_bytes_per_unit: int = 0
    hbm_bytes_s: Optional[float] = None
    phase_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]):
    """(correct, checks): each number that has a limit, beside it; correct
    when there is at least one and every one is finite and within its
    limit."""
    checks = {k: {"value": numbers.get(k, float("nan")),
                  "limit": v["limit"]} for k, v in limits.items()}
    ok = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


def allocator_note(device) -> str:
    """The caching allocator's counters over the run: allocations that
    failed and were retried after freeing the cache, out-of-memory
    errors, and the device allocations and frees it made."""
    if device.type != "cuda":
        return "allocator: no card"
    s = torch.cuda.memory_stats(device)
    keys = ("num_alloc_retries", "num_ooms", "num_device_alloc",
            "num_device_free")
    return "allocator: " + ", ".join(f"{k} {s.get(k, 0)}" for k in keys)


def free_device():
    """Return cached device memory, so that what runs next starts empty."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def peaks(device_kind: str, dtype: str):
    """(peak FLOP/s in ``dtype``, HBM bytes/s) of the card, from the
    benchmark's table; (None, None) for a card it does not hold."""
    import json
    from pathlib import Path
    with open(Path(__file__).resolve().parent / "peaks.json") as f:
        table = json.load(f)["devices"]
    for family, p in table.items():
        if device_kind.startswith(family):
            return p["flops"][dtype], p["hbm_bytes_s"]
    return None, None


def _named(path: str):
    """The object that "<module>:<name>" names."""
    import importlib
    module, name = path.split(":")
    return getattr(importlib.import_module(module), name)


def program_config(config: dict, **kw):
    """The program's configuration object for a configuration file: its
    ``program`` block's class over the block's fields, with the file's
    boosting steps and compute dtype and the traffic's ``kw``."""
    prog = config["program"]
    return _named(prog["config"])(
        **prog["fields"], N_trn=config["N_trn"], N_tst=config["N_tst"],
        compute_dtype=config["compute_dtype"], **kw)


def program_model(config: dict, state_dict, device, **kw):
    """The program's model for a configuration file, holding the
    benchmark's weights (a strict load: the published keys)."""
    model = _named(config["program"]["model"])(
        program_config(config, **kw), device=device)
    model.load_state_dict(state_dict, strict=True)
    return model
