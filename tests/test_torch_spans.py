"""The program's spans (``demfi_torch.utils.profiling.span``) on the CPU.

Off (no profiler recording): one shared null context, no allocation. On
(``torch.profiler``): one engine window of a tiny DeMFI-Net_rb(2,2) cut
into four t-chunks, and one train step, record the ranges the program
names, nested and counted as the model runs them; and turning the
profiler on changes no bit of the served frames or of the step.
"""
import contextlib
import glob
import json
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from demfi_torch.config import config_rb
from demfi_torch.infer import InferenceEngine
from demfi_torch.models import make_model
from demfi_torch.train import create_train_state, make_train_step
from demfi_torch.utils.profiling import device_trace, span

N_UPDATE = 2
INSTANTS = 7
T_CHUNK = 2
BATCHES = -(-INSTANTS // T_CHUNK)        # 4 device batches a window
H = W = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once, and
    the bitwise comparisons want one summation order."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg():
    return config_rb(N_UPDATE, N_UPDATE, nf=16)


def _model():
    return make_model(_cfg(), device="cpu")


def _window():
    rng = np.random.RandomState(3)
    frames = rng.uniform(-1, 1, (1, 4, H, W, 3)).astype(np.float32)
    ts = (np.arange(1, INSTANTS + 1, dtype=np.float32)
          / (INSTANTS + 1))[None]
    return frames, ts


def _serve(profiled: bool):
    """(engine, its one window's result, the profiler's events or None)."""
    engine = InferenceEngine(_model(), N_UPDATE, t_chunk=T_CHUNK,
                             fetch="images", device="cpu")
    frames, ts = _window()
    with (profile(activities=[ProfilerActivity.CPU]) if profiled
          else contextlib.nullcontext()) as prof:
        result = engine.fetch_windows(engine.dispatch_windows(frames, ts))[0]
    return engine, result, prof.events() if profiled else None


def _train(profiled: bool):
    """(the step's metrics, the parameters after it, the events or None)."""
    cfg = _cfg()
    state = create_train_state(cfg, _model())
    rng = np.random.RandomState(5)
    frames = rng.uniform(-1, 1, (2, 9, H, W, 3)).astype(np.float32)
    t = np.array([[0.25], [0.625]], np.float32)
    step = make_train_step(cfg)
    with (profile(activities=[ProfilerActivity.CPU]) if profiled
          else contextlib.nullcontext()) as prof:
        metrics = step(state, frames, t)
    params = {k: v.detach().clone()
              for k, v in state.model.named_parameters()}
    return metrics, params, prof.events() if profiled else None


@pytest.fixture(scope="module")
def served():
    return _serve(False), _serve(True)


@pytest.fixture(scope="module")
def trained():
    return _train(False), _train(True)


def _ranges(events, name):
    """(start, end) of every event ``name``, in order of start."""
    return sorted((e.time_range.start, e.time_range.end)
                  for e in events if e.name == name)


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _count_inside(events, name, outer):
    return sum(_inside(r, outer) for r in _ranges(events, name))


def _peak_of(fn, n=100):
    """(net, peak) bytes that ``n`` calls of ``fn`` allocate (tracemalloc),
    after two calls that warm it."""
    fn()
    fn()
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        for _ in range(n):
            fn()
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return after - before, peak - before


def test_span_off_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = span("extract"), span("engine.upload")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)


def test_span_off_allocates_nothing():
    """A span that is off allocates what an empty ``with`` allocates:
    nothing of its own."""
    null = contextlib.nullcontext()

    def spanned():
        with span("synthesize"):
            pass

    def bare():
        with null:
            pass
    assert _peak_of(spanned) == _peak_of(bare)


def test_span_on_is_a_named_range_in_the_trace(tmp_path):
    """Under the operator's exporter a span is a ``demfi.`` range of the
    Chrome trace, on the thread that opened it, holding its operators."""
    with device_trace(str(tmp_path / "trace")):
        assert torch.autograd._profiler_enabled()
        with span("extract"):
            torch.ones(4).add_(1)
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    events = json.load(open(path))["traceEvents"]
    (mark,) = [e for e in events if e.get("name") == "demfi.extract"]
    assert mark["cat"] == "user_annotation" and mark["ph"] == "X"
    adds = [e for e in events if e.get("name") == "aten::add_"]
    assert adds and all(
        mark["ts"] <= e["ts"] and e["ts"] + e["dur"] <= mark["ts"]
        + mark["dur"] and e["tid"] == mark["tid"] for e in adds)


def test_engine_window_spans(served):
    """One window of 7 instants at t_chunk 2: one device batch a t-chunk,
    each holding one copy in, one Stage I (``extract``), one
    ``synthesize`` with N_tst boosting iterations inside it, and one
    readback; the engine's host work before each batch, and before the
    first, in ``engine.prepare``."""
    _, (engine, _, events) = served
    assert engine.dispatched_batches == BATCHES
    assert engine.dispatched_windows == 1
    counts = {n: len(_ranges(events, "demfi." + n)) for n in (
        "engine.prepare", "engine.upload", "engine.readback", "extract",
        "synthesize", "boost")}
    assert counts == {"engine.prepare": BATCHES + 1,
                      "engine.upload": BATCHES,
                      "engine.readback": BATCHES, "extract": BATCHES,
                      "synthesize": BATCHES, "boost": BATCHES * N_UPDATE}
    synth = _ranges(events, "demfi.synthesize")
    for s in synth:
        assert _count_inside(events, "demfi.boost", s) == N_UPDATE
    # Stage I, then the t-dependent part, batch after batch
    order = sorted(
        (r[0], n) for n in ("extract", "synthesize", "engine.upload",
                            "engine.readback")
        for r in _ranges(events, "demfi." + n))
    assert [n for _, n in order] == ["engine.upload", "extract",
                                     "synthesize",
                                     "engine.readback"] * BATCHES
    # the stages do not nest in the engine's own spans
    for name in ("engine.prepare", "engine.upload", "engine.readback"):
        for r in _ranges(events, "demfi." + name):
            assert _count_inside(events, "demfi.extract", r) == 0
            assert _count_inside(events, "demfi.synthesize", r) == 0


def test_engine_window_bitwise_with_profiler(served):
    (plain, want, _), (traced, got, _) = served
    assert plain.dispatched_batches == traced.dispatched_batches == BATCHES
    for field in ("s0_prime", "s1_prime", "st_prime", "s0_final",
                  "s1_final", "st_final"):
        a, b = getattr(want, field), getattr(got, field)
        assert a.shape == (INSTANTS, H, W, 3)
        assert np.array_equal(a, b), field


def test_train_step_spans_in_order(trained):
    """forward, backward, optimizer, one after the other; the model's
    stages inside the forward, N_trn boosting iterations inside its
    ``synthesize``."""
    _, (_, _, events) = trained
    phases = [_ranges(events, "demfi.step." + n)
              for n in ("forward", "backward", "optimizer")]
    assert [len(p) for p in phases] == [1, 1, 1]
    (fwd,), (bwd,), (opt,) = phases
    assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
    (extract,) = _ranges(events, "demfi.extract")
    (synth,) = _ranges(events, "demfi.synthesize")
    assert _inside(extract, fwd) and _inside(synth, fwd)
    assert extract[1] <= synth[0]
    assert _count_inside(events, "demfi.boost", synth) == N_UPDATE
    assert len(_ranges(events, "demfi.boost")) == N_UPDATE
    assert not _ranges(events, "demfi.engine.prepare")


def test_train_step_bitwise_with_profiler(trained):
    (m_plain, p_plain, _), (m_traced, p_traced, _) = trained
    for k in ("total_loss", "rec_D1", "rec_D2"):
        assert torch.equal(m_plain[k], m_traced[k]), k
    assert float(m_plain["total_loss"]) > 0
    assert p_plain.keys() == p_traced.keys()
    for k in p_plain:
        assert torch.equal(p_plain[k], p_traced[k]), k
