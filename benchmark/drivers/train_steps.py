"""Training: the program's train step (``make_train_step``) back to back
on batches of seeded samples, the loader bypassed.

Each sample is a scene of its own at the crop size (the published
recipe: 256 x 256 crops, batch 2, t drawn from the 7 x8 instants, L1 on
D1 + D2, Adam at 1e-4), made on the card and kept on the host in pinned
memory; the step copies its batch to the card as the loader's batches
are copied. Every batch holds samples no other batch holds. Set-up
builds the train state once and drives it through its first steps (the
first three are the comparison's) before the window takes the same
state on.

End-to-end: ``train_samples_s`` (batch x steps over the window's
seconds, which end in a synchronise), ``peak_mem_gib``, ``setup_s``
(process start to the first measured window, less the benchmark's own
making of weights, samples and calibration).

Correctness: the float32 reference takes the same weights and the first
three batches through three steps of its own (plain autograd, plain
Adam). Compared: each step's loss, each parameter's first gradient as
the program's optimizer got it (its first moment after one step over
1 - beta1) and each parameter's change over the three steps, by the
gap between the two sides' norms (see :func:`compare`).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import torch

from benchmark import inputs, reference
from benchmark.counts import flops as flop_counts
from benchmark.counts import gather_bytes
from benchmark.harness import (Measured, Run, allocator_note, free_device,
                               peaks, program_config, program_model)
from benchmark.reference import train as ref_train
from benchmark.trace import profiled

CHECK_STEPS = 3
BETA1 = ref_train.BETAS[0]


def batch(frames, t, i: int, size: int):
    """Batch i: samples i*size .. i*size + size - 1, cycling."""
    n = frames.shape[0] // size
    j = (i % n) * size
    return frames[j:j + size], t[j:j + size]


def prepare(run_seed: int, cell, device, samples=None):
    tr = cell.traffic
    sd = inputs.make_weights(reference.param_shapes(cell.config), run_seed,
                             device)
    frames, t = inputs.train_samples(run_seed, samples or tr["samples"],
                                     tr["size"], tr["max_px"], device)
    first = frames[:1, :4].to(device).permute(0, 1, 4, 2, 3).contiguous()
    with torch.no_grad():
        inputs.calibrate_flow_head(reference.build(cell.config, sd, device),
                                   sd, first, tr["flow_peak_px"])
    free_device()
    return sd, frames, t


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def program_steps(cell, sd, frames, t, device, plant=None):
    """The program's train state and step, driven through the first
    CHECK_STEPS batches: (state, step, losses, first gradients' norms,
    norms of the parameters' change)."""
    from demfi_torch.train import create_train_state, make_train_step
    tr = cell.traffic
    pcfg = program_config(cell.config, batch_size=tr["batch"],
                          patch_size=tr["size"], init_lr=tr["lr"])
    model = program_model(cell.config, sd, device)
    state = create_train_state(pcfg, model)
    step = make_train_step(pcfg)
    if plant is not None:
        step = plant(step)
    params = dict(model.named_parameters())
    losses, grads = [], {}
    for i in range(CHECK_STEPS):
        f, tv = batch(frames, t, i, tr["batch"])
        met = step(state, f, tv)
        losses.append(float(met["total_loss"]))
        if i == 0:
            opt = state.optimizer.state
            grads = _norms({k: opt[p]["exp_avg"] / (1 - BETA1)
                            for k, p in params.items() if p in opt})
    change = _norms({k: p.detach() - sd[k] for k, p in params.items()})
    return state, step, losses, grads, change


def reference_steps(cell, sd, frames, t, device, precision="float32"):
    """The reference's three steps: (losses, first gradients' norms,
    norms of the parameters' change)."""
    tr = cell.traffic
    model = reference.build(cell.config, sd, device, precision)
    batches = [tuple(x.to(device) for x in batch(frames, t, i, tr["batch"]))
               for i in range(CHECK_STEPS)]
    losses, first, after = ref_train.run_steps(
        model, batches, cell.config["N_trn"], tr["lr"])
    return (losses, _norms(first),
            _norms({k: after[k] - sd[k] for k in after}))


def _gap(got: Dict[str, float], want: Dict[str, float], floor: float
         ) -> float:
    """The worst leaf's |got - want| over the larger of want and the
    median leaf's, over the leaves whose reference norm is at least
    ``floor`` times the median leaf's (a leaf the program lacks reads
    0)."""
    med = sorted(want.values())[len(want) // 2]
    return max(abs(got.get(k, 0.0) - w) / max(w, med)
               for k, w in want.items() if w >= floor * med)


def compare(got, want) -> Dict[str, float]:
    """``first_loss_gap``: the first step's |loss - reference's| over the
    reference's; ``loss_gap``: the worst of the three steps' (the later
    steps' losses carry the noise of Adam's first updates: an element
    whose gradient is rounding noise moves by +-lr whichever sign the
    noise takes). ``grad_gap`` and ``change_gap``: :func:`_gap` of the
    first gradients' and of the three steps' changes' norms, leaving out
    the leaves whose reference gradient is under a thousandth of the
    median leaf's (gradients that are nought to rounding)."""
    (lp, gp, cp), (lr, gr, cr) = got, want
    kept = {k for k, v in gr.items()
            if v >= 1e-3 * sorted(gr.values())[len(gr) // 2]}
    gaps = [abs(a - b) / abs(b) for a, b in zip(lp, lr)]
    return {"first_loss_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": _gap(gp, {k: gr[k] for k in kept}, 0.0),
            "change_gap": _gap(cp, {k: cr[k] for k in kept}, 0.0)}


def measure(run: Run) -> Measured:
    cell, tr, dev = run.cell, run.cell.traffic, run.device
    t0 = time.perf_counter()
    sd, frames, t = prepare(run.seed, cell, dev)
    inputs_s = time.perf_counter() - t0
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state, step, losses, grads, change = program_steps(
        cell, sd, frames, t, dev, run.plant)
    i = CHECK_STEPS
    for _ in range(tr["warmup_steps"]):
        step(state, *batch(frames, t, i, tr["batch"]))
        i += 1
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - run.started - inputs_s

    # a traced run records a CUDA event at each of the step's phase marks
    marks: List[dict] = []
    timed = run.traced and cuda

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1][name] = ev

    def window(seconds):
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if timed:
                marks.append({})
            with run.spans("step"):
                step(state, *batch(frames, t, i + n, tr["batch"]),
                     on_phase=on_phase if timed else None)
            n += 1
        if cuda:
            torch.cuda.synchronize(dev)
        return n, time.perf_counter() - t0

    seconds = min(run.seconds, tr["trace_seconds"]) if run.traced \
        else run.seconds
    with profiled() if run.traced else contextlib.nullcontext() as holder:
        steps, secs = window(seconds)
    trace = holder.trace if run.traced else None
    peak_bytes = torch.cuda.max_memory_allocated(dev) if cuda else 0
    alloc = allocator_note(dev)
    phase_ms = {"backward": [m["forward"].elapsed_time(m["backward"])
                             for m in marks]}
    del state, step
    free_device()

    numbers = compare((losses, grads, change),
                      reference_steps(cell, sd, frames, t, dev))
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak_flops, hbm = peaks(kind, cell.config["compute_dtype"])
    return Measured(
        kind="train", attempted=steps, failed=0, peak_bytes=peak_bytes,
        end_to_end={"train_samples_s": tr["batch"] * steps / secs,
                    "peak_mem_gib": peak_bytes / 2 ** 30,
                    "setup_s": setup_s},
        numbers=numbers, spans=run.spans, units=steps, trace=trace,
        flops_per_unit=flop_counts.train_step(
            cell.config, tr["batch"], tr["size"], cell.config["N_trn"]),
        peak_flops=peak_flops, hbm_bytes_s=hbm,
        gather_bwd_bytes_per_unit=gather_bytes.train_step_bwd(
            tr["batch"], tr["size"], cell.config["N_trn"],
            cell.config["architecture"]["nf"]),
        phase_ms=phase_ms,
        notes=[f"losses of the first {CHECK_STEPS} steps {losses}",
               f"the benchmark's weights, samples and calibration "
               f"{inputs_s:.3f} s, left out of setup_s", alloc])
