"""Faults planted under the timed path, to show that the comparison
catches them (``benchmark/tests``, and ``benchmark.readings`` on the
card). Each takes the program's object and returns a broken one.

  unchanged_state  a train step that leaves the parameters and the
                   optimizer's state as they were
  half_batch       a train step on the first half of its batch alone, so
                   that the loss is the mean over the rest
  altered_answer   a served window whose final frame at one instant is
                   altered where it is produced (zeroed)
  half_instants    a served window with every other instant left out,
                   each missing frame taken from the instant before it
"""
from __future__ import annotations

import dataclasses

import numpy as np


def unchanged_state(step):
    def broken(state, frames, t, on_phase=None):
        real = state.optimizer.step
        state.optimizer.step = lambda *a, **k: None
        try:
            return step(state, frames, t, on_phase=on_phase)
        finally:
            state.optimizer.step = real
    return broken


def half_batch(step):
    def broken(state, frames, t, on_phase=None):
        n = max(1, frames.shape[0] // 2)
        return step(state, frames[:n], t[:n], on_phase=on_phase)
    return broken


class _Engine:
    """An engine whose fetched windows pass through ``alter``."""

    def __init__(self, engine, alter, thin=False):
        self.engine, self.alter, self.thin = engine, alter, thin

    def dispatch_windows(self, frames, ts):
        self.m = ts.shape[1]
        return self.engine.dispatch_windows(
            frames, ts[:, ::2] if self.thin else ts)

    def fetch_windows(self, handle):
        return [self.alter(r, self.m)
                for r in self.engine.fetch_windows(handle)]


def altered_answer(engine):
    def alter(r, m):
        st = r.st_final.copy()
        st[m // 2] = 0.0
        return dataclasses.replace(r, st_final=st)
    return _Engine(engine, alter)


def half_instants(engine):
    def alter(r, m):
        pick = np.arange(m) // 2
        return dataclasses.replace(r, **{
            f.name: getattr(r, f.name)[pick]
            for f in dataclasses.fields(r)
            if getattr(r, f.name) is not None})
    return _Engine(engine, alter, thin=True)


SERVE = {"altered_answer": altered_answer, "half_instants": half_instants}
TRAIN = {"unchanged_state": unchanged_state, "half_batch": half_batch}
