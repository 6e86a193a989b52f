"""Model FLOPs of a serving window and of a train step: PyTorch's
``FlopCounterMode`` over the reference at the run's exact shapes on the
meta device (nothing is computed or allocated). It counts the
convolutions (2 per multiply-add; their backward's two products in a
train step), which are all but a few thousandth of the model's
arithmetic; the warps, activations and blends are left out. The count
is the work the model defines, whatever the program runs it with."""
from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import reference
from benchmark.reference import train as ref_train


def serve_window(config: dict, h: int, w: int, instants: int,
                 n_update: int) -> int:
    """One window at the padded size h x w of ``config``'s reference:
    Stage I once, ``instants`` instants of Stage II."""
    return _serve_window(json.dumps(config, sort_keys=True), h, w, instants,
                         n_update)


def train_step(config: dict, batch: int, size: int, n_update: int) -> int:
    """One train step of ``config``'s reference on batch x size x size
    crops: forward, loss and backward (the optimizer's update is
    elementwise)."""
    return _train_step(json.dumps(config, sort_keys=True), batch, size,
                       n_update)


@functools.lru_cache(maxsize=None)
def _serve_window(config: str, h, w, instants, n_update) -> int:
    model = reference.build(json.loads(config), device="meta")
    with torch.device("meta"):
        frames = torch.empty(1, 4, 3, h, w)
        t = torch.empty(instants)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model.synthesize(model.extract(frames).repeat(instants), t, n_update)
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def _train_step(config: str, batch, size, n_update) -> int:
    model = reference.build(json.loads(config), device="meta")
    with torch.device("meta"):
        frames = torch.empty(batch, 9, size, size, 3)
        t = torch.empty(batch, 1)
    inputs, gt0, gt1, gtt, tv = ref_train.split_batch(frames, t)
    with FlopCounterMode(display=False) as fc:
        ref_train.loss(model(inputs, tv, n_update), gt0, gt1, gtt).backward()
    return int(fc.get_total_flops())
