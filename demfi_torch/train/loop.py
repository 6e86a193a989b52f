"""Training: the losses (Eq. 9/10), the optimizer and the train step.

  D1 = lambda_D1 * mean(L(S0', GT0), L(S1', GT1), L(St', GTt))
  D2 = lambda_D2 * sum over boosting iterations i = 1..N of
       mean(L(S0_i, GT0), L(S1_i, GT1), L(St_i, GTt))
  total = D1 + D2,  L one of L1 (the default), MSE, L1-Charbonnier.

The optimizer is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8,
weight_decay)`` itself: its decay is L2-coupled (grad += wd * param before
the moments), as the JAX package's ``adam_l2`` is. The lr is a function
of the epoch (``DeMFIConfig.lr_at_epoch``: MultiStepLR stair decay by
default), set on the param groups by :func:`set_epoch` when an epoch
starts.

Batch layout as in the JAX package: frames [B, 9, H, W, 3] NHWC in the
loader's order B0, B1, B-1, B2, St, S0, S1, S-1, S2, and t [B, 1]. The
step moves them to the model's device and turns them NCHW there: the
inputs are frames 0-3, the targets St, S0, S1 frames 4, 5 and 6.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from demfi_torch import disable_tf32
from demfi_torch.config import DeMFIConfig
from demfi_torch.models.demfi import DeMFINet, DeMFIOutputs


@dataclasses.dataclass
class TrainState:
    model: DeMFINet
    optimizer: torch.optim.Optimizer
    epoch: int = 0          # drives the lr (set_epoch)


def _rec_loss(loss_type: str) -> Callable:
    if loss_type == "MSE":
        return lambda a, b: torch.mean((a - b) ** 2)
    if loss_type == "L1_Charbonnier_loss":
        eps = 1e-3
        return lambda a, b: torch.mean(torch.sqrt((a - b) ** 2 + eps ** 2))
    return lambda a, b: torch.mean(torch.abs(a - b))


def make_optimizer(cfg: DeMFIConfig, model: DeMFINet
                   ) -> torch.optim.Optimizer:
    """Adam with L2-coupled weight decay at the first epoch's lr."""
    return torch.optim.Adam(model.parameters(), lr=cfg.lr_at_epoch(0),
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def demfi_loss(cfg: DeMFIConfig, out: DeMFIOutputs, gt0: torch.Tensor,
               gt1: torch.Tensor, gtt: torch.Tensor, loss_fn=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Eq. 9 + Eq. 10: (total, {"total_loss", "rec_D1", "rec_D2"})."""
    rec = loss_fn or _rec_loss(cfg.loss_type)
    d1 = cfg.rec_D1_lambda * (rec(gt0, out.s0_prime) + rec(gt1, out.s1_prime)
                              + rec(gtt, out.st_prime)) / 3.0
    d2 = torch.zeros((), device=d1.device)
    for i in range(out.s0_final.shape[0]):
        d2 = d2 + cfg.rec_D2_lambda * (
            rec(gt0, out.s0_final[i]) + rec(gt1, out.s1_final[i])
            + rec(gtt, out.st_final[i])) / 3.0
    total = d1 + d2
    return total, {"total_loss": total, "rec_D1": d1, "rec_D2": d2}


def create_train_state(cfg: DeMFIConfig, model: DeMFINet) -> TrainState:
    """The model (put in train mode) with a fresh optimizer, at epoch 0."""
    model.train()
    return TrainState(model=model, optimizer=make_optimizer(cfg, model))


def set_epoch(cfg: DeMFIConfig, state: TrainState, epoch: int) -> float:
    """Start epoch ``epoch``: its lr goes on every param group. Returns
    the lr."""
    state.epoch = epoch
    lr = cfg.lr_at_epoch(epoch)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return lr


def make_train_step(cfg: DeMFIConfig) -> Callable:
    """The train step: ``step(state, frames, t_value, on_phase=None)``
    takes frames [B,9,H,W,3] and t [B,1] (numpy or tensors, on any
    device), runs forward, backward and the optimizer's update on the
    model's device, and returns the metrics as 0-d device tensors beside
    the lr. ``on_phase``, where given, is called with "forward",
    "backward" and "optimizer" as each part has been enqueued (a timer
    records an event there)."""

    def step(state: TrainState, frames, t_value,
             on_phase: Optional[Callable[[str], None]] = None
             ) -> Dict[str, torch.Tensor]:
        disable_tf32()
        model = state.model
        dev = next(model.parameters()).device
        x = torch.as_tensor(frames).to(dev, non_blocking=True).permute(
            0, 1, 4, 2, 3)
        t = torch.as_tensor(t_value).to(dev, non_blocking=True)
        inputs = x[:, :4].contiguous()
        gtt, gt0, gt1 = x[:, 4], x[:, 5], x[:, 6]
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():   # also where the caller turned it off
            out = model(inputs, t, num_update=cfg.N_trn)
            total, metrics = demfi_loss(cfg, out, gt0, gt1, gtt)
            if on_phase is not None:
                on_phase("forward")
            total.backward()
        if on_phase is not None:
            on_phase("backward")
        state.optimizer.step()
        if on_phase is not None:
            on_phase("optimizer")
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["lr"] = state.optimizer.param_groups[0]["lr"]
        return metrics

    return step
