"""The reference's training: the loss of DeMFI (Eq. 9 and 10, L1) and
Adam, in plain PyTorch, float32.

  D1 = mean over (S0', GT0), (S1', GT1), (St', GTt) of the mean |.|
  D2 = the sum over the boosting steps of the same mean for S0, S1, St
  total = D1 + D2
Adam (beta 0.9, 0.999, eps 1e-8, no weight decay) with bias correction;
a parameter that gets no gradient is left alone.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

BETAS = (0.9, 0.999)
EPS = 1e-8


def loss(out: dict, gt0, gt1, gtt) -> torch.Tensor:
    def rec(a, b):
        return torch.mean(torch.abs(a - b))
    total = (rec(gt0, out["s0_prime"]) + rec(gt1, out["s1_prime"])
             + rec(gtt, out["st_prime"])) / 3.0
    for s0, s1, st in zip(out["s0"], out["s1"], out["st"]):
        total = total + (rec(gt0, s0) + rec(gt1, s1) + rec(gtt, st)) / 3.0
    return total


def split_batch(frames: torch.Tensor, t: torch.Tensor):
    """frames [B, 9, H, W, 3] NHWC (B0, B1, B-1, B2, St, S0, S1, S-1, S2),
    t [B, 1] -> (inputs [B, 4, 3, H, W], gt0, gt1, gtt, t [B])."""
    x = frames.permute(0, 1, 4, 2, 3)
    return x[:, :4].contiguous(), x[:, 5], x[:, 6], x[:, 4], t.reshape(-1)


def run_steps(model, batches: List[Tuple[torch.Tensor, torch.Tensor]],
              n_update: int, lr: float
              ) -> Tuple[List[float], Dict[str, torch.Tensor],
                         Dict[str, torch.Tensor]]:
    """Train ``model`` in place, one Adam step a batch. Returns each
    step's loss, the first step's gradients and the parameters after the
    last step (by name)."""
    params = dict(model.named_parameters())
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, first = [], {}
    for step, (frames, t) in enumerate(batches, 1):
        inputs, gt0, gt1, gtt, tv = split_batch(frames, t)
        for p in params.values():
            p.grad = None
        total = loss(model(inputs, tv, n_update), gt0, gt1, gtt)
        total.backward()
        losses.append(float(total.detach()))
        with torch.no_grad():
            for k, p in params.items():
                if p.grad is None:
                    continue
                if step == 1:
                    first[k] = p.grad.clone()
                m[k].mul_(BETAS[0]).add_(p.grad, alpha=1 - BETAS[0])
                v[k].mul_(BETAS[1]).addcmul_(p.grad, p.grad,
                                             value=1 - BETAS[1])
                denom = (v[k].sqrt() / (1 - BETAS[1] ** step) ** 0.5).add_(EPS)
                p.addcdiv_(m[k], denom, value=-lr / (1 - BETAS[0] ** step))
    return losses, first, {k: p.detach().clone() for k, p in params.items()}
