"""The card-against-CPU gradient check's rule, and how tight it is.

    python -m demfi_torch.utils.grad_check [phase7b|card_test]

The check (``chip_smoke.py`` phase 7(b), ``tests/test_torch_cuda.py``)
holds every parameter's gradient of one train step on the card to the
CPU's, each tensor within the bound that ``gradient_bounds`` sets from
the CPU's own change under nudges of the batch sized to the card's
departure, and the card's change between two runs. ``planted_fault``
cuts the gradient of one group of the card's warps, the fault the
check exists for; ``chip_smoke.py`` shows with it that the check
catches each group.

Run as a script, on the inputs of one of the two checks (``phase7b``:
DeMFI-Net_rb(5,3), B = 2, 64x64, flow head calibrated to 24 px;
``card_test``: DeMFI-Net_rb(2,2), B = 2, 32x48, 6 px): how far the
card's flows lie from the CPU's; the rule's bounds; then, for nudges of
1e-4 ... 1e-7 (two draws, and all six), how far they move the CPU's
flows, the healthy card's worst error as a share of its bound and, for
each planted fault, the tensors beyond their bounds.
"""
from __future__ import annotations

import contextlib
import sys

import numpy as np
import torch

from demfi_torch.ops import kernels

# one group of the card's warps passing no gradient on: its inputs are
# detached, as the kernels' outputs were before their autograd Functions
PLANTED_FAULTS = ("every_warp", "cfr_splats", "booster_pairs",
                  "feature_pairs", "fgac_samples")
NUDGES = (1e-4, 1e-5, 3e-6, 1e-6, 1e-7)
SEED = 0
# the check's rule (gradient_bounds)
GRAD_TOL = 1e-3         # relative Frobenius error, where the yardstick is less
NUDGE = 1e-6            # times a normal draw, added to the batch
NUDGE_DRAWS = 8         # at most
NUDGE_REACH = 10.0      # a nudge that moves the flows further is skipped


@contextlib.contextmanager
def planted_fault(kind: str):
    """Within the block, one group of the card's warps (``PLANTED_FAULTS``)
    passes no gradient on: the autograd Functions that serve it see their
    inputs detached. The forward and the launches are unchanged."""
    if kind not in PLANTED_FAULTS:
        raise ValueError(f"planted_fault: {kind!r} not in {PLANTED_FAULTS}")
    saved = (kernels._Gather, kernels._GatherPair, kernels._Fwarp,
             kernels._FwarpPair)
    gather, pair, fwarp, fwarp_pair = saved
    every = kind == "every_warp"

    class Gather:                   # FGAC's absolute samples
        @staticmethod
        def apply(img, coords, *rest):
            if every or kind == "fgac_samples":
                img, coords = img.detach(), coords.detach()
            return gather.apply(img, coords, *rest)

    class Pair:                     # C=64 feature pairs, C=3 booster pairs
        @staticmethod
        def apply(*args):
            group = "booster_pairs" if args[0].shape[1] == 3 \
                else "feature_pairs"
            if every or kind == group:
                args = tuple(a.detach() for a in args[:4]) + args[4:]
            return pair.apply(*args)

    class Fwarp:                    # a single forward warp
        @staticmethod
        def apply(img, flo, *rest):
            if every or kind == "cfr_splats":
                img, flo = img.detach(), flo.detach()
            return fwarp.apply(img, flo, *rest)

    class FwarpPair:                # the CFR splats
        @staticmethod
        def apply(*args):
            if every or kind == "cfr_splats":
                args = tuple(a.detach() for a in args[:4]) + args[4:]
            return fwarp_pair.apply(*args)

    (kernels._Gather, kernels._GatherPair, kernels._Fwarp,
     kernels._FwarpPair) = Gather, Pair, Fwarp, FwarpPair
    try:
        yield
    finally:
        (kernels._Gather, kernels._GatherPair, kernels._Fwarp,
         kernels._FwarpPair) = saved


def rel_frobenius(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.double().norm())
    err = float((got.double() - want.double()).norm())
    return err / scale if scale > 0 else err


def gradient_bounds(cpu_step, want, flows_cpu, flows_card, rerun_spread,
                    directions):
    """Per-tensor bounds for the card's gradients against the CPU's
    (``want``: name -> gradient, or None where there is none).

    Upstream of the warps the gradient is ill-conditioned in float32: a
    floor or the 0.999 mask flips where a coordinate lies within
    rounding of an integer or the edge, and a flip in the forward moves
    the flows that later warps read. So each tensor may depart by twice
    its yardstick where that exceeds GRAD_TOL: the larger of the card's
    own change between two runs (``rerun_spread``, name -> relative
    change: float atomics reorder sums) and the CPU's change when the
    batch is nudged by NUDGE times a draw of ``directions``. The nudges
    are sized to the card's departure, read on the flows
    (``cpu_step(delta)`` gives (gradients, flows) of the batch plus
    delta): a nudge that moves the CPU's flows more than NUDGE_REACH
    times as far as the card's lie from them is skipped, and nudges are
    drawn, at most NUDGE_DRAWS, until two count and one has moved the
    flows at least half as far as the card's lie.

    Returns (bounds by name, the counted nudges' flow moves, the card's
    flow departure); raises RuntimeError if no nudge reached."""
    gap = rel_frobenius(flows_card, flows_cpu)
    moved, moves, tried = [], [], 0
    for d in directions:
        if tried == NUDGE_DRAWS:
            break
        tried += 1
        grads, flows = cpu_step(d * np.float32(NUDGE))
        move = rel_frobenius(flows, flows_cpu)
        if move > NUDGE_REACH * gap:
            continue
        moved.append(grads)
        moves.append(move)
        if len(moved) >= 2 and max(moves) >= gap / 2:
            bounds = {k: max(GRAD_TOL, 2 * max(
                [rerun_spread.get(k, 0.0)]
                + [rel_frobenius(m[k], w) for m in moved]))
                for k, w in want.items() if w is not None}
            return bounds, moves, gap
    raise RuntimeError(
        f"gradient_bounds: {tried} nudges of {NUDGE:.0e} moved the flows "
        f"{', '.join('%.3g' % m for m in moves)}, none as far as half the "
        f"card's "
        f"departure {gap:.3g} within {NUDGE_REACH}x of it")


def _setting(name: str, dev):
    """(config, weights, frames [B,F,3,H,W] (the model reads the first 4),
    t [B,1], loss(out, frames on the device), nudge directions: normals
    of the frames' shape, the check's own first) of the check that
    ``name`` stands for."""
    from demfi_torch.config import config_rb
    from demfi_torch.models import make_model
    from demfi_torch.train import demfi_loss
    from demfi_torch.utils.profiling import calibrate_flow_head

    if name == "phase7b":           # chip_smoke.py phase 7(b)
        cfg = config_rb(5, 3, seed=SEED)
        batch = np.random.RandomState(SEED + 8).uniform(
            -1, 1, (2, 9, 64, 64, 3)).astype(np.float32)
        x = np.ascontiguousarray(batch.transpose(0, 1, 4, 2, 3))
        t, target = [[0.375], [0.625]], 24.0
        dirs = [np.random.RandomState(s).randn(*batch.shape).astype(
            np.float32).transpose(0, 1, 4, 2, 3)
            for s in range(SEED + 9, SEED + 15)]

        def loss(out, frames):
            return demfi_loss(cfg, out, frames[:, 5], frames[:, 6],
                              frames[:, 4])[0]
    elif name == "card_test":       # test_model_backward_card_matches_cpu
        cfg = config_rb(2, 2, seed=3)
        rng = np.random.RandomState(6)
        x = rng.uniform(-1, 1, (2, 4, 3, 32, 48)).astype(np.float32)
        dirs = [rng.randn(2, 4, 3, 32, 48).astype(np.float32)
                for _ in range(2)]
        gt = rng.uniform(-1, 1, (2, 3, 32, 48)).astype(np.float32)
        dirs += [np.random.RandomState(s).randn(*x.shape).astype(np.float32)
                 for s in range(4)]
        t, target = [[0.25], [0.625]], 6.0

        def loss(out, frames):
            g = torch.from_numpy(gt).to(frames.device)
            return ((out.st_prime - g).abs().mean()
                    + (out.st_final - g).abs().mean())
    else:
        raise SystemExit(f"grad_check: unknown setting {name!r}")
    model = make_model(cfg, device=dev)
    calibrate_flow_head(model, torch.from_numpy(np.ascontiguousarray(
        x[:, :4])).to(dev), target)
    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    return (cfg, weights, np.ascontiguousarray(x),
            np.array(t, np.float32), loss, dirs)


def main(argv) -> int:
    from demfi_torch import disable_tf32
    from demfi_torch.models import make_model

    name = argv[0] if argv else "phase7b"
    disable_tf32()
    dev = torch.device("cuda")
    cfg, weights, x, t_np, loss, dirs = _setting(name, dev)

    def step(device, inputs):
        """(gradients by name, flows) of one loss.backward()."""
        m = make_model(cfg, device=device)
        m.load_state_dict(weights, strict=True)
        frames = torch.from_numpy(np.ascontiguousarray(inputs)).to(device)
        with torch.enable_grad():
            out = m(frames[:, :4].contiguous(),
                    torch.from_numpy(t_np).to(device), num_update=cfg.N_trn)
            loss(out, frames).backward()
        return ({k: p.grad.cpu() for k, p in m.named_parameters()
                 if p.grad is not None}, out.flow_preds.detach().cpu())

    want, flows_c = step("cpu", x)
    got, flows_g = step(dev, x)
    rerun = step(dev, x)[0]
    err = {k: rel_frobenius(got[k], w) for k, w in want.items()}
    spread = {k: rel_frobenius(rerun[k], got[k]) for k in want}
    faults = {}
    for kind in PLANTED_FAULTS:
        with planted_fault(kind):
            g = step(dev, x)[0]
        faults[kind] = {k: rel_frobenius(g[k], w) if k in g else 1.0
                        for k, w in want.items()}
    gap = rel_frobenius(flows_g, flows_c)
    above = sum(v > 1e-3 for v in err.values())
    worst_err = max(err, key=err.get)
    print(f"{name}: flows, card against CPU {gap:.3g}; card against itself "
          f"{rel_frobenius(step(dev, x)[1], flows_g):.3g}; worst gradient "
          f"{worst_err} {err[worst_err]:.3g}, {above} of {len(err)} above "
          f"1e-3; the card's own spread up to {max(spread.values()):.3g}",
          flush=True)
    def report(label, bound):
        worst = max((err[k] / bound[k], k) for k in bound)
        line = (f"{label}: largest bound {max(bound.values()):.3g}; healthy "
                f"worst {worst[0]:.3f} of its bound ({worst[1]}); "
                f"{worst_err}'s bound {bound[worst_err]:.3g}")
        for kind, fe in faults.items():
            ratios = [fe[k] / bound[k] for k in bound]
            line += (f" | {kind} {sum(r > 1 for r in ratios)} beyond, "
                     f"{max(ratios):.1f}x")
        print(line, flush=True)

    bound, moves, _ = gradient_bounds(
        lambda delta: step("cpu", x + delta), want, flows_c, flows_g, spread,
        dirs)
    report(f"{name} the check's rule ({len(moves)} nudges counted, flows "
           f"moved {', '.join('%.3g' % v for v in moves)}, "
           f"{max(moves) / gap:.3g}x the card's)", bound)
    for eps in NUDGES:
        moved, moves = [], []
        for d in dirs:
            g, f = step("cpu", x + d * np.float32(eps))
            moved.append(g)
            moves.append(rel_frobenius(f, flows_c))
        for k_used in (2, len(dirs)):
            report(f"{name} nudge {eps:.0e} x{k_used}: flows moved "
                   f"{', '.join('%.3g' % v for v in moves[:k_used])} "
                   f"({max(moves[:k_used]) / gap:.3g}x the card's)",
                   {k: max(GRAD_TOL, 2 * max([spread[k]] + [
                       rel_frobenius(m[k], w) for m in moved[:k_used]]))
                    for k, w in want.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
