"""Collectives of a frame split by rows (``--mesh_spatial``), over a
:class:`~demfi_torch.parallel.grid.RowShard`'s spatial group.

  - :func:`exchange_rows`  a tensor's rows with ``above`` rows of the
    neighbour above and ``below`` rows of the one below, zeros at the
    frame's top and bottom edges: what a convolution's zero padding reads
    there, so that a convolution with no row padding on the result is the
    unsplit convolution's rows;
  - :func:`allgather_rows`  the whole frame from every rank's rows;
  - :func:`allreduce_sum`, :func:`allreduce_min`, :func:`allreduce_max`
    the elementwise sum, minimum and maximum over the group's ranks.

Each is built from ``all_gather`` and ``all_reduce`` alone, so one code
path serves gloo on the CPU, NCCL with one card per rank, and gloo ranks
that share one card: under gloo a collective's tensors are staged through
the host (``demfi_torch.parallel.distributed._collective_device``), as
gloo requires; the kernels and convolutions still run on the card.
A gather moves bits (bfloat16 as bytes); a reduction runs in float32 (the
minimum and maximum of bfloat16 values are bfloat16 values).

Each is differentiable (a ``torch.autograd.Function``), so a train step
runs on a shard's rows (``make_train_step`` under a grid): the halo rows'
cotangents go back to the neighbour they came from and add onto its edge
rows; the whole frame's cotangent is summed over the group and each rank
keeps its rows (a reduce-scatter made of ``all_reduce``, which gloo has
and NCCL has); a sum's cotangent is summed; a minimum's or maximum's goes
to the ranks whose value is the group's, shared evenly among them, as
``torch.amax`` shares it among equal elements (the count of such ranks
is reduced with the cotangent). A backward makes its collectives
whatever its cotangent holds, zeros included, and autograd runs the
nodes of identical graphs in one order, so every rank of a group makes
the same collectives in the same order.

Measurement: while ``timing`` is a list, each collective on card tensors
appends the pair of CUDA events recorded on the current stream before
and after it (``chip_smoke.py`` phase 10 sums them into the collectives'
share of a window, phase 11 that of a train step); None, the
default, records nothing. :func:`reduce_gradients`, the split train
step's sum of the parameters' gradients over the world, is timed too.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

from demfi_torch.parallel.distributed import _collective_device
from demfi_torch.parallel.grid import RowShard

timing: Optional[list] = None


@contextlib.contextmanager
def _timed(x: torch.Tensor):
    if timing is None or not x.is_cuda:
        yield
        return
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    yield
    end.record()
    timing.append((start, end))


def _all_gather(x: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    """Every rank's x (equal shapes), in rank order, on x's device."""
    with _timed(x):
        bits = x.contiguous()
        if bits.dtype == torch.bfloat16:     # gloo gathers no bfloat16
            bits = bits.view(torch.uint8)
        t = bits.to(_collective_device())
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return [p.to(x.device).view(x.dtype) for p in parts]


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    """The reduction of every rank's x, in float32 and back to x's
    dtype."""
    with _timed(x):
        t = x.float().to(_collective_device())
        if t.data_ptr() == x.data_ptr():
            t = t.clone()
        dist.all_reduce(t, op=op, group=group)
        return t.to(x.device).to(x.dtype)


def _exchange(x, above, below, shard):
    rows = x.shape[-2]
    # the first `below` rows go to the rank above, the last `above` rows
    # to the rank below
    strip = torch.cat([x[..., :below, :], x[..., rows - above:, :]], dim=-2)
    parts = _all_gather(strip, shard.group, shard.size)
    s = shard.index
    zeros = x.new_zeros

    def edge(n):
        return zeros(x.shape[:-2] + (n, x.shape[-1]))
    top = parts[s - 1][..., below:, :] if s > 0 else edge(above)
    bottom = parts[s + 1][..., :below, :] if s < shard.size - 1 else \
        edge(below)
    return torch.cat([top, x, bottom], dim=-2)


class _ExchangeRows(torch.autograd.Function):
    """:func:`exchange_rows`; the backward sends the halos' cotangents
    back to their owners, which add them onto their edge rows (a zero
    edge's cotangent goes nowhere)."""

    @staticmethod
    def forward(ctx, x, above, below, shard):
        ctx.geometry = (above, below, shard)
        return _exchange(x, above, below, shard)

    @staticmethod
    def backward(ctx, g):
        above, below, shard = ctx.geometry
        rows = g.shape[-2] - above - below
        # the top halo's cotangent goes to the rank above, the bottom
        # one's to the rank below
        strip = torch.cat([g[..., :above, :], g[..., above + rows:, :]],
                          dim=-2)
        parts = _all_gather(strip, shard.group, shard.size)
        s = shard.index
        gx = g[..., above:above + rows, :].clone()
        if s < shard.size - 1:        # the top halo of the rank below
            gx[..., rows - above:, :] += parts[s + 1][..., :above, :]
        if s > 0:                     # the bottom halo of the rank above
            gx[..., :below, :] += parts[s - 1][..., above:, :]
        return gx, None, None, None


def exchange_rows(x: torch.Tensor, above: int, below: int,
                  shard: RowShard) -> torch.Tensor:
    """x [..., rows, W], this rank's rows of a frame, with ``above`` rows
    of the rank above it and ``below`` rows of the rank below it: [...,
    above + rows + below, W]. At the frame's top and bottom edges the
    missing rows are zeros. Each halo must come from one neighbour
    (above, below <= rows)."""
    if above == 0 and below == 0:
        return x
    rows = x.shape[-2]
    if above > rows or below > rows:
        raise ValueError(f"exchange_rows: a halo of {above} and {below} "
                         f"rows around {rows} rows needs a neighbour's "
                         f"neighbour; give each rank at least "
                         f"{max(above, below)} rows")
    return _ExchangeRows.apply(x, above, below, shard)


class _AllGatherRows(torch.autograd.Function):
    """:func:`allgather_rows`. Ranks may hold different numbers of rows
    (unequal blocks): each strip is padded to the largest, gathered, and
    trimmed to its owner's rows. The backward sums the whole frame's
    cotangent over the group and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        spans = [shard.span(i) for i in range(shard.size)]
        most = max(b - a for a, b in spans)
        if x.shape[-2] < most:
            x = torch.cat([x, x.new_zeros(x.shape[:-2] + (
                most - x.shape[-2], x.shape[-1]))], dim=-2)
        parts = _all_gather(x, shard.group, shard.size)
        return torch.cat([p[..., :b - a, :]
                          for p, (a, b) in zip(parts, spans)], dim=-2)

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        whole = _all_reduce(g, shard.group, dist.ReduceOp.SUM)
        return whole[..., shard.r0:shard.r1, :].contiguous(), None


def allgather_rows(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The whole frame [..., h, W] from every rank's rows x [..., rows,
    W]."""
    if x.shape[-2] != shard.rows:
        raise ValueError(f"allgather_rows: {x.shape[-2]} rows for a shard "
                         f"of {shard.rows}")
    return _AllGatherRows.apply(x, shard)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _all_reduce(x, shard.group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.shard.group, dist.ReduceOp.SUM), None


class _AllReduceExtreme(torch.autograd.Function):
    """The group's minimum or maximum. Its cotangent, summed over the
    group, goes to the ranks whose value equals the result, divided by
    their count (the same one all-reduce carries both)."""

    @staticmethod
    def forward(ctx, x, shard, op):
        y = _all_reduce(x, shard.group, op)
        ctx.save_for_backward(x, y)
        ctx.shard = shard
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        hit = (x == y).float()
        n = g.numel()
        both = _all_reduce(torch.cat([g.float().reshape(-1),
                                      hit.reshape(-1)]),
                           ctx.shard.group, dist.ReduceOp.SUM)
        total = both[:n].view(g.shape)
        count = both[n:].view(g.shape)
        return ((total / count) * hit).to(g.dtype), None, None


def allreduce_sum(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The elementwise sum of every rank's x (float32)."""
    return _AllReduceSum.apply(x, shard)


def allreduce_min(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The elementwise minimum of every rank's x."""
    return _AllReduceExtreme.apply(x, shard, dist.ReduceOp.MIN)


def allreduce_max(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The elementwise maximum of every rank's x."""
    return _AllReduceExtreme.apply(x, shard, dist.ReduceOp.MAX)


def reduce_gradients(params, scale: float) -> None:
    """Every parameter's gradient summed over the whole process group and
    times ``scale``, in place: one all-reduce of all of them flattened
    (float32). The parameters without a gradient (the same on every
    rank: ``DeMFINet.unread_parameters``) are left out."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat = _all_reduce(flat, None, dist.ReduceOp.SUM)
    if scale != 1.0:
        flat = flat * scale
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
