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

Serving only: under ``torch.is_grad_enabled()`` every function raises.
Their backward (and the warps' row-offset backward kernels) is a later
slice of the port.

Measurement: while ``timing`` is a list, each collective on card tensors
appends the pair of CUDA events recorded on the current stream before
and after it (``chip_smoke.py`` phase 10 sums them into the collectives'
share of a window); None, the default, records nothing.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

import torch
import torch.distributed as dist

from demfi_torch.parallel.distributed import _collective_device
from demfi_torch.parallel.grid import RowShard

timing: Optional[list] = None


def _serving_only(name: str) -> None:
    if torch.is_grad_enabled():
        raise RuntimeError(
            f"{name}: a frame split by rows (--mesh_spatial) serves only; "
            f"its collectives have no backward yet (training's spatial "
            f"axis is a later slice). Run under torch.no_grad() or "
            f"torch.inference_mode().")


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


def _all_gather(x: torch.Tensor, shard: RowShard) -> List[torch.Tensor]:
    """Every rank's x (equal shapes), in rank order, on x's device."""
    with _timed(x):
        return _gather_bits(x, shard)


def _gather_bits(x: torch.Tensor, shard: RowShard) -> List[torch.Tensor]:
    bits = x.contiguous()
    if bits.dtype == torch.bfloat16:     # gloo gathers no bfloat16
        bits = bits.view(torch.uint8)
    t = bits.to(_collective_device())
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t, group=shard.group)
    return [p.to(x.device).view(x.dtype) for p in parts]


def _all_reduce(x: torch.Tensor, shard: RowShard, op) -> torch.Tensor:
    with _timed(x):
        t = x.float().to(_collective_device())
        if t.data_ptr() == x.data_ptr():
            t = t.clone()
        dist.all_reduce(t, op=op, group=shard.group)
        return t.to(x.device).to(x.dtype)


def exchange_rows(x: torch.Tensor, above: int, below: int,
                  shard: RowShard) -> torch.Tensor:
    """x [..., rows, W], this rank's rows of a frame, with ``above`` rows
    of the rank above it and ``below`` rows of the rank below it: [...,
    above + rows + below, W]. At the frame's top and bottom edges the
    missing rows are zeros. Each halo must come from one neighbour
    (above, below <= rows)."""
    _serving_only("exchange_rows")
    if above == 0 and below == 0:
        return x
    rows = x.shape[-2]
    if above > rows or below > rows:
        raise ValueError(f"exchange_rows: a halo of {above} and {below} "
                         f"rows around {rows} rows needs a neighbour's "
                         f"neighbour; give each rank at least "
                         f"{max(above, below)} rows")
    # the first `below` rows go to the rank above, the last `above` rows
    # to the rank below
    strip = torch.cat([x[..., :below, :], x[..., rows - above:, :]], dim=-2)
    parts = _all_gather(strip, shard)
    s = shard.index
    zeros = x.new_zeros

    def edge(n):
        return zeros(x.shape[:-2] + (n, x.shape[-1]))
    top = parts[s - 1][..., below:, :] if s > 0 else edge(above)
    bottom = parts[s + 1][..., :below, :] if s < shard.size - 1 else \
        edge(below)
    return torch.cat([top, x, bottom], dim=-2)


def allgather_rows(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The whole frame [..., h, W] from every rank's rows x [..., rows,
    W]."""
    _serving_only("allgather_rows")
    return torch.cat(_all_gather(x, shard), dim=-2)


def allreduce_sum(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The elementwise sum of every rank's x (float32)."""
    _serving_only("allreduce_sum")
    return _all_reduce(x, shard, dist.ReduceOp.SUM)


def allreduce_min(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The elementwise minimum of every rank's x."""
    _serving_only("allreduce_min")
    return _all_reduce(x, shard, dist.ReduceOp.MIN)


def allreduce_max(x: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The elementwise maximum of every rank's x."""
    _serving_only("allreduce_max")
    return _all_reduce(x, shard, dist.ReduceOp.MAX)
