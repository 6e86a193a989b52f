"""The process grid of ``--mesh_data`` x ``--mesh_spatial``: data groups
of consecutive ranks, and within a group the rows of each frame split
across its ranks.

The counterpart of ``demfi_tpu/parallel/mesh.py``'s ('data', 'spatial')
mesh. There XLA SPMD splits a jitted forward over the mesh's devices;
here there is one process per card (``demfi_torch.parallel.
init_distributed``), and the world of P processes becomes P / S data
groups of S consecutive ranks (``torch.distributed.new_group``). A data
group evaluates whole scenes, as one process does without a grid; inside
it, rank s holds rows [s H / S, (s + 1) H / S) of every padded frame (a
:class:`RowShard`), exchanges halo rows with its neighbours
(``demfi_torch.parallel.halo``), and the group's rank 0 gathers the
outputs. The JAX mesh replaces the reference's serial tile loop (its
utils.py:1389-1450), and so does this grid: a frame that one card cannot
hold untiled is computed whole, exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch.distributed as dist

# a rank's rows and first row are multiples of this: the network's total
# stride (space-to-depth and RefineUNet's three stride-2 encoders,
# DeMFINet.row_stride)
ROW_STRIDE = 8


def row_cuts(h: int, size: int, stride: int = ROW_STRIDE
             ) -> Optional[Tuple[int, ...]]:
    """The first row of each of ``size`` ranks' blocks of a frame of h
    rows, and h: the frame cut into blocks of ``stride`` rows, each rank
    ``floor`` or ``ceil`` of blocks / size of them, the larger shares to
    the first ranks (736 rows at size 8: four ranks of 96 rows, four of
    88). None where the frame is not split: size 1, h not a multiple of
    size (the JAX engine shards H only where it divides) or of stride,
    or fewer blocks than ranks."""
    if size <= 1 or h % size or h % stride or h // stride < size:
        return None
    base, extra = divmod(h // stride, size)
    cuts = [0]
    for i in range(size):
        cuts.append(cuts[-1] + (base + (i < extra)) * stride)
    return tuple(cuts)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """The rows [r0, r1) of a frame of h rows that rank ``index`` of a
    spatial group of ``size`` ranks (``group``) holds. ``above`` and
    ``below`` are the global ranks of its neighbours, None at the frame's
    top and bottom edges. ``cuts``: every rank's first row and h
    (:func:`row_cuts`); empty for h / size rows a rank."""
    h: int
    r0: int
    r1: int
    index: int
    size: int
    group: Any = None
    above: Optional[int] = None
    below: Optional[int] = None
    cuts: Tuple[int, ...] = ()

    @property
    def rows(self) -> int:
        return self.r1 - self.r0

    def span(self, i: int) -> Tuple[int, int]:
        """Rows [a, b) of rank i of the group."""
        if self.cuts:
            return self.cuts[i], self.cuts[i + 1]
        rows = self.h // self.size
        return i * rows, (i + 1) * rows


@dataclasses.dataclass(frozen=True)
class Grid:
    """This process's place in the grid: ``world`` processes in ``data``
    groups of ``spatial`` consecutive ranks, this one ``rank``; ``group``
    is its spatial group (None where spatial == 1)."""
    world: int = 1
    data: int = 1
    spatial: int = 1
    rank: int = 0
    group: Any = None

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def leader(self) -> bool:
        """The rank of its data group that computes metrics and writes
        outputs."""
        return self.spatial_index == 0

    def shard(self, h: int, stride: int = ROW_STRIDE) -> Optional[RowShard]:
        """This rank's rows of a frame of h rows (:func:`row_cuts`), or
        None where the frame is not split: a grid without a spatial axis,
        h not a multiple of it or of ``stride``, or fewer blocks of
        ``stride`` rows than ranks."""
        s = self.spatial
        cuts = row_cuts(h, s, stride)
        if cuts is None:
            return None
        i = self.spatial_index
        base = self.rank - i
        return RowShard(h=h, r0=cuts[i], r1=cuts[i + 1], index=i, size=s,
                        group=self.group,
                        above=base + i - 1 if i > 0 else None,
                        below=base + i + 1 if i < s - 1 else None,
                        cuts=cuts)


def make_grid(mesh_data: int = 0, mesh_spatial: int = 1) -> Grid:
    """The grid of the joined process group (one process without one):
    ``mesh_spatial`` S consecutive ranks per data group, ``mesh_data``
    the number of groups, which must be P / S (0: whatever P / S is).
    Without a spatial axis (S = 1) a ``mesh_data`` of 1, the JAX
    package's default, is taken too: every process is a data group, as
    in a process group the JAX package leaves its mesh aside. Every rank
    must call this, in the same order: each spatial group is made with
    ``torch.distributed.new_group``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    s = int(mesh_spatial)
    if s < 1:
        raise ValueError(f"--mesh_spatial must be >= 1, got {s}")
    if s > world or world % s:
        raise ValueError(
            f"--mesh_spatial {s} splits rows across {s} processes of one "
            f"data group, but the run has {world} process"
            f"{'es' if world != 1 else ''} (start {s} or a multiple of "
            f"{s}, with --coordinator_address, --num_processes and "
            f"--process_id)")
    data = world // s
    if mesh_data not in (0, data) and not (s == 1 and mesh_data == 1):
        raise ValueError(
            f"--mesh_data {mesh_data} does not match the process group: "
            f"{world} processes with --mesh_spatial {s} make {data} data "
            f"groups (give --mesh_data {data}, or 0 for the rest)")
    group = None
    if s > 1:
        for g in range(data):
            ranks = list(range(g * s, (g + 1) * s))
            made = dist.new_group(ranks)
            if rank in ranks:
                group = made
    return Grid(world=world, data=data, spatial=s, rank=rank, group=group)
