"""The process group of data-parallel runs: one process per card (NCCL)
or per CPU worker (gloo), joined by ``torch.distributed``.

The counterpart of ``demfi_tpu/parallel/distributed.py``. Launch one
process per rank with the same flags but ``--process_id``:

  # one process per card (rank p drives cuda:p unless --device cuda:N)
  python -m demfi_torch.main --phase train ... \\
      --coordinator_address <host of rank 0>:<port> \\
      --num_processes P --process_id p
  # two CPU processes, gloo
  python -m demfi_torch.main --phase train --device cpu ... \\
      --coordinator_address 127.0.0.1:<port> --num_processes 2 \\
      --process_id 0        (and 1 in the second process)

Nothing tells a process of its cluster: the flags name the address of
rank 0's TCP store, the world size and the rank.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


def rank_device(device: str, process_id: int) -> torch.device:
    """The device of rank ``process_id``: ``cuda`` becomes
    ``cuda:{process_id % device_count}``; ``cuda:N`` and ``cpu`` are taken
    as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return torch.device("cuda", process_id % torch.cuda.device_count())


BACKENDS = ("nccl", "gloo")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda",
                     backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group; returns (process_id, process_count).

    With neither an address nor a process count this is a no-op that
    returns (0, 1), as the JAX package's is. Otherwise all three flags
    are needed; a CUDA device becomes the process's current device, the
    group's store is ``tcp://{coordinator_address}``, served by rank 0,
    and its backend ``backend``: by default NCCL for a CUDA device and
    gloo for the CPU. NCCL refuses two ranks on one card; gloo ranks may
    share one (rank p drives ``cuda:{p % device_count}``), their
    collectives staged through the host while the kernels run on the
    card."""
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if not coordinator_address and not num_processes:
        return 0, 1
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs --coordinator_address, "
                         "--num_processes and --process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} outside "
                         f"[0, {num_processes})")
    dev = rank_device(device, process_id)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda"
                                        else "gloo"),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return process_id, num_processes


def destroy_distributed() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _collective_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _joined() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank (pickled; the other ranks'
    arguments are ignored). Without a group of two or more, ``obj``."""
    if not _joined():
        return obj
    box = [obj if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, device=_collective_device())
    return box[0]


def data_parallel(model: torch.nn.Module, num_update: int
                  ) -> DistributedDataParallel:
    """``model`` (a DeMFINet on this process's device) wrapped in
    DistributedDataParallel over the process group; its first broadcast
    gives every process rank 0's weights. The parameters that a forward
    with ``num_update`` iterations never reads
    (``model.unread_parameters``: FGAC's source-key convolution at
    fgac_rr = 0) are left out of the reduction, so every other parameter
    has a gradient each step and DDP needs no per-step search of the graph
    for unused ones (``find_unused_parameters``: 11 ms more a full-width
    float32 train step on an H100, this 3 ms; chip_smoke.py phase 8).
    Left in, DDP's second step fails on them."""
    DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
        model, model.unread_parameters(num_update))
    device = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None)


def allgather_sums(values: Sequence[float]) -> np.ndarray:
    """The sum over ranks of each rank's ``values``, in float64: every
    rank's values are gathered and added in rank order, so every rank
    gets the same bits. Without a group of two or more, the values."""
    local = np.asarray(values, np.float64)
    if not _joined():
        return local.copy()
    t = torch.from_numpy(local).to(_collective_device())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    total = np.zeros_like(local)
    for p in parts:
        total += p.cpu().numpy()
    return total
