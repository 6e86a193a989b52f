from demfi_torch.parallel.distributed import (
    allgather_sums,
    broadcast_object,
    data_parallel,
    destroy_distributed,
    init_distributed,
    rank_device,
)
from demfi_torch.parallel.grid import Grid, RowShard, make_grid

__all__ = ["Grid", "RowShard", "allgather_sums", "broadcast_object",
           "data_parallel", "destroy_distributed", "init_distributed",
           "make_grid", "rank_device"]
