from demfi_torch.parallel.distributed import (
    allgather_sums,
    broadcast_object,
    data_parallel,
    destroy_distributed,
    init_distributed,
    rank_device,
)

__all__ = ["allgather_sums", "broadcast_object", "data_parallel",
           "destroy_distributed", "init_distributed", "rank_device"]
