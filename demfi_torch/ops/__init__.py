from demfi_torch.ops.reshape import space_to_depth, depth_to_space
from demfi_torch.ops.warp import (
    bwarp,
    bwarp_pair,
    bilinear_sample_abs,
    fwarp,
    cfr_flow_t_align,
    fgac_correlate,
)

__all__ = [
    "space_to_depth",
    "depth_to_space",
    "bwarp",
    "bwarp_pair",
    "bilinear_sample_abs",
    "fwarp",
    "cfr_flow_t_align",
    "fgac_correlate",
]
