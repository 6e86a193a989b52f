from demfi_torch.models.demfi import (
    DeMFINet,
    DeMFIOutputs,
    StageIContext,
    make_model,
)

__all__ = ["DeMFINet", "DeMFIOutputs", "StageIContext", "make_model"]
