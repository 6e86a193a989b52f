from demfi_torch.data.datasets import (
    CustomDataset,
    EvalDataset,
    EvalItem,
    build_custom_index,
    build_eval_index,
    get_test_data,
)

__all__ = [
    "CustomDataset",
    "EvalDataset",
    "EvalItem",
    "build_custom_index",
    "build_eval_index",
    "get_test_data",
]
