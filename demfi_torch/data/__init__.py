from demfi_torch.data.datasets import (
    AdobeTrainDataset,
    CustomDataset,
    EvalDataset,
    EvalItem,
    TrainSample,
    build_custom_index,
    build_eval_index,
    build_train_index,
    get_test_data,
)
from demfi_torch.data.pipeline import TrainLoader, device_prefetch

__all__ = [
    "AdobeTrainDataset",
    "CustomDataset",
    "EvalDataset",
    "EvalItem",
    "TrainLoader",
    "TrainSample",
    "build_custom_index",
    "build_eval_index",
    "build_train_index",
    "device_prefetch",
    "get_test_data",
]
