from demfi_torch.checkpoint.convert import (
    flax_params_to_state_dict,
    load_checkpoint,
    load_training_checkpoint,
    save_checkpoint,
    state_dict_to_flax_params,
)
from demfi_torch.checkpoint.manager import (
    AsyncExperimentManager,
    ExperimentManager,
    checkpoint_path,
    eval_checkpoint_tag,
)

__all__ = ["flax_params_to_state_dict", "load_checkpoint",
           "load_training_checkpoint", "save_checkpoint",
           "state_dict_to_flax_params", "checkpoint_path",
           "eval_checkpoint_tag", "ExperimentManager",
           "AsyncExperimentManager"]
