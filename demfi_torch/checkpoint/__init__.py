from demfi_torch.checkpoint.convert import flax_params_to_state_dict

__all__ = ["flax_params_to_state_dict"]
