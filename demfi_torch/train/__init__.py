from demfi_torch.train.loop import (
    TrainState,
    create_train_state,
    demfi_loss,
    make_optimizer,
    make_train_step,
    set_epoch,
)

__all__ = ["TrainState", "create_train_state", "demfi_loss",
           "make_optimizer", "make_train_step", "set_epoch"]
