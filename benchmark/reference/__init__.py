"""The benchmark's plain references, float32 PyTorch, importing nothing of
the program. A configuration file names its reference's class,
``"reference": "<module>:<class>"`` (a module of this package), and the
class is built from the file's ``architecture`` block, so that a
configuration of another size needs a file, and one of another
architecture a file and a reference module, but no edit here."""
from __future__ import annotations

import importlib
from typing import List, Optional


def model_class(config: dict):
    """The reference class that ``config`` names."""
    module, name = config["reference"].split(":")
    return getattr(importlib.import_module(f"benchmark.reference.{module}"),
                   name)


def build(config: dict, state_dict: Optional[dict] = None, device="cpu",
          precision: str = "float32"):
    """The reference of ``config`` on ``device`` holding ``state_dict`` (a
    strict load; None leaves the parameters unset, as on the meta
    device), Stage II built where a boosting step is run. Turns TF32 off
    for cuDNN and cuBLAS, process-wide: on a card float32 convolutions
    would otherwise run in TF32 (a lower precision is only ever the
    control's, by operand rounding)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.device(device):
        model = model_class(config)(
            **config["architecture"],
            stage2=max(config["N_trn"], config["N_tst"]) > 0,
            precision=precision)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def param_shapes(config: dict) -> List[tuple]:
    """(name, shape) of every parameter of ``config``'s reference, in the
    module order the keys of the state dict follow."""
    model = build(config, device="meta")
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
