"""Checkpoints in the reference's ``.pt`` layout, and weights carried
across from the JAX package's Flax parameter tree.

The port's ``state_dict`` keys and shapes are the reference torch
model's, so a reference ``.pt`` loads with ``strict=True`` and no
conversion. The JAX package's ``.msgpack`` checkpoints cross over with
``python -m demfi_torch.tools export_pt`` (and back with ``import_pt``),
through the port's own msgpack codec (``checkpoint/msgpack.py``).

The Flax modules mirror the reference torch attribute names with list
indices flattened (``RDBs.3`` -> ``RDBs_3``, ``conv.0`` -> ``conv_0``) and
keep conv kernels as HWIO. This maps such a tree, given as numpy arrays,
to the port's ``state_dict``, whose keys and shapes are the reference
torch model's:

  params/FF_RDB_Module/RDBs_3/convs_2/conv_0/kernel  [kH,kW,I,O]
      -> FF_RDB_Module.RDBs.3.convs.2.conv.0.weight  [O,I,kH,kW]
  params/Dec_first/kernel  [3,3,I,O]
      -> Dec_first.weight  [O,I,1,3,3]   (Conv3d, temporal extent 1)
  */bias -> *.bias  (unchanged)

:func:`state_dict_to_flax_params` is the inverse.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# containers that are lists in the torch model: a trailing _N splits back
_LIST_PREFIXES = ("RDBs", "convs", "conv", "GFF", "UPNet",
                  "feature_extraction", "Decoder_res", "Decoder_res_2")
# torch modules that are Conv3d in the reference
_CONV3D_PREFIXES = ("Dec_first.", "Decoder_res.", "Dec_last1.", "Dec_last2.")


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    """('FF_RDB_Module', 'RDBs_3', 'LFF', 'kernel') ->
    'FF_RDB_Module.RDBs.3.LFF.weight'."""
    parts = []
    for p in path[:-1]:
        m = re.fullmatch(r"(.*)_(\d+)", p)
        if m and m.group(1) in _LIST_PREFIXES:
            parts.extend([m.group(1), m.group(2)])
        else:
            parts.append(p)
    leaf = "weight" if path[-1] == "kernel" else path[-1]
    return ".".join(parts + [leaf])


def torch_key_to_flax_path(key: str) -> Tuple[Tuple[str, ...], str]:
    """'FF_RDB_Module.RDBs.3.LFF.weight' ->
    (('FF_RDB_Module', 'RDBs_3', 'LFF'), 'kernel'): each index merged
    into the name before it."""
    parts = key.split(".")
    leaf = parts.pop()
    if leaf == "weight":
        leaf = "kernel"
    elif leaf != "bias":
        raise ValueError(f"unexpected torch leaf {leaf!r} in {key!r}")
    merged: list = []
    for p in parts:
        if re.fullmatch(r"\d+", p):
            if not merged:
                raise ValueError(f"leading index in {key!r}")
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    return tuple(merged), leaf


def _weight_to_kernel(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO; a Conv3d weight [O,I,1,kH,kW] loses its temporal
    axis first."""
    if w.ndim == 5:
        if w.shape[2] != 1:
            raise ValueError(f"only temporal-extent-1 Conv3d supported, "
                             f"got {w.shape}")
        w = w[:, :, 0]
    if w.ndim != 4:
        raise ValueError(f"unexpected conv weight rank {w.shape}")
    return np.transpose(w, (2, 3, 1, 0))


def _kernel_to_weight(k: np.ndarray, conv3d: bool) -> np.ndarray:
    """HWIO -> OIHW, plus a temporal axis of 1 for the Conv3d layers."""
    w = np.transpose(k, (3, 2, 0, 1))
    return w[:, :, None] if conv3d else w


def flax_params_to_state_dict(variables: Mapping[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """{'params': nested numpy tree} -> the port's state_dict (float32
    CPU tensors), loadable with ``load_state_dict(..., strict=True)``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, path + (name,))
                continue
            key = flax_path_to_torch_key(path + (name,))
            arr = np.array(val, np.float32)      # a copy: val may be read-only
            if name == "kernel":
                conv3d = any(key.startswith(p) for p in _CONV3D_PREFIXES)
                arr = _kernel_to_weight(arr, conv3d)
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(variables["params"], ())
    return out


def state_dict_to_flax_params(state_dict: Mapping[str, Any]
                              ) -> Dict[str, Any]:
    """The port's (or the reference's) state_dict -> {'params': nested
    numpy float32 tree}, the inverse of :func:`flax_params_to_state_dict`.
    The nested dicts are built in the state_dict's key order, as the JAX
    package's converter builds them, so the msgpack bytes of the tree
    equal its."""
    root: Dict[str, Any] = {}
    for key, val in state_dict.items():
        arr = np.asarray(val.detach().cpu().numpy()
                         if isinstance(val, torch.Tensor) else val)
        path, leaf = torch_key_to_flax_path(key)
        if leaf == "kernel":
            arr = _weight_to_kernel(arr)
        node = root
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": root}


def load_training_checkpoint(path: str
                             ) -> Tuple[Dict[str, torch.Tensor],
                                        Optional[Dict[str, Any]],
                                        Dict[str, Any]]:
    """Load a ``.pt`` checkpoint -> (state_dict, optimizer state or None,
    metadata).

    Accepts the reference's combined training checkpoint (a dict with
    ``state_dict_Model`` beside ``state_dict_Optimizer``, ``last_epoch``,
    ``best_PSNR``, the metrics and the scheduler's state) or a bare state
    dict. The file is unpickled in full (the combined layout holds plain
    Python and numpy values): load only checkpoints you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict_Model" in ckpt:
        meta = {k: v for k, v in ckpt.items()
                if not k.startswith("state_dict")}
        return (ckpt["state_dict_Model"], ckpt.get("state_dict_Optimizer"),
                meta)
    return ckpt, None, {}


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                        Dict[str, Any]]:
    """Load a ``.pt`` checkpoint -> (state_dict, metadata); see
    :func:`load_training_checkpoint`."""
    state_dict, _, meta = load_training_checkpoint(path)
    return state_dict, meta


def to_cpu(obj: Any) -> Any:
    """A copy of a state dict (nested dicts, lists and tuples of tensors
    and plain values) with every tensor detached and copied to the CPU:
    a snapshot that later updates of the live tensors do not reach."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    meta: Optional[Mapping[str, Any]] = None,
                    optimizer_state: Optional[Mapping[str, Any]] = None
                    ) -> None:
    """Write the combined layout: ``state_dict_Model`` (CPU tensors),
    ``state_dict_Optimizer`` where given, beside the metadata entries.
    The file is written under a temporary name and renamed, so a reader
    never sees half of it."""
    ckpt: Dict[str, Any] = dict(meta or {})
    ckpt["state_dict_Model"] = {k: v.detach().cpu()
                                for k, v in state_dict.items()}
    if optimizer_state is not None:
        ckpt["state_dict_Optimizer"] = to_cpu(optimizer_state)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
