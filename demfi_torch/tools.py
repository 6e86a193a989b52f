"""Checkpoint conversion tools.

  # reference-format .pt -> flax msgpack + json metadata
  python -m demfi_torch.tools import_pt  DeMFInet_exp1_latest.pt out_dir/

  # flax msgpack (+ json beside it) -> reference-format .pt
  python -m demfi_torch.tools export_pt  checkpoint_dir/DeMFInet_exp1/DeMFInet_exp1_latest.msgpack out.pt
"""
from __future__ import annotations

import json
import os
import sys

import torch

from demfi_torch.checkpoint import msgpack
from demfi_torch.checkpoint.convert import (flax_params_to_state_dict,
                                            load_training_checkpoint,
                                            state_dict_to_flax_params)


def import_pt(src: str, out_dir: str) -> str:
    """Write ``<out_dir>/<stem>.msgpack`` (the flax parameter tree, as
    ``flax.serialization.to_bytes`` writes it) and ``<stem>.json`` (the
    checkpoint's metadata, every ``state_dict*`` entry dropped: the
    optimizer's state does not cross). Returns ``<out_dir>/<stem>``."""
    state_dict, _, meta = load_training_checkpoint(src)
    variables = state_dict_to_flax_params(state_dict)
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, os.path.splitext(os.path.basename(src))[0])
    with open(base + ".msgpack", "wb") as f:
        f.write(msgpack.packb(variables))
    with open(base + ".json", "w") as f:
        json.dump(meta, f, default=float, indent=1)
    print(f"wrote {base}.msgpack ({meta})")
    return base


def export_pt(src_msgpack: str, out_pt: str) -> str:
    """Write the reference's combined ``.pt``: ``state_dict_Model`` beside
    the entries of the ``.json`` next to ``src_msgpack`` (where there is
    one)."""
    with open(src_msgpack, "rb") as f:
        variables = msgpack.unpackb(f.read())
    sd = flax_params_to_state_dict(variables)
    meta_path = src_msgpack.replace(".msgpack", ".json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    torch.save({**meta, "state_dict_Model": sd}, out_pt)
    print(f"wrote {out_pt} ({len(sd)} tensors)")
    return out_pt


def main(argv=None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3 or argv[0] not in ("import_pt", "export_pt"):
        print(__doc__)
        raise SystemExit(2)
    if argv[0] == "import_pt":
        import_pt(argv[1], argv[2])
    else:
        export_pt(argv[1], argv[2])


if __name__ == "__main__":
    main()
