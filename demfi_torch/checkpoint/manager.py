"""Where an experiment's checkpoints live.

The reference's naming rule:
``<checkpoint_dir>/<model_dir>/<model_dir>_{latest,best_PSNR,epc<N>}.pt``.
The experiment manager that writes them (latest / best / per-epoch saves,
the text log) waits for the training slice.
"""
from __future__ import annotations

import os

from demfi_torch.config import DeMFIConfig


def checkpoint_path(cfg: DeMFIConfig, tag: str) -> str:
    """Path of the checkpoint with tag ``latest``, ``best_PSNR`` or
    ``epc<N>``."""
    return os.path.join(cfg.checkpoint_dir, cfg.model_dir,
                        f"{cfg.model_dir}_{tag}.pt")


def eval_checkpoint_tag(cfg: DeMFIConfig) -> str:
    """The checkpoint a test phase loads: ``--test_epoch_point N`` takes
    epoch N - 1 (the reference's load_epc_model), ``--load_best_PSNR_flag``
    the best one, else the latest."""
    if cfg.test_epoch_point:
        return f"epc{cfg.test_epoch_point - 1}"
    return "best_PSNR" if cfg.load_best_PSNR_flag else "latest"
