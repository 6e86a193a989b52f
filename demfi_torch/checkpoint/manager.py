"""Experiment and checkpoint management.

The reference's naming rule:
``<checkpoint_dir>/<model_dir>/<model_dir>_{latest,best_PSNR,epc<N>}.pt``,
each file in the reference's combined ``.pt`` layout (``state_dict_Model``,
``state_dict_Optimizer`` and the metadata entries; ``checkpoint/convert.py``).
:class:`ExperimentManager` keeps one experiment's directories, the args
snapshot and results log in ``<text_dir>/<model_dir>.txt``, and its
latest / best_PSNR / per-epoch checkpoints; :class:`AsyncExperimentManager`
writes them on a background thread.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from demfi_torch.checkpoint.convert import (load_training_checkpoint,
                                            save_checkpoint, to_cpu)
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


StateDicts = Tuple[Dict[str, torch.Tensor], Optional[Dict[str, Any]],
                   Dict[str, Any]]


class ExperimentManager:
    """One experiment's directories, text log and checkpoints."""

    def __init__(self, cfg: DeMFIConfig):
        self.cfg = cfg
        for d in (os.path.join(cfg.checkpoint_dir, cfg.model_dir),
                  cfg.text_dir, cfg.log_dir, cfg.test_img_dir):
            os.makedirs(d, exist_ok=True)
        self.text_path = os.path.join(cfg.text_dir, cfg.model_dir + ".txt")
        with open(self.text_path, "a") as f:
            f.write("----- Model parameters -----\n")
            for field in dataclasses.fields(cfg):
                f.write(f"{field.name} : {getattr(cfg, field.name)}\n")

    def write_info(self, text: str) -> None:
        with open(self.text_path, "a") as f:
            f.write(text)

    def path(self, tag: str) -> str:
        return checkpoint_path(self.cfg, tag)

    # ---------------------------------------------------------- save
    def _save_sync(self, tag: str, model_state: Mapping[str, torch.Tensor],
                   optimizer_state: Optional[Mapping[str, Any]],
                   meta: Optional[Mapping[str, Any]],
                   best_psnr_flag: bool = False) -> str:
        path = self.path(tag)
        save_checkpoint(path, model_state, meta, optimizer_state)
        if best_psnr_flag:
            best = self.path("best_PSNR")
            shutil.copyfile(path, best + ".tmp")
            os.replace(best + ".tmp", best)
        return path

    def save(self, tag: str, model_state, optimizer_state=None,
             meta=None) -> str:
        return self._save_sync(tag, model_state, optimizer_state, meta)

    def save_latest(self, model_state, optimizer_state=None, meta=None,
                    best_psnr_flag: bool = False) -> None:
        """Always write latest; copy it to best_PSNR on improvement (the
        reference's save_best_model)."""
        self._save_sync("latest", model_state, optimizer_state, meta,
                        best_psnr_flag)

    def save_epoch(self, epoch: int, model_state, optimizer_state=None,
                   meta=None) -> None:
        self.save(f"epc{epoch}", model_state, optimizer_state, meta)

    # ---------------------------------------------------------- load
    def load(self, tag: str) -> StateDicts:
        """(model state dict, optimizer state dict or None, metadata) of
        the checkpoint ``tag``, on the CPU."""
        return load_training_checkpoint(self.path(tag))

    def load_latest(self) -> StateDicts:
        return self.load("latest")

    def load_best_psnr(self) -> StateDicts:
        return self.load("best_PSNR")

    def load_epoch(self, epoch: int) -> StateDicts:
        """The reference's load_epc_model: ``epoch`` N reads epc{N-1}."""
        return self.load(f"epc{epoch - 1}")

    def has(self, tag: str) -> bool:
        return os.path.exists(self.path(tag))

    def wait(self) -> None:
        """Writes are synchronous here; see AsyncExperimentManager."""


class AsyncExperimentManager(ExperimentManager):
    """ExperimentManager whose saves return at once: the model's and the
    optimizer's state are copied to the host when ``save*`` is called
    (so later steps cannot change what is written), and serialisation and
    the disk writes run on one background thread. ``wait()`` blocks until
    the last save has committed and raises what it raised; loads wait
    first."""

    def __init__(self, cfg: DeMFIConfig):
        super().__init__(cfg)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt")
        self._pending: Optional[concurrent.futures.Future] = None

    def _submit(self, tag, model_state, optimizer_state, meta,
                best_psnr_flag=False) -> str:
        model_state = to_cpu(dict(model_state))
        optimizer_state = (None if optimizer_state is None
                           else to_cpu(optimizer_state))
        self.wait()
        self._pending = self._pool.submit(
            self._save_sync, tag, model_state, optimizer_state, meta,
            best_psnr_flag)
        return self.path(tag)

    def save(self, tag, model_state, optimizer_state=None, meta=None) -> str:
        return self._submit(tag, model_state, optimizer_state, meta)

    def save_latest(self, model_state, optimizer_state=None, meta=None,
                    best_psnr_flag: bool = False) -> None:
        self._submit("latest", model_state, optimizer_state, meta,
                     best_psnr_flag)

    def load(self, tag: str) -> StateDicts:
        self.wait()
        return super().load(tag)

    def has(self, tag: str) -> bool:
        self.wait()
        return super().has(tag)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        """Wait for the last save and stop the writer thread."""
        self.wait()
        self._pool.shutdown(wait=True)
