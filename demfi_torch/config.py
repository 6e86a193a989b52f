"""Configuration: the architecture, evaluation and experiment fields of
DeMFI.

The port's own copy of the fields its inference and evaluation paths
read (the training, dataset-sampling and multi-device fields wait for
later slices). What the JAX package reads from the environment is an
explicit field here (``device``, ``fwarp_shift_d``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class DeMFIConfig:
    # ---- experiment management ----
    net_type: str = "DeMFInet"
    exp_num: int = 1
    phase: str = "test"  # train | test | test_custom
    test_epoch_point: Optional[int] = None
    test_img_dir: str = "./test_img_dir"
    text_dir: str = "./text_dir"
    checkpoint_dir: str = "./checkpoint_dir"
    log_dir: str = "./log_dir"

    # ---- datasets ----
    test_data_path: str = "./Datasets/Adobe_240fps_blur"
    t_step_size: int = 8      # K in the paper
    custom_path: str = "./custom_path"

    # ---- fields of the training schedule that evaluation reads ----
    epochs: int = 7500        # names the output directory of a final test
    patch_size: int = 256     # centre crop of a validation pass
    loss_type: str = "L1"     # L1 | MSE | L1_Charbonnier_loss
    rec_D2_lambda: float = 1.0

    # ---- architecture ----
    img_ch: int = 3
    nf: int = 64
    scale_factor: int = 2
    num_ResB_FACFB: int = 5
    num_ResB_Dec: int = 5
    N_trn: int = 5
    N_tst: int = 3
    shared_FGAC_flag: bool = True
    # FGAC correlation radii. The released model is point-wise
    # (rr = sr = 0); the generalised window form is supported.
    fgac_rr: int = 0
    fgac_sr: int = 0

    # ---- test settings ----
    load_best_PSNR_flag: bool = False
    visualization_flag: bool = False
    test_patch: Tuple[int, int] = (1, 1)
    patch_boundary: int = 32
    multiple_MFI: int = 8
    # Same-shape windows batched per device call during untiled eval.
    eval_window_batch: int = 1
    # Cap on t-values per device batch in the inference engine (0 = derive
    # it from the free device memory).
    t_chunk: int = 0
    # EXPERIMENTAL: a tOF-style temporal-consistency number during eval
    # (metrics.tof_pair; needs cv2). Not validated against any published
    # number.
    experimental_tof: bool = False
    seed: int = 0

    # ---- device ----
    # "cuda" (the default: a run without a card fails) or "cpu".
    device: str = "cuda"
    # Window of the deterministic forward warp in CFR. 0: the atomic
    # splat (exact for any motion, bits vary from run to run). N > 0: the
    # atomic-free stencil kernel wherever max|flow| <= N - 1 (the same
    # bits every run), the atomic splat elsewhere.
    fwarp_shift_d: int = 0

    @property
    def model_dir(self) -> str:
        return f"{self.net_type}_exp{self.exp_num}"


def config_bs(**kw) -> DeMFIConfig:
    """DeMFI-Net_bs: Stage I only (N boosting iterations = 0)."""
    return DeMFIConfig(N_trn=0, N_tst=0, **kw)


def config_rb(n_trn: int = 5, n_tst: int = 3, **kw) -> DeMFIConfig:
    """DeMFI-Net_rb(N_trn, N_tst): recursive boosting."""
    return DeMFIConfig(N_trn=n_trn, N_tst=n_tst, **kw)
