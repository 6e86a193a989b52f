"""Configuration: the architecture, training, evaluation and experiment
fields of DeMFI.

The port's own copy of the fields its training, inference and
evaluation paths read (the multi-device fields wait for the DDP slice).
What the JAX package reads from the environment is an explicit field
here (``device``, ``fwarp_shift_d``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass
class DeMFIConfig:
    # ---- experiment management ----
    net_type: str = "DeMFInet"
    exp_num: int = 1
    phase: str = "test"  # train | test | test_custom
    test_epoch_point: Optional[int] = None
    fine_tuning: bool = False
    fine_tuning_epoch_point: Optional[int] = None
    test_img_dir: str = "./test_img_dir"
    text_dir: str = "./text_dir"
    checkpoint_dir: str = "./checkpoint_dir"
    log_dir: str = "./log_dir"

    # ---- datasets ----
    train_data_path: str = "./Datasets/Adobe_240fps_blur"
    test_data_path: str = "./Datasets/Adobe_240fps_blur"
    t_step_size: int = 8      # K in the paper
    t_sampling_num: int = 8
    custom_path: str = "./custom_path"

    # ---- training ----
    epochs: int = 7500        # also names the output directory of a test
    freq_display: int = 25
    epoch_freq_display: int = 50
    epoch_freq_save: int = 50
    init_lr: float = 1e-4
    lr_type: str = "stair_decay"   # stair_decay | linear_decay | no_decay
    lr_dec_fac: float = 0.5
    lr_milestones: Sequence[int] = (3750, 6250, 7250)
    lr_dec_start: int = 0
    batch_size: int = 2
    weight_decay: float = 0.0
    need_patch: bool = True
    patch_size: int = 256     # train crop; centre crop of a validation pass
    num_thrds: int = 8
    loss_type: str = "L1"     # L1 | MSE | L1_Charbonnier_loss
    rec_D1_lambda: float = 1.0
    rec_D2_lambda: float = 1.0
    # resume from the latest checkpoint when one exists
    auto_resume: bool = False

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

    def lr_at_epoch(self, epoch: int) -> float:
        """Epoch-indexed schedule. stair_decay: MultiStepLR (the lr is
        multiplied by lr_dec_fac at each milestone reached); linear_decay:
        init_lr until lr_dec_start, then a ramp to zero at ``epochs``;
        no_decay: init_lr."""
        if self.lr_type == "no_decay":
            return self.init_lr
        if self.lr_type == "linear_decay":
            if epoch < self.lr_dec_start:
                return self.init_lr
            return self.init_lr * (self.epochs - epoch) / max(
                self.epochs - self.lr_dec_start, 1)
        n = sum(1 for m in self.lr_milestones if m <= epoch)
        return self.init_lr * (self.lr_dec_fac ** n)


def config_bs(**kw) -> DeMFIConfig:
    """DeMFI-Net_bs: Stage I only (N boosting iterations = 0)."""
    return DeMFIConfig(N_trn=0, N_tst=0, **kw)


def config_rb(n_trn: int = 5, n_tst: int = 3, **kw) -> DeMFIConfig:
    """DeMFI-Net_rb(N_trn, N_tst): recursive boosting."""
    return DeMFIConfig(N_trn=n_trn, N_tst=n_tst, **kw)
