"""Model configuration: the architecture and test-time fields of DeMFI.

The port's own copy of the fields it needs (the training, dataset and
mesh fields wait for later slices).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class DeMFIConfig:
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
    visualization_flag: bool = False
    test_patch: Tuple[int, int] = (1, 1)
    patch_boundary: int = 32
    multiple_MFI: int = 8
    seed: int = 0


def config_bs(**kw) -> DeMFIConfig:
    """DeMFI-Net_bs: Stage I only (N boosting iterations = 0)."""
    return DeMFIConfig(N_trn=0, N_tst=0, **kw)


def config_rb(n_trn: int = 5, n_tst: int = 3, **kw) -> DeMFIConfig:
    """DeMFI-Net_rb(N_trn, N_tst): recursive boosting."""
    return DeMFIConfig(N_trn=n_trn, N_tst=n_tst, **kw)
