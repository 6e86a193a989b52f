"""Command-line interface of the PyTorch port.

Keeps the reference CLI surface for the evaluation phases:

  python -m demfi_torch.main --phase test        --multiple_MFI 8
  python -m demfi_torch.main --phase test_custom --custom_path ./custom_path

plus ``--device`` (``cuda``, the default, or ``cpu``) and
``--fwarp_shift_d`` (window of the deterministic forward warp). The
checkpoint is ``<checkpoint_dir>/<net_type>_exp<N>/<net_type>_exp<N>_latest.pt``
(``_best_PSNR`` / ``_epc<N>`` with the flags below), in the reference's
``.pt`` layout. Training is a later slice of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

from demfi_torch.config import DeMFIConfig


def str2bool(v) -> bool:
    """Boolean CLI parser (the reference's own ``type=bool`` flags parse
    '--flag False' as True, since any non-empty string is truthy).
    Accepts yes/no/true/false/t/f/y/n/1/0, case-insensitive."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("yes", "true", "t", "y", "1"):
        return True
    if s in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def parse_args(argv=None) -> DeMFIConfig:
    p = argparse.ArgumentParser(description="DeMFI in PyTorch on CUDA")
    d = DeMFIConfig()
    p.add_argument("--gpu", type=int, default=0,
                   help="accepted for reference compatibility; ignored "
                        "(select a card with --device cuda:N)")
    p.add_argument("--net_type", type=str, default=d.net_type,
                   choices=["DeMFInet"])
    p.add_argument("--exp_num", type=int, default=d.exp_num)
    p.add_argument("--phase", type=str, default=d.phase,
                   choices=["train", "test", "test_custom"])
    p.add_argument("--test_epoch_point", type=int, default=None)
    p.add_argument("--test_img_dir", type=str, default=d.test_img_dir)
    p.add_argument("--text_dir", type=str, default=d.text_dir)
    p.add_argument("--checkpoint_dir", type=str, default=d.checkpoint_dir)
    p.add_argument("--log_dir", type=str, default=d.log_dir)
    p.add_argument("--test_data_path", type=str, default=d.test_data_path)
    p.add_argument("--t_step_size", type=int, default=d.t_step_size)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--img_ch", type=int, default=d.img_ch,
                   help="accepted for reference CLI compatibility; only "
                        "3 is supported")
    p.add_argument("--nf", type=int, default=d.nf)
    p.add_argument("--scale_factor", type=int, default=d.scale_factor)
    p.add_argument("--patch_size", type=int, default=d.patch_size)
    p.add_argument("--loss_type", type=str, default=d.loss_type,
                   choices=["L1", "MSE", "L1_Charbonnier_loss"])
    p.add_argument("--num_ResB_FACFB", type=int, default=d.num_ResB_FACFB)
    p.add_argument("--num_ResB_Dec", type=int, default=d.num_ResB_Dec)
    p.add_argument("--N_trn", type=int, default=d.N_trn)
    p.add_argument("--N_tst", type=int, default=d.N_tst)
    p.add_argument("--shared_FGAC_flag", type=str2bool,
                   default=d.shared_FGAC_flag)
    p.add_argument("--rec_D2_lambda", type=float, default=d.rec_D2_lambda)
    p.add_argument("--load_best_PSNR_flag", action="store_true")
    p.add_argument("--visualization_flag", action="store_true")
    p.add_argument("--test_patch", type=int, nargs=2, default=list(d.test_patch))
    p.add_argument("--patch_boundary", type=int, default=d.patch_boundary)
    p.add_argument("--multiple_MFI", type=int, default=d.multiple_MFI)
    p.add_argument("--custom_path", type=str, default=d.custom_path)
    p.add_argument("--experimental_tof", "--compute_tOF",
                   dest="experimental_tof", action="store_true",
                   help="EXPERIMENTAL tOF-style metric (not validated "
                        "against the paper's Table 2 numbers; the "
                        "reference code never computes tOF; needs cv2)")
    p.add_argument("--eval_window_batch", type=int, default=d.eval_window_batch)
    p.add_argument("--t_chunk", type=int, default=d.t_chunk)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--device", type=str, default=d.device,
                   help="cuda (default; fails without a card), cuda:N or cpu")
    p.add_argument("--fwarp_shift_d", type=int, default=d.fwarp_shift_d,
                   help="window D of CFR's deterministic forward warp: 0 "
                        "takes the atomic splat (bits vary from run to "
                        "run); D > 0 takes the atomic-free kernel wherever "
                        "max|flow| <= D - 1 (the same bits every run)")
    a = p.parse_args(argv)

    if a.img_ch != 3:
        # The reference plumbs --img_ch only into its data loaders; its
        # model hard-codes 3-channel convs. Reject it instead of
        # ignoring the flag.
        p.error(f"--img_ch {a.img_ch} is not supported: the DeMFI "
                "architecture is 3-channel; only --img_ch 3 is valid")
    if a.fwarp_shift_d < 0:
        p.error("--fwarp_shift_d must be >= 0")

    fields = {f.name for f in dataclasses.fields(DeMFIConfig)}
    kwargs = {k: v for k, v in vars(a).items() if k in fields}
    kwargs["test_patch"] = tuple(a.test_patch)
    return DeMFIConfig(**kwargs)


def _load_eval_model(cfg: DeMFIConfig):
    """Build the model on ``cfg.device`` and load the checkpoint the
    flags name, strictly."""
    from demfi_torch.checkpoint import (checkpoint_path, eval_checkpoint_tag,
                                        load_checkpoint)
    from demfi_torch.models import make_model

    model = make_model(cfg, device=cfg.device)
    path = checkpoint_path(cfg, eval_checkpoint_tag(cfg))
    state_dict, meta = load_checkpoint(path)
    model.load_state_dict(state_dict, strict=True)
    print(f"loaded checkpoint {path}, epoch: {meta.get('last_epoch', '?')}")
    return model


def _eval_engine(cfg: DeMFIConfig):
    from demfi_torch.infer import InferenceEngine

    return InferenceEngine(_load_eval_model(cfg), cfg.N_tst,
                           t_chunk=cfg.t_chunk or None,
                           fetch="full" if cfg.visualization_flag
                           else "images", device=cfg.device)


def run_test(cfg: DeMFIConfig
             ) -> Tuple[float, float, float, float, float, str]:
    from demfi_torch.infer.driver import evaluate

    engine = _eval_engine(cfg)
    print(f"Evaluating on {cfg.test_data_path} with multiple = "
          f"{cfg.multiple_MFI} with full resolution")
    return evaluate(cfg, engine, multiple=cfg.multiple_MFI,
                    epoch=cfg.epochs - 1, test_patch=cfg.test_patch,
                    post_fix=f"_final_x{cfg.multiple_MFI}_full_resolution"
                             f"_Ntst{cfg.N_tst}",
                    window_batch=cfg.eval_window_batch)


def run_test_custom(cfg: DeMFIConfig) -> None:
    from demfi_torch.infer.driver import evaluate_custom

    engine = _eval_engine(cfg)
    print(f"Evaluating on {cfg.custom_path} with multiple = "
          f"{cfg.multiple_MFI}")
    evaluate_custom(cfg, engine, multiple=cfg.multiple_MFI,
                    test_patch=cfg.test_patch)


def cli(argv=None) -> Optional[Tuple[float, float, float, float, float, str]]:
    """Run one phase. ``test`` returns evaluate's (loss, intp_PSNR,
    intp_SSIM, deblur_PSNR, deblur_SSIM, save_path)."""
    cfg = parse_args(argv)
    for f in dataclasses.fields(cfg):
        print(f"# {f.name} : {getattr(cfg, f.name)}")
    if cfg.phase == "train":
        raise SystemExit("--phase train: training is a later slice of the "
                         "PyTorch port; use python -m demfi_tpu.main")
    if cfg.phase == "test":
        return run_test(cfg)
    run_test_custom(cfg)
    return None


if __name__ == "__main__":
    cli()
