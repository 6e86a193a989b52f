"""Command-line interface of the PyTorch port.

Keeps the reference CLI surface:

  python -m demfi_torch.main --phase train
  python -m demfi_torch.main --phase test        --multiple_MFI 8
  python -m demfi_torch.main --phase test_custom --custom_path ./custom_path

plus ``--device`` (``cuda``, the default, or ``cpu``),
``--fwarp_shift_d`` (window of the deterministic forward warp) and
``--compute_dtype`` (``float32``, the default, or ``bfloat16``: the
convolutions' dtype in every phase; parameters and checkpoints stay
float32). The
checkpoints are ``<checkpoint_dir>/<net_type>_exp<N>/<net_type>_exp<N>_``
``{latest,best_PSNR,epc<N>}.pt`` in the reference's ``.pt`` layout;
training writes them and resumes from them (``--auto_resume``,
``--fine_tuning [--fine_tuning_epoch_point N]``).

Data parallelism: ``--coordinator_address HOST:PORT --num_processes P
--process_id p`` in each of P processes joins them in one
``torch.distributed`` group (NCCL on cards, one per process; gloo with
``--device cpu``; ``demfi_torch.parallel``). Training then wraps the
model in ``DistributedDataParallel``, each process loading its share of
every global batch; ``--phase test`` and ``test_custom`` give each
process whole scenes, round-robin, and sum the meters across them.
``--dist_backend gloo`` lets processes share one card.

Rows across cards (``--mesh_spatial S``, the JAX package's mesh flags,
in every phase): the P processes form P / S data groups of S consecutive
ranks; a group shares out scenes, or loads its share of every global
batch, as one process does, and its ranks each compute a block of every
frame's rows, exactly (``demfi_torch.parallel.make_grid``: blocks of 8
rows, the first ranks taking one more where they do not share out
evenly). ``--mesh_data`` must be P / S, or 0 for that (its default, 1,
is taken too where S = 1). Training then sums the gradients over each
group's ranks and averages them over the groups
(``demfi_torch.train.make_train_step``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from datetime import datetime
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
    p.add_argument("--fine_tuning", action="store_true")
    p.add_argument("--fine_tuning_epoch_point", type=int, default=None)
    p.add_argument("--test_img_dir", type=str, default=d.test_img_dir)
    p.add_argument("--text_dir", type=str, default=d.text_dir)
    p.add_argument("--checkpoint_dir", type=str, default=d.checkpoint_dir)
    p.add_argument("--log_dir", type=str, default=d.log_dir)
    p.add_argument("--train_data_path", type=str, default=d.train_data_path)
    p.add_argument("--test_data_path", type=str, default=d.test_data_path)
    p.add_argument("--t_step_size", type=int, default=d.t_step_size)
    p.add_argument("--t_sampling_num", type=int, default=d.t_sampling_num)
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--freq_display", type=int, default=d.freq_display)
    p.add_argument("--epoch_freq_display", type=int,
                   default=d.epoch_freq_display)
    p.add_argument("--epoch_freq_save", type=int, default=d.epoch_freq_save)
    p.add_argument("--init_lr", type=float, default=d.init_lr)
    p.add_argument("--lr_type", type=str, default=d.lr_type,
                   choices=["linear_decay", "stair_decay", "no_decay"])
    p.add_argument("--lr_dec_fac", type=float, default=d.lr_dec_fac)
    p.add_argument("--lr_milestones", type=int, nargs="+",
                   default=list(d.lr_milestones))
    p.add_argument("--lr_dec_start", type=int, default=d.lr_dec_start)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--weight_decay", type=float, default=d.weight_decay)
    p.add_argument("--need_patch", type=str2bool, default=d.need_patch)
    p.add_argument("--img_ch", type=int, default=d.img_ch,
                   help="accepted for reference CLI compatibility; only "
                        "3 is supported")
    p.add_argument("--nf", type=int, default=d.nf)
    p.add_argument("--scale_factor", type=int, default=d.scale_factor)
    p.add_argument("--patch_size", type=int, default=d.patch_size)
    p.add_argument("--num_thrds", type=int, default=d.num_thrds)
    p.add_argument("--loss_type", type=str, default=d.loss_type,
                   choices=["L1", "MSE", "L1_Charbonnier_loss"])
    p.add_argument("--num_ResB_FACFB", type=int, default=d.num_ResB_FACFB)
    p.add_argument("--num_ResB_Dec", type=int, default=d.num_ResB_Dec)
    p.add_argument("--N_trn", type=int, default=d.N_trn)
    p.add_argument("--N_tst", type=int, default=d.N_tst)
    p.add_argument("--shared_FGAC_flag", type=str2bool,
                   default=d.shared_FGAC_flag)
    p.add_argument("--rec_D1_lambda", type=float, default=d.rec_D1_lambda)
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
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="HOST:PORT of rank 0's TCP store: one process per "
                        "card (or CPU worker) joined by torch.distributed")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", type=str, default=d.dist_backend,
                   choices=["nccl", "gloo"],
                   help="the process group's backend: NCCL on cards and "
                        "gloo on the CPU by default; gloo lets processes "
                        "share one card")
    p.add_argument("--mesh_data", type=int, default=d.mesh_data,
                   help="data groups: process count / --mesh_spatial "
                        "(0: just that; the default 1 is taken too "
                        "without --mesh_spatial)")
    p.add_argument("--mesh_spatial", type=int, default=d.mesh_spatial,
                   help="processes of a data group that split each "
                        "frame's rows")
    p.add_argument("--auto_resume", action="store_true",
                   help="resume from the latest checkpoint if one exists")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--device", type=str, default=d.device,
                   help="cuda (default; fails without a card), cuda:N or cpu")
    p.add_argument("--fwarp_shift_d", type=int, default=d.fwarp_shift_d,
                   help="window D of CFR's deterministic forward warp: 0 "
                        "takes the atomic splat (bits vary from run to "
                        "run); D > 0 takes the atomic-free kernel wherever "
                        "max|flow| <= D - 1 (the same bits every run)")
    p.add_argument("--compute_dtype", type=str, default=d.compute_dtype,
                   choices=["float32", "bfloat16"],
                   help="dtype of the convolutions; parameters, gradients, "
                        "the optimizer's state and checkpoints stay float32")
    a = p.parse_args(argv)

    if a.img_ch != 3:
        # The reference plumbs --img_ch only into its data loaders; its
        # model hard-codes 3-channel convs. Reject it instead of
        # ignoring the flag.
        p.error(f"--img_ch {a.img_ch} is not supported: the DeMFI "
                "architecture is 3-channel; only --img_ch 3 is valid")
    if a.fwarp_shift_d < 0:
        p.error("--fwarp_shift_d must be >= 0")
    if a.mesh_spatial < 1 or a.mesh_data < 0:
        p.error("--mesh_spatial must be >= 1 and --mesh_data >= 0")

    fields = {f.name for f in dataclasses.fields(DeMFIConfig)}
    kwargs = {k: v for k, v in vars(a).items() if k in fields}
    kwargs["test_patch"] = tuple(a.test_patch)
    kwargs["lr_milestones"] = tuple(a.lr_milestones)
    return DeMFIConfig(**kwargs)


def _writer(cfg: DeMFIConfig):
    """A tensorboardX SummaryWriter where the package imports, else
    None."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(cfg.log_dir)


def _save_debug(cfg: DeMFIConfig, model, it: int, frames, ts) -> None:
    """The debug sheet and the sample frames of one training batch (the
    reference saves them while it trains)."""
    import torch

    from demfi_torch.data import imageio
    from demfi_torch.metrics import to_png_uint8
    from demfi_torch.utils.viz import train_debug_sheet

    with torch.no_grad():
        out = model(frames[:, :4].permute(0, 1, 4, 2, 3).contiguous(), ts,
                    num_update=cfg.N_trn)
    frames = frames.cpu().numpy()
    path = os.path.join(cfg.test_img_dir, cfg.model_dir, "while_training")
    os.makedirs(path, exist_ok=True)
    tag = f"trainIdx_{str(it).zfill(5)}"
    imageio.imwrite(os.path.join(path, f"{tag}_Bx20.png"),
                    train_debug_sheet(frames, ts, out))
    t0 = float(ts[0, 0])
    has_final = out.s0_final.shape[0] > 0
    s0, s1, st = ((v[-1] if has_final else p) for v, p in (
        (out.s0_final, out.s0_prime), (out.s1_final, out.s1_prime),
        (out.st_final, out.st_prime)))

    def hwc(x):
        return x[0].detach().permute(1, 2, 0).float().cpu().numpy()
    for name, img in ((f"{tag}_Ovld", hwc(out.ovlp_b0b1)),
                      (f"{tag}_S0_Prd", hwc(s0)),
                      (f"{tag}_t_{t0}_Prd", hwc(st)),
                      (f"{tag}_S1_Prd", hwc(s1)),
                      (f"{tag}_S0_GT", frames[0, 5]),
                      (f"{tag}_t_{t0}_GT", frames[0, 4]),
                      (f"{tag}_S1_GT", frames[0, 6])):
        imageio.imwrite(os.path.join(path, name + ".png"), to_png_uint8(img))


def _join(cfg: DeMFIConfig) -> Tuple[DeMFIConfig, int, int]:
    """Join the process group the flags name (none without them). Returns
    the config, with the rank's device where a group was joined, the
    process id and the process count."""
    import torch.distributed as dist

    from demfi_torch.parallel import init_distributed, rank_device

    pid, pcount = init_distributed(cfg.coordinator_address,
                                   cfg.num_processes, cfg.process_id,
                                   cfg.device, cfg.dist_backend)
    if dist.is_initialized():
        cfg = dataclasses.replace(cfg, device=str(rank_device(cfg.device,
                                                              pid)))
    return cfg, pid, pcount


def run_train(cfg: DeMFIConfig) -> dict:
    """The reference's training phase on ``cfg.device``: epochs of the
    train loader through the train step, the per-epoch meters, debug
    sheets, validation (x2, centre patches, 5 windows per scene) at epoch
    0 and every ``epoch_freq_display`` epochs, the latest / best_PSNR /
    per-epoch checkpoints, and a final full-resolution evaluation at
    x``multiple_MFI`` with N_tst. Returns the epochs run, their mean
    losses, the best PSNR and the final evaluation's results.

    In a process group (the coordinator flags) the model is wrapped in
    ``DistributedDataParallel`` and each process steps on its share of
    every global batch. With ``--mesh_spatial S`` each data group of S
    processes loads one share, each of its ranks computes its rows of it,
    and the step sums the gradients itself (no DDP); validation and the
    final evaluation run on the grid, as ``--phase test`` does. Process
    0 decides whether to resume and hands its restored state to the
    others; it alone writes checkpoints, the text log, TensorBoard and
    debug sheets (of whole frames, with no collective); without a
    spatial axis it alone runs the validation passes; the final
    evaluation is shared out by scenes."""
    from demfi_torch.parallel import destroy_distributed

    cfg, pid, pcount = _join(cfg)
    try:
        return _train(cfg, pid, pcount)
    finally:
        destroy_distributed()


def _train(cfg: DeMFIConfig, pid: int, pcount: int) -> dict:
    import torch.distributed as dist

    from demfi_torch.checkpoint import AsyncExperimentManager
    from demfi_torch.data import (AdobeTrainDataset, TrainLoader,
                                  device_prefetch)
    from demfi_torch.infer import InferenceEngine
    from demfi_torch.infer.driver import evaluate
    from demfi_torch.models import make_model
    from demfi_torch.parallel import (broadcast_object, data_parallel,
                                      make_grid)
    from demfi_torch.train import (create_train_state, make_train_step,
                                   set_epoch)
    from demfi_torch.utils.meters import (AverageMeter, ProgressPrinter,
                                          model_summary)
    from demfi_torch.utils.profiling import StepTimer

    # refuses a --mesh_data that is not P / S
    grid = make_grid(cfg.mesh_data, cfg.mesh_spatial)
    spatial = grid.spatial > 1
    is_main = pid == 0
    em = AsyncExperimentManager(cfg) if is_main else None
    model = make_model(cfg, device=cfg.device)
    device = next(model.parameters()).device
    net = model
    if spatial:
        print(f"mesh: {grid.data} data group(s) x {grid.spatial} ranks "
              f"splitting rows; this is rank {grid.spatial_index} of data "
              f"group {grid.data_index} ({dist.get_backend()} on {device})")
    elif dist.is_initialized():
        net = data_parallel(model, cfg.N_trn)
        print(f"data parallel: process {pid} of {pcount}, "
              f"DistributedDataParallel on {device} ({dist.get_backend()})")
    state = create_train_state(cfg, net)
    if is_main:
        print(model_summary(model))
    step = make_train_step(cfg, grid)
    writer = _writer(cfg) if is_main else None

    def engine(num_update):
        return InferenceEngine(model, num_update, t_chunk=cfg.t_chunk or None,
                               fetch="full" if cfg.visualization_flag
                               else "images", device=device,
                               grid=grid if spatial else None)

    start_epoch = 0
    best_psnr = 0.0
    results = (0.0,) * 5 + ("",)
    # process 0 decides and restores; the others take its state
    resume = broadcast_object(is_main and bool(
        cfg.fine_tuning or (cfg.auto_resume and em.has("latest"))))
    if resume:
        loaded = None
        if is_main:
            loaded = (em.load_epoch(cfg.fine_tuning_epoch_point)
                      if cfg.fine_tuning and cfg.fine_tuning_epoch_point
                      else em.load_latest())
        sd, opt, meta = broadcast_object(loaded)
        model.load_state_dict(sd, strict=True)
        if opt is not None:
            state.optimizer.load_state_dict(opt)
        start_epoch = int(meta.get("last_epoch", -1)) + 1
        best_psnr = float(meta.get("best_PSNR", 0.0))
        # the loaded metrics stand until the next validation pass
        results = tuple(float(meta.get(k, 0.0)) for k in (
            "testLoss", "intp_testPSNR", "intp_testSSIM", "deblur_testPSNR",
            "deblur_testSSIM")) + ("",)
        print(f"resumed at epoch {start_epoch} (best_PSNR {best_psnr})")

    ds = AdobeTrainDataset(cfg.train_data_path, cfg.t_sampling_num,
                           cfg.patch_size, cfg.need_patch)
    # the ranks of a data group load the same share of every batch
    loader = TrainLoader(ds, cfg.batch_size, cfg.num_thrds, cfg.seed,
                         process_id=grid.data_index,
                         process_count=grid.data)
    timer = StepTimer(device)
    if is_main:
        em.write_info("Epoch\tintp_testPSNR\tdeblur_testPSNR\tavg_testPSNR"
                      "\tbest_PSNR\n")
    print("[*] Training starts")
    epoch_losses = []
    for epoch in range(start_epoch, cfg.epochs):
        lr = set_epoch(cfg, state, epoch)
        losses = AverageMeter("trainLoss:", ":.4e")
        d1m = AverageMeter("trainLoss_rec_D1:", ":.4e")
        d2m = AverageMeter("trainLoss_rec_D2:", ":.4e")
        btime = AverageMeter("Batch_Time[s]:", ":6.3f")
        progress = ProgressPrinter(len(loader), btime, losses, d1m, d2m,
                                   prefix=f"Epoch: [{epoch}]")
        print(f"Start epoch {epoch} at [{str(datetime.now())[:-7]}], "
              f"learning rate : [{lr}]")
        debug_its = {0, cfg.freq_display - 1, (cfg.freq_display - 1) * 2}
        for it, (frames, ts) in enumerate(
                device_prefetch(loader.epoch(epoch), device)):
            timer.start()
            m = step(state, frames, ts)
            btime.update(timer.stop())
            losses.update(float(m["total_loss"]))
            d1m.update(float(m["rec_D1"]))
            d2m.update(float(m["rec_D2"]))
            if (it + 1) % cfg.freq_display == 0:
                progress.print(it)
                if writer:
                    tb = it + epoch * len(loader)
                    writer.add_scalar("trainLoss", losses.val, tb)
                    writer.add_scalar("trainLoss_rec_D1", d1m.val, tb)
                    writer.add_scalar("trainLoss_rec_D2", d2m.val, tb)
            if is_main and it in debug_its:
                _save_debug(cfg, model, it, frames, ts)
        epoch_losses.append(losses.avg)

        if ((is_main or spatial)
                and ((epoch + 1) % cfg.epoch_freq_display == 0
                     or epoch == 0)):
            results = evaluate(cfg, engine(cfg.N_trn), multiple=2,
                               epoch=epoch, center_patch=cfg.patch_size,
                               test_type="valid_5_per_scene",
                               post_fix="_x2_valid_5_intervals",
                               writer=writer,
                               window_batch=cfg.eval_window_batch,
                               grid=grid if spatial else None)
            model.train()
        test_loss, intp_p, intp_s, dblr_p, dblr_s, _ = results
        score = (intp_p + dblr_p) / 2
        best_flag = score > best_psnr
        best_psnr = max(score, best_psnr)
        if is_main:
            meta = dict(last_epoch=epoch, best_PSNR=best_psnr,
                        intp_testPSNR=intp_p, intp_testSSIM=intp_s,
                        deblur_testPSNR=dblr_p, deblur_testSSIM=dblr_s,
                        testLoss=test_loss, trainLoss=losses.avg,
                        learningRate=lr, batch_size=cfg.batch_size)
            optimizer_state = state.optimizer.state_dict()
            em.save_latest(model.state_dict(), optimizer_state, meta,
                           best_flag)
            if (epoch + 1) % cfg.epoch_freq_save == 0:
                em.save_epoch(epoch, model.state_dict(), optimizer_state,
                              meta)
            em.write_info(f"{epoch}\t{intp_p:.4}\t{dblr_p:.4}\t{score:.4}"
                          f"\t{best_psnr:.4}\n")

    print("-" * 20, "Training has been ended.", "-" * 20)
    print("best_PSNR of model:", best_psnr)
    final = evaluate(cfg, engine(cfg.N_tst), multiple=cfg.multiple_MFI,
                     epoch=cfg.epochs - 1,
                     post_fix=f"_final_x{cfg.multiple_MFI}_full_resolution"
                              f"_Ntst{cfg.N_tst}",
                     test_patch=cfg.test_patch, writer=writer,
                     window_batch=cfg.eval_window_batch,
                     shard=(pid, pcount), grid=grid if spatial else None)
    if is_main:
        em.close()
    if writer:
        writer.close()
    return dict(start_epoch=start_epoch, epoch_losses=epoch_losses,
                step_seconds=timer.records,
                best_PSNR=best_psnr, final=final)


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
    """The evaluation engine on the process grid the flags name, and the
    grid."""
    from demfi_torch.infer import InferenceEngine
    from demfi_torch.parallel import make_grid

    grid = make_grid(cfg.mesh_data, cfg.mesh_spatial)
    if grid.spatial > 1:
        print(f"mesh: {grid.data} data group(s) x {grid.spatial} ranks "
              f"splitting rows; this is rank {grid.spatial_index} of data "
              f"group {grid.data_index}")
    return InferenceEngine(_load_eval_model(cfg), cfg.N_tst,
                           t_chunk=cfg.t_chunk or None,
                           fetch="full" if cfg.visualization_flag
                           else "images", device=cfg.device,
                           grid=grid), grid


def run_test(cfg: DeMFIConfig
             ) -> Tuple[float, float, float, float, float, str]:
    """``--phase test``; in a process group each data group (each
    process, without --mesh_spatial) evaluates whole scenes,
    round-robin, and the meters are summed across the groups."""
    from demfi_torch.infer.driver import evaluate
    from demfi_torch.parallel import destroy_distributed

    cfg, _, _ = _join(cfg)
    try:
        engine, grid = _eval_engine(cfg)
        print(f"Evaluating on {cfg.test_data_path} with multiple = "
              f"{cfg.multiple_MFI} with full resolution")
        return evaluate(cfg, engine, multiple=cfg.multiple_MFI,
                        epoch=cfg.epochs - 1, test_patch=cfg.test_patch,
                        post_fix=f"_final_x{cfg.multiple_MFI}_full_"
                                 f"resolution_Ntst{cfg.N_tst}",
                        window_batch=cfg.eval_window_batch, grid=grid)
    finally:
        destroy_distributed()


def run_test_custom(cfg: DeMFIConfig) -> None:
    """``--phase test_custom``; in a process group each process
    interpolates whole scenes, round-robin."""
    from demfi_torch.infer.driver import evaluate_custom
    from demfi_torch.parallel import destroy_distributed

    cfg, _, _ = _join(cfg)
    try:
        engine, grid = _eval_engine(cfg)
        print(f"Evaluating on {cfg.custom_path} with multiple = "
              f"{cfg.multiple_MFI}")
        evaluate_custom(cfg, engine, multiple=cfg.multiple_MFI,
                        test_patch=cfg.test_patch, grid=grid)
    finally:
        destroy_distributed()


def cli(argv=None):
    """Run one phase. ``train`` returns run_train's summary, ``test``
    evaluate's (loss, intp_PSNR, intp_SSIM, deblur_PSNR, deblur_SSIM,
    save_path), ``test_custom`` None."""
    cfg = parse_args(argv)
    for f in dataclasses.fields(cfg):
        print(f"# {f.name} : {getattr(cfg, f.name)}")
    if cfg.phase == "train":
        return run_train(cfg)
    if cfg.phase == "test":
        return run_test(cfg)
    run_test_custom(cfg)
    return None


if __name__ == "__main__":
    cli()
