"""Evaluation loops: GT benchmark eval and custom (GT-free) interpolation.

The reference's ``test`` / ``test_custom`` phases: per-time-index
PSNR/SSIM meters for Stage I ("prime") and Stage II (final),
scene-average rollover, deblur accounting at the t=0.5 sample plus the
trailing S1, PNG outputs; the serial per-t forward is replaced by one
t-batched engine call per 4-frame window, dispatched one batch ahead of
the host-side metrics and PNG work.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np

from demfi_torch.config import DeMFIConfig
from demfi_torch.data.datasets import (CustomDataset, EvalDataset, _imread,
                                       _normalize)
from demfi_torch.data.imageio import imwrite
from demfi_torch.infer.engine import InferenceEngine
from demfi_torch.metrics import eval_pair_hwc, to_png_uint8
from demfi_torch.utils.meters import AverageMeter, ProgressPrinter


def _lookahead(gen, depth: int = 2):
    """Run a generator on a worker thread with a bounded queue so device
    inference overlaps the host-side metrics/PNG work."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # handed to the consumer, which re-raises
            err.append(e)
        finally:
            q.put(None)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            if err:
                raise err[0]
            return
        yield item


def _rec_loss_np(loss_type: str):
    if loss_type == "MSE":
        return lambda a, b: float(np.mean((a - b) ** 2))
    if loss_type == "L1_Charbonnier_loss":
        return lambda a, b: float(np.mean(np.sqrt((a - b) ** 2 + 1e-6)))
    return lambda a, b: float(np.mean(np.abs(a - b)))


class _SlotMeters:
    """PSNR/SSIM meters for interp slots 1..7 + deblur slot 8."""

    def __init__(self, tag: str):
        self.psnr = {i: AverageMeter(f"PSNR_{i}{tag}:", ":.4e")
                     for i in range(1, 9)}
        self.ssim = {i: AverageMeter(f"SSIM_{i}{tag}:", ":.4e")
                     for i in range(1, 9)}

    def reset(self):
        for m in list(self.psnr.values()) + list(self.ssim.values()):
            m.reset()

    def update_from(self, other: "_SlotMeters"):
        for i in range(1, 9):
            self.psnr[i].update(other.psnr[i].avg, 1)
            self.ssim[i].update(other.ssim[i].avg, 1)


@dataclasses.dataclass
class EvalStats:
    """What one :func:`evaluate` call did, for whoever measures it.

    windows: windows evaluated; dispatched: those that went through
    ``dispatch_windows``; wall_seconds: the whole call by the host clock;
    stream_seconds: the engine's ``dispatched_stream_seconds`` of this
    call; decode, metrics, encode: host seconds in PNG decode (on the
    dispatching thread), PSNR/SSIM and PNG encode (on the consuming
    thread), one writer per field."""
    windows: int = 0
    dispatched: int = 0
    wall_seconds: float = 0.0
    stream_seconds: float = 0.0
    decode: float = 0.0
    metrics: float = 0.0
    encode: float = 0.0

    def timed(self, field: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        setattr(self, field, getattr(self, field) + time.perf_counter() - t0)
        return out


# the stats of this process's most recent evaluate call
last_eval_stats: Optional[EvalStats] = None


def _load_window(ds: EvalDataset, w: int):
    """Load one 4-frame window: blur inputs once + per-t GT frames."""
    m1 = ds.multiple - 1
    items = ds.items[w * m1:(w + 1) * m1]
    blur = np.stack([_imread(p) for p in items[0].blur_paths])
    s0 = _imread(items[0].s0_path)
    s1 = _imread(items[0].s1_path)
    sts = np.stack([_imread(it.st_path) for it in items])
    if ds.center_patch:
        ps = ds.center_patch
        ih, iw = blur.shape[1:3]
        iy, ix = (ih - ps) // 2, (iw - ps) // 2
        sl = np.s_[iy:iy + ps, ix:ix + ps]
        blur = blur[:, sl[0], sl[1]]
        s0, s1 = s0[sl], s1[sl]
        sts = sts[:, sl[0], sl[1]]
    return (_normalize(blur), _normalize(s0[None])[0], _normalize(s1[None])[0],
            _normalize(sts), items)


def _owned_windows(items, m1: int, n_windows: int, shard: Tuple[int, int]):
    """Windows of the scenes this process owns: whole scenes go
    round-robin to processes (scene rollover and the trailing-S1 deblur
    need contiguous scenes)."""
    pid, pcount = shard
    if pcount <= 1:
        return list(range(n_windows))
    scene_order = []
    for w in range(n_windows):
        sc = items[w * m1].scene
        if not scene_order or scene_order[-1] != sc:
            scene_order.append(sc)
    owned = set(scene_order[pid::pcount])
    return [w for w in range(n_windows) if items[w * m1].scene in owned]


def _viz_grid(res, j: int, st_gt):
    from demfi_torch.utils.viz import eval_visualization
    return eval_visualization(
        res.ovlp[j], res.st_prime[j], res.st_final[j], st_gt,
        res.flow_init[j], res.flow_final[j],
        res.occ0_init[j], res.occ0_final[j],
        res.blend_w0[j], res.blend_w1[j], res.diff_10[j], res.diff_01[j],
        fgac_10=(res.fgac_src_10[j], res.fgac_ref_10[j],
                 res.fgac_warp_10[j], res.fgac_fcw_10[j]),
        fgac_01=(res.fgac_src_01[j], res.fgac_ref_01[j],
                 res.fgac_warp_01[j], res.fgac_fcw_01[j]),
        flow_01=res.flow_01[j], flow_10=res.flow_10[j])


def evaluate(cfg: DeMFIConfig, engine: InferenceEngine, multiple: int,
             epoch: int = 0, center_patch: Optional[int] = None,
             test_type: Optional[str] = None, post_fix: str = "",
             save_images: bool = True, writer=None,
             test_patch: Tuple[int, int] = (1, 1),
             window_batch: int = 1,
             shard: Tuple[int, int] = (0, 1),
             ) -> Tuple[float, float, float, float, float, str]:
    """GT evaluation (reference ``test``). Returns (loss, intp_PSNR,
    intp_SSIM, deblur_PSNR, deblur_SSIM, save_path); the call's counts
    and seconds are left in ``last_eval_stats``.

    ``shard=(process_id, process_count)`` assigns whole scenes
    round-robin to processes. The cross-process gather of the meters
    belongs to the multi-GPU slice: ``process_count > 1`` raises."""
    if multiple not in (2, 8):
        raise ValueError("phase test supports multiple in {2, 8}")
    if shard[1] > 1:
        raise NotImplementedError(
            "evaluate with shard=(pid, pcount > 1) needs the cross-process "
            "gather of the meters, which comes with the DDP slice")
    ds = EvalDataset(cfg.test_data_path, multiple, cfg.t_step_size,
                     center_patch=center_patch, test_type=test_type)
    m1 = multiple - 1
    n_windows = len(ds) // m1
    owned = _owned_windows(ds.items, m1, n_windows, shard)
    rec = _rec_loss_np(cfg.loss_type)
    stats = EvalStats(windows=len(owned))
    wall0 = time.perf_counter()
    # the engine counts what went through dispatch_windows (stubs do not)
    disp0 = (getattr(engine, "dispatched_windows", 0),
             getattr(engine, "dispatched_stream_seconds", 0.0))

    batch_time = AverageMeter("Time:", ":6.3f")
    losses = AverageMeter("testLoss:", ":.4e")
    intp_psnr = {"prime": AverageMeter("intp_testPSNR_prime:", ":.4e"),
                 "final": AverageMeter("intp_testPSNR:", ":.4e")}
    intp_ssim = {"prime": AverageMeter("intp_testSSIM_prime:", ":.4e"),
                 "final": AverageMeter("intp_testSSIM:", ":.4e")}
    deblur_psnr = {"prime": AverageMeter("deblur_testPSNR_prime:", ":.4e"),
                   "final": AverageMeter("deblur_testPSNR:", ":.4e")}
    deblur_ssim = {"prime": AverageMeter("deblur_testSSIM_prime:", ":.4e"),
                   "final": AverageMeter("deblur_testSSIM:", ":.4e")}
    total = {k: _SlotMeters("_prime" if k == "prime" else "")
             for k in ("prime", "final")}
    scene = {k: _SlotMeters("_scene_prime" if k == "prime" else "_scene")
             for k in ("prime", "final")}

    if "val" in post_fix:
        save_root = os.path.join(cfg.test_img_dir, cfg.model_dir,
                                 "val_latest_" + post_fix)
    else:
        save_root = os.path.join(cfg.test_img_dir, cfg.model_dir,
                                 f"epoch_{str(epoch).zfill(5)}{post_fix}")
    os.makedirs(save_root, exist_ok=True)

    prev_scene = None
    last_s1 = None  # (psnr_p, ssim_p, psnr_f, ssim_f) of trailing S1
    tof_meter = AverageMeter("tOF:", ":.4e")
    prev_pred_st = None
    prev_gt_st = None

    def finalize_scene():
        """Scene rollover: trailing-S1 deblur update + fold scene
        averages into the totals."""
        if last_s1 is not None:
            pp, sp, pf, sf = last_s1
            scene["prime"].psnr[8].update(pp, 1)
            scene["prime"].ssim[8].update(sp, 1)
            scene["final"].psnr[8].update(pf, 1)
            scene["final"].ssim[8].update(sf, 1)
            deblur_psnr["prime"].update(pp, 1)
            deblur_ssim["prime"].update(sp, 1)
            deblur_psnr["final"].update(pf, 1)
            deblur_ssim["final"].update(sf, 1)
        for k in ("prime", "final"):
            total[k].update_from(scene[k])
            scene[k].reset()

    def iter_dispatched():
        """Yield (chunk, pending-or-results): load ``window_batch``
        same-shape windows, then either dispatch them asynchronously
        (untiled: a pending handle) or run them eagerly (tiled path)."""
        w = 0
        n_owned = len(owned)
        while w < n_owned:
            chunk = [stats.timed("decode", _load_window, ds, owned[w])]
            h_, w_ = chunk[0][0].shape[1:3]
            # the batched path skips the reflect-pad step, so it requires
            # 32-multiple frames (forward_window pads otherwise)
            if test_patch == (1, 1) and h_ % 32 == 0 and w_ % 32 == 0:
                while (len(chunk) < window_batch
                       and w + len(chunk) < n_owned):
                    nxt = stats.timed("decode", _load_window, ds,
                                     owned[w + len(chunk)])
                    if nxt[0].shape != chunk[0][0].shape:
                        break
                    chunk.append(nxt)
            t0 = time.time()
            if test_patch == (1, 1):
                frames = np.stack([c[0] for c in chunk])
                ts_b = np.asarray([[it.t_value for it in c[4]]
                                   for c in chunk], np.float32)
                dispatch = getattr(engine, "dispatch_windows", None)
                if dispatch is not None:
                    pending = dispatch(frames, ts_b,
                                       patch_boundary=cfg.patch_boundary)
                    if pending is not None:
                        yield chunk, ("pending", pending, t0)
                        w += len(chunk)
                        continue
                elif len(chunk) > 1:   # engine-like stubs (tests)
                    yield chunk, ("done", engine.forward_windows(
                        frames, ts_b,
                        patch_boundary=cfg.patch_boundary), t0)
                    w += len(chunk)
                    continue
            results = [engine.forward_window(
                c[0][None],
                np.asarray([it.t_value for it in c[4]], np.float32),
                test_patch=test_patch,
                patch_boundary=cfg.patch_boundary) for c in chunk]
            yield chunk, ("done", results, t0)
            w += len(chunk)

    def iter_results():
        """Yield (window_data, WindowResult) with a two-deep device
        pipeline: chunk N+1 is dispatched before chunk N's results are
        fetched, so the device computes through the readback and the
        consumer's metrics work."""
        it = iter_dispatched()
        prev = next(it, None)
        while prev is not None:
            nxt = next(it, None)
            chunk, (kind, payload, t0) = prev
            results = (engine.fetch_windows(payload)
                       if kind == "pending" else payload)
            batch_time.update((time.time() - t0) / len(chunk), len(chunk))
            for c, r in zip(chunk, results):
                yield c, r
            prev = nxt

    for w, ((blur, s0_gt, s1_gt, sts_gt, items), res) in enumerate(
            _lookahead(iter_results())):
        if items[0].scene != prev_scene:
            if prev_scene is not None:
                finalize_scene()
            prev_scene = items[0].scene
            prev_pred_st = prev_gt_st = None

        scene_dir = os.path.join(save_root, items[0].scene)
        if save_images:
            os.makedirs(scene_dir, exist_ok=True)

        for j, it in enumerate(items):
            def pair(pred, gt):
                return stats.timed("metrics", eval_pair_hwc, pred, gt)
            p_st_p, s_st_p = pair(res.st_prime[j], sts_gt[j])
            p_st_f, s_st_f = pair(res.st_final[j], sts_gt[j])
            p_s0_p, s_s0_p = pair(res.s0_prime[j], s0_gt)
            p_s0_f, s_s0_f = pair(res.s0_final[j], s0_gt)
            p_s1_p, s_s1_p = pair(res.s1_prime[j], s1_gt)
            p_s1_f, s_s1_f = pair(res.s1_final[j], s1_gt)
            last_s1 = (p_s1_p, s_s1_p, p_s1_f, s_s1_f)

            losses.update(cfg.rec_D2_lambda
                          * rec(res.st_final[j], sts_gt[j]), 1)

            if cfg.experimental_tof:
                from demfi_torch.metrics import tof_pair
                if prev_pred_st is not None:
                    tof_meter.update(tof_pair(prev_pred_st, res.st_final[j],
                                              prev_gt_st, sts_gt[j]), 1)
                prev_pred_st = res.st_final[j]
                prev_gt_st = sts_gt[j]

            # interp slot: x8 -> slots 1..7; x2 -> slot 4
            slot = (j + 1) if multiple == 8 else 4
            for k, (pv, sv) in (("prime", (p_st_p, s_st_p)),
                                ("final", (p_st_f, s_st_f))):
                scene[k].psnr[slot].update(pv, 1)
                scene[k].ssim[slot].update(sv, 1)
                intp_psnr[k].update(pv, 1)
                intp_ssim[k].update(sv, 1)

            # deblur at the t=0.5 sample (x8: j==3; x2: every sample)
            if (multiple == 8 and j == 3) or multiple == 2:
                scene["prime"].psnr[8].update(p_s0_p, 1)
                scene["prime"].ssim[8].update(s_s0_p, 1)
                scene["final"].psnr[8].update(p_s0_f, 1)
                scene["final"].ssim[8].update(s_s0_f, 1)
                deblur_psnr["prime"].update(p_s0_p, 1)
                deblur_ssim["prime"].update(s_s0_p, 1)
                deblur_psnr["final"].update(p_s0_f, 1)
                deblur_ssim["final"].update(s_s0_f, 1)

            if save_images:
                def save(directory, path, img_u8):
                    stats.timed("encode", imwrite, os.path.join(
                        directory, os.path.basename(path)), img_u8)
                save(scene_dir, it.st_path, to_png_uint8(res.st_final[j]))
                if j == 0 or (multiple == 8 and j == 3) or multiple == 2:
                    save(scene_dir, it.s0_path, to_png_uint8(res.s0_final[j]))
                    save(scene_dir, it.s1_path, to_png_uint8(res.s1_final[j]))
                if cfg.visualization_flag:
                    viz_dir = os.path.join(
                        save_root + "_visualizations", items[0].scene)
                    os.makedirs(viz_dir, exist_ok=True)
                    save(viz_dir, it.st_path, _viz_grid(res, j, sts_gt[j]))

        if writer is not None:
            tb = w * m1 + epoch * len(ds)
            writer.add_scalar("testLoss", losses.val, tb)
            writer.add_scalar("intp_testPSNR", intp_psnr["final"].val, tb)
            writer.add_scalar("deblur_testPSNR", deblur_psnr["final"].val, tb)

    finalize_scene()

    n_print = n_windows
    print("-" * 40 + f" x{multiple} MFI results " + "-" * 40)
    for k in ("prime", "final"):
        stage = "Stage I" if k == "prime" else "Stage II"
        pp = ProgressPrinter(n_print, *total[k].psnr.values(),
                             prefix=f"[PSNR {stage} (7 intp, 1 dblr)] :")
        pp.print(n_print)
        ps = ProgressPrinter(n_print, *total[k].ssim.values(),
                             prefix=f"[SSIM {stage} (7 intp, 1 dblr)] :")
        ps.print(n_print)
    if cfg.experimental_tof:
        print(" tOF (EXPERIMENTAL, unvalidated definition):", tof_meter.avg)
    print(" Average Inference Time per Window:", batch_time.avg)
    stats.dispatched = getattr(engine, "dispatched_windows", 0) - disp0[0]
    stats.stream_seconds = \
        getattr(engine, "dispatched_stream_seconds", 0.0) - disp0[1]
    stats.wall_seconds = time.perf_counter() - wall0
    global last_eval_stats
    last_eval_stats = stats
    return (losses.avg, intp_psnr["final"].avg, intp_ssim["final"].avg,
            deblur_psnr["final"].avg, deblur_ssim["final"].avg, save_root)


def evaluate_custom(cfg: DeMFIConfig, engine: InferenceEngine,
                    multiple: int,
                    test_patch: Tuple[int, int] = (1, 1),
                    shard: Tuple[int, int] = (0, 1)) -> None:
    """GT-free interpolation of user scenes (reference ``test_custom``):
    writes S0/S1 once per window plus every St into
    <custom_path>/<scene>_sharply_interpolated_xM/.

    ``shard=(process_id, process_count)`` assigns whole scenes
    round-robin for multi-process runs (each process writes its own)."""
    ds = CustomDataset(cfg.custom_path, multiple)
    m1 = multiple - 1
    n_windows = len(ds) // m1
    batch_time = AverageMeter("Time:", ":6.3f")

    for w in _owned_windows(ds.items, m1, n_windows, shard):
        items = ds.items[w * m1:(w + 1) * m1]
        blur = _normalize(np.stack([_imread(p)
                                    for p in items[0].blur_paths]))
        ts = np.asarray([it.t_value for it in items], np.float32)
        t0 = time.time()
        res = engine.forward_window(blur[None], ts, test_patch=test_patch,
                                    patch_boundary=cfg.patch_boundary)
        batch_time.update(time.time() - t0)

        out_dir = os.path.join(
            cfg.custom_path,
            f"{items[0].scene}_sharply_interpolated_x{multiple}")
        os.makedirs(out_dir, exist_ok=True)
        imwrite(os.path.join(out_dir, items[0].s0_path),
                to_png_uint8(res.s0_final[0]))
        imwrite(os.path.join(out_dir, items[0].s1_path),
                to_png_uint8(res.s1_final[0]))
        for j, it in enumerate(items):
            imwrite(os.path.join(out_dir, it.st_path),
                    to_png_uint8(res.st_final[j]))
            print(f"png for predicted St frame has been saved in "
                  f"[{os.path.join(out_dir, it.st_path)}]")

            if cfg.visualization_flag:
                viz_dir = out_dir + "_visualizations"
                os.makedirs(viz_dir, exist_ok=True)
                imwrite(os.path.join(viz_dir, it.st_path),
                        _viz_grid(res, j, None))
    print(" Average Inference Time per Window:", batch_time.avg)
