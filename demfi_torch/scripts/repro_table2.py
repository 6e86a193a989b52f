"""One-command Table-2 reproduction harness.

The day the Adobe240/GoPro240 data and the released
``DeMFInet_exp1_latest.pt`` checkpoint are at hand, reproducing the
paper's Table 2 (DeMFI-Net_rb(5,3), x8) is one invocation:

    python -m demfi_torch.scripts.repro_table2 \\
        --data /path/to/Adobe_240fps_blur --ckpt /path/to/DeMFInet_exp1_latest.pt

on the card (add ``--device cpu`` for the CPU). It preflights the
dataset layout and the checkpoint's key and shape manifest against the
model's state_dict (clear errors before any device time is spent), runs
the ``--phase test`` evaluation (``infer.driver.evaluate``) at x8 (and x2
where asked), prints a diff table against the paper with pass/fail at a
dB budget (0.05 by default), and writes a JSON report
(``<workdir>/repro_table2.json`` unless ``--out`` says otherwise). Exit
code 0 when every metric is within the budget, 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

# Table 2, DeMFI-Net_rb(5,3) row: per dataset {metric: (PSNR, SSIM)}.
TABLE2_RB53 = {
    "adobe": {"deblur": (34.19, 0.9410), "interp_x8": (34.29, 0.9454)},
    "youtube": {"deblur": (33.31, 0.9282), "interp_x8": (33.33, 0.9300)},
    "gopro": {"deblur": (30.82, 0.8991), "interp_x8": (31.25, 0.9102)},
}


def detect_dataset(data_path: str) -> str:
    p = data_path.lower()
    if "gopro" in p:
        return "gopro"
    if "youtube" in p:
        return "youtube"
    return "adobe"


def preflight_dataset(data_path: str) -> dict:
    """Check the evaluation tree's layout (the conventions of
    ``data.datasets.build_eval_index``). Raises SystemExit with what is
    wrong and what is expected."""
    from demfi_torch.data import imageio

    if "BlurLFR" in data_path:
        zf6 = "Gopro" in data_path or "GoPro" in data_path
        sharp = data_path[:-3] + ("_test_GT_zfill6" if zf6
                                  else "_test_GT_zfill5")
        blur = data_path
    else:
        sharp = os.path.join(data_path, "test")
        blur = os.path.join(data_path, "test_blur")
    for d, what in ((blur, "blurry test frames"), (sharp, "sharp GT")):
        if not os.path.isdir(d):
            raise SystemExit(
                f"preflight: missing directory for {what}: {d}\n"
                "expected layout: <data>/test_blur/<scene>/*.png + "
                "<data>/test/<scene>/*.png (or a BlurLFR dir with a "
                "sibling *_test_GT_zfill{5,6})")
    bscenes = sorted(os.listdir(blur))
    sscenes = set(os.listdir(sharp))
    if not bscenes:
        raise SystemExit(f"preflight: no scene directories under {blur}")
    missing = [s for s in bscenes if s not in sscenes]
    if missing:
        raise SystemExit(f"preflight: scenes missing sharp GT: {missing}")
    n_frames, stride = 0, None
    for sc in bscenes:
        frames = sorted(os.listdir(os.path.join(blur, sc)))
        pngs = [f for f in frames if f.endswith(".png")]
        if len(pngs) < 4:
            raise SystemExit(f"preflight: scene {sc} has {len(pngs)} "
                             "blur frames; need >= 4 for one window")
        idxs = [int(f[:-4]) for f in pngs[:3]]
        if stride is None:
            stride = idxs[1] - idxs[0]
        n_frames += len(pngs)
    sample = os.path.join(blur, bscenes[0],
                          sorted(os.listdir(os.path.join(blur, bscenes[0])))[0])
    try:
        img = imageio.imread(sample)
    except (OSError, ValueError):
        raise SystemExit(f"preflight: unreadable png {sample}") from None
    info = dict(scenes=len(bscenes), blur_frames=n_frames,
                frame_stride=stride, height=img.shape[0],
                width=img.shape[1],
                zfill=len(os.path.basename(sample)) - 4)
    print(f"preflight dataset OK: {info}")
    return info


def _checkpoint_file(ckpt: str) -> str:
    """A ``.pt`` as given, or an experiment directory's
    ``<dir name>_latest.pt`` (``<checkpoint_dir>/DeMFInet_exp1`` holds
    ``DeMFInet_exp1_latest.pt``)."""
    if ckpt.endswith(".pt"):
        path = ckpt
    elif os.path.isdir(ckpt):
        name = os.path.basename(os.path.normpath(ckpt))
        path = os.path.join(ckpt, f"{name}_latest.pt")
    else:
        raise SystemExit(f"preflight: unsupported checkpoint {ckpt} "
                         "(expected a reference .pt file or an experiment "
                         "directory holding <name>_latest.pt)")
    if not os.path.isfile(path):
        raise SystemExit(f"preflight: no checkpoint file {path}")
    return path


def preflight_checkpoint(ckpt: str, cfg) -> dict:
    """Load the checkpoint and check its key and shape manifest against
    the state_dict of DeMFI-Net for ``cfg``. Returns the state_dict."""
    from demfi_torch.checkpoint import load_checkpoint
    from demfi_torch.models import make_model

    want = {k: tuple(v.shape)
            for k, v in make_model(cfg, device="cpu").state_dict().items()}
    state_dict, meta = load_checkpoint(_checkpoint_file(ckpt))
    have = {k: tuple(v.shape) for k, v in state_dict.items()}
    missing = sorted(set(want) - set(have))
    extra = sorted(set(have) - set(want))
    bad = sorted(k for k in set(want) & set(have) if want[k] != have[k])
    if missing or extra or bad:
        lines = ["preflight: checkpoint does not match DeMFI-Net_rb params:"]
        for k in missing[:8]:
            lines.append(f"  missing {k} {want[k]}")
        for k in extra[:8]:
            lines.append(f"  unexpected {k} {have[k]}")
        for k in bad[:8]:
            lines.append(f"  shape {k}: ckpt {have[k]} != model {want[k]}")
        raise SystemExit("\n".join(lines))
    print(f"preflight checkpoint OK: {len(have)} arrays, "
          f"epoch={meta.get('last_epoch', '?')}")
    return state_dict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", required=True,
                    help="dataset root (test/ + test_blur/) or BlurLFR dir")
    ap.add_argument("--ckpt", required=True,
                    help="reference DeMFInet_exp1_latest.pt or an "
                         "experiment checkpoint directory")
    ap.add_argument("--dataset", default="auto",
                    choices=["auto", "adobe", "youtube", "gopro"])
    ap.add_argument("--multiples", default="8",
                    help="comma list from {2,8}; Table 2 is x8")
    ap.add_argument("--N_tst", type=int, default=3)
    ap.add_argument("--test_patch", type=int, nargs=2, default=(1, 1))
    ap.add_argument("--budget_db", type=float, default=0.05,
                    help="the dB budget against Table 2")
    ap.add_argument("--compute_dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="float32 reproduces the reference's numerics; "
                         "bfloat16 is the serving mode")
    ap.add_argument("--eval_window_batch", type=int, default=1)
    ap.add_argument("--save_pngs", action="store_true")
    ap.add_argument("--out", default="",
                    help="the JSON report (default "
                         "<workdir>/repro_table2.json)")
    ap.add_argument("--workdir", default="",
                    help="where experiment dirs (pngs/logs) go; default "
                         "a tempdir")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dataset = (detect_dataset(args.data) if args.dataset == "auto"
               else args.dataset)
    ds_info = preflight_dataset(args.data)

    from demfi_torch.config import config_rb
    wd = args.workdir or tempfile.mkdtemp(prefix="repro_t2_")
    out_path = args.out or os.path.join(wd, "repro_table2.json")
    cfg = config_rb(args.N_tst, args.N_tst,
                    test_data_path=args.data,
                    compute_dtype=args.compute_dtype,
                    eval_window_batch=args.eval_window_batch,
                    test_patch=tuple(args.test_patch),
                    checkpoint_dir=os.path.join(wd, "ckpt"),
                    test_img_dir=os.path.join(wd, "imgs"),
                    text_dir=os.path.join(wd, "text"),
                    log_dir=os.path.join(wd, "log"),
                    device=args.device)
    state_dict = preflight_checkpoint(args.ckpt, cfg)

    from demfi_torch.infer import InferenceEngine
    from demfi_torch.infer.driver import evaluate
    from demfi_torch.models import make_model

    model = make_model(cfg, device=args.device)
    model.load_state_dict(state_dict, strict=True)
    engine = InferenceEngine(model, cfg.N_tst, t_chunk=cfg.t_chunk or None,
                             fetch="images", device=args.device)

    report = {"data": args.data, "ckpt": args.ckpt, "dataset": dataset,
              "N_tst": args.N_tst, "dtype": args.compute_dtype,
              "budget_db": args.budget_db, "dataset_info": ds_info,
              "results": {}}
    baseline = TABLE2_RB53[dataset]
    rows, n_fail = [], 0
    for mult in (int(m) for m in args.multiples.split(",")):
        t0 = time.time()
        _, ipsnr, issim, dpsnr, dssim, _ = evaluate(
            cfg, engine, multiple=mult, epoch=0,
            post_fix=f"_repro_x{mult}", save_images=args.save_pngs,
            test_patch=tuple(args.test_patch),
            window_batch=args.eval_window_batch)
        report["results"][f"x{mult}"] = dict(
            interp_psnr=ipsnr, interp_ssim=issim,
            deblur_psnr=dpsnr, deblur_ssim=dssim,
            wall_s=time.time() - t0)
        for name, got_p, got_s in (("deblur", dpsnr, dssim),
                                   (f"interp_x{mult}", ipsnr, issim)):
            if name in baseline:
                ref_p, ref_s = baseline[name]
                d = got_p - ref_p
                ok = abs(d) <= args.budget_db
                n_fail += not ok
                rows.append((f"{dataset} {name}", ref_p, got_p, d,
                             ref_s, got_s, "PASS" if ok else "FAIL"))
            else:
                rows.append((f"{dataset} {name}", float("nan"), got_p,
                             float("nan"), float("nan"), got_s, "info"))

    print(f"\n{'metric':28s} {'Table2':>8s} {'ours':>8s} {'dPSNR':>7s} "
          f"{'SSIM(T2)':>9s} {'SSIM':>7s}  verdict")
    for name, rp, gp, d, rs, gs, v in rows:
        print(f"{name:28s} {rp:8.2f} {gp:8.2f} {d:+7.3f} "
              f"{rs:9.4f} {gs:7.4f}  {v}")
    report["rows"] = [list(r) for r in rows]
    report["pass"] = n_fail == 0
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"\nwrote {out_path}; "
          + ("ALL WITHIN BUDGET" if n_fail == 0
             else f"{n_fail} metrics OUTSIDE the {args.budget_db} dB budget"))
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
