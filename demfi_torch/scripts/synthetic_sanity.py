"""End-to-end learning check on synthetic motion.

Generates a small Adobe240-style dataset with the reference's BIN blur
formation (sharp 240 fps frames of a translating texture; each blurry
frame the average of 11 consecutive sharp frames, at stride 8) and
overfits DeMFI-Net_rb(1,1) (patch 48, batch 2) for ``--steps`` steps.
It passes when the x2 evaluation's interpolation and deblurring PSNR
both rise by more than 6 dB over the untrained model: the loss, the
gradients, the optimizer and the data path learn.

    python -m demfi_torch.scripts.synthetic_sanity [--steps 150] [--root DIR] [--device cpu]

The generator is numpy only: a seeded texture smoothed by three 7x7 box
blurs (reflect-101 border), min-max normalised to [0, 255], translated
with wrap-around by sub-pixel steps (bilinear at the exact position; the
JAX package's ``cv2.warpAffine`` takes the same position in OpenCV 5 and
rounds it to 1/32 pixel in OpenCV 4), and PNGs through
``demfi_torch.data.imageio``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

BOX = 7          # box blur side


def _box_blur(img: np.ndarray) -> np.ndarray:
    """Mean over a BOX x BOX window, reflect-101 border; float32."""
    r = BOX // 2
    p = np.pad(img.astype(np.float64), ((r, r), (r, r), (0, 0)),
               mode="reflect")
    h, w = img.shape[:2]
    rows = sum(p[i:i + h] for i in range(BOX))
    out = sum(rows[:, j:j + w] for j in range(BOX))
    return (out / (BOX * BOX)).astype(np.float32)


def _minmax(img: np.ndarray, lo: float = 0.0, hi: float = 255.0
            ) -> np.ndarray:
    """Scale to [lo, hi] over all channels."""
    smin, smax = float(img.min()), float(img.max())
    scale = (hi - lo) / (smax - smin) if smax > smin else 0.0
    return (img.astype(np.float64) * scale + (lo - smin * scale)).astype(
        np.float32)


def _axis_taps(n: int, shift: float):
    """Source indices (wrapped) and the upper tap's weight of an output
    axis of n pixels moved by ``shift`` (taken at float32, as a float32
    affine matrix holds it): the output at x reads x - shift."""
    src = -float(np.float32(shift))
    i = int(np.floor(src))
    i0 = (np.arange(n) + i) % n
    return i0, (i0 + 1) % n, np.float32(src - i)


def _translate_wrap(img: np.ndarray, tx: float, ty: float) -> np.ndarray:
    """img moved by (tx, ty) pixels with wrap-around, bilinear."""
    h, w = img.shape[:2]
    y0, y1, fy = _axis_taps(h, ty)
    x0, x1, fx = _axis_taps(w, tx)
    one = np.float32(1)
    top = img[y0][:, x0] * ((one - fy) * (one - fx)) \
        + img[y0][:, x1] * ((one - fy) * fx)
    bot = img[y1][:, x0] * (fy * (one - fx)) + img[y1][:, x1] * (fy * fx)
    return top + bot


def make_dataset(root: str, scenes: int = 2, n_sharp: int = 90,
                 size=(64, 96), seed: int = 0) -> None:
    """``train/``, ``train_blur/``, ``test/`` and ``test_blur/`` scene
    trees under ``root``: sharp frames 00000.png..., blurry frames
    00017.png at stride 8 (each the mean of the 11 sharp frames around
    it)."""
    from demfi_torch.data import imageio

    rng = np.random.RandomState(seed)
    h, w = size
    for split in ("train", "test"):
        for s in range(scenes):
            base = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
            for _ in range(3):
                base = _box_blur(base)
            base = _minmax(base)
            vx, vy = rng.uniform(0.5, 1.5, 2)  # px per sharp frame

            sharp_dir = os.path.join(root, split, f"scene{s}")
            blur_dir = os.path.join(root, f"{split}_blur", f"scene{s}")
            os.makedirs(sharp_dir, exist_ok=True)
            os.makedirs(blur_dir, exist_ok=True)

            sharps = []
            for i in range(n_sharp):
                f = _translate_wrap(base, vx * i, vy * i)
                sharps.append(f)
                imageio.imwrite(os.path.join(sharp_dir, f"{i:05d}.png"),
                                f.astype(np.uint8))
            # BIN: the blurry frame at centre c averages sharps c-5..c+5
            for k in range(10):
                c = 17 + 8 * k
                if c + 6 > n_sharp:
                    break
                blur = np.mean(sharps[c - 5:c + 6], axis=0)
                imageio.imwrite(os.path.join(blur_dir, f"{c:05d}.png"),
                                blur.astype(np.uint8))


def run(root: str = "", steps: int = 150, lr: float = 4e-4,
        device: str = "cuda", log=print) -> dict:
    """Generate (where ``root`` holds no dataset yet), measure the
    untrained PSNR, train ``steps`` steps, measure again. Returns the
    PSNRs before and after, the seconds of each part and the verdict."""
    from demfi_torch.config import config_rb
    from demfi_torch.data import AdobeTrainDataset, TrainLoader
    from demfi_torch.infer import InferenceEngine
    from demfi_torch.infer.driver import evaluate
    from demfi_torch.models import make_model
    from demfi_torch.train import create_train_state, make_train_step

    t0 = time.perf_counter()
    root = root or tempfile.mkdtemp(prefix="demfi_synth_")
    if not os.path.exists(os.path.join(root, "train")):
        log(f"generating synthetic BIN dataset under {root}")
        make_dataset(root)
    gen_s = time.perf_counter() - t0

    cfg = config_rb(1, 1, train_data_path=root, test_data_path=root,
                    patch_size=48, batch_size=2, init_lr=lr,
                    test_img_dir=os.path.join(root, "imgs"),
                    text_dir=os.path.join(root, "txt"),
                    checkpoint_dir=os.path.join(root, "ckpt"),
                    log_dir=os.path.join(root, "log"), device=device)
    model = make_model(cfg, device=device)
    ds = AdobeTrainDataset(root, patch_size=48)
    loader = TrainLoader(ds, cfg.batch_size, num_threads=2)

    def val_psnr():
        engine = InferenceEngine(model, num_update=1, device=device)
        out = evaluate(cfg, engine, multiple=2, save_images=False)
        return out[1], out[3]  # interp, deblur PSNR

    t0 = time.perf_counter()
    ip0, dp0 = val_psnr()
    eval_s = time.perf_counter() - t0
    log(f"untrained: interp {ip0:.2f} dB  deblur {dp0:.2f} dB")

    state = create_train_state(cfg, model)
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    it, epoch = 0, 0
    while it < steps:
        for frames, ts in loader.epoch(epoch):
            m = step(state, frames, ts)
            it += 1
            if it % 25 == 0:
                log(f"step {it}: loss {float(m['total_loss']):.4f}")
            if it >= steps:
                break
        epoch += 1
    float(m["total_loss"])         # the last step has run
    train_s = time.perf_counter() - t0

    ip1, dp1 = val_psnr()
    ok = ip1 - ip0 > 6.0 and dp1 - dp0 > 6.0
    log(f"trained({steps} steps): interp {ip1:.2f} dB "
        f"(+{ip1 - ip0:.2f})  deblur {dp1:.2f} dB (+{dp1 - dp0:.2f})")
    log(f"SANITY {'PASS' if ok else 'FAIL'}")
    return dict(interp_db=[ip0, ip1], deblur_db=[dp0, dp1], steps=steps,
                generate_s=gen_s, eval_s=eval_s, train_s=train_s, ok=ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--root", type=str, default="")
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.root, args.steps, args.lr, args.device)
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
