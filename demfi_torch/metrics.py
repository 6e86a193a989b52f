"""Evaluation metrics with reference parity (host-side numpy).

PSNR/SSIM follow the reference pipeline: float64 RGB in [0, 255],
PSNR = 20 log10(255/sqrt(MSE)); SSIM is the MATLAB variant (11x11
Gaussian, sigma = 1.5, C1/C2 on the 255 scale, valid-cropped by 5 px)
computed over the full 3-channel array. The reference's ``crop_8x8`` is a
no-op: metrics run on full frames.
"""
from __future__ import annotations

import functools
import math

import numpy as np

_SSIM_TAPS = 11
_SSIM_SIGMA = 1.5


def denorm255(x: np.ndarray) -> np.ndarray:
    """[-1,1] float -> [0,255] float."""
    return np.clip((x + 1.0) / 2.0, 0.0, 1.0) * 255.0


def crop_8x8(img: np.ndarray):
    """Reference API parity: computes 32-multiple center-crop offsets but
    returns the image *uncropped* (the reference comments out the crop,
    so all published metrics are on full frames).
    Returns (img, y_offset, x_offset)."""
    ori_h, ori_w = img.shape[0], img.shape[1]
    h = (ori_h // 32) * 32
    w = (ori_w // 32) * 32
    while h > ori_h - 16:
        h -= 32
    while w > ori_w - 16:
        w -= 32
    return img, (ori_h - h) // 2, (ori_w - w) // 2


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR on [0,255] images."""
    a = img1.astype(np.float64)
    b = img2.astype(np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0:
        return float("inf")
    return 20.0 * math.log10(255.0 / math.sqrt(mse))


@functools.lru_cache(maxsize=8)
def _gauss_band(n: int) -> np.ndarray:
    """[n - 10, n] banded matrix whose row i holds the normalised
    11-tap Gaussian at columns i..i+10: a valid-mode correlation along
    an axis of length n as one matrix product. Read-only."""
    i = np.arange(_SSIM_TAPS) - _SSIM_TAPS // 2
    g = np.exp(-(i * i) / (2.0 * _SSIM_SIGMA ** 2))
    g /= g.sum()
    band = np.zeros((n - _SSIM_TAPS + 1, n))
    for k in range(_SSIM_TAPS):
        band[np.arange(n - _SSIM_TAPS + 1), np.arange(n - _SSIM_TAPS + 1) + k] = g[k]
    band.setflags(write=False)
    return band


def _gauss_valid(x: np.ndarray) -> np.ndarray:
    """The 11x11 Gaussian window over maps x [H, N, W, K], at the pixels
    whose window lies inside the image: [H-10, N, K, W-10]. The window is
    separable; each axis is one float64 matrix product with a banded
    matrix (BLAS), which equals the reference's ``cv2.filter2D(...)
    [5:-5, 5:-5]`` to float64 rounding."""
    h, _, w, _ = x.shape
    if h < _SSIM_TAPS or w < _SSIM_TAPS:
        raise ValueError(f"ssim needs at least 11x11 pixels, got {h}x{w}")
    rows = np.tensordot(_gauss_band(h), x, axes=(1, 0))   # [H-10, N, W, K]
    return np.tensordot(rows, _gauss_band(w), axes=(2, 1))


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    a = img1.astype(np.float64).reshape(img1.shape[:2] + (-1,))
    b = img2.astype(np.float64).reshape(img2.shape[:2] + (-1,))
    x = np.empty((a.shape[0], 5) + a.shape[1:])
    x[:, 0], x[:, 1] = a, b
    np.multiply(a, a, out=x[:, 2])
    np.multiply(b, b, out=x[:, 3])
    np.multiply(a, b, out=x[:, 4])
    f = _gauss_valid(x)
    mu1, mu2 = f[:, 0], f[:, 1]
    mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    s1 = f[:, 2] - mu1_sq
    s2 = f[:, 3] - mu2_sq
    s12 = f[:, 4] - mu12
    num = (2 * mu12 + c1) * (2 * s12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2)
    return float((num / den).mean())


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-style SSIM on [0,255] images, [H,W] or [H,W,C].

    For 3-channel inputs the reference computes the value over the full
    RGB array (it calls its single-array function on the 3D array three
    times and averages identical values, which equals once).
    """
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2 or (img1.ndim == 3 and img1.shape[2] in (1, 3)):
        return _ssim_single(np.squeeze(img1), np.squeeze(img2))
    raise ValueError("Wrong input image dimensions.")


def eval_pair(pred_chw_bgr: np.ndarray, gt_chw_bgr: np.ndarray):
    """Reference metric pipeline for one prediction.

    pred/gt are [C,H,W] BGR in [-1,1]. Prediction is denormalized and
    *rounded*, the target is denormalized unrounded; both flipped to RGB.
    Returns (psnr, ssim).
    """
    return eval_pair_hwc(np.transpose(pred_chw_bgr, (1, 2, 0)),
                         np.transpose(gt_chw_bgr, (1, 2, 0)))


def eval_pair_hwc(pred_hwc_bgr: np.ndarray, gt_hwc_bgr: np.ndarray):
    """Same pipeline for NHWC-native arrays ([H,W,C] BGR in [-1,1])."""
    out = np.around(denorm255(pred_hwc_bgr[:, :, ::-1]))
    tgt = denorm255(gt_hwc_bgr[:, :, ::-1])
    return psnr(tgt, out), ssim(tgt, out)


def to_png_uint8(img_hwc_bgr: np.ndarray) -> np.ndarray:
    """[-1,1] BGR float -> uint8 BGR for a PNG file."""
    return denorm255(img_hwc_bgr).astype(np.uint8)


def tof_pair(pred_prev: np.ndarray, pred_cur: np.ndarray,
             gt_prev: np.ndarray, gt_cur: np.ndarray) -> float:
    """EXPERIMENTAL tOF-style temporal consistency.

    Table 2 of the paper reports tOF, but the released reference code
    never computes it, so there is no oracle to match. This follows the
    TecoGAN-style definition (mean |OF(pred_prev, pred_cur) -
    OF(gt_prev, gt_cur)|_1 with Farneback flow on grayscale [0, 255]);
    it has NOT been validated against any published number: treat the
    absolute values as relative-comparison-only. Exposed via
    --experimental_tof. Farneback flow is OpenCV's: this function, alone
    in the package, needs ``cv2``.

    Inputs are [H,W,C] BGR in [-1,1].
    """
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("tof_pair (--experimental_tof) needs OpenCV "
                           "(cv2) for Farneback optical flow") from e

    def gray(x):
        return cv2.cvtColor(denorm255(x).astype(np.uint8),
                            cv2.COLOR_BGR2GRAY)

    params = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                  poly_n=5, poly_sigma=1.2, flags=0)
    f_pred = cv2.calcOpticalFlowFarneback(gray(pred_prev), gray(pred_cur),
                                          None, **params)
    f_gt = cv2.calcOpticalFlowFarneback(gray(gt_prev), gray(gt_cur),
                                        None, **params)
    return float(np.mean(np.abs(f_pred - f_gt)))
