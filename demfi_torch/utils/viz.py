"""Visualization: flow colouring and the component grid.

Middlebury-colourwheel flow rendering and the ``--visualization_flag``
component grid (inputs / predictions / GT / flows / occlusions / FGAC
internals / error maps), on NHWC numpy arrays, and the training debug
sheet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from demfi_torch.metrics import denorm255


def _colorwheel() -> np.ndarray:
    """Middlebury optical-flow color wheel (RY/YG/GC/CB/BM/MR segments)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[:ry, 0] = 255
    wheel[:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


_WHEEL = _colorwheel()


def flow_to_color(flow_hw2: np.ndarray, max_mag: Optional[float] = None
                  ) -> np.ndarray:
    """[H,W,2] flow -> uint8 [H,W,3] RGB, Middlebury convention."""
    u = flow_hw2[..., 0].astype(np.float64)
    v = flow_hw2[..., 1].astype(np.float64)
    u = np.nan_to_num(u)
    v = np.nan_to_num(v)
    mag = np.sqrt(u * u + v * v)
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-9)
    u, v = u / max_mag, v / max_mag
    mag = mag / max_mag

    n = len(_WHEEL)
    angle = np.arctan2(-v, -u) / np.pi          # [-1, 1]
    fk = (angle + 1.0) / 2.0 * (n - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = fk - k0

    img = np.zeros(flow_hw2.shape[:2] + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(mag <= 1, 1 - mag * (1 - col), col * 0.75)
        img[..., c] = np.floor(255.0 * col)
    return img


def _to_u8(img_hwc: np.ndarray) -> np.ndarray:
    """[-1,1] float -> uint8."""
    return denorm255(img_hwc).astype(np.uint8)


def _gray_u8(x_hw1: np.ndarray, scale01: bool = True) -> np.ndarray:
    """[H,W,1] in [0,1] -> uint8 [H,W,3]."""
    v = np.clip(x_hw1[..., 0], 0, 1) * 255 if scale01 else x_hw1[..., 0]
    v = v.astype(np.uint8)
    return np.stack([v, v, v], axis=-1)


def make_grid(rows: Sequence[Sequence[np.ndarray]]) -> np.ndarray:
    """Tile uint8 [H,W,3] cells into one image; rows padded to equal len."""
    h, w = rows[0][0].shape[:2]
    ncols = max(len(r) for r in rows)
    grid = np.zeros((len(rows) * h, ncols * w, 3), np.uint8)
    for i, row in enumerate(rows):
        for j, cell in enumerate(row):
            grid[i * h:(i + 1) * h, j * w:(j + 1) * w] = cell
    return grid


def _nhwc(x) -> np.ndarray:
    """A model output (torch, [..., C, H, W]) as numpy [..., H, W, C]."""
    x = x.detach().float().cpu().numpy()
    return np.moveaxis(x, -3, -1)


def train_debug_sheet(frames_gt: np.ndarray, t_value: np.ndarray,
                      out) -> np.ndarray:
    """Per-batch 20-column debug sheet (the reference's get_batch_images):
    for each sample a row of
    [ovlp, S0', St', S1', S0, St, S1 (last iteration), St_GT, S0_GT, S1_GT,
     flow_t0 / flow_t1 colourings (initial, final), occlusion (initial,
     final), FGAC diff maps, FGAC gates].

    frames_gt: the loader's batch [B, 9, H, W, 3] (numpy, NHWC); out: the
    model's DeMFIOutputs (torch, NCHW)."""
    flow_preds = _nhwc(out.flow_preds)
    occ = _nhwc(out.occ0_preds)
    ovlp = _nhwc(out.ovlp_b0b1)
    primes = [_nhwc(v) for v in (out.s0_prime, out.st_prime, out.s1_prime)]
    has_final = out.s0_final.shape[0] > 0
    finals = ([_nhwc(v[-1]) for v in (out.s0_final, out.st_final,
                                      out.s1_final)]
              if has_final else primes)
    diffs = [_nhwc(v) for v in out.diff_maps]
    gates = [_nhwc(v) for v in out.blend_weights]
    rows = []
    for i in range(frames_gt.shape[0]):
        rows.append(
            [_to_u8(ovlp[i])] + [_to_u8(v[i]) for v in primes]
            + [_to_u8(v[i]) for v in finals]
            + [_to_u8(frames_gt[i, k]) for k in (4, 5, 6)]
            + [flow_to_color(flow_preds[0][i, ..., :2]),
               flow_to_color(flow_preds[0][i, ..., 2:]),
               flow_to_color(flow_preds[-1][i, ..., :2]),
               flow_to_color(flow_preds[-1][i, ..., 2:]),
               _gray_u8(occ[0][i]), _gray_u8(occ[-1][i])]
            + [_gray_u8(v[i]) for v in diffs + gates])
    return make_grid(rows)


def _norm_gray_u8(x_hw1: np.ndarray) -> np.ndarray:
    """Min-max-normalized single-channel map -> uint8 gray (the
    reference's rows-1/2 error panels)."""
    v = x_hw1[..., 0].astype(np.float64)
    v = v - v.min()
    mx = v.max()
    if mx > 0:
        v = v / mx
    v = (v * 255).astype(np.uint8)
    return np.stack([v, v, v], axis=-1)


def eval_visualization(ovlp: np.ndarray, st_prime: np.ndarray,
                       st_final: np.ndarray, st_gt: Optional[np.ndarray],
                       flow_init: np.ndarray, flow_final: np.ndarray,
                       occ_init: np.ndarray, occ_final: np.ndarray,
                       blend_w0: np.ndarray, blend_w1: np.ndarray,
                       diff_10: np.ndarray, diff_01: np.ndarray,
                       fgac_10: Optional[Sequence[np.ndarray]] = None,
                       fgac_01: Optional[Sequence[np.ndarray]] = None,
                       flow_01: Optional[np.ndarray] = None,
                       flow_10: Optional[np.ndarray] = None
                       ) -> np.ndarray:
    """--visualization_flag component grid (the reference's
    ``visualizations``): 3x10 layout.

      row 0: overlay, St'(D1), St(D2), GT, flow_t0 init/final colorings,
             occ init/final, raw |err| maps (prime, final)
      row 1 (1to0): w, 1-w, source_v, init_ref_k, E_s("warped"),
             flow_01 coloring, diff_1to0, FCW, normalized err maps
      row 2 (0to1): same with the 0to1 tensors and flow_10

    ``fgac_10``/``fgac_01`` are the (source_v, init_ref_k, E_s, FCW)
    normalized 1-channel stacks from the model's ``viz_internals`` mode;
    cells fall back to blank when they're absent (model ran without
    visualization outputs)."""
    h, w = ovlp.shape[:2]
    blank = np.zeros((h, w, 3), np.uint8)
    gt_cell = _to_u8(st_gt) if st_gt is not None else blank
    err_p = err_f = err_pn = err_fn = blank
    if st_gt is not None:
        ep = np.mean(np.abs(st_prime - st_gt), -1, keepdims=True)
        ef = np.mean(np.abs(st_final - st_gt), -1, keepdims=True)
        err_p, err_f = _gray_u8(ep), _gray_u8(ef)
        # rows 1-2 repeat the error maps min-max normalized
        err_pn, err_fn = _norm_gray_u8(ep), _norm_gray_u8(ef)
    row0 = [_to_u8(ovlp), _to_u8(st_prime), _to_u8(st_final), gt_cell,
            flow_to_color(flow_init[..., :2]),
            flow_to_color(flow_final[..., :2]),
            _gray_u8(occ_init), _gray_u8(occ_final), err_p, err_f]

    def fgac_row(bw, stack, flow, diff):
        cells = [_gray_u8(bw), _gray_u8(1.0 - bw)]
        if stack is not None:
            cells += [_gray_u8(stack[0]), _gray_u8(stack[1]),
                      _gray_u8(stack[2])]
        else:
            cells += [blank, blank, blank]
        cells.append(flow_to_color(flow) if flow is not None else blank)
        cells.append(_gray_u8(diff))
        cells.append(_gray_u8(stack[3]) if stack is not None else blank)
        cells += [err_pn, err_fn]
        return cells

    row1 = fgac_row(blend_w0, fgac_10, flow_01, diff_10)
    row2 = fgac_row(blend_w1, fgac_01, flow_10, diff_01)
    return make_grid([row0, row1, row2])
