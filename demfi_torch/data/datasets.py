"""Datasets: Adobe240-style blur training data, GT eval windows and
custom scenes.

Blur frame names encode absolute sharp frame indices (stride
``t_step_size``, e.g. 00017.png, 00025.png ...); samples are 4-frame
sliding windows that skip each scene's first and last blur frames.
Frames are NHWC [T, H, W, C] float32 BGR in [-1, 1], the layout of the
inference engine's public surface and of the train step's batches.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import random
from typing import List, Optional, Tuple

import numpy as np

from demfi_torch.data.imageio import imread


def _list_scene_frames(root: str) -> List[List[str]]:
    scenes = []
    for scene in sorted(os.listdir(root)):
        spath = os.path.join(root, scene)
        if os.path.isdir(spath):
            scenes.append([os.path.join(spath, f)
                           for f in sorted(os.listdir(spath))])
    return scenes


def _imread(path: str) -> np.ndarray:
    """BGR uint8, HWC: the reference's convention."""
    return imread(path)


def _normalize(frames_thwc_uint8: np.ndarray, channels: int = 3) -> np.ndarray:
    """uint8 [T,H,W,C] -> float32 [-1,1]. With channels == 1 the
    reference's BT.601 Y-conversion is applied first."""
    f = frames_thwc_uint8.astype(np.float32)
    if channels == 1:
        f = (np.sum(f * np.reshape([65.481, 128.553, 24.966],
                                   [1, 1, 1, 3]) / 255.0,
                    axis=-1, keepdims=True) + 16.0)
    return (f / 255.0 - 0.5) * 2.0


# ===================================================================== train
@dataclasses.dataclass
class TrainSample:
    frames: np.ndarray  # [9, ps, ps, 3]: B0,B1,B-1,B2,St,S0,S1,S-1,S2
    t_value: np.ndarray  # [1] float32


def build_train_index(train_data_path: str
                      ) -> Tuple[List[List[str]], List[List[str]]]:
    """(sharp scenes, blur scenes) path lists: ``train/<scene>/`` and
    ``train_blur/<scene>/``."""
    return (_list_scene_frames(os.path.join(train_data_path, "train")),
            _list_scene_frames(os.path.join(train_data_path, "train_blur")))


class AdobeTrainDataset:
    """Random-window training sampler.

    Per sample: a random 4-blur-frame window, a random t index in
    {1..K-1}/K, the matching sharp GT frames, a random patch_size^2
    crop, horizontal flip and rot90, and a random temporal reversal with
    t -> 1 - t. The draws from ``rng`` come in the JAX package's order,
    so one seed gives the same sample in both.

    ``use_native``: the crop, flip, rot90 and normalisation run as one
    native pass (``demfi_torch.data.native``, built with g++ at first
    use; a failed build raises), bitwise equal to the numpy chain that
    ``use_native=False`` takes.
    """

    def __init__(self, train_data_path: str, t_sampling_num: int = 8,
                 patch_size: int = 256, need_patch: bool = True,
                 use_native: bool = True):
        # the t grid uses t_sampling_num; the blur-frame interval itself
        # is derived from the file names
        self.sharp, self.blur = build_train_index(train_data_path)
        if not self.sharp:
            raise RuntimeError(f"no scenes under {train_data_path}")
        self.k = t_sampling_num
        self.patch_size = patch_size
        self.need_patch = need_patch
        self.use_native = use_native
        self.t_grid = np.linspace(1 / self.k, 1 - 1 / self.k, self.k - 1)

    def __len__(self) -> int:
        return len(self.sharp)

    def sample(self, idx: int, rng: random.Random) -> TrainSample:
        sharp = self.sharp[idx]
        blur = self.blur[idx]

        first = rng.randint(1, len(blur) - 3)
        inter = rng.randint(1, self.k - 1)
        abs_idx = int(os.path.basename(blur[first])[:-4])
        interval = int(os.path.basename(blur[first + 1])[:-4]) - abs_idx

        st = int(abs_idx + inter * interval / self.k - 1)
        t_value = float(self.t_grid[inter - 1])
        s0 = abs_idx - 1
        s1 = abs_idx + interval - 1
        sm1 = s0 - interval
        s2 = s1 + interval

        if rng.randint(0, 1):
            blur_ids = [first, first + 1, first - 1, first + 2]
            sharp_ids = [st, s0, s1, sm1, s2]
        else:  # temporal reversal
            blur_ids = [first + 1, first, first + 2, first - 1]
            sharp_ids = [st, s1, s0, s2, sm1]
            t_value = 1.0 - t_value

        imgs = [_imread(blur[i]) for i in blur_ids]
        imgs += [_imread(sharp[i]) for i in sharp_ids]
        frames = np.stack(imgs, axis=0)  # [9,H,W,3]

        ih, iw = frames.shape[1:3]
        if self.need_patch:
            ps = self.patch_size
            ix = rng.randrange(0, iw - ps + 1)
            iy = rng.randrange(0, ih - ps + 1)
        else:
            ps, ix, iy = min(ih, iw), 0, 0
        flip = rng.random() < 0.5
        rot = rng.randint(0, 3)

        if self.use_native:
            from demfi_torch.data import native
            return TrainSample(native.augment_pack(frames, iy, ix, ps, flip,
                                                   rot),
                               np.array([t_value], np.float32))
        frames = frames[:, iy:iy + ps, ix:ix + ps]
        if flip:
            frames = frames[:, :, ::-1]
        frames = np.rot90(frames, rot, (1, 2))
        return TrainSample(_normalize(np.ascontiguousarray(frames)),
                           np.array([t_value], np.float32))


# ====================================================================== eval
@dataclasses.dataclass
class EvalItem:
    blur_paths: List[str]       # [B0, B1, B-1, B2]
    st_path: str                # sharp GT for this t
    s0_path: str
    s1_path: str
    sm1_path: str
    s2_path: str
    t_value: float
    scene: str


def _zfill_for(path: str) -> int:
    if "GoPro_blur" in path or "Gopro" in path:
        return 6
    return 5


def build_eval_index(test_data_path: str, multiple: int,
                     t_step_size: int = 8,
                     test_type: Optional[str] = None) -> List[EvalItem]:
    """Sliding eval windows with GT: skip each scene's first and last-two
    blur frames; per window emit multiple-1 samples with
    t = linspace(1/M, 1-1/M); sharp GT name = blur_idx + (K/M)*(mul+1)."""
    if "BlurLFR" in test_data_path:
        # alternate layout: blur dir given directly, sharp GT in a
        # sibling *_test_GT_zfill{5,6} directory
        zf6 = "Gopro" in test_data_path or "GoPro" in test_data_path
        sharp_dir = test_data_path[:-3] + ("_test_GT_zfill6" if zf6
                                           else "_test_GT_zfill5")
        blur_dir = test_data_path
    else:
        sharp_dir = os.path.join(test_data_path, "test")
        blur_dir = os.path.join(test_data_path, "test_blur")
    zf = _zfill_for(test_data_path)
    t_grid = np.linspace(1 / multiple, 1 - 1 / multiple, multiple - 1)

    items: List[EvalItem] = []
    for scene in sorted(os.listdir(blur_dir)):
        bsc = os.path.join(blur_dir, scene)
        ssc = os.path.join(sharp_dir, scene)
        frames = sorted(os.listdir(bsc))
        for idx in range(len(frames)):
            if idx == len(frames) - 2:
                break
            if idx != 0:
                for mul in range(multiple - 1):
                    st_name = str(int(int(frames[idx][:-4])
                                      + (t_step_size / multiple) * (mul + 1))
                                  ).zfill(zf) + ".png"
                    items.append(EvalItem(
                        blur_paths=[os.path.join(bsc, frames[idx]),
                                    os.path.join(bsc, frames[idx + 1]),
                                    os.path.join(bsc, frames[idx - 1]),
                                    os.path.join(bsc, frames[idx + 2])],
                        st_path=os.path.join(ssc, st_name),
                        s0_path=os.path.join(ssc, frames[idx]),
                        s1_path=os.path.join(ssc, frames[idx + 1]),
                        sm1_path=os.path.join(ssc, frames[idx - 1]),
                        s2_path=os.path.join(ssc, frames[idx + 2]),
                        t_value=float(t_grid[mul]),
                        scene=scene))
            if test_type == "valid_5_per_scene" and frames[idx + 1] == "00057.png":
                break
    return items


class EvalDataset:
    """GT eval dataset. Loads one sample:
    (blur_frames [4,H,W,3], st_gt [H,W,3], s0_gt, s1_gt, t, scene, names)."""

    def __init__(self, test_data_path: str, multiple: int,
                 t_step_size: int = 8, center_patch: Optional[int] = None,
                 test_type: Optional[str] = None):
        self.items = build_eval_index(test_data_path, multiple, t_step_size,
                                      test_type)
        if not self.items:
            raise RuntimeError(f"no eval samples under {test_data_path}")
        self.center_patch = center_patch
        self.multiple = multiple

    def __len__(self):
        return len(self.items)

    def load(self, i: int):
        it = self.items[i]
        blur = np.stack([_imread(p) for p in it.blur_paths])
        gts = np.stack([_imread(p) for p in
                        (it.st_path, it.s0_path, it.s1_path)])
        if self.center_patch:
            ps = self.center_patch
            ih, iw = blur.shape[1:3]
            iy, ix = (ih - ps) // 2, (iw - ps) // 2
            blur = blur[:, iy:iy + ps, ix:ix + ps]
            gts = gts[:, iy:iy + ps, ix:ix + ps]
        blur = _normalize(blur)
        gts = _normalize(gts)
        return dict(blur=blur, st_gt=gts[0], s0_gt=gts[1], s1_gt=gts[2],
                    t_value=it.t_value, scene=it.scene,
                    st_name=os.path.basename(it.st_path),
                    s0_name=os.path.basename(it.s0_path),
                    s1_name=os.path.basename(it.s1_path))


# ==================================================================== custom
def build_custom_index(custom_path: str, multiple: int) -> List[EvalItem]:
    """GT-free user scenes: every directory under custom_path with >= 4
    pngs; windows skip first/last frames; outputs go to
    <scene>_sharply_interpolated_xM with names <frame>_<iii>.png."""
    t_grid = np.linspace(1 / multiple, 1 - 1 / multiple, multiple - 1)
    items: List[EvalItem] = []
    for scene_dir in sorted(glob.glob(os.path.join(custom_path, "*", ""))):
        frames = sorted(glob.glob(os.path.join(scene_dir, "*.png")))
        scene = os.path.basename(os.path.dirname(scene_dir))
        if scene.endswith(tuple(f"_sharply_interpolated_x{m}"
                                for m in range(2, 65))):
            continue
        for idx in range(1, len(frames)):
            if idx == len(frames) - 2:
                break
            for suffix, mul in enumerate(range(multiple - 1)):
                base = os.path.basename(frames[idx]).split(".")[0]
                items.append(EvalItem(
                    blur_paths=[frames[idx], frames[idx + 1],
                                frames[idx - 1], frames[idx + 2]],
                    st_path=f"{base}_{str(suffix).zfill(3)}.png",
                    s0_path=os.path.basename(frames[idx]),
                    s1_path=os.path.basename(frames[idx + 1]),
                    sm1_path="", s2_path="",
                    t_value=float(t_grid[mul]),
                    scene=scene))
    return items


def get_test_data(cfg, multiple: int, center_flag: bool = False,
                  test_type: Optional[str] = None):
    """The reference's get_test_data dispatcher: the custom dataset for
    the test_custom phase, the GT eval dataset otherwise."""
    if cfg.phase == "test_custom":
        return CustomDataset(cfg.custom_path, multiple)
    return EvalDataset(cfg.test_data_path, multiple, cfg.t_step_size,
                       center_patch=cfg.patch_size if center_flag else None,
                       test_type=test_type)


class CustomDataset:
    def __init__(self, custom_path: str, multiple: int):
        self.items = build_custom_index(custom_path, multiple)
        if not self.items:
            raise RuntimeError(f"no custom scenes under {custom_path}")
        self.multiple = multiple

    def __len__(self):
        return len(self.items)

    def load(self, i: int):
        it = self.items[i]
        blur = _normalize(np.stack([_imread(p) for p in it.blur_paths]))
        return dict(blur=blur, t_value=it.t_value, scene=it.scene,
                    st_name=it.st_path, s0_name=it.s0_path,
                    s1_name=it.s1_path)
