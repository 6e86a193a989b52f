"""The port's native augment (``demfi_torch.data.native``) on the CPU:
bitwise equal to the port's numpy chain and to the JAX package's native
pass for every flip and rot90, the same samples from AdobeTrainDataset
either way, built under ``demfi_torch/_build/``, and a failed build
raises instead of falling back."""
import random

import numpy as np
import pytest

from demfi_tpu.data import native as jax_native
from demfi_torch.data import AdobeTrainDataset, imageio, native
from demfi_torch.data.datasets import _normalize


def numpy_chain(frames, cy, cx, ps, flip, rot):
    """The port's numpy route of AdobeTrainDataset.sample."""
    f = frames[:, cy:cy + ps, cx:cx + ps]
    if flip:
        f = f[:, :, ::-1]
    f = np.rot90(f, rot, (1, 2))
    return _normalize(np.ascontiguousarray(f))


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(0).randint(0, 256, (9, 40, 56, 3), np.uint8)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("rot", range(4))
def test_augment_pack_bitwise(frames, flip, rot):
    got = native.augment_pack(frames, 3, 5, 32, flip, rot)
    assert got.dtype == np.float32 and got.shape == (9, 32, 32, 3)
    np.testing.assert_array_equal(got, numpy_chain(frames, 3, 5, 32, flip,
                                                   rot))
    if jax_native.get_lib() is not None:
        np.testing.assert_array_equal(
            got, jax_native.augment_pack(frames, 3, 5, 32, flip, rot))


def test_normalize_bitwise(frames):
    got = native.normalize(frames)
    np.testing.assert_array_equal(got, _normalize(frames))
    if jax_native.get_lib() is not None:
        np.testing.assert_array_equal(got, jax_native.normalize(frames))


def test_refuses_what_it_cannot_take(frames):
    with pytest.raises(ValueError, match="uint8"):
        native.augment_pack(frames[..., :1], 0, 0, 8, False, 0)
    with pytest.raises(ValueError, match="uint8"):
        native.normalize(frames.astype(np.float32))
    with pytest.raises(ValueError, match="outside"):
        native.augment_pack(frames, 10, 0, 32, False, 0)


def test_builds_under_build_dir():
    native.get_lib()
    path = native.lib_path()
    assert path.exists()
    assert path.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.name == "_build"
    assert native.BUILD_ROOT.parent.name == "demfi_torch"
    assert not list(native.SRC.parent.glob("*.so"))


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.augment_pack(np.zeros((1, 8, 8, 3), np.uint8), 0, 0, 8,
                            False, 0)
    # a compiler that runs and fails: its stderr is in the message
    monkeypatch.setattr(native, "CXX", "g++")
    monkeypatch.setattr(native, "CXX_FLAGS", ["-O3", "-shared", "-fPIC",
                                              "-no-such-flag-xyz"])
    with pytest.raises(RuntimeError, match="no-such-flag-xyz"):
        native.get_lib()


def test_dataset_native_equals_numpy(tmp_path):
    rng = np.random.RandomState(0)
    (tmp_path / "train" / "s0").mkdir(parents=True)
    (tmp_path / "train_blur" / "s0").mkdir(parents=True)
    for i in range(60):
        imageio.imwrite(str(tmp_path / "train" / "s0" / f"{i:05d}.png"),
                        rng.randint(0, 256, (48, 64, 3)).astype(np.uint8))
    for k in range(6):
        imageio.imwrite(str(tmp_path / "train_blur" / "s0" /
                            f"{17 + 8 * k:05d}.png"),
                        rng.randint(0, 256, (48, 64, 3)).astype(np.uint8))
    for kw in (dict(patch_size=32), dict(need_patch=False)):
        ds_n = AdobeTrainDataset(str(tmp_path), use_native=True, **kw)
        ds_p = AdobeTrainDataset(str(tmp_path), use_native=False, **kw)
        for seed in range(8):
            a = ds_n.sample(0, random.Random(seed))
            b = ds_p.sample(0, random.Random(seed))
            np.testing.assert_array_equal(a.frames, b.frames)
            np.testing.assert_array_equal(a.t_value, b.t_value)
