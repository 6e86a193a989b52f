"""The port's evaluation datasets and PNG routes against the JAX package
and cv2, on one fixture tree (the layout of the reference's test set:
``test/<scene>/`` sharp frames, ``test_blur/<scene>/`` blurry frames named
by absolute sharp index, stride 8)."""
import dataclasses
import os

import cv2
import numpy as np
import pytest

from demfi_tpu.data import datasets as jds
from demfi_torch.data import datasets as tds
from demfi_torch.data import imageio


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.RandomState(0)
    for s in range(2):
        sharp = root / "test" / f"scene{s}"
        blur = root / "test_blur" / f"scene{s}"
        sharp.mkdir(parents=True)
        blur.mkdir(parents=True)
        for i in range(16, 60):
            cv2.imwrite(str(sharp / f"{i:05d}.png"),
                        rng.randint(0, 255, (24, 32, 3), np.uint8))
        for k in range(5 + s):
            cv2.imwrite(str(blur / f"{17 + 8 * k:05d}.png"),
                        rng.randint(0, 255, (24, 32, 3), np.uint8))
    custom = root / "custom"
    for name, n in (("clipA", 5), ("clipB", 6), ("short", 3),
                    ("clipA_sharply_interpolated_x4", 5)):
        (custom / name).mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(custom / name / f"{i:05d}.png"),
                        rng.randint(0, 255, (24, 32, 3), np.uint8))
    return str(root)


@pytest.mark.parametrize("multiple,test_type", [(8, None), (2, None),
                                                (2, "valid_5_per_scene")])
def test_eval_index_equals_jax(tree, multiple, test_type):
    got = tds.build_eval_index(tree, multiple, 8, test_type)
    want = jds.build_eval_index(tree, multiple, 8, test_type)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_custom_index_equals_jax(tree):
    got = tds.build_custom_index(os.path.join(tree, "custom"), 4)
    want = jds.build_custom_index(os.path.join(tree, "custom"), 4)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]
    assert {g.scene for g in got} == {"clipA", "clipB"}


@pytest.mark.parametrize("center_patch", [None, 16])
def test_eval_load_equals_jax(tree, center_patch):
    got = tds.EvalDataset(tree, 8, 8, center_patch=center_patch)
    want = jds.EvalDataset(tree, 8, 8, center_patch=center_patch)
    assert len(got) == len(want)
    for i in (0, 9, len(got) - 1):
        g, w = got.load(i), want.load(i)
        assert g.keys() == w.keys()
        for k in g:
            if isinstance(g[k], np.ndarray):
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_custom_load_and_dispatcher(tree):
    @dataclasses.dataclass
    class Cfg:
        phase: str
        custom_path: str = os.path.join(tree, "custom")
        test_data_path: str = tree
        t_step_size: int = 8
        patch_size: int = 16
    got = tds.get_test_data(Cfg("test_custom"), 4)
    want = jds.get_test_data(Cfg("test_custom"), 4)
    assert isinstance(got, tds.CustomDataset) and len(got) == len(want)
    g, w = got.load(3), want.load(3)
    np.testing.assert_array_equal(g.pop("blur"), w.pop("blur"))
    assert g == w
    centred = tds.get_test_data(Cfg("test"), 2, center_flag=True)
    assert isinstance(centred, tds.EvalDataset)
    assert centred.load(0)["blur"].shape == (4, 16, 16, 3)
    with pytest.raises(RuntimeError):
        tds.CustomDataset(os.path.join(tree, "custom", "short"), 8)


def test_normalize_equals_jax():
    x = np.random.RandomState(1).randint(0, 256, (2, 8, 8, 3), np.uint8)
    for ch in (3, 1):
        np.testing.assert_array_equal(tds._normalize(x, ch),
                                      jds._normalize(x, ch))


def _smooth(h, w, seed):
    """Smooth content with a noisy patch, so that libpng picks a mix of
    row filters (Sub, Up, Average, Paeth)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(yy + xx) % 256, (2 * yy + xx // 3) % 256,
                    (xx * yy // 7) % 256], -1).astype(np.uint8)
    img[h // 4:h // 2, w // 4:w // 2] = rng.randint(0, 256, (
        h // 2 - h // 4, w // 2 - w // 4, 3))
    return img


@pytest.mark.parametrize("kind", ["bgr", "gray", "bgra"])
def test_numpy_route_reads_what_cv2_wrote(tmp_path, kind):
    img = _smooth(45, 70, 2)
    if kind == "gray":
        img = img[:, :, 0]
    elif kind == "bgra":
        img = np.dstack([img, img[:, :, 1]])
    path = str(tmp_path / "a.png")
    assert cv2.imwrite(path, img)
    with open(path, "rb") as f:
        assert set(np.frombuffer(__import__("zlib").decompress(
            _idat(f.read())), np.uint8).reshape(45, -1)[:, 0]) - {0}, \
            "the fixture must exercise the row filters"
    np.testing.assert_array_equal(imageio.read_png(path), cv2.imread(path))
    np.testing.assert_array_equal(imageio.imread(path), cv2.imread(path))


def _idat(blob):
    import struct
    pos, out = 8, b""
    while pos < len(blob):
        n, = struct.unpack(">I", blob[pos:pos + 4])
        if blob[pos + 4:pos + 8] == b"IDAT":
            out += blob[pos + 8:pos + 8 + n]
        pos += 12 + n
    return out


@pytest.mark.parametrize("gray", [False, True])
def test_cv2_reads_what_the_numpy_route_wrote(tmp_path, gray):
    img = _smooth(33, 50, 3)
    img = img[:, :, 0] if gray else img
    path = str(tmp_path / "b.png")
    imageio.write_png(path, img)
    want = np.repeat(img[:, :, None], 3, 2) if gray else img
    np.testing.assert_array_equal(cv2.imread(path), want)
    np.testing.assert_array_equal(imageio.read_png(path), want)


def test_imageio_refuses_what_it_does_not_take(tmp_path):
    with pytest.raises(FileNotFoundError):
        imageio.imread(str(tmp_path / "missing.png"))
    with pytest.raises(FileNotFoundError):
        imageio.read_png(str(tmp_path / "missing.png"))
    with pytest.raises(ValueError):
        imageio.imwrite(str(tmp_path / "f.png"), np.zeros((4, 4, 3), np.float32))
    path = str(tmp_path / "deep.png")
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="8-bit"):
        imageio.read_png(path)
    (tmp_path / "junk.png").write_bytes(b"not a png at all")
    with pytest.raises(ValueError):
        imageio.read_png(str(tmp_path / "junk.png"))
