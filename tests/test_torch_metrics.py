"""The port's host-side numpy helpers (metrics, visualization, meters)
against the JAX package's, on inputs from a numpy seed.

PSNR is the same float64 expression (exact). SSIM replaces
``cv2.filter2D(...)[5:-5, 5:-5]`` by a valid-mode separable correlation
with the same 11-tap Gaussian: equal to float64 rounding, held to 1e-9.
"""
import numpy as np
import pytest
import torch

from demfi_tpu import metrics as jm
from demfi_tpu.utils import meters as jmeters
from demfi_tpu.utils import viz as jviz
from demfi_torch import metrics as tm
from demfi_torch.utils import meters as tmeters
from demfi_torch.utils import viz as tviz


def _pair(shape, seed, noise=6.0):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 255, shape)
    return a, np.clip(np.around(a + rng.randn(*shape) * noise), 0, 255)


def test_psnr_exact():
    a, b = _pair((40, 56, 3), 0)
    assert tm.psnr(a, b) == jm.psnr(a, b)
    assert tm.psnr(a, a) == float("inf")


@pytest.mark.parametrize("shape", [(40, 56, 3), (33, 47), (24, 24, 1),
                                   (352, 640, 3)])
def test_ssim_matches_cv2_form(shape):
    a, b = _pair(shape, 1)
    assert tm.ssim(a, b) == pytest.approx(jm.ssim(a, b), abs=1e-9)


def test_ssim_refuses_bad_shapes():
    a, b = _pair((24, 24, 3), 2)
    with pytest.raises(ValueError):
        tm.ssim(a, b[:-1])
    with pytest.raises(ValueError):
        tm.ssim(np.zeros((24, 24, 4)), np.zeros((24, 24, 4)))
    with pytest.raises(ValueError):
        tm.ssim(a[:8, :8], b[:8, :8])


def test_eval_pair_matches():
    rng = np.random.RandomState(3)
    gt = rng.uniform(-1, 1, (32, 48, 3)).astype(np.float32)
    pred = (gt + rng.randn(32, 48, 3) * 0.05).astype(np.float32)
    gp, gs = tm.eval_pair_hwc(pred, gt)
    wp, ws = jm.eval_pair_hwc(pred, gt)
    assert gp == wp and gs == pytest.approx(ws, abs=1e-9)
    cp, cs = tm.eval_pair(pred.transpose(2, 0, 1), gt.transpose(2, 0, 1))
    assert (cp, cs) == (gp, gs)
    wcp, _ = jm.eval_pair(pred.transpose(2, 0, 1), gt.transpose(2, 0, 1))
    assert cp == wcp


def test_denorm_png_crop_match():
    x = np.random.RandomState(4).uniform(-1.3, 1.3, (50, 70, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tm.denorm255(x), jm.denorm255(x))
    np.testing.assert_array_equal(tm.to_png_uint8(x), jm.to_png_uint8(x))
    assert tm.to_png_uint8(x).dtype == np.uint8
    for shape in ((50, 70, 3), (352, 640, 3), (720, 1280, 3)):
        img = np.zeros(shape, np.uint8)
        g, w = tm.crop_8x8(img), jm.crop_8x8(img)
        assert g[0] is img and g[1:] == w[1:]


def test_tof_pair_matches():
    rng = np.random.RandomState(5)
    f = [rng.uniform(-1, 1, (48, 64, 3)).astype(np.float32) for _ in range(4)]
    assert tm.tof_pair(*f) == jm.tof_pair(*f)


def test_visualization_grid_matches():
    rng = np.random.RandomState(6)
    h, w = 24, 32

    def u(c, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, (h, w, c)).astype(np.float32)
    flow = u(2, -9, 9)
    np.testing.assert_array_equal(tviz.flow_to_color(flow),
                                  jviz.flow_to_color(flow))
    args = [u(3), u(3), u(3), u(3), u(4, -5, 5), u(4, -5, 5),
            u(1, 0, 1), u(1, 0, 1), u(1, 0, 1), u(1, 0, 1), u(1, 0, 1),
            u(1, 0, 1)]
    kw = dict(fgac_10=[u(1, 0, 1) for _ in range(4)],
              fgac_01=[u(1, 0, 1) for _ in range(4)],
              flow_01=u(2, -5, 5), flow_10=u(2, -5, 5))
    got = tviz.eval_visualization(*args, **kw)
    assert got.shape == (3 * h, 10 * w, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jviz.eval_visualization(*args, **kw))
    args[3] = None          # no GT (custom scenes), no FGAC internals
    np.testing.assert_array_equal(tviz.eval_visualization(*args),
                                  jviz.eval_visualization(*args))


def test_meters_match():
    a, b = tmeters.AverageMeter("PSNR_1:", ":.4e"), \
        jmeters.AverageMeter("PSNR_1:", ":.4e")
    for v, n in ((31.5, 1), (28.25, 3), (40.0, 2)):
        a.update(v, n)
        b.update(v, n)
    assert str(a) == str(b) and a.avg == b.avg and a.count == b.count
    a.reset()
    assert a.count == 0 and a.avg == 0.0


def test_progress_printer_and_summary(capsys):
    m = tmeters.AverageMeter("Time:", ":6.3f")
    m.update(0.5)
    jm_ = jmeters.AverageMeter("Time:", ":6.3f")
    jm_.update(0.5)
    tmeters.ProgressPrinter(12, m, prefix="[x] :").print(3)
    jmeters.ProgressPrinter(12, jm_, prefix="[x] :").print(3)
    got, want = capsys.readouterr().out.strip().split("\n")
    assert got == want
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.Conv2d(4, 2, 1))
    text = tmeters.model_summary(net)
    assert f"{3 * 4 * 9 + 4 + 4 * 2 + 2:,}" in text.splitlines()[-2]
