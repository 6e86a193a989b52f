"""Frames, training samples and weights are the same for one seed and
differ for another."""
import json
from pathlib import Path

import numpy as np
import torch

from benchmark import inputs, reference

SEED = 2 ** 31 + 11
with open(Path(__file__).resolve().parents[2] / "benchmark" / "configs"
          / "rb53-f32.json") as _f:
    CONFIG = json.load(_f)


def test_clip_is_a_function_of_the_seed():
    a = inputs.serve_clip(SEED, 5, 32, 48, 3.0, "cpu")
    b = inputs.serve_clip(SEED, 5, 32, 48, 3.0, "cpu")
    c = inputs.serve_clip(SEED + 1, 5, 32, 48, 3.0, "cpu")
    assert a.shape == (5, 32, 48, 3) and a.dtype == np.float32
    assert np.array_equal(a, b)
    assert np.abs(a - c).max() > 0.1
    assert np.abs(a).max() <= 0.9 + 1e-6
    # consecutive blurry frames differ: the scene moves
    assert np.abs(a[1] - a[0]).mean() > 1e-3
    w = inputs.window_frames(a, 0)
    assert w.shape == (1, 4, 32, 48, 3)
    assert np.array_equal(w[0, 0], a[1]) and np.array_equal(w[0, 2], a[0])


def test_train_samples_are_a_function_of_the_seed():
    f1, t1 = inputs.train_samples(SEED, 3, 16, 3.0, "cpu")
    f2, t2 = inputs.train_samples(SEED, 3, 16, 3.0, "cpu")
    f3, _ = inputs.train_samples(SEED + 1, 3, 16, 3.0, "cpu")
    assert f1.shape == (3, 9, 16, 16, 3) and t1.shape == (3, 1)
    assert torch.equal(f1, f2) and torch.equal(t1, t2)
    assert (f1 - f3).abs().max() > 0.1
    assert set((t1 * 8).round().int().ravel().tolist()) <= set(range(1, 8))
    # every sample is its own scene
    assert (f1[0] - f1[1]).abs().mean() > 1e-2


def test_weights_are_a_function_of_the_seed():
    shapes = reference.param_shapes(CONFIG)
    a = inputs.make_weights(shapes, SEED, "cpu")
    b = inputs.make_weights(shapes, SEED, "cpu")
    c = inputs.make_weights(shapes, SEED + 1, "cpu")
    assert list(a) == [k for k, _ in shapes]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a)
    assert sum(v.numel() for v in a.values()) == 7_408_284
    w = a["FF_RDB_Module.SFENet2.weight"]
    assert abs(float(w.std()) - (2.0 / (96 * 9 * 2)) ** 0.5) < 2e-3
    bias = a["FF_RDB_Module.SFENet2.bias"]
    assert float(bias.abs().max()) <= (96 * 9) ** -0.5


def test_calibration_scales_the_flows_to_the_target():
    sd = inputs.make_weights(reference.param_shapes(CONFIG), SEED, "cpu")
    clip = inputs.serve_clip(SEED, 4, 32, 64, 3.0, "cpu")
    frames = torch.from_numpy(inputs.window_frames(clip, 0)).permute(
        0, 1, 4, 2, 3).contiguous()
    with torch.no_grad():
        raw = inputs.calibrate_flow_head(reference.build(CONFIG, sd), sd,
                                         frames, 4.0)
        s1 = reference.build(CONFIG, sd).extract(frames)
    peak = max(float(s1.flow_01.abs().max()), float(s1.flow_10.abs().max()))
    assert raw > 4.0 and abs(peak - 4.0) < 1e-4
