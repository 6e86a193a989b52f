"""The frozen reference against the program's plain CPU path at a tiny
size, and the FLOP and byte counts against hand counts."""
import json
from pathlib import Path

import torch
import torch.nn as nn
from torch.utils.flop_counter import FlopCounterMode

from benchmark import inputs, reference
from benchmark.counts import flops, gather_bytes
from benchmark.drivers import serve_stream, train_steps
from benchmark.harness import program_model
from benchmark.reference import model as ref

SEED = 5
ROOT = Path(__file__).resolve().parents[2]
with open(ROOT / "benchmark" / "configs" / "rb53-f32.json") as _f:
    CONFIG = json.load(_f)


def _window():
    sd = inputs.make_weights(reference.param_shapes(CONFIG), SEED, "cpu")
    clip = inputs.serve_clip(SEED, 4, 32, 64, 3.0, "cpu")
    frames = serve_stream.to_model(inputs.window_frames(clip, 0), "cpu")
    with torch.no_grad():
        inputs.calibrate_flow_head(reference.build(CONFIG, sd), sd, frames,
                                   12.0)
    return sd, frames


@torch.no_grad()
def test_reference_serves_as_the_program_plain_path():
    sd, frames = _window()
    t = torch.tensor([0.25, 0.625])
    r = reference.build(CONFIG, sd)
    want = r.synthesize(r.extract(frames).repeat(2), t, 3)
    p = program_model(CONFIG, sd, "cpu").eval()
    got = p.synthesize(p.extract(frames).repeat(2), t, 3)
    pairs = [(want["s0_prime"], got.s0_prime),
             (want["st_prime"], got.st_prime)]
    pairs += [(want[k][-1], getattr(got, f"{k}_final")[-1])
              for k in ("s0", "s1", "st")]
    for a, b in pairs:
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5), float(
            (a - b).abs().max())


def test_reference_trains_as_the_program_plain_path():
    """Losses and first gradients agree to rounding. Parameters are held
    by the norm of each one's change: an element whose gradient is
    rounding noise moves by +-lr under Adam, whichever sign the noise
    takes."""
    cell = type("Cell", (), {"config": dict(CONFIG, N_trn=2),
                             "traffic": {"batch": 2, "size": 16,
                                         "lr": 1e-4}})()
    sd = inputs.make_weights(reference.param_shapes(CONFIG), SEED, "cpu")
    frames, t = inputs.train_samples(SEED, 6, 16, 2.0, "cpu")
    got = train_steps.program_steps(cell, sd, frames, t, "cpu")[2:]
    want = train_steps.reference_steps(cell, sd, frames, t, "cpu")
    n = train_steps.compare(got, want)
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5, n
    assert n["change_gap"] < 1e-2, n


def test_conv_flops_match_a_hand_count():
    conv = ref.Conv(48, 96, 5)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    x = torch.zeros(2, 48, 20, 30)
    with FlopCounterMode(display=False) as fc:
        conv(x)
    assert fc.get_total_flops() == 2 * 2 * 96 * 48 * 25 * 20 * 30


def test_window_flops_sum_every_convolution_by_hand():
    """Hooks record each convolution's output shape on the meta device;
    2 x Cin x kh x kw per output element, summed, is the count."""
    model = reference.build(CONFIG, device="meta")
    total = [0]

    def hook(mod, args, out):
        w = mod.weight
        cin, kh, kw = w.shape[1], w.shape[-2], w.shape[-1]
        total[0] += 2 * cin * kh * kw * out.numel()
    for m in model.modules():
        if isinstance(m, ref.Conv):
            m.register_forward_hook(hook)
    h, w, inst = 64, 96, 3
    frames = torch.empty(1, 4, 3, h, w, device="meta")
    with torch.no_grad():
        model.synthesize(model.extract(frames).repeat(inst),
                         torch.empty(inst, device="meta"), 2)
    assert flops.serve_window(CONFIG, h, w, inst, 2) == total[0]
    # a train step: forward plus the backward's two products but the first
    # convolution's input gradient (the frames need none)
    assert flops.train_step(CONFIG, 2, 32, 1) > \
        2.5 * flops.serve_window(CONFIG, 32, 32, 2, 1)


def test_gather_bytes_match_a_hand_count():
    # one relative pair launch: 2 halves x 5 images x (4 channels of bf16
    # image + 2 float32 coordinates + 4 float32 outputs) x 6 x 7 pixels
    assert gather_bytes._relative_pair(5, 4, 42, 2) == \
        2 * 5 * 42 * (4 * 2 + 2 * 4 + 4 * 4)
    # its backward reads image, coordinates, output gradient and writes
    # the image's and the coordinates' gradients
    assert gather_bytes._relative_pair_bwd(5, 4, 42) == \
        2 * 5 * 42 * 4 * (4 + 2 + 4 + 4 + 2)
    hw = 8 * 16
    assert gather_bytes.serve_window(8, 16, 7, 3, 64, 4) == (
        2 * hw * 4 * (2 + 64)
        + 2 * gather_bytes._relative_pair(7, 64, hw, 4)
        + 3 * gather_bytes._relative_pair(7, 3, hw, 4))


def test_train_comparison_reads_one_for_an_unchanged_state():
    want = ([1.0, 0.9, 0.8], {"a": 2.0, "b": 1.0, "c": 1e-9},
            {"a": 1e-3, "b": 2e-3, "c": 5e-4})
    got = ([1.0, 0.9, 0.8], {}, {"a": 0.0, "b": 0.0, "c": 0.0})
    n = train_steps.compare(got, want)
    assert n["change_gap"] == 1.0 and n["grad_gap"] == 1.0
    assert n["loss_gap"] == 0.0
