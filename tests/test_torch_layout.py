"""The model's memory format (``demfi.activation_format``) on the CPU.

On the card a bfloat16 model keeps its activations channels_last, so
that cuDNN's NHWC engines need no transpose around a convolution; every
other run is NCHW. Here the chooser is patched to channels_last on CPU
models of DeMFI-Net_rb(2,2) at the golden geometry of
tests/test_torch_model.py (32x48), and held against the same model in
NCHW: every convolution gets its input in the layout
(``kernels.layout_counts``), the warp kernels' boundary copies are
counted, and the outputs are the NCHW run's.

The convolution is the one op whose arithmetic the layout changes (a CPU
or cuDNN engine sums in another order for each layout), so in the
comparisons of whole outputs every ``F.conv2d`` runs in NCHW and returns
its input's format (``neutral_conv``): what is left is the bookkeeping
this layout adds (folds, space-to-depth, the pixel shuffle, the repeat,
the up-sampling, casts and concatenations). In bfloat16 the two runs then
agree bit for bit. In float32 they agree within 2e-4 of each field's
largest value (the port's float32 tolerance against JAX,
tests/test_torch_model.py), not 1e-5: a 1-channel slice is strided in
channels_last, and the CPU's scalar sigmoid and tanh differ from its
vectorised ones by an ulp, which the random-weight network carries to
5.5e-5 of st_prime's largest value.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from demfi_torch.config import config_rb
from demfi_torch.models import demfi, make_model
from demfi_torch.ops import kernels, reshape
from demfi_torch.train import create_train_state, make_train_step

H, W, T = 32, 48, 0.375
CL = torch.channels_last
NUM_UPDATE = 2
TOL = {"float32": 2e-4, "bfloat16": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def neutral_conv(monkeypatch):
    """Every ``F.conv2d`` computes in NCHW and returns its input's
    format."""
    conv2d = F.conv2d

    def conv(x, w, *args, **kw):
        y = conv2d(x.contiguous(), w.contiguous(), *args, **kw)
        return y.contiguous(memory_format=CL) if reshape.channels_last(x) \
            else y
    monkeypatch.setattr(F, "conv2d", conv)


def channels_last_model(monkeypatch):
    monkeypatch.setattr(demfi, "activation_format", lambda dt, dev: CL)


def frames_and_t():
    rng = np.random.RandomState(42)
    frames = torch.from_numpy(rng.uniform(-1, 1, (1, 4, 3, H, W)).astype(
        np.float32))
    return frames, torch.tensor([T, 0.125, 0.75])


def serve(model, frames, t):
    """Stage I once and the instants of t in one batch, as the engine
    runs a window; the outputs and the layout counts."""
    kernels.reset_layout_counts()
    with torch.no_grad():
        out = model.synthesize(model.extract(frames).repeat(t.numel()), t,
                               NUM_UPDATE)
    return out, kernels.layout_counts()


def fields(out):
    """Every output tensor by name (tuples flattened)."""
    got = {}
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        for i, x in enumerate(v if isinstance(v, tuple) else (v,)):
            got[f"{f.name}{i if isinstance(v, tuple) else ''}"] = x
    return got


def test_the_chooser():
    """channels_last for bfloat16 on a CUDA device only."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert demfi.activation_format(torch.bfloat16, cuda) == CL
    for dt, dev in ((torch.float32, cuda), (torch.float32, cpu),
                    (torch.bfloat16, cpu)):
        assert demfi.activation_format(dt, dev) == torch.contiguous_format


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_runs_stay_nchw(dtype):
    """Unpatched, a CPU model gets every convolution's input in NCHW and
    makes no boundary copy; its outputs are NCHW."""
    model = make_model(config_rb(2, 2, seed=7, compute_dtype=dtype),
                       device="cpu")
    out, counts = serve(model, *frames_and_t())
    assert counts["conv_calls"] > 0
    assert counts["conv_in_layout"] == counts["conv_calls"]
    assert counts["warp_copies"] == 0
    assert out.st_prime.is_contiguous() and out.s0_prime.is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channels_last_equals_nchw(monkeypatch, neutral_conv, dtype):
    """Patched to channels_last: every convolution's input arrives in the
    layout, the warps' channels_last inputs are copied to NCHW and
    counted (the two FGAC samples a key and a flow each; CFR's two
    splats two flows and two scaled flows; the blended features' pair
    its two images, its flows CFR's NCHW outputs; the refined features'
    pair two images and two flows; each boosting step's image pair the
    same four), the frame outputs are channels_last, and every output
    field is the NCHW run's."""
    model = make_model(config_rb(2, 2, seed=7, compute_dtype=dtype),
                       device="cpu")
    frames, t = frames_and_t()
    want, nchw_counts = serve(model, frames, t)
    channels_last_model(monkeypatch)
    got, counts = serve(model, frames, t)
    assert counts["conv_calls"] == nchw_counts["conv_calls"] > 0
    assert counts["conv_in_layout"] == counts["conv_calls"]
    assert counts["warp_copies"] == 4 + 4 + 2 + 4 + 4 * NUM_UPDATE
    for name in ("s0_prime", "s1_prime", "st_prime", "ovlp_b0b1"):
        assert getattr(got, name).is_contiguous(memory_format=CL), name
    want, got = fields(want), fields(got)
    assert set(want) == set(got)
    for name, w in want.items():
        w, g = w.float(), got[name].float()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        scale = float(w.nan_to_num().abs().max())
        err = float((g - w).nan_to_num().abs().max())
        assert err <= TOL[dtype] * scale, (name, err, scale)


def test_train_step_channels_last_equals_nchw(monkeypatch, neutral_conv):
    """A bfloat16 train step (autograd through the folds, space-to-depth,
    the pixel shuffle, the up-sampling and the boundary copies in
    channels_last) takes the NCHW step's loss and gradients."""
    rng = np.random.RandomState(21)
    frames = rng.uniform(-1, 1, (2, 9, H, W, 3)).astype(np.float32)
    t = np.array([[0.25], [0.625]], np.float32)

    def step():
        cfg = config_rb(2, 2, seed=3, compute_dtype="bfloat16")
        model = make_model(cfg, device="cpu")
        metrics = make_train_step(cfg)(create_train_state(cfg, model),
                                       frames, t)
        return float(metrics["total_loss"]), {
            k: p.grad for k, p in model.named_parameters()
            if p.grad is not None}
    want_loss, want = step()
    channels_last_model(monkeypatch)
    kernels.reset_layout_counts()
    loss, got = step()
    counts = kernels.layout_counts()
    assert counts["conv_in_layout"] == counts["conv_calls"] > 0
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert set(got) == set(want)
    for k, g in want.items():
        assert float((got[k] - g).norm()) <= 1e-5 * float(g.norm()), k


@pytest.mark.parametrize("op", ["space_to_depth", "depth_to_space",
                                "repeat_batch", "nearest_up2"])
def test_reshapes_keep_the_format(op):
    """Each op the model runs between convolutions gives a channels_last
    input's result in channels_last, equal to the NCHW result."""
    x = torch.randn(2, 16, 8, 12)
    fn = {"space_to_depth": lambda v: reshape.space_to_depth(v, 2),
          "depth_to_space": lambda v: reshape.depth_to_space(v, 2),
          "repeat_batch": lambda v: reshape.repeat_batch(v, 3),
          "nearest_up2": demfi._nearest_up2}[op]
    want = fn(x)
    got = fn(x.contiguous(memory_format=CL))
    assert want.is_contiguous()
    assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
    assert torch.equal(got, want)
    # a channels_last view (a channel slice) keeps its format too
    if op == "repeat_batch":
        view = x.contiguous(memory_format=CL)[:, 3:5]
        assert torch.equal(fn(view), fn(x[:, 3:5]))
        assert fn(view).is_contiguous(memory_format=CL)


def test_boundary_copy_counts_only_channels_last_inputs():
    """``kernels.nchw``: a contiguous tensor passes as it is, a view of an
    NCHW tensor is copied uncounted, a channels_last tensor (or a view of
    one) is copied and counted."""
    x = torch.randn(2, 8, 6, 10)
    kernels.reset_layout_counts()
    assert kernels.nchw(x) is x
    assert torch.equal(kernels.nchw(x[:, 2:4]), x[:, 2:4])
    assert kernels.layout_counts()["warp_copies"] == 0
    cl = x.contiguous(memory_format=CL)
    for v, w in ((cl, x), (cl[:, 2:4], x[:, 2:4])):
        got = kernels.nchw(v)
        assert got.is_contiguous() and torch.equal(got, w)
    assert kernels.layout_counts()["warp_copies"] == 2
