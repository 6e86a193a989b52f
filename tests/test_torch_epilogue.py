"""The convolutions' epilogue: the bias add and the ReLU or residual add
after it (``demfi._conv_in``, ``kernels.conv_epilogue``).

On the CPU (tier 1): the sites' forms (``kernels.epilogue_counts``), no
site served by the kernel, each block bit for bit the separate ops it
ran before the epilogue was passed to its convolutions, and a bfloat16
model whose every site takes the in-place plain version
(``kernels.conv_epilogue_plain``) bit for bit the model that takes the
separate ops.

On the card (marker ``cuda``; these skip without one, and the file
imports nothing of JAX, so that it also runs where JAX is not
installed)::

    python -m pytest --noconftest -m cuda tests/test_torch_epilogue.py -q

the kernel bit for bit the separate ops (a bfloat16 convolution's
output plus the bias cast to bfloat16, then ``F.relu`` or ``r + y``) at
every channel count the model has and more, on random values with NaN,
infinities and signed zeros planted (views that do not start on 16
bytes are refused: the model takes the separate ops there); and a whole
bfloat16 window of DeMFI-Net_rb(5,3) under ``torch.no_grad()`` (every
site fused) bit for bit the same window with grad enabled (the separate
ops), with the deterministic forward warp (``fwarp_shift_d`` 8 and flows
of at most 6 px) so that two runs can agree to the bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from demfi_torch.config import config_rb
from demfi_torch.models import demfi, make_model
from demfi_torch.ops import kernels
from demfi_torch.utils.profiling import calibrate_flow_head

CL = torch.channels_last
BF16 = torch.bfloat16
# one bfloat16 serving window of DeMFI-Net_rb(5,3) (N_tst 3): 87
# convolutions in extract, 92 in synthesize
RB53_FORMS = {"bias": 34, "bias_relu": 107, "bias_residual": 38}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: tier-1 runs several test workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _window(model, frames, t, num_update):
    """Stage I once and the instants of t in one batch, as the engine
    runs a window; every output field by name and the counts."""
    kernels.reset_layout_counts()
    out = model.synthesize(model.extract(frames).repeat(t.numel()), t,
                           num_update)
    got = {}
    for f in dataclasses.fields(out):
        v = getattr(out, f.name)
        for i, x in enumerate(v if isinstance(v, tuple) else (v,)):
            got[f"{f.name}{i}"] = x.detach()
    return got, kernels.epilogue_counts(), kernels.layout_counts()


def _bitwise(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(torch.isnan(g), torch.isnan(w)), name
        assert torch.equal(g.nan_to_num(), w.nan_to_num()), name


def _frames(h, w, seed=42):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (1, 4, 3, h, w)).astype(
        np.float32))


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_site_forms_of_a_window(dtype):
    """DeMFI-Net_rb(5,3) serving 3 instants: 179 convolutions, 107 with a
    ReLU after them, 38 with a residual add, 34 with the bias alone (the
    sigmoid and tanh heads, the GRU's gates, the flow and frame heads,
    the first convolutions and FGAC's keys); on the CPU none fused."""
    model = make_model(config_rb(5, 3, nf=16, seed=3, compute_dtype=dtype),
                       device="cpu")
    with torch.no_grad():
        _, forms, layout = _window(model, _frames(32, 32),
                                   torch.tensor([0.25, 0.5, 0.75]), 3)
    assert forms == dict(RB53_FORMS, fused=0)
    assert layout["conv_calls"] == sum(RB53_FORMS.values()) == 179


def _conv_of(m):
    return m if isinstance(m, (demfi._Conv, demfi._Conv3dT1)) else None


def _blocks():
    """(name, block, input, the block's forward as the separate ops it
    ran before its convolutions took their epilogue): each convolution
    called alone returns its output with the bias, as nn.Conv2d does."""
    g = torch.Generator().manual_seed(5)

    def x(c, h=8, w=12, n=2):
        return torch.randn(n, c, h, w, generator=g)

    def rdb_conv(b, v):
        return torch.cat([v, F.relu(b.conv[0](v))], dim=1)

    def rdb(b, v):
        y = v
        for dense in b.convs:
            y = rdb_conv(dense, y)
        return b.LFF(y) + v

    def res(b, v):
        return v + b.conv2(F.relu(b.conv1(v)))

    def refine(b, v):
        e1 = F.relu(b.enc1(v))
        e2 = F.relu(b.enc2(e1))
        h = F.relu(b.enc3(e2))
        h = demfi._nearest_up2(F.relu(b.dec0(h)))
        h = demfi._nearest_up2(F.relu(b.dec1(torch.cat([h, e2], dim=1))))
        h = demfi._nearest_up2(F.relu(b.dec2(torch.cat([h, e1], dim=1))))
        return b.dec3(h)

    def mixer(b, ref, delta):
        r = F.relu(b.conv_ref2(F.relu(b.conv_ref1(ref))))
        d = F.relu(b.conv_delta2(F.relu(b.conv_delta1(delta))))
        h = F.relu(b.conv_blend1(torch.cat([r, d], dim=1)))
        return F.relu(b.conv_blend2(h))

    def flow_occ(b, v):
        return b.conv2(F.relu(b.conv1(v)))

    def ffrdb(b, frames):
        v = demfi.space_to_depth(frames, b.scale_factor)
        f1 = b.SFENet1(v)
        v = b.SFENet2(f1)
        outs = []
        for blk in b.RDBs:
            v = rdb(blk, v)
            outs.append(v)
        v = b.GFF(torch.cat(outs, dim=1)) + f1
        s, nf = b.UPNet(v), b.nf
        f0f1 = torch.tanh(s[:, :2 * nf])
        return (f0f1[:, :nf], f0f1[:, nf:], s[:, 2 * nf:2 * nf + 2].float(),
                s[:, 2 * nf + 2:2 * nf + 4].float(), s[:, 2 * nf + 4:])

    def init(block):
        demfi.init_weights(block, torch.Generator().manual_seed(9))
        with torch.no_grad():      # biases that move the sums
            for m in block.modules():
                if _conv_of(m) is not None:
                    m.bias.normal_(0, 0.5, generator=g)
        return block

    nf = 16
    return [
        ("RDBConv", init(demfi.RDBConv(24, 8)), (x(24),), rdb_conv),
        ("RDB", init(demfi.RDB(24, 8, 3)), (x(24),), rdb),
        ("ResBlock", init(demfi.ResBlock(nf)), (x(nf),), res),
        ("ResBlock3d", init(demfi.ResBlock(nf, conv3d=True)), (x(nf),), res),
        ("RefineUNet", init(demfi.RefineUNet(nf)), (x(3 * nf + 9, 16, 24),),
         refine),
        ("Mixer", init(demfi.Mixer(nf)), (x(30), x(5)), mixer),
        ("FlowOcc", init(demfi.FlowOcc(nf)), (x(nf),), flow_occ),
        ("FFRDB", init(demfi.FFRDB(nf, num_rdb=3, n_convs=2, g0=24,
                                   growth=8)),
         (x(12, 16, 24, 1),), ffrdb),
    ]


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("index", range(8))
def test_blocks_equal_the_separate_ops(dtype, index):
    """Each block that passes a ReLU or a residual to its convolutions,
    float32 and bfloat16 on the CPU, with grad and without: bit for bit
    its forward written as the separate ops."""
    name, block, args, today = _blocks()[index]
    for m in block.modules():
        if _conv_of(m) is not None:
            m.compute_dtype = dtype
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            got, want = block(*args), today(block, *args)
        got, want = (v if isinstance(v, tuple) else (v,)
                     for v in (got, want))
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (name, grad)
            assert g.requires_grad == w.requires_grad == grad, name


def test_plain_epilogue_is_the_separate_ops():
    """``conv_epilogue_plain`` in place, bit for bit ``y + b.to(bf16)``
    then ``F.relu`` or ``r + y``, NaN, infinities and signed zeros
    included; both a ReLU and a residual are refused."""
    y, b, r = _special_values(2, 9, 5, 7, seed=1)
    for relu, res in ((False, None), (True, None), (False, r)):
        want = _separate_ops(y, b, relu, res)
        got = y.clone()
        assert kernels.conv_epilogue_plain(got, b, relu, res) is got
        _same_bits(got, want)
    with pytest.raises(ValueError):
        kernels.conv_epilogue(y.clone(), b, True, r)


def test_cpu_outputs_refused_by_the_predicate():
    """On the CPU no output qualifies for the in-place kernel, whatever
    its layout or dtype, and the kernel's wrapper refuses it."""
    y = torch.zeros(1, 8, 4, 4, dtype=BF16).contiguous(memory_format=CL)
    assert not kernels.conv_epilogue_takes(y, torch.zeros(8))
    with pytest.raises(ValueError):
        kernels.conv_epilogue(y, torch.zeros(8))


def test_in_place_epilogue_keeps_the_model_bitwise(monkeypatch):
    """A bfloat16 DeMFI-Net_rb(2,2) in channels_last on the CPU, each of
    its convolutions' epilogues done in place on the convolution's output
    (the plain version, where the card runs the kernel): every output
    bit for bit the model that takes the separate ops. So no output
    updated in place is held anywhere else."""
    monkeypatch.setattr(demfi, "activation_format", lambda dt, dev: CL)
    model = make_model(config_rb(2, 2, nf=16, seed=7,
                                 compute_dtype="bfloat16"), device="cpu")
    frames, t = _frames(32, 48), torch.tensor([0.375, 0.125, 0.75])
    with torch.no_grad():
        want, forms, _ = _window(model, frames, t, 2)
        served = []

        def takes(y, bias, residual=None):
            served.append(y.is_contiguous(memory_format=CL))
            return True
        monkeypatch.setattr(kernels, "conv_epilogue_takes", takes)
        monkeypatch.setattr(kernels, "conv_epilogue",
                            kernels.conv_epilogue_plain)
        got, _, _ = _window(model, frames, t, 2)
    assert len(served) == sum(forms[k] for k in RB53_FORMS) > 0
    assert all(served)
    _bitwise(got, want)


# ------------------------------------------------------------ the card
def _special_values(n, c, h, w, seed, device="cpu"):
    """(y, bias, residual): y and residual bfloat16 channels_last [n, c,
    h, w] with NaN, +-inf, +-0 and values that cancel planted; bias
    float32 [c] with one NaN-free spread, one infinity where c > 3."""
    rng = np.random.RandomState(seed)

    def plant(v):
        flat = v.reshape(-1)
        k = min(flat.size, 64)
        idx = rng.choice(flat.size, k, replace=False)
        specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-30,
                             -1e-30, 3e38], np.float32)
        flat[idx] = specials[rng.randint(0, len(specials), k)]
        return v
    y = plant(rng.randn(n, h, w, c).astype(np.float32) * 2)
    r = plant(rng.randn(n, h, w, c).astype(np.float32) * 2)
    b = rng.randn(c).astype(np.float32)
    if c > 3:
        b[2], b[3] = np.inf, -0.0

    def nhwc(a):
        return torch.from_numpy(a).to(BF16).permute(0, 3, 1, 2).to(device)
    return nhwc(y), torch.from_numpy(b).to(device), nhwc(r)


def _separate_ops(y, b, relu, res):
    v = y + b.to(BF16)[:, None, None]
    if relu:
        return F.relu(v)
    return v if res is None else res + v


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    g = got.contiguous().view(torch.int16).cpu()
    w = want.contiguous().view(torch.int16).cpu()
    assert torch.equal(g, w), int((g != w).sum())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 5, 9, 32, 35, 64, 96, 133, 256])
@pytest.mark.parametrize("n", [1, 7])
def test_kernel_bitwise_equals_separate_ops(cuda_device, c, n):
    """A bfloat16 convolution's channels_last output, the kernel against
    ``conv + b.to(bf16)`` then ``F.relu`` or ``r + y``: every bit, at
    every form, with specials planted; at H x W of 6 x 10 (n x C x 60
    elements, a multiple of 8 where C is even or n C is) and 7 x 9 (odd:
    a tail of fewer than 8). Views 2 elements into a buffer (not 16-byte
    aligned) are refused: the model takes the separate ops there."""
    for h, w in ((6, 10), (7, 9)):
        x = torch.randn(n, 16, h, w, device=cuda_device).to(BF16)
        wt = torch.randn(c, 16, 3, 3, device=cuda_device).to(BF16)
        conv = F.conv2d(x.contiguous(memory_format=CL),
                        wt.contiguous(memory_format=CL), None, padding=1)
        assert conv.is_contiguous(memory_format=CL)
        y, b, r = _special_values(n, c, h, w, seed=c * 10 + n,
                                  device=cuda_device)
        y = torch.where(torch.rand(y.shape, device=cuda_device) < 0.5,
                        conv, y).contiguous(memory_format=CL)
        for relu, res in ((False, None), (True, None), (False, r)):
            want = _separate_ops(y, b, relu, res)
            got = y.clone(memory_format=CL)
            assert kernels.conv_epilogue_takes(got, b, res)
            assert kernels.conv_epilogue(got, b, relu, res) is got
            _same_bits(got, want)
            # unaligned: y, or the residual, 2 elements into its buffer
            buf = torch.empty(y.numel() + 2, dtype=BF16, device=cuda_device)
            off = buf[2:].view(n, h, w, c).permute(0, 3, 1, 2)
            for yy, rr in [(off, res)] + ([] if res is None else [(y, off)]):
                assert not kernels.conv_epilogue_takes(yy, b, rr)
                with pytest.raises(ValueError):
                    kernels.conv_epilogue(yy, b, relu, rr)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_signed_zeros_and_nan_through_relu(cuda_device):
    """ReLU of -0.0, +0.0 and NaN after the bias add: the kernel's bits
    are ``F.relu``'s (NaN kept, the zeros as ATen's clamp_min gives
    them)."""
    vals = torch.tensor([-0.0, 0.0, float("nan"), -1.0, 1.0, float("-inf"),
                         float("inf"), -0.0], dtype=BF16)
    y = vals.reshape(1, 8, 1, 1).repeat(3, 1, 5, 3).to(cuda_device)
    y = y.contiguous(memory_format=CL)
    for bias in (torch.zeros(8), torch.full((8,), -0.0)):
        bias = bias.to(cuda_device)
        want = F.relu(y + bias.to(BF16)[:, None, None])
        got = kernels.conv_epilogue(y.clone(memory_format=CL), bias, True)
        _same_bits(got, want)


@pytest.mark.cuda
def test_the_predicate_on_the_card(cuda_device):
    """The in-place kernel is taken for a bfloat16 dense channels_last
    output without autograd, and for nothing else: not NCHW (C > 1), not
    float32, not a residual of another layout, not where a gradient is
    recorded; the wrapper refuses those."""
    y = torch.randn(2, 8, 4, 6, device=cuda_device).to(BF16)
    cl = y.contiguous(memory_format=CL)
    b = torch.randn(8, device=cuda_device, requires_grad=True)
    with torch.no_grad():
        assert kernels.conv_epilogue_takes(cl, b)
        assert kernels.conv_epilogue_takes(cl, b, cl.clone(
            memory_format=CL))
        assert not kernels.conv_epilogue_takes(y, b)
        assert not kernels.conv_epilogue_takes(cl.float(), b)
        assert not kernels.conv_epilogue_takes(cl, b, y.clone())
        with pytest.raises(ValueError):
            kernels.conv_epilogue(y, b)
        with pytest.raises(TypeError):
            kernels.conv_epilogue(cl.float(), b)
    assert not kernels.conv_epilogue_takes(cl, b)
    with pytest.raises(ValueError):
        kernels.conv_epilogue(cl, b)


@pytest.mark.cuda
def test_whole_bf16_window_fused_equals_separate_ops(cuda_device):
    """DeMFI-Net_rb(5,3) in bfloat16 at 64x128, 7 instants (x8), 3
    boosting steps: the window under ``torch.no_grad()`` (all 179
    convolutions' epilogues fused, in place) bit for bit the window with
    grad enabled (the separate ops; none fused). The forward warp is the
    deterministic stencil (flows calibrated to 6 px, window 8), so two
    runs can agree to the bit."""
    cfg = config_rb(5, 3, seed=17, compute_dtype="bfloat16",
                    fwarp_shift_d=8)
    model = make_model(cfg)
    frames = _frames(64, 128, seed=9).to(cuda_device)
    calibrate_flow_head(model, frames, 6.0)
    t = torch.arange(1, 8, dtype=torch.float32, device=cuda_device) / 8
    with torch.no_grad():
        got, fused, _ = _window(model, frames, t, 3)
    with torch.enable_grad():
        want, separate, _ = _window(model, frames, t, 3)
    assert fused == dict(RB53_FORMS, fused=179)
    assert separate == dict(RB53_FORMS, fused=0)
    _bitwise(got, want)
