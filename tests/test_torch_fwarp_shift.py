"""The deterministic forward warp's plain version against the JAX package,
on the CPU.

``fwarp_shift_plain`` is the plain version of the CUDA kernel
``csrc/fwarp_shift.cu``. It is held against the JAX package's stencil
form (``_fwarp_xla_shifts``), its exact scatter (``_fwarp_xla``) and the
Pallas kernel ``fwarp_shift_tpu`` in interpret mode, on inputs from a
numpy seed. Tolerance atol 1e-5: the stencil multiplies two separable
Gaussian weights where the scatter exponentiates their sum, and the sums
run in different orders.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from demfi_tpu.ops.pallas_kernels import fwarp_shift_tpu
from demfi_tpu.ops.warp import _fwarp_xla, _fwarp_xla_shifts
from demfi_tpu.ops.warp import cfr_flow_t_align as jax_cfr
from demfi_torch import nchw_to_nhwc, nhwc_to_nchw
from demfi_torch.ops import kernels, warp

ATOL = 1e-5


def _inputs(shape, peak, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    flo = rng.uniform(-peak, peak, shape[:3] + (2,)).astype(np.float32)
    return x, flo


def _plain(x, flo, d):
    out, norm = warp.fwarp_shift_plain(nhwc_to_nchw(torch.from_numpy(x)),
                                       nhwc_to_nchw(torch.from_numpy(flo)), d)
    return nchw_to_nhwc(out).numpy(), nchw_to_nhwc(norm).numpy()


@pytest.mark.parametrize("oracle", ["xla_shifts", "xla_scatter"])
def test_plain_matches_jax(oracle):
    x, flo = _inputs((2, 40, 56, 3), 6.9)
    # integer and half-integer displacements sit on the bucket edges
    flo[0, :8] = np.round(flo[0, :8])
    flo[1, :8] = np.round(flo[1, :8]) + 0.5
    flo = np.clip(flo, -7.0, 7.0)
    got, gotn = _plain(x, flo, 8)
    if oracle == "xla_shifts":
        want, wantn = _fwarp_xla_shifts(jnp.asarray(x), jnp.asarray(flo), 8)
    else:
        want, wantn = _fwarp_xla(jnp.asarray(x), jnp.asarray(flo))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(gotn, np.asarray(wantn), atol=ATOL)


def test_plain_matches_interpreted_pallas_kernel():
    """The inputs of the JAX package's own test of the kernel: [2,48,256,2],
    flows in +-6.9, D = 8, the v2 body in interpret mode."""
    x, flo = _inputs((2, 48, 256, 2), 6.9)
    with pltpu.force_tpu_interpret_mode():
        want, wantn = jax.block_until_ready(
            fwarp_shift_tpu(jnp.asarray(x), jnp.asarray(flo), D=8, v2=True))
    got, gotn = _plain(x, flo, 8)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(gotn, np.asarray(wantn), atol=ATOL)


def test_plain_drops_splats_beyond_the_window():
    """Beyond the window the stencil alone is not the forward warp: a
    pixel displaced by 12 with d = 8 leaves no trace."""
    x = np.ones((1, 32, 32, 1), np.float32)
    flo = np.zeros((1, 32, 32, 2), np.float32)
    flo[0, 16, 4] = (12.0, 0.0)
    got, gotn = _plain(x, flo, 8)
    want, wantn = _fwarp_xla(jnp.asarray(x), jnp.asarray(flo))
    assert np.asarray(wantn)[0, 16, 16, 0] > gotn[0, 16, 16, 0] + 0.5
    flo[0, 16, 4] = 0.0
    keep, keepn = _plain(x, flo, 8)
    mask = np.ones((32, 32), bool)
    mask[16, 4:6] = mask[17, 4:6] = False
    np.testing.assert_array_equal(gotn[0, ..., 0][mask], keepn[0, ..., 0][mask])


@pytest.mark.parametrize("peak,served_by", [(6.9, "fwarp_shift_plain"),
                                            (20.0, "fwarp_splat_plain")])
def test_guard_routes(monkeypatch, peak, served_by):
    """fwarp(shift_d=8) takes the stencil inside the window and the exact
    splat beyond it; either way it equals the JAX scatter."""
    calls = []
    for name in ("fwarp_shift_plain", "fwarp_splat_plain"):
        fn = getattr(warp, name)
        monkeypatch.setattr(
            warp, name,
            lambda *a, _fn=fn, _n=name: (calls.append(_n), _fn(*a))[1])
    x, flo = _inputs((2, 32, 48, 2), peak, seed=1)
    out, norm = warp.fwarp(nhwc_to_nchw(torch.from_numpy(x)),
                           nhwc_to_nchw(torch.from_numpy(flo)), shift_d=8)
    assert calls == [served_by]
    want, wantn = _fwarp_xla(jnp.asarray(x), jnp.asarray(flo))
    np.testing.assert_allclose(nchw_to_nhwc(out).numpy(), np.asarray(want),
                               atol=ATOL * max(1.0, peak))
    np.testing.assert_allclose(nchw_to_nhwc(norm).numpy(), np.asarray(wantn),
                               atol=ATOL)


def test_fwarp_shift_d_zero_is_the_splat():
    x, flo = _inputs((1, 24, 32, 2), 5.0, seed=2)
    tx, tf = (nhwc_to_nchw(torch.from_numpy(a)) for a in (x, flo))
    a = warp.fwarp(tx, tf)
    b = warp.fwarp_splat_plain(tx, tf)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("peak", [6.0, 30.0])
def test_cfr_with_shift_matches_jax(peak):
    """cfr_flow_t_align(shift_d=8) against the JAX CFR, inside the window
    (both forward warps take the stencil) and beyond it (the splat)."""
    rng = np.random.RandomState(5)
    f01 = rng.uniform(-peak, peak, (3, 32, 48, 2)).astype(np.float32)
    f10 = rng.uniform(-peak, peak, (3, 32, 48, 2)).astype(np.float32)
    t = np.array([0.125, 0.5, 0.875], np.float32)
    want0, want1 = jax_cfr(jnp.asarray(f01), jnp.asarray(f10),
                           jnp.asarray(t).reshape(3, 1, 1, 1))
    got0, got1 = warp.cfr_flow_t_align(
        nhwc_to_nchw(torch.from_numpy(f01)),
        nhwc_to_nchw(torch.from_numpy(f10)), torch.from_numpy(t), shift_d=8)
    tol = dict(atol=ATOL * max(1.0, peak), rtol=1e-5)
    np.testing.assert_allclose(nchw_to_nhwc(got0).numpy(), np.asarray(want0),
                               **tol)
    np.testing.assert_allclose(nchw_to_nhwc(got1).numpy(), np.asarray(want1),
                               **tol)


def test_wrapper_takes_the_plain_version_on_the_cpu_only():
    x, flo = _inputs((1, 16, 16, 2), 3.0)
    tx, tf = (nhwc_to_nchw(torch.from_numpy(a)) for a in (x, flo))
    n = kernels.fwarp_shift.launches
    out, norm = kernels.fwarp_shift(tx, tf, 4)
    assert kernels.fwarp_shift.launches == n     # no kernel was launched
    want, wantn = warp.fwarp_shift_plain(tx, tf, 4)
    assert torch.equal(out, want) and torch.equal(norm, wantn)
    with pytest.raises(ValueError):
        kernels.fwarp_shift(tx, tf, 0)
    with pytest.raises(ValueError):
        kernels.fwarp_guarded(tx, tf, 0)
    n = kernels.launch_counts()
    out, norm = kernels.fwarp_guarded(tx, tf, 4)
    assert kernels.launch_counts() == n
    assert torch.equal(out, want) and torch.equal(norm, wantn)
