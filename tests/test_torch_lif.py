"""Port parity: the LIF scan and the fused norm+affine+LIF epilogue
against the JAX package's jnp path (repro.core.lif, the layered norm of
repro.core.layers), on the same numpy inputs.

Spikes must agree except where the reference membrane lies within 1e-5
of v_th (the bar tests/test_lif_backend.py sets); the normalised
currents must agree to float rounding.  The CUDA kernels themselves are
checked on the card (chip_smoke.py, tests/test_torch_cuda_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lif import lif_scan as jax_lif_scan
from repro_torch.core.layers import instance_norm_affine
from repro_torch.core.lif import f32_decay
from repro_torch.kernels import lif_scan as klif
from repro_torch.kernels.ops import lif_scan_op, norm_affine_lif_op
from repro_torch.testing import spike_mismatch

TOL = 1e-5



def _jax_norm_affine(y4, scale, bias):
    mu = jnp.mean(y4, axis=(0, 2), keepdims=True)
    var = jnp.var(y4, axis=(0, 2), keepdims=True)
    return (y4 - mu) * jax.lax.rsqrt(var + 1e-6) * scale + bias


@pytest.mark.parametrize("tau", [1.5, 2.0, 5.0])
def test_f32_decay_matches_reference(tau):
    want = np.asarray(jnp.exp(-1.0 / tau).astype(jnp.float32))
    assert np.float32(f32_decay(tau)) == want


@pytest.mark.parametrize("T,N", [(3, 64), (5, 300), (8, 1025)])
@pytest.mark.parametrize("tau", [1.5, 2.0, 5.0])
def test_lif_scan_matches_jax(T, N, tau):
    rng = np.random.default_rng(T * N)
    cur = rng.normal(0.6, 1.0, (T, N)).astype(np.float32)
    want = np.asarray(jax.jit(lambda c: jax_lif_scan(c, tau=tau))(cur))
    for fn in (klif.lif_scan, lif_scan_op):
        got = fn(torch.tensor(cur), tau=tau).numpy()
        res = spike_mismatch(cur, got, tol=TOL, tau=tau)
        assert res["far"] == 0, res
        # the same float32 op order: no flip at these seeds
        np.testing.assert_array_equal(got, want)
    assert 0.0 < want.mean() < 1.0


@pytest.mark.parametrize("T,B,C", [(5, 8, 64), (3, 2, 33), (12, 4, 40),
                                   (1, 1, 1)])
def test_lif_scan_bias_matches_jax(T, B, C):
    """A dense layer's bias given to the scan (on the card its add is in
    the launch): the JAX scan of currents + bias, through the wrapper on
    [T, B * C] and the op on [T, B, C]."""
    rng = np.random.default_rng(T * B * C)
    cur = rng.normal(0.5, 1.0, (T, B, C)).astype(np.float32)
    bias = rng.normal(0.0, 0.5, C).astype(np.float32)
    want = np.asarray(jax.jit(jax_lif_scan)(jnp.asarray(cur) + bias))
    tb = torch.tensor(bias)
    got = klif.lif_scan(torch.tensor(cur.reshape(T, -1)), bias=tb)
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    np.testing.assert_array_equal(
        lif_scan_op(torch.tensor(cur), bias=tb).numpy(), want)
    # no bias: the scan of the currents as they are
    np.testing.assert_array_equal(
        lif_scan_op(torch.tensor(cur), bias=None).numpy(),
        np.asarray(jax.jit(jax_lif_scan)(cur)))


def test_lif_scan_rejects_a_bias_of_the_wrong_length():
    cur = torch.zeros(5, 8, 64)
    with pytest.raises(ValueError, match="bias"):
        lif_scan_op(cur, bias=torch.zeros(65))
    with pytest.raises(ValueError, match="bias"):
        lif_scan_op(cur, bias=torch.zeros(8, 64))
    with pytest.raises(ValueError, match="bias"):
        klif.lif_scan(cur.reshape(5, -1), bias=torch.zeros(60))
    with pytest.raises(ValueError, match="bias"):
        klif.lif_scan(cur.reshape(5, -1), bias=torch.zeros(0))
    with pytest.raises(TypeError):
        klif.lif_scan(cur.reshape(5, -1),
                      bias=torch.zeros(64, dtype=torch.float64))


@pytest.mark.parametrize("T,B,HW,C", [(3, 2, 64, 16), (5, 1, 100, 8),
                                      (2, 4, 33, 24)])
def test_norm_affine_lif_matches_jax(T, B, HW, C):
    rng = np.random.default_rng(T * B * HW * C)
    y = rng.normal(0.3, 1.0, (T, B, HW, C)).astype(np.float32)
    scale = rng.normal(1, 0.2, (C,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (C,)).astype(np.float32)
    z_ref = np.asarray(jax.jit(_jax_norm_affine)(y, scale, bias))
    want = np.asarray(jax.jit(lambda z: jax_lif_scan(z))(z_ref))
    ty, ts, tb = (torch.tensor(a) for a in (y, scale, bias))
    np.testing.assert_allclose(
        instance_norm_affine(ty, ts, tb).numpy(), z_ref, atol=1e-5, rtol=0)
    for got in (klif.norm_affine_lif(ty, ts, tb),
                norm_affine_lif_op(ty.reshape(T, B, 1, HW, C), ts,
                                   tb).reshape(T, B, HW, C)):
        res = spike_mismatch(z_ref, got, tol=TOL)
        assert res["far"] == 0, res
        assert res["flipped"] <= res["near"]
    assert 0.0 < want.mean() < 1.0


def test_spike_mismatch_flags_a_far_flip():
    """The rule itself: a flip away from threshold is reported."""
    cur = np.array([[0.2], [2.0], [0.3]], np.float32)
    s = np.array([[0.0], [1.0], [0.0]], np.float32)
    assert spike_mismatch(cur, s, tol=TOL)["far"] == 0
    s_bad = s.copy()
    s_bad[1, 0] = 0.0
    assert spike_mismatch(cur, s_bad, tol=TOL)["far"] == 1


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        klif.lif_scan(torch.zeros(3, 4, 5))
    with pytest.raises(TypeError):
        klif.lif_scan(torch.zeros(3, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        klif.norm_affine_lif(torch.zeros(2, 1, 4, 3), torch.ones(2),
                             torch.zeros(3))
    with pytest.raises(ValueError):
        klif.lif_scan(torch.zeros(4, 3).t())           # not contiguous

