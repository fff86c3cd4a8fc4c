"""Port parity: the spike-im2col conv, its occupancy mask and the
tile-skip spike matmul against the JAX package's jnp path
(repro.core.layers.spike_conv_jnp, repro.kernels.spike_conv
.occupancy_mask, a plain jnp matmul) on the same numpy inputs.

Tolerance: allclose atol=1e-5 — both sides sum K in the same 128-wide
canonical blocks, but XLA and PyTorch order the sums inside a block
differently.  The CUDA kernels are checked on the card (chip_smoke.py
and tests/test_torch_cuda_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layers import spike_conv_jnp, spike_im2col as jax_im2col
from repro.kernels.spike_conv import occupancy_mask as jax_occupancy_mask
from repro_torch.core.layers import spike_conv, spike_im2col
from repro_torch.kernels.ops import spike_conv_op, spike_matmul_op
from repro_torch.kernels.spike_conv import occupancy_mask
from repro_torch.kernels.spike_conv import spike_conv as spike_conv_kernel
from repro_torch.kernels.spike_matmul import spike_matmul

ATOL = 1e-5


def _spikes(rng, shape, density, silent_rows=0):
    x = (rng.random(shape) < density).astype(np.float32)
    if silent_rows:
        x[:silent_rows] = 0.0          # whole silent frames: skipped tiles
    return x


# (N, H, W, cin, cout, k, stride, density, silent frames)
CASES = {
    "normal": (4, 16, 16, 8, 16, 3, 1, 0.3, 0),
    "strided": (4, 17, 15, 8, 16, 3, 2, 0.3, 0),
    "pointwise": (3, 8, 8, 16, 14, 1, 1, 0.4, 0),
    "ragged_k_n": (2, 12, 12, 15, 19, 3, 1, 0.3, 0),   # K=135, N=19
    "wide_k": (2, 8, 8, 40, 24, 3, 1, 0.2, 0),         # K=360: 3 blocks
    "partly_silent": (6, 16, 16, 8, 16, 3, 1, 0.3, 4),
    "all_silent": (2, 8, 8, 4, 8, 3, 2, 0.0, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spike_conv_matches_jax(case):
    n, h, w_, cin, cout, k, stride, dens, silent = CASES[case]
    rng = np.random.default_rng(len(case))
    xf = _spikes(rng, (n, h, w_, cin), dens, silent)
    w = (rng.normal(0, 1, (k, k, cin, cout)) * (2 / (k * k * cin)) ** 0.5
         ).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, b: spike_conv_jnp(a, b, stride=stride))(
        xf, w))
    tx, tw = torch.tensor(xf), torch.tensor(w)
    for got in (spike_conv(tx, tw, stride=stride),
                spike_conv_op(tx, tw, stride=stride)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["strided", "ragged_k_n", "partly_silent"])
def test_im2col_and_mask_match_jax(case):
    n, h, w_, cin, _, k, stride, dens, silent = CASES[case]
    rng = np.random.default_rng(7)
    xf = _spikes(rng, (n, h, w_, cin), dens, silent)
    jp, jhw = jax_im2col(jnp.asarray(xf), k, k, stride)
    tp, thw = spike_im2col(torch.tensor(xf), k, k, stride)
    assert tuple(thw) == tuple(jhw)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(occupancy_mask(tp).numpy(),
                                  np.asarray(jax_occupancy_mask(jp)))
    if silent:
        assert (occupancy_mask(tp).numpy() == 0).any()


@pytest.mark.parametrize("M,K,N,density", [(40, 64, 8, 0.3), (40, 64, 8, 0.0),
                                           (300, 200, 33, 0.1)])
def test_spike_matmul_matches_jax(M, K, N, density):
    rng = np.random.default_rng(M + K + N)
    x = _spikes(rng, (M, K), density)
    w = rng.normal(0, 1, (K, N)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.matmul)(x, w))
    for got in (spike_matmul(torch.tensor(x), torch.tensor(w)),
                spike_matmul_op(torch.tensor(x), torch.tensor(w))):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_wrappers_reject_bad_inputs():
    p = torch.zeros(130, 20)
    w = torch.zeros(20, 4)
    with pytest.raises(ValueError):
        spike_conv_kernel(p, w, torch.zeros(1, 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        spike_conv_kernel(p, torch.zeros(21, 4), occupancy_mask(p))
    with pytest.raises(TypeError):
        spike_matmul(p.double(), w.double())

