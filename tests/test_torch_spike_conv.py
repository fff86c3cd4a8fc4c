"""Port parity: the spike-im2col conv, the spike_conv kernel's wrapper
(on the CPU its plain version) and spike_conv_op under every gate, the
occupancy mask and the tile-skip spike matmul against the JAX package's
jnp path (repro.core.layers.spike_conv_jnp, repro.kernels.spike_conv
.occupancy_mask, a plain jnp matmul) on the same numpy inputs; and the
kernel's tile/split-K choice (conv_tiles) against its invariants.

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
from repro_torch.kernels.blocks import CANONICAL_K_BLOCK
from repro_torch.kernels.spike_conv import (BLOCKS_PER_SM, GATES, TILE_K,
                                            TILE_M, conv_tiles,
                                            occupancy_mask)
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
    # 2 channels, stride 2 on an even 64-wide input: SAME puts the whole
    # pad on the high side
    "c2_stride2_even": (2, 64, 64, 2, 8, 3, 2, 0.1, 0),
    "densenet_c24": (2, 12, 12, 24, 24, 3, 1, 0.3, 0),  # K=216: 2 blocks
    "pointwise_c66": (2, 8, 8, 66, 14, 1, 1, 0.3, 0),
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
    got = [spike_conv(tx, tw, stride=stride)]
    for gate in GATES:
        got += [spike_conv_kernel(tx, tw, stride=stride, gate=gate),
                spike_conv_op(tx, tw, stride=stride, gate=gate)]
    for g in got:
        assert g.shape == want.shape
        np.testing.assert_allclose(g.numpy(), want, atol=ATOL, rtol=0)


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
    xf = torch.zeros(2, 8, 8, 4)
    w = torch.zeros(3, 3, 4, 6)
    with pytest.raises(ValueError, match="gate"):
        spike_conv_kernel(xf, w, gate="sometimes")
    with pytest.raises(ValueError, match="gate"):
        spike_conv_op(xf, w, gate="")
    with pytest.raises(ValueError):             # HWIO cin != C
        spike_conv_kernel(xf, torch.zeros(3, 3, 5, 6))
    with pytest.raises(ValueError):             # patches, not xf
        spike_conv_kernel(torch.zeros(130, 36), w)
    with pytest.raises(ValueError):
        spike_conv_kernel(xf, w, stride=0)
    with pytest.raises(TypeError):
        spike_conv_kernel(xf.double(), w.double())
    with pytest.raises(TypeError):
        spike_conv_kernel(xf, w.half())
    p = torch.zeros(130, 20)
    with pytest.raises(TypeError):
        spike_matmul(p.double(), torch.zeros(20, 4).double())


# (M, K, N): every conv of the four archs' batch-8 ticks, the chip
# tests' split-K case, and edges
TILE_SHAPES = [
    (40960, 18, 32), (40960, 288, 32), (10240, 288, 64), (10240, 576, 64),
    (2560, 576, 128), (2560, 1152, 128), (640, 1152, 256), (640, 2304, 256),
    (640, 256, 14), (163840, 18, 32), (163840, 288, 32), (2560, 2304, 256),
    (40960, 32, 32), (10240, 32, 64), (2560, 64, 128), (640, 128, 256),
    (163840, 18, 24), (163840, 216, 24), (163840, 648, 24), (163840, 96, 48),
    (40960, 432, 24), (40960, 120, 60), (10240, 540, 24), (10240, 972, 24),
    (10240, 132, 66), (2560, 594, 66), (2560, 66, 14), (1, 1, 1),
    (129, 129, 33), (65535 * 64 + 64, 18, 32), (127, 5000, 300),
]


@pytest.mark.parametrize("M,K,N", TILE_SHAPES)
def test_conv_tiles_cover_and_split_only_when_short(M, K, N):
    t = conv_tiles(M, K, N)
    # each K slice lies inside one canonical block
    assert CANONICAL_K_BLOCK % TILE_K == 0
    for s in range(-(-K // TILE_K)):
        lo, hi = s * TILE_K, min((s + 1) * TILE_K, K) - 1
        assert lo // CANONICAL_K_BLOCK == hi // CANONICAL_K_BLOCK
    assert t.kblocks == -(-K // CANONICAL_K_BLOCK)
    # the tiles cover M x N exactly: no row or column left out, no tile
    # wholly outside
    assert TILE_M == 128 and t.bn in (32, 64, 128)
    assert (t.row_tiles - 1) * TILE_M < M <= t.row_tiles * TILE_M
    assert (t.col_tiles - 1) * t.bn < N <= t.col_tiles * t.bn
    # the narrowest width that holds cout, 128 past it
    assert t.bn == min([w for w in (32, 64, 128) if N <= w] or [128])
    # split-K only where the output tiles alone leave SMs idle, into runs
    # of consecutive K blocks that cover K once and fit one wave
    tiles = t.row_tiles * t.col_tiles
    assert not t.split or (tiles < 132 and t.kblocks > 1)
    assert t.split == (t.kgroup < t.kblocks)
    assert (t.groups - 1) * t.kgroup < t.kblocks <= t.groups * t.kgroup
    if t.split:
        assert tiles * t.groups <= 132 * BLOCKS_PER_SM[t.bn]
        # one run fewer would not fit the shortest length
        assert -(-t.kblocks // (t.kgroup - 1 or 1)) * tiles > \
            132 * BLOCKS_PER_SM[t.bn] or t.kgroup == 1
    if tiles >= 132:
        assert not t.split
    assert conv_tiles(M, K, N, sms=tiles).split is False
