"""The launch shapes of the redesigned depthwise conv and spike matmul
kernels, checked on the CPU: ``spike_dwconv.dw_tiles`` (every output in
exactly one block, each block staging exactly its outputs' input rows
and columns with the halo, its shared memory and threads leaving room
for two blocks an SM, nothing past gridDim.x) and
``spike_matmul.matmul_path`` (which shapes take the small path); and the
port's depthwise conv at full MobileNet width, batch 1, bit-equal to
JAX's ``spike_conv_jnp(..., depthwise=True)`` on numpy-seeded spikes (the
same in-order tap loop; every product of a 0/1 spike is exact).  The
kernels themselves run on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.layers import spike_conv_jnp
from repro_torch.configs.registry import SNN_ARCHS
from repro_torch.core.backbones import mobilenet_specs
from repro_torch.kernels.spike_dwconv import (MAX_SMEM, MAX_THREADS,
                                              MIN_BLOCKS, dw_tiles,
                                              spike_dwconv)
from repro_torch.kernels.spike_matmul import (SMALL_BLOCK_OUTPUTS,
                                              SMALL_ROWS, matmul_path,
                                              small_rows)

# (N, H, W, C, stride): MobileNet's four depthwise layers at batch 8
# (T = 5), then the shapes of the depthwise tests
MOBILENET = [(40, 64, 64, 32, 2), (40, 32, 32, 32, 2), (40, 16, 16, 64, 2),
             (40, 8, 8, 128, 2)]
TEST_SHAPES = [(3, h, w, c, s) for (h, w) in ((9, 7), (8, 10))
               for c in (8, 24, 33) for s in (1, 2)]
TEST_SHAPES += [(3, 17, 15, 33, 2), (4, 9, 10, 256, 1), (6, 16, 16, 24, 2),
                (2, 8, 8, 8, 1), (40, 32, 32, 32, 1), (40, 64, 64, 33, 2)]
# an H100 SM: shared memory for blocks (228 KB less 1 KB a block kept by
# the runtime), threads
SM_SMEM, SM_THREADS = 228 * 1024, 2048


def _ceil(a, b):
    return -(-a // b)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("shape", MOBILENET + TEST_SHAPES)
def test_dw_tiles_cover_each_output_once_with_its_window(shape, vec, k):
    N, H, W, C, stride = shape
    t = dw_tiles(N, H, W, C, k, k, stride, vec=vec)
    Ho, Wo = _ceil(H, stride), _ceil(W, stride)
    assert (t.Ho, t.Wo) == (Ho, Wo)
    assert t.vec == (4 if vec and C % 4 == 0 else 1) and t.cg % t.vec == 0
    assert t.blocks == N * t.blocks_per_frame
    # the tiles at the real frame count, walked on two frames
    N = min(N, 2)
    t = dataclasses.replace(t, N=N)
    seen = np.zeros((N, Ho, Wo, C), dtype=np.int32)
    for b in range(t.blocks):
        n, rows, cols, chans, rows_in, cols_in = t.block(b)
        seen[n, rows.start:rows.stop, cols.start:cols.stop,
             chans.start:chans.stop] += 1
        # the staged rows and columns are exactly the outputs' taps
        taps_h = {ho * stride - t.pad_h + i for ho in rows for i in range(k)}
        taps_w = {wo * stride - t.pad_w + j for wo in cols for j in range(k)}
        assert set(rows_in) >= taps_h and set(cols_in) >= taps_w
        assert rows_in.start == min(taps_h) and rows_in.stop - 1 == max(taps_h)
        assert cols_in.start == min(taps_w) and cols_in.stop - 1 == max(taps_w)
        assert len(rows_in) <= t.rows_in and len(cols_in) <= t.cols_in
    assert (seen == 1).all()
    assert t.grid == (t.blocks, 1, 1)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("shape", MOBILENET + TEST_SHAPES)
def test_dw_tiles_leave_room_for_two_blocks_an_sm(shape, vec):
    """A block's tile fits MAX_SMEM (so no opt-in past 48 KB) and two
    blocks fit an SM by shared memory and by threads; every lane of a
    group has a thread."""
    N, H, W, C, stride = shape
    for k in (3, 5):
        t = dw_tiles(N, H, W, C, k, k, stride, vec=vec)
        assert t.smem_bytes == t.rows_in * t.cols_in * min(t.cg, C) * 4
        assert t.smem_bytes <= MAX_SMEM <= 48 * 1024
        assert SM_SMEM // (t.smem_bytes + 1024) >= 2
        assert t.threads <= MAX_THREADS and SM_THREADS // t.threads >= 2
        assert t.threads == t.cg // t.vec * t.col_threads
        assert 1 <= t.col_threads <= t.bw


@pytest.mark.parametrize("k", [15, 41, 91])
def test_dw_tiles_fit_very_large_kernels(k):
    """A kernel whose taps pass MAX_SMEM over a full row and 64 channels
    takes narrower tiles and fewer channels a block, down to one."""
    t = dw_tiles(2, 20, 20, 64, k, k, 1)
    assert t.smem_bytes <= MAX_SMEM
    seen = np.zeros((2, t.Ho, t.Wo, 64), dtype=np.int32)
    for b in range(t.blocks):
        n, rows, cols, chans, rows_in, cols_in = t.block(b)
        seen[n, rows.start:rows.stop, cols.start:cols.stop,
             chans.start:chans.stop] += 1
        assert len(rows_in) == (len(rows) - 1) + k
        assert len(cols_in) == (len(cols) - 1) + k
    assert (seen == 1).all()


def test_dw_tiles_fill_the_card_on_dw0():
    """dw0 moves ~70% of the bytes: its blocks fill the 132 SMs four
    times over, in one wave (five fit an SM by shared memory), with more
    than one output row a block; the smaller layers take one row."""
    t = dw_tiles(*MOBILENET[0][:4], 3, 3, 2)
    assert t.vec == 4 and t.cg == 32 and t.bw == t.Wo and t.bh == 2
    assert MIN_BLOCKS <= t.blocks <= 132 * (SM_SMEM // (t.smem_bytes + 1024))
    for shape in MOBILENET[1:]:
        assert dw_tiles(*shape[:4], 3, 3, 2).bh == 1


def test_dw_tiles_put_every_frame_on_grid_x():
    """70,000 frames: past what gridDim.y or z holds, all on x."""
    t = dw_tiles(70_000, 8, 8, 8, 3, 3, 1)
    assert t.grid[1:] == (1, 1)
    assert t.grid[0] == t.blocks >= 70_000
    assert t.grid[0] < 2 ** 31


@pytest.mark.parametrize("batch", [1, 2, 4, 8, 16])
def test_control_head_takes_the_small_path(batch):
    cfg = SNN_ARCHS["spiking_yolo"]
    M, N = cfg.time_steps * batch, cfg.control_dim
    assert matmul_path(M, N) == "small"
    rows = small_rows(M, N)
    assert rows * N <= SMALL_BLOCK_OUTPUTS and rows <= SMALL_ROWS
    assert _ceil(M, rows) == (1 if M <= SMALL_ROWS else 2)


@pytest.mark.parametrize("M,N", [
    (65535 * 64 + 64, 32),      # the row-cap test's shape
    (40 * 32 * 32, 64),         # full-width conv-oracle patches ...
    (40 * 4 * 4, 14),           # ... down to the smallest (head_pred)
    (40 * 16 * 16, 32),
    (64, 65),                   # one column past the small path
    (4097, 1),                  # one output past it
])
def test_large_shapes_keep_the_tiled_path(M, N):
    assert matmul_path(M, N) == "tiled"


@pytest.mark.parametrize("M,N", [(1, 1), (1, 64), (4096, 1), (64, 64),
                                 (37, 13)])
def test_small_rows_hold_the_block(M, N):
    assert matmul_path(M, N) == "small"
    rows = small_rows(M, N)
    assert 1 <= rows <= min(M, SMALL_ROWS)
    assert rows * N <= SMALL_BLOCK_OUTPUTS


def test_full_width_mobilenet_depthwise_equals_jax():
    """Batch 1 (N = T = 5): each of MobileNet's depthwise layers at its
    full width, the port's conv bit-equal to JAX's."""
    cfg = SNN_ARCHS["spiking_mobilenet"]
    H, W = cfg.height, cfg.width
    C = cfg.in_channels
    dws = 0
    for s in mobilenet_specs(cfg):
        if s.depthwise:
            seed = 100 + dws
            rng = np.random.default_rng(seed)
            x = (rng.random((cfg.time_steps, H, W, C)) < 0.2).astype(
                np.float32)
            w = rng.normal(0, 0.5, (3, 3, 1, C)).astype(np.float32)
            want = np.asarray(spike_conv_jnp(x, w, stride=s.stride,
                                             depthwise=True))
            got = spike_dwconv(torch.tensor(x), torch.tensor(w),
                               stride=s.stride)
            np.testing.assert_array_equal(got.numpy(), want)
            dws += 1
        H, W = _ceil(H, s.stride), _ceil(W, s.stride)
        C = s.cout
    assert dws == 4
