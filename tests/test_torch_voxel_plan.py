"""The event-voxelization kernel's launch plan (``kernels/event_voxel.py``
``voxel_plan``, ``event_share``) on the CPU, by the kernel's decode of
gridDim.x: every cell of every window in exactly one block, no (OFF, ON)
pair split, shared bytes, cluster and grid within limits, every event of
a window read by exactly one block of each cluster; and the tick's
encode (``core.encoding.encode_batch``, both backends; on the CPU the
kernel wrapper takes its plain version) against the JAX engine's
encode-and-select, bit-exact.  The kernel runs only on the card
(``tests/test_torch_cuda_kernels.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as jenc
from repro_torch.core.encoding import (ENCODING_BACKENDS, OOB_POLICIES,
                                       VOXEL_MODES, EventStream,
                                       encode_batch)
from repro_torch.kernels import event_voxel as K

# (T, H, W): the tick's grid, small and odd frames, a DAVIS346 frame and
# a 720p one (several clusters a window)
GRIDS = [(5, 64, 64), (3, 16, 12), (7, 37, 53), (5, 260, 346),
         (5, 720, 1280)]


def _blocks(plan, B, T, H, W):
    """(window, first cell, cells) of each block, by the kernel's decode
    of blockIdx.x: the rank in the cluster fastest, then the cluster,
    then the window."""
    grid = T * H * W * 2
    blk = np.arange(plan.blocks, dtype=np.int64)
    rank, cid = blk % plan.cluster, blk // plan.cluster
    b = cid // plan.clusters
    c0 = (cid - b * plan.clusters) * plan.cluster * plan.cells \
        + rank * plan.cells
    return b, c0, np.clip(grid - c0, 0, plan.cells)


@pytest.mark.parametrize("grid", GRIDS)
def test_every_cell_in_exactly_one_block(grid):
    T, H, W = grid
    B = 3
    plan = K.voxel_plan(B, T, H, W)
    b, c0, n = _blocks(plan, B, T, H, W)
    cells = T * H * W * 2
    for w in range(B):
        mine = b == w
        order = np.argsort(c0[mine])
        start, count = c0[mine][order], n[mine][order]
        live = count > 0
        # the live blocks tile [0, cells) end to end
        assert start[live][0] == 0
        assert (start[live][1:] == (start + count)[live][:-1]).all()
        assert (start + count)[live][-1] == cells
        assert count.sum() == cells
    # whole (OFF, ON) pairs and 16-byte rows a block
    assert plan.cells % 4 == 0 and (c0 % 4 == 0).all() and (n % 2 == 0).all()
    # no cluster of a window lies wholly past its grid
    span = plan.cluster * plan.cells
    assert (plan.clusters - 1) * span < cells <= plan.clusters * span


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("batch", [1, 8, 65537])
def test_plan_fits_the_card(grid, batch):
    plan = K.voxel_plan(batch, *grid)
    assert plan.smem == 4 * plan.cells <= K.SMEM_LIMIT
    assert plan.cells <= K.MAX_CELLS
    assert 1 <= plan.cluster <= K.MAX_CLUSTER
    assert plan.blocks % plan.cluster == 0          # whole clusters
    assert plan.blocks == batch * plan.clusters * plan.cluster
    assert plan.blocks < 2 ** 31
    assert plan.threads == K.VOXEL_THREADS


def test_the_tick_and_the_long_grids():
    """The tick's window is one cluster of 16 blocks of 10 KB (128
    blocks at batch 8); 65537 time steps and batch 65537 stay on
    gridDim.x; a grid past int32 cells is refused."""
    assert K.voxel_plan(8, 5, 64, 64) == K.VoxelPlan(
        cluster=16, cells=2560, clusters=1, blocks=128,
        threads=K.VOXEL_THREADS, smem=10240)
    for shape in ((2, 65537, 4, 4), (65537, 2, 4, 4), (2, 65537, 64, 64),
                  (65537, 5, 64, 64)):
        plan = K.voxel_plan(*shape)
        assert plan.blocks < 2 ** 31 and plan.blocks % plan.cluster == 0
    assert K.voxel_plan(8, 5, 64, 64) is K.voxel_plan(8, 5, 64, 64)
    with pytest.raises(ValueError, match="past int32"):
        K.voxel_plan(1, 2 ** 20, 64, 64)
    with pytest.raises(ValueError, match="empty grid"):
        K.voxel_plan(0, 5, 64, 64)


@pytest.mark.parametrize("n_events", [0, 1, 3, 4, 301, 2048, 8192])
@pytest.mark.parametrize("cluster", [1, 3, 16])
def test_every_event_read_once_a_cluster(n_events, cluster):
    share = K.event_share(n_events, cluster)
    assert share % 4 == 0
    read = np.zeros(n_events, dtype=np.int64)
    for rank in range(cluster):
        read[rank * share:min(n_events, (rank + 1) * share)] += 1
    assert (read == 1).all()


def _case(seed, B, N, T, H, W):
    """Numpy events with out-of-range coordinates, polarities and
    timestamps, staged voxels and a mask that mixes windows."""
    rng = np.random.default_rng(seed)
    leaves = (rng.uniform(-0.3, 1.3, (B, N)).astype(np.float32),
              rng.integers(-2, W + 2, (B, N)).astype(np.int32),
              rng.integers(-2, H + 2, (B, N)).astype(np.int32),
              rng.integers(-1, 3, (B, N)).astype(np.int32),
              rng.random((B, N)) < 0.8)
    vox = rng.uniform(-1, 2, (T, B, H, W, 2)).astype(np.float32)
    mask = rng.random(B) < 0.5
    mask[0], mask[-1] = True, False
    return leaves, vox, mask


@pytest.mark.parametrize("oob", OOB_POLICIES)
@pytest.mark.parametrize("mode", VOXEL_MODES)
def test_encode_batch_matches_jax(mode, oob):
    """encode_batch on both backends against the JAX engine's encode and
    select (``repro.serve.engine_core``): jnp.where(from_events, the
    time-major grid, the staged voxels)."""
    B, N, T, H, W = 5, 300, 4, 9, 7
    leaves, vox, mask = _case(VOXEL_MODES.index(mode) + 10 * len(oob),
                              B, N, T, H, W)
    kw = dict(time_steps=T, height=H, width=W, mode=mode, oob=oob)
    want = np.asarray(jax.jit(lambda e, v, f: jnp.where(
        f[None, :, None, None, None],
        jnp.moveaxis(jenc.events_to_voxel_batch(e, **kw), 0, 1), v))(
            jenc.EventStream(*leaves), vox, mask))
    evs = EventStream(*(torch.tensor(a) for a in leaves))
    for backend in ENCODING_BACKENDS:
        got = encode_batch(evs, torch.tensor(vox), torch.tensor(mask),
                           backend=backend, **kw)
        assert got.shape == (T, B, H, W, 2)
        np.testing.assert_array_equal(got.numpy(), want)


def test_encode_batch_refuses_what_the_kernel_does_not_take():
    B, N, T, H, W = 2, 8, 3, 4, 4
    leaves, vox, mask = _case(0, B, N, T, H, W)
    evs = EventStream(*(torch.tensor(a) for a in leaves))
    kw = dict(time_steps=T, height=H, width=W)
    with pytest.raises(ValueError, match="voxels must be"):
        K.event_voxel_encode(evs, torch.tensor(vox[:2]), torch.tensor(mask),
                             **kw)
    with pytest.raises(ValueError, match="from_events must be"):
        K.event_voxel_encode(evs, torch.tensor(vox),
                             torch.tensor(mask).float(), **kw)
    with pytest.raises(ValueError, match="unknown encoding backend"):
        encode_batch(evs, torch.tensor(vox), torch.tensor(mask),
                     backend="pallas", **kw)
