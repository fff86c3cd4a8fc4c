"""The norm kernels' statistics contract and the launch plan of
``norm_affine_lif``'s kernel, on the CPU.

``testing.norm_affine_lif_contract`` replays the contract of
``csrc/lif_common.cuh`` (32 row classes, each summed in row order in
float64, added in class order; the LIF step as separate float32 ops).
The card tests hold the kernel to it bit for bit; here it is held to
JAX's jnp reference (``repro.kernels.ref.norm_affine_lif_ref``): spikes
by the near-threshold rule at 1e-4, the statistics at 1e-6.

``lif_scan.norm_lif_plan`` is the kernel's launch plan, decoded here as
the kernel decodes it (``NormLifPlan.block``/``chain``/``slab_row``/
``owner``/``neurons``): every (b, c, class) summed by exactly one
thread, every neuron fired once, every row staged once and found again
by the fire pass, within the card's limits, at any batch.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import norm_affine_lif_ref
from repro_torch.configs.registry import SNN_ARCHS
from repro_torch.core.npu import init_npu
from repro_torch.kernels import lif_scan as klif
from repro_torch.testing import (norm_affine_lif_contract,
                                 norm_lif_contract_stats, spike_mismatch)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the served shapes the card run times
import chip_smoke  # noqa: E402

NEAR = 1e-4                 # near-threshold band for spike flips
STATS_TOL = 1e-6            # the statistics against JAX's instance norm
EPS = 1e-6
# ragged shapes: HW and C off the multiples of 32, single rows, T = 1
RAGGED = [(3, 2, 64, 16), (5, 1, 100, 8), (2, 4, 33, 24), (5, 2, 16, 66),
          (1, 3, 1, 5), (3, 2, 100, 33), (5, 1, 1, 1)]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    C = shape[-1]
    return (rng.normal(0.3, 1.0, shape).astype(np.float32),
            rng.normal(1, 0.2, (C,)).astype(np.float32),
            rng.normal(0, 0.2, (C,)).astype(np.float32))


def _jax_stats(y):
    mu = jnp.mean(y, axis=(0, 2))
    var = jnp.var(y, axis=(0, 2))
    return np.asarray(mu), np.asarray(jax.lax.rsqrt(var + EPS))


@pytest.mark.parametrize("shape", RAGGED)
def test_contract_replay_agrees_with_jax(shape):
    y, scale, bias = _inputs(shape, sum(shape))
    want = np.asarray(jax.jit(norm_affine_lif_ref)(y, scale, bias))
    mu_j, r_j = _jax_stats(y)
    ty, ts, tb = (torch.tensor(a) for a in (y, scale, bias))
    mu, r = norm_lif_contract_stats(ty)
    np.testing.assert_allclose(mu.numpy(), mu_j, atol=STATS_TOL, rtol=0)
    np.testing.assert_allclose(r.numpy(), r_j, atol=STATS_TOL,
                               rtol=STATS_TOL)
    got = norm_affine_lif_contract(ty, ts, tb)
    assert got.shape == ty.shape and got.dtype == torch.float32
    # the JAX membrane, from its own normalised currents
    z = (y - mu_j[None, :, None, :]) * r_j[None, :, None, :] * scale + bias
    res = spike_mismatch(z, got, tol=NEAR)
    assert res["far"] == 0, res
    assert res["flipped"] <= res["near"]
    flips = int((got.numpy() != want).any(axis=0).sum())
    assert flips <= res["near"]


def test_contract_replay_edge_values():
    """An all-silent slab fires from the bias alone; a channel whose
    normalised current is exactly v_th fires at t = 0."""
    T, B, HW, C = 3, 2, 33, 4
    y = torch.zeros(T, B, HW, C)
    scale = torch.ones(C)
    bias = torch.tensor([1.0, 0.5, 2.0, -1.0])
    got = norm_affine_lif_contract(y, scale, bias)
    mu, r = norm_lif_contract_stats(y)
    assert bool((mu == 0).all())
    assert torch.equal(got, norm_affine_lif_contract(
        torch.ones(T, B, HW, C) * 3.0, scale, bias))
    # z is the bias: 1.0 and 2.0 reach v_th at t = 0, -1.0 never does
    assert bool((got[0, ..., 0] == 1.0).all())
    assert bool((got[0, ..., 2] == 1.0).all())
    assert bool((got[..., 3] == 0.0).all())
    y, s, b = (torch.tensor(a) for a in _inputs((2, 2, 16, 6), 1))
    s[::2], b[::2] = 0.0, 1.0
    on = norm_affine_lif_contract(y, s, b)
    assert bool((on[0, ..., ::2] == 1.0).all())


def _shapes_to_plan():
    return (list(chip_smoke.NORM_SERVED_SHAPES) + RAGGED
            + [(2, chip_smoke.BIG_BATCH, 3, 5), (5, 8, 16384, 32),
               (5, 8, 65536, 32), (5, 1, 4096, 1), (4, 16, 4096, 256)])


@pytest.mark.parametrize("aligned", [True, False])
def test_plan_within_the_card_limits(aligned):
    for shape in _shapes_to_plan():
        p = klif.norm_lif_plan(*shape, aligned=aligned)
        assert p.cluster in (1, 2, 4, 8, 16), shape
        assert 1 <= p.ct <= klif.MAX_TILE and p.ct <= max(shape[3], 1)
        assert p.smem_bytes <= klif.MAX_SMEM, shape
        assert p.threads % 32 == 0 and p.threads <= klif.MAX_THREADS
        assert p.threads >= p.classes * p.ct     # a thread a chain
        assert p.blocks < 2 ** 31 and p.grid == (p.blocks, 1, 1)
        assert p.blocks % p.cluster == 0
        if p.vec == 4:
            assert aligned and shape[3] % 4 == 0 and p.ct % 4 == 0
        else:
            assert not aligned or shape[3] % 4 != 0


def test_plan_at_batch_65537_and_past_the_int_range():
    p = klif.norm_lif_plan(2, chip_smoke.BIG_BATCH, 3, 5)
    assert p.blocks >= chip_smoke.BIG_BATCH and p.blocks < 2 ** 31
    assert p.block(p.blocks - 1)[0] == chip_smoke.BIG_BATCH - 1
    with pytest.raises(ValueError, match="int range"):
        klif.norm_lif_plan(2, 2 ** 31 - 1, 3, 64)
    with pytest.raises(ValueError, match="rows"):
        klif.norm_lif_plan(2 ** 16, 1, 2 ** 15, 4)


def test_served_shapes_fit_the_shared_memory_path():
    """The four backbones' untuned ticks at batch 8 launch exactly the
    shapes the card run times, and each holds its slab on chip."""
    served = set()
    for cfg in SNN_ARCHS.values():
        params = init_npu(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
        served |= set(chip_smoke.norm_shapes(params, cfg, 8))
    assert sorted(served) == sorted(chip_smoke.NORM_SERVED_SHAPES)
    for shape in served:
        p = klif.norm_lif_plan(*shape)
        assert p.staged, (shape, p)
        # enough blocks for the card, unless each block's slab is small
        # or its chains short (a cluster of one)
        assert p.blocks >= klif.MIN_BLOCKS - 4 \
            or p.slab_bytes <= klif.MIN_SLAB \
            or (p.J <= klif.SHORT_CHAIN and p.cluster == 1), (shape, p)


@pytest.mark.parametrize("shape", RAGGED + [(5, 8, 1024, 32),
                                            (5, 8, 4096, 48),
                                            (5, 8, 16, 256),
                                            (5, 8, 256, 66)])
def test_plan_sums_each_class_and_fires_each_neuron_once(shape):
    T, B, HW, C = shape
    p = klif.norm_lif_plan(*shape)
    # the chain threads: each (class offset, channel) once
    chains = [p.chain(t) for t in range(p.threads)]
    live = [c for c in chains if c is not None]
    assert sorted(live) == [(lc, ch) for lc in range(p.classes)
                            for ch in range(p.ct)]
    summed = np.zeros((B, C, klif.CLASSES), np.int64)
    fired = np.zeros((B, HW, C), np.int64)
    for k in range(p.blocks):
        b, chans, classes = p.block(k)
        assert len(classes) == p.classes and len(chans) >= 1
        summed[b, chans.start:chans.stop, classes.start:classes.stop] += 1
        hws = p.neurons(k % p.cluster)
        assert len(set(hws)) == len(hws)
        assert all(hw % klif.CLASSES in classes for hw in hws)
        fired[b, hws, chans.start:chans.stop] += 1
    assert bool((summed == 1).all())
    assert bool((fired == 1).all())


@pytest.mark.parametrize("shape", RAGGED)
def test_plan_stages_each_row_once_and_finds_it(shape):
    """Each block's local rows hold exactly its classes' rows; the fire
    pass's lookup of any row (owner block, local row) lands on it."""
    p = klif.norm_lif_plan(*shape)
    held = {}
    for rank in range(p.cluster):
        rows = [p.slab_row(rank, q) for q in range(p.classes * p.J)]
        mine = [i for i in rows if i < p.R]
        assert sorted(mine) == [i for i in range(p.R)
                                if i % klif.CLASSES // p.classes == rank]
        for q, i in enumerate(rows):
            if i < p.R:
                held[i] = (rank, q)
    assert sorted(held) == list(range(p.R))
    assert all(p.owner(i) == held[i] for i in range(p.R))
    assert p.slab_bytes == 4 * p.classes * p.J * p.ct
