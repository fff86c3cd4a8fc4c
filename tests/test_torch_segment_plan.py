"""The launch plan of the ``backbone_segment`` kernel
(``kernels/backbone_segment.py`` ``segment_plan``), its operands and its
launch-table candidates, on the CPU (no card needed: the plan is pure
Python).

- The six full-width fused-route segments of the four backbones at batch
  8: a cluster of at most 16 blocks, a power of two, within 132 SMs; a
  block's share of the largest slab, the ring and the tables within a
  block's shared memory; every slab row and channel of every normal
  layer computed by exactly one tile, stored at the block and local row
  that own it (the kernel's row classes), at every cluster size the plan
  accepts; the plan cached per shape.
- A slab no cluster holds (64x64, 64 channels, T=5: 5.2 MB) is refused.
- The launch table offers the kernel only at cluster sizes the plan
  accepts (its own, twice and half it), and only the per-layer route
  where the plan refuses; forced tables and stale entries resolve to
  the plan's cluster.
- ``segment_operands`` returns views of the HWIO weights (no copy).
"""
import collections

import pytest
import torch

from repro_torch.configs.registry import SNN_ARCHS, TUNE_CONFIGS
from repro_torch.core.backbones import fused_route_segments
from repro_torch.kernels import ops, tune
from repro_torch.kernels.backbone_fuse import LayerSpec, spec_from_token
from repro_torch.kernels.backbone_segment import (
    CLUSTER_SIZES, MAX_LAYERS, SegmentPlan, plan_clusters, segment_operands,
    segment_plan)
from repro_torch.kernels.spike_conv_lif import (BLOCK_RESERVE, CLASSES,
                                                MAX_SMEM, SM_SMEM)
from repro_torch.kernels.tune import LaunchConfig, TuningTable
from repro_torch.launch.roofline import SMS

BATCH = 8


@pytest.fixture(autouse=True)
def _untuned_chain():
    assert tune.chain_is_untuned(), "an earlier test left a table set"
    yield
    leaked = not tune.chain_is_untuned()
    tune.reset()
    assert not leaked, "the test left a table set"


def _served():
    """(label, specs, T, H, W, key) of every fused-route segment of the
    four full-width backbones at batch 8."""
    out = []
    for arch in sorted(SNN_ARCHS):
        cfg = SNN_ARCHS[arch]
        for seg, (h, w), key in fused_route_segments(cfg, BATCH):
            out.append((f"{arch}{seg.describe()}",
                        tuple(s.anon() for s in seg.layers),
                        cfg.time_steps, h, w, key))
    return out


SERVED = _served()
LABELS = [s[0] for s in SERVED]


def _tiles_cover_the_slab(p: SegmentPlan):
    """Every (slab row, channel) of each normal layer computed by one
    tile, at the block and local row that own the slab row."""
    for l, ly in enumerate(p.layers):
        if ly.spec.depthwise:
            continue
        seen = collections.Counter()
        for rank in range(p.cluster):
            for g0, c0, width in p.tiles(l, rank):
                assert 0 < width <= ly.ct
                rows = p.tile_rows(l, rank, g0)
                assert len(rows) <= ly.bm
                for g, i in rows:
                    o, q = divmod(g, ly.rows)
                    assert p.owner(i) == (o, q)
                    assert (i % CLASSES) // p.classes == o
                    for n in range(c0, c0 + width):
                        seen[i, n] += 1
        assert set(seen.values()) == {1}, l
        assert len(seen) == ly.R * ly.N, l


def test_six_served_segments():
    assert len(SERVED) == 6
    assert sorted({s[0].split("[")[0] for s in SERVED}) == sorted(SNN_ARCHS)


@pytest.mark.parametrize("label", LABELS)
def test_served_segment_plans(label):
    _, specs, T, H, W, _ = SERVED[LABELS.index(label)]
    p = segment_plan(specs, T, BATCH, H, W)
    assert p is segment_plan(specs, T, BATCH, H, W)       # cached
    assert p.cluster in CLUSTER_SIZES and p.cluster <= 16
    assert p.cluster & (p.cluster - 1) == 0
    assert BATCH * p.cluster <= SMS
    # batch 8: eight 16-block clusters do not fit one block an SM
    assert (p.cluster, p.occupancy) == (8, 1)
    assert p.smem_bytes <= MAX_SMEM
    assert p.slab_bytes >= max(4 * ly.rows * ly.N for ly in p.layers)
    assert p.stages in (2, 3)
    assert p.blocks == BATCH * p.cluster
    # the spike buffer holds every interior layer's spikes
    for ly in p.layers[:-1]:
        pool = ly.spec.pool or 1
        assert T * (ly.Ho // pool) * (ly.Wo // pool) * ly.N <= p.act_elems
    assert p.act_elems % 4 == 0
    for c in CLUSTER_SIZES:
        try:
            q = segment_plan(specs, T, BATCH, H, W, cluster=c)
        except ValueError:
            continue
        assert q.cluster == c and q.smem_bytes <= MAX_SMEM
        if q.occupancy == 2:        # two blocks an SM: half an SM each
            assert q.smem_bytes <= SM_SMEM // 2 - BLOCK_RESERVE
            assert all(ly.bm <= 128 for ly in q.layers)
        _tiles_cover_the_slab(q)


def test_plan_refuses_a_slab_no_cluster_holds():
    big = (LayerSpec("", cin=64, cout=64), LayerSpec("", cin=64, cout=64))
    # 5 * 64 * 64 * 64 floats: 5.2 MB, 327 KB a block at 16 blocks
    with pytest.raises(ValueError, match="fits no cluster"):
        segment_plan(big, 5, BATCH, 64, 64)
    with pytest.raises(ValueError, match="fits no cluster"):
        segment_plan(big[:1], 5, BATCH, 64, 64, cluster=16)
    with pytest.raises(ValueError, match="layers"):
        segment_plan(big * (MAX_LAYERS // 2 + 1), 5, BATCH, 4, 4)
    with pytest.raises(ValueError, match="cluster"):
        segment_plan(big, 5, BATCH, 4, 4, cluster=3)
    assert plan_clusters(big, 5, BATCH, 64, 64) == ()


def test_plan_past_the_sms_and_the_old_grid_cap():
    specs = (LayerSpec("", cin=2, cout=4, pool=2),)
    p = segment_plan(specs, 1, 65537, 4, 4)
    assert p.cluster == 1 and p.blocks == 65537
    # the largest cluster the card holds at one block an SM: 16-block
    # clusters up to batch 7; a pinned 16 at batch 8 takes two blocks an
    # SM so that all eight clusters are held at once
    assert segment_plan(specs, 1, 7, 4, 4).cluster == 16
    assert segment_plan(specs, 1, 8, 4, 4).cluster == 8
    assert segment_plan(specs, 1, 9, 4, 4).cluster == 8
    assert segment_plan(specs, 1, 17, 4, 4).cluster == 4
    pinned = segment_plan(specs, 1, 8, 4, 4, cluster=16)
    assert (pinned.cluster, pinned.occupancy) == (16, 2)
    assert all(ly.bm <= 128 for ly in pinned.layers)
    assert segment_plan(specs, 1, 7, 4, 4).occupancy == 1


@pytest.mark.parametrize("label", LABELS)
def test_candidates_take_only_clusters_the_plan_accepts(label):
    _, specs, T, H, W, key = SERVED[LABELS.index(label)]
    _, dims = tune.parse_key(key)
    assert tune.segment_specs(dims) == specs
    cands = tune.candidates("backbone_seg", dims, TUNE_CONFIGS["default"])
    fused = [c for c in cands if c.fused]
    assert cands[-1] == LaunchConfig(fused=False)
    plan = segment_plan(specs, T, BATCH, H, W)
    assert {c.bm for c in fused} == set(plan_clusters(specs, T, BATCH, H,
                                                      W))
    assert plan.cluster in {c.bm for c in fused}
    for c in fused:
        assert c.bm in (plan.cluster, 2 * plan.cluster, plan.cluster // 2)
        assert segment_plan(specs, T, BATCH, H, W, cluster=c.bm).cluster \
            == c.bm
        est = tune.estimate("backbone_seg", dims, c, live=0.2)
        assert 0 < est < float("inf")


def test_candidates_only_the_route_where_the_plan_refuses():
    big = (LayerSpec("", cin=64, cout=64), LayerSpec("", cin=64, cout=64))
    dims = ops.segment_dims(big, T=5, B=BATCH, H=64, W=64)
    assert tune.candidates("backbone_seg", dims,
                           TUNE_CONFIGS["default"]) == [LaunchConfig()]
    key = tune.shape_key("backbone_seg", **dims)
    assert ops.fused_segment_table([key]).entries == {}


def test_forced_table_and_stale_entries_resolve_to_the_plan():
    keys = [s[5] for s in SERVED]
    table = ops.fused_segment_table(keys)
    assert sorted(table.entries) == sorted(keys)
    for _, specs, T, H, W, key in SERVED:
        want = segment_plan(specs, T, BATCH, H, W).cluster
        assert table.config_for(key) == LaunchConfig(bm=want, gate="none",
                                                     fused=True)
        stale = TuningTable()
        stale.record(key, LaunchConfig(bm=3, gate="inline", fused=True),
                     1.0, 2.0)
        assert stale.config_for(key) == LaunchConfig(
            bm=want, gate="inline", fused=True)
    twice = ops.fused_segment_table(keys, cluster=16)
    assert {twice.config_for(k).bm for k in keys} == {16}


def test_layer_tokens_round_trip():
    for _, specs, *_ in SERVED:
        for s in specs:
            assert spec_from_token(s.dim_token) == s
    with pytest.raises(ValueError, match="token"):
        spec_from_token("k3s1c64")


def test_segment_operands_are_views():
    g = torch.Generator().manual_seed(0)
    specs = (LayerSpec("", cin=8, cout=16),
             LayerSpec("", stride=2, depthwise=True, cin=16, cout=16),
             LayerSpec("", kernel=1, cin=16, cout=24, pool=2))
    params = [(torch.randn(s.kernel, s.kernel,
                           1 if s.depthwise else s.cin,
                           s.cin if s.depthwise else s.cout, generator=g),
               torch.randn(s.cout), torch.randn(s.cout)) for s in specs]
    flat = segment_operands(params, specs)
    assert len(flat) == 3 * len(specs)
    for (w, scale, bias), s, i in zip(params, specs, range(len(specs))):
        wm, sc, bi = flat[3 * i:3 * i + 3]
        taps = s.kernel * s.kernel
        assert wm.shape == ((taps, s.cin) if s.depthwise
                            else (taps * s.cin, s.cout))
        assert wm.data_ptr() == w.data_ptr() and wm._base is w
        assert sc is scale and bi is bias
        assert torch.equal(wm, w.reshape(-1, w.shape[-1]))
