"""Port parity: the launch table (``repro_torch.kernels.tune``) — the
table and lifecycle cases of tests/test_tune.py: shape keys equal to the
reference's, the JSON round trip and its wholesale invalidation (a JAX
table, the packaged TPU one included, loads empty), the resolution chain
through the port's own variable, ``off``, table swaps with no stale
cache, the sweep on first dispatch, ``pinned`` and the engine's
snapshot.  Every test leaves the untuned chain as it found it (the
autouse fixture checks, and repairs a leak so it cannot reach later
files of the worker)."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.registry import TUNE_CONFIGS as JAX_TUNE_CONFIGS
from repro.kernels import tune as jtune
from repro_torch.configs.base import TuneConfig
from repro_torch.configs.registry import (TUNE_CONFIGS, get_tune_config,
                                          reduced_snn)
from repro_torch.core.encoding import EventStream
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.kernels import ops, tune
from repro_torch.kernels.spike_conv_lif import conv_lif_plan
from repro_torch.kernels.tune import LaunchConfig, TuningTable, shape_key
from repro_torch.launch.roofline import kernel_launch_estimate
from repro_torch.serve.engine_core import EngineCore

ROOT = Path(__file__).resolve().parents[1]
SMOKE = TuneConfig(name="test", reps=1, prune_to=2, max_candidates=64)
LIF = dict(tau=2.0, v_th=1.0, v_reset=0.0)


@pytest.fixture(autouse=True)
def _untuned_chain():
    assert tune.chain_is_untuned(), "an earlier test left a table set"
    yield
    leaked = not tune.chain_is_untuned()
    tune.reset()
    assert not leaked, "the test left a table set"


def _layer(seed=0, shape=(6, 8, 8, 4), cout=8, density=0.3):
    rng = np.random.default_rng(seed)
    xf = torch.tensor((rng.random(shape) < density).astype(np.float32))
    w = torch.tensor(rng.normal(0, 1, (3, 3, shape[3], cout))
                     .astype(np.float32))
    return xf, w, torch.ones(cout), torch.zeros(cout)


def _conv_lif_key(xf, w, T, B, stride=1):
    Ho, Wo = ops.conv_out_hw(xf, 3, 3, stride)
    return shape_key("conv_lif", T=T, B=B, HW=Ho * Wo, K=9 * w.shape[2],
                     N=w.shape[3])


def _count_fused(monkeypatch):
    """Count the fused kernel wrapper's calls from ops."""
    calls = []
    real = ops.spike_conv_lif

    def counted(*a, **kw):
        calls.append(kw.get("gate"))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "spike_conv_lif", counted)
    return calls


@pytest.mark.parametrize("dims", [
    dict(T=3, B=2, HW=1024, K=18, N=8), dict(M=4096, K=1152, N=256),
    dict(B=8, F=9732096, G=144, H=32, T=5, W=32)])
def test_shape_key_equals_jax(dims):
    for op in ("conv_lif", "spike_conv", "backbone_seg"):
        key = shape_key(op, **dims)
        assert key == jtune.shape_key(op, **dims)
        assert tune.parse_key(key) == (op, dims)


def test_launch_config_and_defaults_mirror_jax():
    names = [f.name for f in dataclasses.fields(LaunchConfig)]
    assert names == [f.name for f in dataclasses.fields(jtune.LaunchConfig)]
    assert dataclasses.asdict(LaunchConfig()) == \
        dataclasses.asdict(jtune.LaunchConfig())
    for op in ("conv_lif", "backbone_seg"):
        assert tune.default_config(op) == LaunchConfig(fused=False)
        assert jtune.default_config(op).fused is False
    assert TUNE_CONFIGS.keys() == JAX_TUNE_CONFIGS.keys()
    for name, cfg in TUNE_CONFIGS.items():
        assert dataclasses.asdict(cfg) == \
            dataclasses.asdict(JAX_TUNE_CONFIGS[name])
        assert get_tune_config(name) is cfg


def test_table_roundtrip_and_invalidation(tmp_path):
    t = TuningTable()
    t.record("conv_lif|B2,HW64,K36,N8,T3",
             LaunchConfig(bn=8, gate="inline", fused=True), 12.5, 40.0)
    p = str(tmp_path / "table.json")
    t.save(p)
    loaded = TuningTable.load(p)
    assert loaded.entries == t.entries
    # recorded without a cluster size: it resolves to the plan's
    assert loaded.config_for("conv_lif|B2,HW64,K36,N8,T3") == LaunchConfig(
        bn=8, bm=conv_lif_plan(3, 2, 64, 8, 36).cluster, gate="inline",
        fused=True)
    assert loaded.config_for("conv_lif|B1") is None
    for field, val in (("schema", 999), ("kernels_version", 999),
                       ("kernels_version", jtune.KERNELS_VERSION)):
        blob = json.loads(open(p).read())
        blob[field] = val
        stale = tmp_path / f"stale_{field}_{val}.json"
        stale.write_text(json.dumps(blob))
        assert TuningTable.load(str(stale)).entries == {}


def test_jax_tables_load_empty(tmp_path):
    """A table the JAX package wrote, and its packaged TPU table, are
    emptied wholesale: their times are not the card's."""
    packaged = ROOT / "src" / "repro" / "kernels" / "tuned_defaults.json"
    assert json.loads(packaged.read_text())["entries"]
    assert TuningTable.load(str(packaged)).entries == {}
    jt = jtune.TuningTable()
    jt.record("conv_lif|B2,HW64,K36,N8,T3",
              jtune.LaunchConfig(fused=True), 1.0, 2.0)
    p = str(tmp_path / "jax.json")
    jt.save(p)
    assert TuningTable.load(p).entries == {}
    assert not Path(tune.DEFAULT_TABLE_PATH).exists()   # no packaged table


def test_env_chain_reads_only_the_ports_variable(tmp_path, monkeypatch):
    dims = dict(T=3, B=2, HW=64, K=36, N=8)
    key = shape_key("conv_lif", **dims)
    t = TuningTable()
    t.record(key, LaunchConfig(bn=8, gate="none", fused=True), 1.0, 2.0)
    p = str(tmp_path / "env_table.json")
    t.save(p)
    # the JAX package's variable and packaged file are not the port's
    monkeypatch.setenv("REPRO_" + "TUNE_TABLE", p)
    tune.reset()
    assert tune.dispatch("conv_lif", dims) == LaunchConfig(fused=False)
    monkeypatch.setenv(tune.ENV_VAR, p)
    tune.reset()                        # a new epoch re-reads the chain
    assert tune.dispatch("conv_lif", dims).gate == "none"
    assert tune.active_table().entries == t.entries
    monkeypatch.setenv(tune.ENV_VAR, str(tmp_path / "missing.json"))
    tune.reset()
    assert tune.dispatch("conv_lif", dims) == LaunchConfig(fused=False)
    # the packaged link of the chain, behind the variable
    monkeypatch.delenv(tune.ENV_VAR)
    monkeypatch.setattr(tune, "DEFAULT_TABLE_PATH", p)
    tune.reset()
    assert tune.dispatch("conv_lif", dims).fused
    monkeypatch.undo()
    tune.reset()
    assert tune.dispatch("conv_lif", dims) == LaunchConfig(fused=False)


def test_off_forces_defaults():
    dims = dict(T=3, B=2, HW=64, K=36, N=8)
    t = TuningTable()
    t.record(shape_key("conv_lif", **dims),
             LaunchConfig(bn=4, fused=True), 1.0, 2.0)
    tune.set_table(t)
    try:
        assert tune.dispatch("conv_lif", dims).fused
        with tune.off():
            assert tune.dispatch("conv_lif", dims) == \
                tune.default_config("conv_lif")
            assert tune.active_table() is None
        assert tune.dispatch("conv_lif", dims).bn == 4
    finally:
        tune.set_table(None)


def test_table_swap_changes_dispatch_no_stale_cache(monkeypatch):
    xf, w, sc, bi = _layer()
    key = _conv_lif_key(xf, w, T=3, B=2)
    calls = _count_fused(monkeypatch)
    want = ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF)
    assert calls == []
    t = TuningTable()
    t.record(key, LaunchConfig(bn=8, gate="inline", fused=True), 1.0, 2.0)
    tune.set_table(t)
    try:
        got = ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF)
    finally:
        tune.set_table(None)
    assert calls == ["inline"]
    assert torch.equal(got, want)
    ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF)
    assert calls == ["inline"]          # back on the per-op route


def test_fused_entries_resolve_to_a_cluster_that_holds_the_slab():
    """A fused conv_lif entry resolves to a cluster size its slab fits:
    its own where that holds the slab, else the plan's (an entry made
    without one holds DEFAULT_BM, which is no cluster size)."""
    dense = shape_key("conv_lif", T=5, B=8, HW=4096, K=648, N=24)
    yolo = shape_key("conv_lif", T=5, B=8, HW=1024, K=288, N=32)
    huge = shape_key("conv_lif", T=5, B=1, HW=200000, K=9, N=8)
    t = TuningTable()
    for key, cfg, bm in (
            (dense, LaunchConfig(fused=True), 16),
            (dense, LaunchConfig(bm=8, gate="none", fused=True), 16),
            (yolo, LaunchConfig(bm=8, fused=True), 8),
            (yolo, LaunchConfig(fused=True),
             conv_lif_plan(5, 8, 1024, 32, 288).cluster),
            (yolo, LaunchConfig(gate="inline"), 128),       # the pair
            (huge, LaunchConfig(fused=True), 128),           # no cluster
            ("backbone_seg|B8,L0k3s1c64n64d0p0",
             LaunchConfig(bm=8, fused=True), 8)):
        t.record(key, cfg, 1.0, 2.0)
        assert t.config_for(key) == dataclasses.replace(cfg, bm=bm), key
        assert t.entries[key]["bm"] == cfg.bm       # stored as recorded


def test_tuning_context_sweeps_once_then_caches(monkeypatch):
    xf, w, sc, bi = _layer(1)
    want = ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF)
    sweeps = []
    real = tune._sweep
    monkeypatch.setattr(tune, "_sweep",
                        lambda *a: sweeps.append(a[0]) or real(*a))
    with tune.tuning(tune_cfg=SMOKE) as table:
        out1 = ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF)
        out2 = ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF)
    assert sweeps == ["conv_lif"]
    (key,) = table.entries
    assert key == _conv_lif_key(xf, w, T=3, B=2)
    e = table.entries[key]
    assert 0 < e["us"] <= e["default_us"]
    assert torch.equal(out1, want) and torch.equal(out2, want)
    # the swept table serves: same spikes on whatever route won
    with tune.pinned(table):
        assert torch.equal(
            ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF), want)


def test_pinned_none_is_a_noop_and_empty_pins_per_op(monkeypatch):
    xf, w, sc, bi = _layer(2)
    calls = _count_fused(monkeypatch)
    forced = ops.fused_conv_lif_table([_conv_lif_key(xf, w, T=3, B=2)])
    tune.set_table(forced)
    try:
        with tune.pinned(None):
            ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF)
        assert calls == ["mask"]
        with tune.pinned(TuningTable()):
            ops.spike_conv_lif_op(xf, w, sc, bi, T=3, B=2, **LIF)
            assert tune.active_table().entries == {}
        assert calls == ["mask"]
        assert tune.active_table() is forced
    finally:
        tune.set_table(None)


def test_candidates_launch_where_they_fit():
    """Fused candidates only at plans whose slab fits a cluster (the
    plan's channel tile, its cluster size and the others that hold the
    slab), every gate of both routes, the default always among them."""
    big = dict(T=5, B=8, HW=4096, K=648, N=24)      # DenseNet 64x64
    p = conv_lif_plan(5, 8, 4096, 24, 648)
    assert (p.ct, p.cluster) == (24, 16)            # no 1- or 2-channel
    assert p.smem_bytes <= 232448                   # slices any more
    with pytest.raises(ValueError, match="fits no cluster"):
        conv_lif_plan(5, 8, 4096, 24, 648, cluster=8)
    cands = tune.candidates("conv_lif", big, TUNE_CONFIGS["default"])
    fused = [c for c in cands if c.fused]
    assert {c.bm for c in fused} == {16}
    assert {c.gate for c in fused} == {c.gate for c in cands
                                       if not c.fused} \
        == {"mask", "inline", "none"}
    assert tune.default_config("conv_lif") in cands
    # YOLO's 32x32 layer: 16-block clusters, and the 8-block ones beside
    # them
    yolo = dict(T=5, B=8, HW=1024, K=288, N=32)
    assert {c.bm for c in tune.candidates(
        "conv_lif", yolo, TUNE_CONFIGS["default"]) if c.fused} == {16, 8}
    # the smallest head layer: three cluster sizes hold its slab
    head = dict(T=5, B=8, HW=16, K=2304, N=256)
    assert len({c.bm for c in tune.candidates(
        "conv_lif", head, TUNE_CONFIGS["default"]) if c.fused}) == 3
    huge = dict(T=5, B=1, HW=200000, K=9, N=8)
    assert not any(c.fused for c in tune.candidates(
        "conv_lif", huge, TUNE_CONFIGS["default"]))
    assert tune.candidates("spike_matmul", dict(M=1, K=1, N=1),
                           TUNE_CONFIGS["default"]) == [LaunchConfig()]
    assert len(tune.candidates("conv_lif", big,
                               TuneConfig(max_candidates=2))) == 2


def test_estimate_ranks_slices_and_sparsity():
    """A fused plan that leaves SMs idle (fewer, fuller clusters) ranks
    after the plan's own; a sparse input ranks the gated routes first."""
    dims = dict(T=5, B=8, HW=1024, K=288, N=32)
    p = conv_lif_plan(5, 8, 1024, 32, 288)
    wide = tune.estimate("conv_lif", dims,
                         LaunchConfig(bm=p.cluster, fused=True))
    narrow = tune.estimate("conv_lif", dims,
                           LaunchConfig(bm=p.cluster // 4, fused=True))
    assert wide < narrow                 # 128 blocks against 32
    # where the conv's operations outweigh the launches, a sparse input
    # ranks the gated route first, on either route
    big = dict(T=5, B=8, HW=4096, K=648, N=24)
    sparse = tune.estimate("conv_lif", big, LaunchConfig(), live=0.05)
    dense = tune.estimate("conv_lif", big, LaunchConfig(gate="none"),
                          live=0.05)
    assert sparse < dense
    fused = dict(bm=16, fused=True)
    assert tune.estimate("conv_lif", big, LaunchConfig(**fused),
                         live=0.05) < \
        tune.estimate("conv_lif", big, LaunchConfig(gate="none", **fused),
                      live=0.05)
    a = kernel_launch_estimate(1e9, 1e6, 1)
    assert kernel_launch_estimate(1e9, 1e6, 100) > a
    assert kernel_launch_estimate(2e9, 1e6, 1) > a


def test_pair_estimate_reads_the_activation_not_the_patches():
    """Both routes read xf (implicit im2col): at a fixed input width C
    their bytes do not grow with kh*kw, so where the launches and the
    bytes outweigh the operations their estimates do not either.
    DenseNet's first dense layer (C = N = 24) and VGG's stem (C = 2) as
    a 1x1 and as a 3x3 conv."""
    one = dict(T=5, B=8, HW=4096, K=24, N=24)
    three = dict(one, K=9 * 24)
    pair1 = tune.estimate("conv_lif", one, LaunchConfig(), taps=1)
    pair3 = tune.estimate("conv_lif", three, LaunchConfig(), taps=9)
    assert pair3 == pytest.approx(pair1, rel=1e-3)
    stem1 = dict(T=5, B=8, HW=4096, K=2, N=32)
    stem3 = dict(stem1, K=18)
    fused = LaunchConfig(bm=16, fused=True)
    assert tune.estimate("conv_lif", stem3, fused, taps=9) == \
        pytest.approx(tune.estimate("conv_lif", stem1, fused, taps=1),
                      rel=1e-3)
    # one launch on the fused route, no occupancy launches under "mask";
    # no occupancy launches on the pair either: every gate costs three
    assert tune.estimate("conv_lif", stem3, dataclasses.replace(
        fused, gate="inline"), taps=9) == pytest.approx(
        tune.estimate("conv_lif", stem3, fused, taps=9), rel=1e-9)
    assert tune.estimate("conv_lif", stem3, LaunchConfig(), taps=9) > \
        tune.estimate("conv_lif", stem3, fused, taps=9)
    assert tune.estimate("conv_lif", three, LaunchConfig(gate="inline"),
                         taps=9) == pytest.approx(pair3, rel=1e-9)


def test_measure_times_each_call_after_a_warmup():
    seen = []

    def runner(cfg):
        seen.append(cfg)
        return torch.zeros(3)
    us = tune.measure(runner, LaunchConfig(), reps=3)
    assert len(seen) == 4 and 0 < us < 1e6

    def broken(cfg):
        raise RuntimeError("kernel failed to launch")
    with pytest.raises(RuntimeError, match="failed to launch"):
        tune.measure(broken, LaunchConfig(), reps=1)


def test_engine_snapshots_the_table(monkeypatch):
    """The table active at construction serves every tick; a later
    set_table does not reach the built engine, an explicit table pins
    that one, None follows the live chain."""
    cfg = reduced_snn("spiking_yolo", backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    B = 2
    vox = (torch.rand((cfg.time_steps, B, cfg.height, cfg.width, 2),
                      generator=torch.Generator().manual_seed(1))
           < 0.15).float()
    with tune.tuning(TuningTable(), SMOKE) as swept:
        npu_forward(params, vox, cfg)
    forced = ops.fused_conv_lif_table(swept.entries)
    # the sweep also keys the backbone's fused-route segment
    n_conv_lif = sum(k.startswith("conv_lif|") for k in swept.entries)
    assert len(forced.entries) == n_conv_lif > 0
    bayer = torch.rand(B, cfg.height, cfg.width)
    events = EventStream(torch.zeros(B, 4), *(torch.zeros(
        B, 4, dtype=torch.int32) for _ in range(3)),
        torch.zeros(B, 4, dtype=torch.bool))
    calls = _count_fused(monkeypatch)

    def tick(core):
        calls.clear()
        core.step(vox, bayer, events, torch.zeros(B, dtype=torch.bool))
        return len(calls)
    untuned = EngineCore(params, cfg, device="cpu")
    assert untuned.tune_table.entries == {}
    tune.set_table(forced)
    try:
        snap = EngineCore(params, cfg, device="cpu")
        follows = EngineCore(params, cfg, device="cpu",
                             tune_table=None)
        empty = EngineCore(params, cfg, device="cpu",
                           tune_table=TuningTable())
        n_fused = tick(snap)
        assert n_fused == 5              # 2 stages x 2 convs + head_conv
        assert tick(untuned) == 0 and tick(empty) == 0
        assert tick(follows) == n_fused
        tune.set_table(TuningTable())
        assert tick(snap) == n_fused     # the swap does not reach it
        assert tick(follows) == 0
        assert tick(untuned) == 0
    finally:
        tune.set_table(None)
    with pytest.raises(ValueError, match="tune_table"):
        EngineCore(params, cfg, device="cpu", tune_table="swept")


def test_file_leaves_the_untuned_chain():
    """Pinned for the worker's later files: after this file's tests the
    chain is the untuned one and an untuned key resolves to the per-op
    route."""
    assert tune.chain_is_untuned()
    assert tune.dispatch("conv_lif", dict(T=1, B=1, HW=1, K=1, N=1)) == \
        LaunchConfig(fused=False)
