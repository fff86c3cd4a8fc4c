"""Port parity: the fused-segment tier of the NPU — the segment planner
(``repro_torch.kernels.backbone_fuse``), the plain version of the
``backbone_segment`` kernel, ``_run_layers``' dispatch and the
``backbone_seg`` launch-table entries — against the JAX package, on the
CPU, where the kernel's wrapper runs its plain version.

- Planner: ``plan_segments`` and ``describe_plan`` equal JAX's segment
  for segment (``fusible`` included) on the four archs' layer runs, at
  full width and at ``reduced_snn`` size, over budgets from 16 KB to
  50 MiB; the stride and dtype breaks, a single over-budget layer, the
  working set, MACs and activation counts, ``describe``/``anon``/
  ``dim_token``; the default budget is the H100 figure of
  ``launch/roofline.py``.
- Plain segment against JAX's ``_segment_ref`` (the jnp oracle), layer
  by layer on the reference's own input spikes: conv outputs and
  normalised currents within rtol 1e-5, atol 1e-6; spikes equal except
  where the reference membrane lies within 1e-4 of v_th; a pool equal
  where its layer flipped nothing.  Segments: a canonical pair, a
  stride-2 chain, depthwise layers inside, a pool epilogue, a single
  pool-absorbing layer; both gates.
- ``_run_layers``: under a forced-segment table the "cuda" backend
  gives exactly the per-layer route's output, with one kernel-wrapper
  call per fused-route segment; a tape, the "torch" backend or non-f32
  activations take the per-layer route; each reduced backbone equals
  JAX's eager jnp backbone.
- Tune: ``backbone_seg`` defaults to the per-layer route; its candidates
  (both gates at each cluster size the kernel's plan accepts -- its own,
  twice and half it -- and the per-layer route), their
  estimates, the anonymous key's round trip through ``parse_key`` and
  save/load; an engine under a forced-segment table calls the wrappers
  as often per tick as ``chip_smoke.npu_launches_per_tick`` says.
"""
import collections
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import SNN_ARCHS as JAX_ARCHS
from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core import backbones as jbb
from repro.core import layers as jl
from repro.core.npu import init_npu as jax_init_npu
from repro.kernels import backbone_fuse as jbf
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.configs.base import TuneConfig
from repro_torch.configs.registry import (ENCODING_CONFIGS, ISP_CONFIGS,
                                          SNN_ARCHS, TUNE_CONFIGS,
                                          reduced_snn)
from repro_torch.core import backbones as tbb
from repro_torch.core import layers as tl
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.core.sparsity import SparsityTape
from repro_torch.kernels import backbone_fuse as bf
from repro_torch.kernels import ops, tune
from repro_torch.kernels.backbone_segment import (
    CLUSTER_SIZES, GATES, MAX_LAYERS, backbone_segment,
    backbone_segment_plain, plan_clusters, segment_layer_plain,
    segment_operands, segment_plan)
from repro_torch.kernels.tune import LaunchConfig, TuningTable
from repro_torch.launch import roofline
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)
from repro_torch.testing import spike_mismatch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = 1e-4            # near-threshold band for spike flips
RTOL, ATOL = 1e-5, 1e-6
LIF = dict(tau=2.0, v_th=1.0, v_reset=0.0)
SMOKE = TuneConfig(name="test", reps=1, prune_to=2, max_candidates=64)
B = 2


@pytest.fixture(autouse=True)
def _untuned_chain():
    assert tune.chain_is_untuned(), "an earlier test left a table set"
    yield
    leaked = not tune.chain_is_untuned()
    tune.reset()
    assert not leaked, "the test left a table set"


def _jax_spec(s):
    return jbf.LayerSpec(**dataclasses.asdict(s))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

BUDGETS = (16 * 2 ** 20, roofline.SEGMENT_BUDGET_BYTES, 232448, 2 * 2 ** 20,
           50 * 2 ** 20, 16_000, 60_000, 150_000, 400_000, 1_000_000)
SIZES = ("full", "reduced")


def _cfg(arch, size):
    return SNN_ARCHS[arch] if size == "full" else reduced_snn(arch)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_plans_equal_jax(arch, size, budget):
    cfg = _cfg(arch, size)
    for specs, H, W in tbb.layer_runs(cfg):
        want = jbf.plan_segments(tuple(_jax_spec(s) for s in specs), H=H,
                                 W=W, T=cfg.time_steps, vmem_budget=budget)
        got = bf.plan_segments(specs, H=H, W=W, T=cfg.time_steps,
                               vmem_budget=budget)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.fusible == w.fusible
            assert g.describe() == w.describe()
            assert [dataclasses.asdict(s) for s in g.layers] == \
                [dataclasses.asdict(s) for s in w.layers]
        assert bf.describe_plan(specs, H=H, W=W, T=cfg.time_steps,
                                vmem_budget=budget) == jbf.describe_plan(
            tuple(_jax_spec(s) for s in specs), H=H, W=W, T=cfg.time_steps,
            vmem_budget=budget)


@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_layer_runs_are_the_reference_specs(arch):
    """The runs ``_run_layers`` sees are the reference's declarations:
    the JAX specs for VGG/MobileNet/YOLO, and DenseNet's transitions as
    its apply builds them."""
    for size in SIZES:
        cfg = _cfg(arch, size)
        jcfg = JAX_ARCHS[arch] if size == "full" else jax_reduced_snn(arch)
        runs = tbb.layer_runs(cfg)
        if cfg.backbone != "densenet":
            make = {"vgg": jbb.vgg_specs, "mobilenet": jbb.mobilenet_specs,
                    "yolo": jbb.yolo_specs}[cfg.backbone]
            ((specs, H, W),) = runs
            assert tuple(_jax_spec(s) for s in specs) == make(jcfg)
            assert (H, W) == (cfg.height, cfg.width)
        else:
            assert len(runs) == cfg.num_stages


@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_layer_runs_are_what_run_layers_sees(arch, monkeypatch):
    """Every call of ``_run_layers`` in a forward, with its specs and
    input extent, is one entry of ``layer_runs``."""
    cfg = reduced_snn(arch, backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    seen = []
    real = tbb._run_layers

    def record(p, x, c, specs, tape=None):
        seen.append((tuple(specs), x.shape[2], x.shape[3]))
        return real(p, x, c, specs, tape=tape)
    monkeypatch.setattr(tbb, "_run_layers", record)
    npu_forward(params, _vox(cfg, 1), cfg)
    assert seen == [(tuple(s), h, w) for s, h, w in tbb.layer_runs(cfg)]


def test_default_budget_is_hopper_l2_and_full_width_plans():
    assert roofline.L2_BYTES == 50 * 2 ** 20
    assert roofline.SEGMENT_BUDGET_BYTES == roofline.L2_BYTES // 8 == 6553600
    want = {
        "spiking_yolo": "[d0] [f0?] [d1] [f1+d2] [f2+d3+f3]",
        "spiking_mobilenet": "[stem?] [dw0?] [pw0+dw1] "
                             "[pw1+dw2+pw2+dw3+pw3]",
        "spiking_vgg": "[s0_a?] [s0_b+pool?] [s1_a?] [s1_b+pool?] [s2_a] "
                       "[s2_b+pool?] [s3_a+s3_b+pool]",
        "spiking_densenet": "[t0+pool?] | [t1+pool?] | [t2+pool]"}
    for arch, plan in want.items():
        cfg = SNN_ARCHS[arch]
        got = " | ".join(bf.describe_plan(s, H=h, W=w, T=cfg.time_steps)
                         for s, h, w in tbb.layer_runs(cfg))
        assert got == plan
        assert len(tbb.fused_route_segments(cfg, 8)) == \
            chip_smoke.SEGMENTS_PER_TICK[arch]


def test_plan_breaks():
    specs = (bf.LayerSpec(name="a", cin=2, cout=4),
             bf.LayerSpec(name="s4", cin=4, cout=4, stride=4),
             bf.LayerSpec(name="b", cin=4, cout=4))
    plan = bf.plan_segments(specs, H=32, W=32, T=3)
    assert [s.describe() for s in plan] == ["[a]", "[s4?]", "[b]"]
    assert [s.fusible for s in plan] == [True, False, True]
    assert [s.fused_route for s in plan] == [False, False, False]
    chain = (bf.LayerSpec(name="a", cin=2, cout=4, stride=2),
             bf.LayerSpec(name="b", cin=4, cout=4))
    assert len(bf.plan_segments(chain, H=32, W=32, T=3)) == 1
    # non-f32: every layer its own non-fusible segment, as in JAX
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float16, jnp.float16)):
        got = bf.plan_segments(chain, H=32, W=32, T=3, dtype=dt)
        want = jbf.plan_segments(tuple(_jax_spec(s) for s in chain), H=32,
                                 W=32, T=3, dtype=jdt)
        assert [s.describe() for s in got] == [s.describe() for s in want] \
            == ["[a?]", "[b?]"]
    big = (bf.LayerSpec(name="big", cin=64, cout=64),)
    (seg,) = bf.plan_segments(big, H=32, W=32, T=3, vmem_budget=1024)
    assert not seg.fusible and not seg.fused_route
    pool = (bf.LayerSpec(name="t", kernel=1, cin=8, cout=4, pool=2),)
    (seg,) = bf.plan_segments(pool, H=16, W=16, T=3)
    assert seg.fusible and seg.fused_route and seg.describe() == "[t+pool]"


@pytest.mark.parametrize("H,T", [(16, 3), (33, 5), (64, 5)])
def test_working_set_and_counts_equal_jax(H, T):
    specs = (bf.LayerSpec(name="a", cin=2, cout=8, stride=2),
             bf.LayerSpec(name="b", cin=8, cout=8, pool=2),
             bf.LayerSpec(name="c", depthwise=True, cin=8, cout=8, stride=2),
             bf.LayerSpec(name="d", kernel=1, cin=8, cout=40))
    js = tuple(_jax_spec(s) for s in specs)
    for n in range(1, len(specs) + 1):
        assert bf.segment_vmem_bytes(specs[:n], H=H, W=H, T=T) == \
            jbf.segment_vmem_bytes(js[:n], H=H, W=H, T=T)
        kw = dict(H=H, W=H, T=T, B=3)
        assert bf.segment_macs(specs[:n], **kw) == \
            jbf.segment_macs(js[:n], **kw)
        assert bf.segment_activation_elems(specs[:n], **kw) == \
            jbf.segment_activation_elems(js[:n], **kw)
        if n > 1:           # monotone in depth
            assert bf.segment_vmem_bytes(specs[:n], H=H, W=H, T=T) > \
                bf.segment_vmem_bytes(specs[:n - 1], H=H, W=H, T=T)
    assert bf.segment_vmem_bytes(specs[:1], H=2 * H, W=2 * H, T=T) > \
        bf.segment_vmem_bytes(specs[:1], H=H, W=H, T=T)


def test_describe_anon_and_token():
    seg = bf.Segment(layers=(bf.LayerSpec(name="a", pool=2),
                             bf.LayerSpec(name="b")))
    assert seg.describe() == "[a+pool+b]"
    s = bf.LayerSpec(name="x", cin=3, cout=5, stride=2, depthwise=True,
                     pool=2)
    assert s.anon().name == "" and s.anon().dim_token == s.dim_token
    assert s.dim_token == _jax_spec(s).dim_token == "k3s2c3n5d1p2"
    # LayerSpec keeps its old import path
    assert tbb.LayerSpec is bf.LayerSpec


# ---------------------------------------------------------------------------
# the plain segment against JAX's _segment_ref
# ---------------------------------------------------------------------------

# (T, B, H, density, specs)
SEGMENTS = {
    "canonical_pair": (3, 2, 12, 0.15, (
        bf.LayerSpec("", cin=2, cout=8),
        bf.LayerSpec("", cin=8, cout=24))),
    "stride2_chain": (3, 2, 16, 0.2, (
        bf.LayerSpec("", stride=2, cin=16, cout=32),
        bf.LayerSpec("", cin=32, cout=32),
        bf.LayerSpec("", stride=2, cin=32, cout=40))),
    "depthwise_inside": (3, 2, 17, 0.2, (
        bf.LayerSpec("", kernel=1, cin=6, cout=12),
        bf.LayerSpec("", stride=2, depthwise=True, cin=12, cout=12),
        bf.LayerSpec("", kernel=1, cin=12, cout=20))),
    "pool_epilogue": (3, 2, 12, 0.15, (
        bf.LayerSpec("", cin=2, cout=8),
        bf.LayerSpec("", cin=8, cout=8, pool=2),
        bf.LayerSpec("", kernel=1, cin=8, cout=16))),
    "single_pool_layer": (3, 2, 16, 0.3, (
        bf.LayerSpec("", kernel=1, cin=44, cout=22, pool=2),)),
}


def _segment_data(name):
    T, Bn, H, dens, specs = SEGMENTS[name]
    rng = np.random.default_rng(len(name) + H)
    x = (rng.random((T, Bn, H, H, specs[0].cin)) < dens).astype(np.float32)
    params = []
    for s in specs:
        n = bf.out_channels(s)
        params.append({
            "w": rng.normal(0, 0.5, (s.kernel, s.kernel,
                                     1 if s.depthwise else s.cin, n)),
            "scale": rng.normal(1, 0.2, n), "bias": rng.normal(0, 0.2, n)})
    return x, specs, [jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), p) for p in params]


def _jax_layer(x, p, s):
    """The reference layer on x: its conv output, normalised currents
    (``_segment_ref``'s own formulation) and output spikes."""
    T, Bn, h, w, c = x.shape
    xf = jnp.swapaxes(jnp.asarray(x), 0, 1).reshape(Bn * T, h, w, c)
    y = jl.spike_conv_jnp(xf, jnp.asarray(p["w"]), stride=s.stride,
                          depthwise=s.depthwise)
    _, ho, wo, co = y.shape
    y4 = jnp.swapaxes(y.reshape(Bn, T, ho, wo, co), 0, 1).reshape(
        T, Bn, ho * wo, co)
    mu = jnp.mean(y4, axis=(0, 2), keepdims=True)
    var = jnp.var(y4, axis=(0, 2), keepdims=True)
    z = (y4 - mu) * jax.lax.rsqrt(var + tl.NORM_EPS) * p["scale"] + p["bias"]
    out = jops._segment_ref(
        jnp.asarray(x), ((jnp.asarray(p["w"]), jnp.asarray(p["scale"]),
                          jnp.asarray(p["bias"])),), (_jax_spec(s),),
        beta=4.0, **LIF)
    return np.asarray(y4), np.asarray(z), np.asarray(out)


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("name", sorted(SEGMENTS))
def test_plain_segment_matches_jax_segment_ref(name, gate):
    x, specs, params = _segment_data(name)
    tparams = [convert.params_from_numpy(p, device="cpu") for p in params]
    flat = segment_operands([(p["w"], p["scale"], p["bias"])
                             for p in tparams], specs)
    cur = x                                 # the reference's own input
    for i, (s, p) in enumerate(zip(specs, params)):
        y4, z, want = _jax_layer(cur, p, s)
        w, sc, bi = flat[3 * i:3 * i + 3]
        got_y4, _ = segment_layer_plain(torch.tensor(cur), w, s)
        np.testing.assert_allclose(got_y4.numpy(), y4, rtol=RTOL, atol=ATOL)
        got_z = tl.instance_norm_affine(got_y4, sc, bi)
        np.testing.assert_allclose(got_z.numpy(), z, rtol=RTOL, atol=ATOL)
        s0 = dataclasses.replace(s, pool=0)
        pre = backbone_segment(torch.tensor(cur), (w, sc, bi), specs=(s0,),
                               gate=gate, **LIF)
        res = spike_mismatch(z, pre.reshape(z.shape), tol=TOL, **LIF)
        assert res["far"] == 0, (name, i, res)
        assert 0.0 < float(pre.mean()) < 1.0
        got = backbone_segment(torch.tensor(cur), (w, sc, bi), specs=(s,),
                               gate=gate, **LIF)
        assert got.shape == want.shape
        if res["flipped"] == 0:
            np.testing.assert_array_equal(got.numpy(), want)
        cur = want
    whole = backbone_segment(torch.tensor(x), flat, specs=specs, gate=gate,
                             **LIF)
    assert torch.equal(whole, backbone_segment_plain(torch.tensor(x), flat,
                                                     specs=specs, **LIF))
    assert whole.shape == cur.shape


def test_plain_segment_equals_per_layer_route():
    """On the CPU the kernel's plain version is the per-layer route's
    arithmetic: equal bits, both gates."""
    for name in SEGMENTS:
        x, specs, params = _segment_data(name)
        tparams = [(p["w"], p["scale"], p["bias"]) for p in (
            convert.params_from_numpy(p, device="cpu") for p in params)]
        flat = segment_operands(tparams, specs)
        with tune.off():
            want = ops._seg_unfused(torch.tensor(x), tparams, specs, LIF)
        for gate in GATES:
            got = backbone_segment(torch.tensor(x), flat, specs=specs,
                                   gate=gate, **LIF)
            assert torch.equal(got, want), (name, gate)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, specs, params = _segment_data("stride2_chain")
    tparams = [convert.params_from_numpy(p, device="cpu") for p in params]
    flat = segment_operands([(p["w"], p["scale"], p["bias"])
                             for p in tparams], specs)
    tx = torch.tensor(x)
    with pytest.raises(ValueError, match="gate"):
        backbone_segment(tx, flat, specs=specs, gate="mask")
    with pytest.raises(ValueError, match="cluster"):
        backbone_segment(tx, flat, specs=specs, cluster=32)
    with pytest.raises(ValueError, match="stride"):
        backbone_segment(tx, flat, specs=(dataclasses.replace(
            specs[0], stride=3),) + specs[1:])
    with pytest.raises(TypeError, match="float32"):
        backbone_segment(tx.double(), flat, specs=specs)
    with pytest.raises(ValueError, match="operands"):
        backbone_segment(tx, flat[3:] + flat[:3], specs=specs)
    with pytest.raises(ValueError, match="layers"):
        backbone_segment(tx, flat * (MAX_LAYERS + 1),
                         specs=specs * (MAX_LAYERS + 1))


# ---------------------------------------------------------------------------
# _run_layers
# ---------------------------------------------------------------------------

def _vox(cfg, seed, b=B):
    return (torch.rand((cfg.time_steps, b, cfg.height, cfg.width, 2),
                       generator=torch.Generator().manual_seed(seed))
            < 0.15).float()


def _segment_table(cfg, b=B):
    return ops.fused_segment_table(
        [k for _, _, k in tbb.fused_route_segments(cfg, b)])


def _count_segment_calls(monkeypatch):
    calls = []
    real = ops.backbone_segment

    def counted(*a, **kw):
        calls.append(kw["gate"])
        return real(*a, **kw)
    monkeypatch.setattr(ops, "backbone_segment", counted)
    return calls


@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_run_layers_forced_segments_equal_per_layer(arch, monkeypatch):
    cfg = reduced_snn(arch, backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    vox = _vox(cfg, 1)
    _, apply_bb = tbb.BACKBONES[cfg.backbone]
    with tune.off():
        want = apply_bb(params["backbone"], vox, cfg)
    calls = _count_segment_calls(monkeypatch)
    assert calls == []
    routes = tbb.fused_route_segments(cfg, B)
    assert routes
    for gate in GATES:
        with tune.pinned(ops.fused_segment_table([k for *_, k in routes],
                                                 gate)):
            got = apply_bb(params["backbone"], vox, cfg)
        assert torch.equal(got, want), gate
    assert calls == [g for g in GATES for _ in routes]
    if cfg.backbone != "densenet":
        ((specs, _, _),) = tbb.layer_runs(cfg)
        assert torch.equal(want, tbb._run_per_layer(params["backbone"], vox,
                                                    cfg, specs))


def test_run_layers_takes_the_per_layer_route(monkeypatch):
    """A tape, the "torch" backend or non-f32 activations never reach
    the segment op, whatever the table says."""
    cfg = reduced_snn("spiking_yolo", backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    vox = _vox(cfg, 2)
    specs = tbb.yolo_specs(cfg)
    seg_calls = []
    monkeypatch.setattr(ops, "backbone_segment_op",
                        lambda *a, **kw: seg_calls.append(1))
    with tune.pinned(_segment_table(cfg)):
        tape = SparsityTape()
        got = tbb._run_layers(params["backbone"], vox, cfg, specs, tape=tape)
        assert torch.equal(got, tbb._run_per_layer(params["backbone"], vox,
                                                   cfg, specs))
        assert sorted(tape.rates()) == sorted(s.name for s in specs)
        plain = dataclasses.replace(cfg, backend="torch")
        assert torch.equal(
            tbb._run_layers(params["backbone"], vox, plain, specs),
            tbb._run_per_layer(params["backbone"], vox, plain, specs))
        routed = []
        monkeypatch.setattr(tbb, "_run_per_layer",
                            lambda p, x, c, sp, tape=None: routed.append(
                                (x.dtype, tuple(sp))))
        tbb._run_layers(params["backbone"], vox.half(), cfg, specs)
    assert seg_calls == []
    assert routed == [(torch.float16, specs)]


@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_forced_segment_backbone_matches_jax(arch):
    """Each reduced backbone on the forced-segment route against JAX's
    eager jnp backbone on the same weights and voxels."""
    jcfg = jax_reduced_snn(arch)
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_init_npu, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    vox = (rng.random((jcfg.time_steps, B, jcfg.height, jcfg.width, 2))
           < 0.15).astype(np.float32)
    _, japply = jbb.BACKBONES[jcfg.backbone]
    want = np.asarray(japply(jparams["backbone"], vox, jcfg))
    cfg = dataclasses.replace(convert.snn_config(jcfg), backend="cuda")
    params = convert.params_from_numpy(jparams, device="cpu")
    _, apply_bb = tbb.BACKBONES[cfg.backbone]
    with tune.pinned(_segment_table(cfg)):
        got = apply_bb(params["backbone"], torch.tensor(vox), cfg)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < float(got.mean()) < 1.0


# ---------------------------------------------------------------------------
# the launch table's backbone_seg entries
# ---------------------------------------------------------------------------

def _seg_dims(b=8):
    specs = (bf.LayerSpec("", cin=64, cout=64),
             bf.LayerSpec("", stride=2, cin=64, cout=128))
    return ops.segment_dims(specs, T=5, B=b, H=16, W=16)


def test_backbone_seg_default_is_per_layer():
    assert tune.default_config("backbone_seg") == LaunchConfig(fused=False)
    assert tune.dispatch("backbone_seg", _seg_dims()) == \
        LaunchConfig(fused=False)


def test_backbone_seg_candidates():
    dims = _seg_dims()
    cands = tune.candidates("backbone_seg", dims, TUNE_CONFIGS["default"])
    fused = [c for c in cands if c.fused]
    assert LaunchConfig(fused=False) in cands
    assert {c.gate for c in fused} == set(GATES) == {"inline", "none"}
    # the plan's cluster, and twice and half it where the slab fits
    specs = tune.segment_specs(dims)
    clusters = plan_clusters(specs, 5, 8, 16, 16)
    plan = segment_plan(specs, 5, 8, 16, 16)
    assert clusters[0] == plan.cluster == 8
    assert set(clusters) <= {plan.cluster, plan.cluster * 2,
                             plan.cluster // 2}
    assert {c.bm for c in fused} == set(clusters)
    assert set(clusters) <= set(CLUSTER_SIZES)
    assert len(fused) == len(GATES) * len(clusters)
    # a segment deeper than the kernel takes has the per-layer route only
    deep = dict(_seg_dims(), **{f"L{i}": "k3s1c8n8d0p0"
                                for i in range(MAX_LAYERS + 1)})
    assert tune.candidates("backbone_seg", deep,
                           TUNE_CONFIGS["default"]) == [LaunchConfig()]


def test_backbone_seg_estimates_rank():
    dims = _seg_dims()
    est = {c: tune.estimate("backbone_seg", dims, c, live=0.1)
           for c in tune.candidates("backbone_seg", dims,
                                    TUNE_CONFIGS["default"])}
    unfused = est[LaunchConfig(fused=False)]
    # one launch at the segment's edges beats 6 device ops round-tripping
    # every layer; the live fraction counts under "inline" only
    assert all(v < unfused for c, v in est.items() if c.fused)
    assert est[LaunchConfig(bm=16, gate="inline", fused=True)] < \
        est[LaunchConfig(bm=16, gate="none", fused=True)]
    # more blocks per batch element rank first at batch 8 (fewer idle SMs)
    assert est[LaunchConfig(bm=16, gate="inline", fused=True)] < \
        est[LaunchConfig(bm=8, gate="inline", fused=True)]


def test_backbone_seg_key_is_anonymous_and_round_trips(tmp_path):
    a = bf.LayerSpec(name="s0_a", cin=2, cout=8)
    b = bf.LayerSpec(name="other", cin=2, cout=8)
    ka = tune.shape_key("backbone_seg", **ops.segment_dims(
        (a.anon(),), T=3, B=2, H=8, W=8))
    kb = tune.shape_key("backbone_seg", **ops.segment_dims(
        (b.anon(),), T=3, B=2, H=8, W=8))
    assert ka == kb and "s0_a" not in ka
    key = tune.shape_key("backbone_seg", **_seg_dims())
    op, dims = tune.parse_key(key)
    assert op == "backbone_seg" and dims == _seg_dims()
    assert tune.shape_key(op, **dims) == key
    assert dims["L1"] == "k3s2c64n128d0p0" and dims["T"] == 5
    assert tune.parse_key("conv_lif|B2,HW1024,K18,N8,T3") == (
        "conv_lif", dict(B=2, HW=1024, K=18, N=8, T=3))
    table = ops.fused_segment_table([key, "conv_lif|B2,HW4,K9,N4,T3"],
                                    gate="none", cluster=16)
    assert list(table.entries) == [key]
    path = tmp_path / "table.json"
    table.save(str(path))
    loaded = TuningTable.load(str(path))
    assert loaded.config_for(key) == LaunchConfig(bm=16, gate="none",
                                                  fused=True)
    (lkey,) = loaded.entries
    assert tune.parse_key(lkey) == (op, dims)


def test_tuning_sweeps_segments_then_serves_them(monkeypatch):
    """Under ``tuning()`` a forward sweeps each fused-route segment's
    key once (and the conv_lif keys inside it); the swept table serves
    the same output."""
    cfg = reduced_snn("spiking_mobilenet", backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    vox = _vox(cfg, 3)
    want = npu_forward(params, vox, cfg)
    with tune.tuning(TuningTable(), SMOKE) as swept:
        got = npu_forward(params, vox, cfg)
    seg_keys = {k for *_, k in tbb.fused_route_segments(cfg, B)}
    assert seg_keys <= set(swept.entries)
    conv_keys = {tune.shape_key("conv_lif", **d)
                 for d in chip_smoke.conv_lif_dims(params, cfg, B)}
    assert set(swept.entries) == seg_keys | conv_keys
    assert torch.equal(got.raw_pred, want.raw_pred)
    with tune.pinned(swept):
        assert torch.equal(npu_forward(params, vox, cfg).raw_pred,
                           want.raw_pred)


WRAPPERS = ("spike_conv", "spike_conv_lif", "norm_affine_lif",
            "spike_dwconv", "max_pool", "lif_scan", "spike_matmul",
            "backbone_segment")


@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_engine_launches_per_tick_under_segment_table(arch, monkeypatch):
    """A reduced all-kernel engine built under a forced-segment table:
    one segment-wrapper call per fused-route segment, the layers inside
    calling no other wrapper, the counts of
    ``chip_smoke.npu_launches_per_tick``; results equal the untuned
    engine's."""
    cfg = reduced_snn(arch, backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [dict(rid=i, voxels=(rng.random((cfg.time_steps, cfg.height,
                                            cfg.width, 2)) < 0.15)
                 .astype(np.float32),
                 bayer=rng.uniform(0.05, 0.95, (cfg.height, cfg.width))
                 .astype(np.float32)) for i in range(B)]
    calls = collections.Counter()
    for name in WRAPPERS:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    table = _segment_table(cfg)
    segments = chip_smoke.fused_segments(cfg, B, table)
    assert len(segments) == len(tbb.fused_route_segments(cfg, B)) > 0
    results = {}
    for label, tab in (("untuned", TuningTable()), ("segment", table)):
        with tune.pinned(tab):
            eng = CognitiveEngine(params, cfg, isp_cfg=ISP_CONFIGS["cuda"],
                                  enc_cfg=ENCODING_CONFIGS["cuda"], batch=B,
                                  device="cpu")
        calls.clear()
        done = eng.run_to_completion([PerceptionRequest(**r) for r in reqs])
        assert eng.ticks == 1 and len(done) == B
        want = chip_smoke.npu_launches_per_tick(
            cfg, segments=segments if label == "segment" else ())
        assert dict(calls) == {k: v for k, v in want.items() if v}, label
        results[label] = {r.rid: r.result for r in done}
    for rid, res in results["segment"].items():
        for f in ("raw_pred", "control", "rgb"):
            np.testing.assert_array_equal(
                getattr(res, f), getattr(results["untuned"][rid], f))


def test_launch_table_full_width_forced_segments():
    """At full width the forced-segment tick launches the segment
    kernel once per fused-route segment, and its layers nothing else."""
    got = {}
    for arch, cfg in SNN_ARCHS.items():
        segs = [s for s, *_ in tbb.fused_route_segments(cfg, 8)]
        got[arch] = chip_smoke.npu_launches_per_tick(cfg, segments=segs)
    assert got["spiking_yolo"] == dict(
        spike_conv=5, norm_affine_lif=4, spike_dwconv=0, max_pool=0,
        lif_scan=1, spike_matmul=1, backbone_segment=2)
    assert got["spiking_mobilenet"] == dict(
        spike_conv=3, norm_affine_lif=3, spike_dwconv=1, max_pool=0,
        lif_scan=1, spike_matmul=1, backbone_segment=2)
    assert got["spiking_vgg"] == dict(
        spike_conv=8, norm_affine_lif=7, spike_dwconv=0, max_pool=3,
        lif_scan=1, spike_matmul=1, backbone_segment=1)
    assert got["spiking_densenet"] == dict(
        spike_conv=14, norm_affine_lif=13, spike_dwconv=0, max_pool=2,
        lif_scan=1, spike_matmul=1, backbone_segment=1)


def test_file_leaves_the_untuned_chain():
    assert tune.chain_is_untuned()
    assert tune.dispatch("backbone_seg", _seg_dims(2)) == \
        LaunchConfig(fused=False)
