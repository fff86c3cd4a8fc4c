"""Port parity: the fused spiking-conv layer (``spike_conv_lif``) and its
place in the tick, on the CPU, where its wrapper runs the plain version.

- The fused wrapper on the folded spikes (xf and HWIO weights, its plain
  version here) equals the per-op pair's plain composition bit for bit
  under every gate: stride 1 and 2, T*HW not a multiple of the 128-row
  chunk, K not a multiple of 128, an all-silent input (every tile
  skipped) and a layer whose membrane sits on v_th; and it is held to the
  reference's interpret-mode fused kernel (on spike_im2col's patches)
  under each gate by the near-threshold rule.
- The kernel's launch plan (``conv_lif_plan``) at the four backbones'
  served shapes and at batch 65537: every conv row computed once, every
  (b, c, class) summed by one thread in row order, every neuron fired
  once, shared memory within 227 KB, clusters of at most 16, gridDim.x
  in range; DenseNet's 64x64 layers on 24-channel tiles.
- The slab occupancy mask ``chip_smoke.py`` counts the kernel's live work
  with equals the reference's ``slab_occupancy_mask``.
- ``spike_conv_lif_op`` gives the same spikes under an empty, a
  forced-fused and a swept table.
- Every firing conv of the four reduced archs, on the fused route, held
  to the JAX jnp layer on the reference's own input: currents within
  1e-5, spikes equal except where the reference membrane lies within
  1e-4 of v_th.  The reference's interpret-mode fused kernel is compared
  at that rule too, never taken as the exact value.
- ``npu_forward`` under a forced-fused table equals the per-op forward,
  and an engine built under it calls the kernel wrappers as often per
  tick as ``chip_smoke.npu_launches_per_tick`` says.
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

from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core import layers as jl
from repro.core.npu import init_npu as jax_init_npu
from repro.kernels import spike_conv as jsc
from repro_torch import convert
from repro_torch.configs.base import TuneConfig
from repro_torch.configs.registry import (ENCODING_CONFIGS, ISP_CONFIGS,
                                          SNN_ARCHS, reduced_snn)
from repro_torch.core import layers as tl
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.kernels import ops, tune
from repro_torch.kernels import spike_conv_lif as kcl
from repro_torch.kernels.spike_conv_lif import (GATES, conv_lif_plan,
                                                spike_conv_lif,
                                                spike_conv_lif_plain)
from repro_torch.kernels.tune import TuningTable
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)
from repro_torch.testing import slab_occupancy_mask, spike_mismatch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TOL = 1e-4            # near-threshold band for spike flips
PRE_ATOL = 1e-5       # normalised currents
SMOKE = TuneConfig(name="test", reps=1, prune_to=2, max_candidates=64)
LIF = dict(tau=2.0, v_th=1.0, v_reset=0.0)
B = 2


@pytest.fixture(autouse=True)
def _untuned_chain():
    assert tune.chain_is_untuned(), "an earlier test left a table set"
    yield
    leaked = not tune.chain_is_untuned()
    tune.reset()
    assert not leaked, "the test left a table set"


# (T, B, H, W, cin, cout, stride, density)
CASES = {
    "stride1": (3, 2, 8, 8, 4, 8, 1, 0.3),
    "stride2_ragged_rows": (3, 2, 13, 11, 6, 10, 2, 0.3),   # T*HW = 126
    "k_not_canonical": (2, 3, 9, 7, 20, 12, 1, 0.2),        # K = 180
    "all_silent": (3, 2, 8, 8, 4, 8, 2, 0.0),
    "on_threshold": (3, 2, 8, 8, 4, 8, 1, 0.3),
}


def _case(name):
    T, Bn, H, W, cin, cout, stride, dens = CASES[name]
    rng = np.random.default_rng(len(name))
    xf = torch.tensor((rng.random((Bn * T, H, W, cin)) < dens)
                      .astype(np.float32))
    w = torch.tensor(rng.normal(0, 1, (3, 3, cin, cout)).astype(np.float32))
    scale = torch.tensor(rng.normal(1, 0.2, cout).astype(np.float32))
    bias = torch.tensor(rng.normal(0, 0.2, cout).astype(np.float32))
    if name == "on_threshold":
        # z = 0 * normed + v_th: the membrane is exactly v_th at t = 0
        scale, bias = torch.zeros(cout), torch.full((cout,), LIF["v_th"])
    return T, Bn, stride, xf, w, scale, bias


def _per_op_plain(T, Bn, stride, xf, w, scale, bias, gate):
    y = tl.unfold(ops.spike_conv_op(xf, w, stride=stride, gate=gate), T, Bn)
    return ops.norm_affine_lif_op(y, scale, bias, **LIF)


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_equals_per_op_plain(case, gate):
    T, Bn, stride, xf, w, scale, bias = _case(case)
    got = spike_conv_lif(xf, w, scale, bias, T=T, B=Bn, stride=stride,
                         gate=gate, **LIF)
    want = _per_op_plain(T, Bn, stride, xf, w, scale, bias, gate)
    assert torch.equal(got.reshape(want.shape), want)
    assert torch.equal(got, spike_conv_lif_plain(
        xf, w, scale, bias, T=T, B=Bn, stride=stride, **LIF))
    if case == "on_threshold":
        assert torch.equal(got[0], torch.ones_like(got[0]))
    if case == "all_silent":
        patches, (Ho, Wo) = tl.spike_im2col(xf, 3, 3, stride)
        occ = slab_occupancy_mask(patches.reshape(Bn, T * Ho * Wo, -1))
        assert int(occ.sum()) == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    T, Bn, stride, xf, w, scale, bias = _case("stride1")
    kw = dict(T=T, B=Bn, stride=stride)
    with pytest.raises(ValueError, match="stride"):
        spike_conv_lif(xf, w, scale, bias, T=T, B=Bn, stride=0)
    with pytest.raises(ValueError, match="cluster"):
        spike_conv_lif(xf, w, scale, bias, cluster=3, **kw)
    with pytest.raises(ValueError, match="gate"):
        spike_conv_lif(xf, w, scale, bias, gate="tiles", **kw)
    with pytest.raises(ValueError, match="folded frames"):
        spike_conv_lif(xf, w, scale, bias, T=T, B=Bn + 1, stride=stride)
    with pytest.raises(ValueError, match="scale"):
        spike_conv_lif(xf, w, scale[:3], bias, **kw)
    with pytest.raises(ValueError, match="fits no cluster"):
        conv_lif_plan(10 ** 5, 1, 64, 8, 36)     # 6.4M slab rows


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_xf_plain_matches_the_interpret_fused_kernel(case, gate):
    """The xf entry point (its plain version here) against the
    reference's interpret-mode ``spike_conv_lif_pallas`` on the same
    spikes' patches under the same gate: spikes equal except where the
    membrane over the port's own currents lies within 1e-4 of v_th (the
    Pallas outputs are never an exact oracle); the currents are the
    per-op pair's."""
    T, Bn, stride, xf, w, scale, bias = _case(case)
    patches, (Ho, Wo) = tl.spike_im2col(xf, 3, 3, stride)
    wmat = w.reshape(-1, w.shape[-1])
    pallas = np.asarray(jsc.spike_conv_lif_pallas(
        jnp.asarray(patches.numpy()), jnp.asarray(wmat.numpy()),
        jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()), T=T, B=Bn,
        HW=Ho * Wo, eps=tl.NORM_EPS, gate=gate, interpret=True, **LIF))
    got = spike_conv_lif(xf, w, scale, bias, T=T, B=Bn, stride=stride,
                         gate=gate, **LIF)
    y = tl.spike_conv(xf, w, stride=stride).reshape(Bn, T, Ho * Wo, -1)
    z = tl.instance_norm_affine(y.transpose(0, 1).contiguous(), scale, bias)
    for spikes in (pallas, got):
        assert spike_mismatch(z, spikes, tol=TOL, **LIF)["far"] == 0
    assert int((got.numpy() != pallas).any(axis=0).sum()) <= \
        spike_mismatch(z, got, tol=TOL, **LIF)["near"]


# ---------------------------------------------------------------------------
# the kernel's launch plan
# ---------------------------------------------------------------------------

def test_served_shapes_are_the_conv_lif_dispatches():
    served = set()
    for cfg in SNN_ARCHS.values():
        params = init_npu(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
        served |= {(d["T"], d["B"], d["HW"], d["K"], d["N"])
                   for d in chip_smoke.conv_lif_dims(params, cfg, 8)}
    assert sorted(served) == sorted(chip_smoke.CONV_LIF_SERVED_SHAPES)


def _plan_cases():
    return list(chip_smoke.CONV_LIF_SERVED_SHAPES) + [
        (2, chip_smoke.BIG_BATCH, 2, 18, 4), (3, 2, 126, 54, 10),
        (2, 3, 63, 180, 12), (1, 1, 1, 9, 1), (5, 1, 33, 27, 66)]


@pytest.mark.parametrize("shape", _plan_cases())
def test_plan_computes_sums_and_fires_each_once(shape):
    """The plan at (T, B, HW, K, N), decoded as the kernel decodes it:
    every conv row of every (batch element, channel tile) computed once,
    by the block that owns its class, in whole row tiles; every (b, c,
    class) summed by one thread over its rows in increasing order; every
    neuron fired once; shared memory, cluster and grid within the card's
    limits."""
    T, B, HW, K, N = shape
    p = conv_lif_plan(T, B, HW, N, K)
    R = T * HW
    assert p.cluster in kcl.CLUSTERS and p.cluster <= 16
    assert p.smem_bytes <= kcl.MAX_SMEM == 232448
    assert p.blocks < 2 ** 31 and p.grid == (p.blocks, 1, 1)
    assert p.blocks == B * p.tiles * p.cluster
    assert 1 <= p.ct <= kcl.TILE_N and (p.vec == 1 or p.ct % 4 == 0)
    assert p.bm in kcl.ROW_TILES and p.stages in kcl.STAGES
    tiles = p.row_tiles()
    assert [q for t in tiles for q in t] == list(range(p.rows))
    assert all(len(t) <= p.bm for t in tiles)
    # rows, chains and neurons of one (b, tile): the same for every one
    computed = np.zeros(R, np.int64)
    fired = np.zeros(HW, np.int64)
    summed = {}
    for rank in range(p.cluster):
        classes = range(rank * p.classes, (rank + 1) * p.classes)
        for q in range(p.rows):
            i = p.slab_row(rank, q)
            if i < R:
                assert i % 32 in classes and p.owner(i) == (rank, q)
                computed[i] += 1
        for thread, cls, ch, qs in p.chains(rank):
            assert 0 <= thread < kcl.THREADS and cls in classes
            rows = [p.slab_row(rank, q) for q in qs]
            assert rows == list(range(cls, R, 32))
            summed[cls, ch] = summed.get((cls, ch), 0) + 1
        hws = p.neurons(rank)
        assert all(hw % 32 in classes for hw in hws)
        fired[hws] += 1
    assert (computed == 1).all() and (fired == 1).all()
    assert summed == {(cls, ch): 1 for cls in range(32)
                      for ch in range(p.ct)}
    # every (batch element, tile, class share) once on gridDim.x
    ks = range(p.blocks) if p.blocks <= 4096 else \
        list(range(2048)) + list(range(p.blocks - 2048, p.blocks))
    seen = set()
    for k in ks:
        b, chans, classes = p.block(k)
        assert 0 <= b < B and chans.start % p.ct == 0 and len(chans) >= 1
        seen.add((b, chans.start, classes.start))
    assert len(seen) == len(ks)
    assert p.block(p.blocks - 1)[0] == B - 1
    if HW == 4096:
        assert p.ct > 2                  # DenseNet's 64x64: wide tiles


def test_plan_pins_and_refusals():
    p = conv_lif_plan(5, 8, 4096, 24, 216)        # DenseNet 64x64
    assert (p.ct, p.cluster) == (24, 16)
    assert conv_lif_plan(5, 8, 4096, 24, 216, cluster=p.cluster) == p
    with pytest.raises(ValueError, match="fits no cluster"):
        conv_lif_plan(5, 8, 4096, 24, 216, cluster=8)
    with pytest.raises(ValueError, match="cluster 3"):
        conv_lif_plan(5, 8, 1024, 32, 288, cluster=3)
    # the channel tile: N split evenly into tiles of at most 32, a
    # multiple of 4 where N is
    assert [kcl.channel_tile(n) for n in (24, 30, 36, 66, 256)] == \
        [24, 30, 20, 22, 32]
    with pytest.raises(ValueError, match="int range"):
        conv_lif_plan(2, 2 ** 31 - 1, 1, 64, 9)     # two tiles a batch
    with pytest.raises(ValueError, match="empty"):
        conv_lif_plan(5, 0, 16, 8, 9)


@pytest.mark.parametrize("shape,density", [((2, 126, 36), 0.2),
                                           ((3, 300, 256), 0.05),
                                           ((1, 64, 130), 0.0)])
def test_slab_occupancy_mask_matches_jax(shape, density):
    rng = np.random.default_rng(shape[1])
    x3 = (rng.random(shape) < density).astype(np.float32)
    x3[:, : shape[1] // 2] = 0.0                # partly silent
    pk = (-shape[2]) % 128
    want = jsc.slab_occupancy_mask(
        jnp.asarray(np.pad(x3, ((0, 0), (0, 0), (0, pk)))), bm=128)
    got = slab_occupancy_mask(torch.tensor(x3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_op_under_empty_forced_and_swept_tables():
    T, Bn, stride, xf, w, scale, bias = _case("stride2_ragged_rows")

    def run():
        return ops.spike_conv_lif_op(xf, w, scale, bias, T=T, B=Bn,
                                     stride=stride, **LIF)
    with tune.pinned(TuningTable()):
        want = run()
    with tune.tuning(TuningTable(), SMOKE) as swept:
        assert torch.equal(run(), want)
    assert len(swept.entries) == 1
    with tune.pinned(swept):
        assert torch.equal(run(), want)
    for gate in GATES:
        with tune.pinned(ops.fused_conv_lif_table(swept.entries, gate)):
            assert torch.equal(run(), want)


# ---------------------------------------------------------------------------
# the four reduced archs against the JAX jnp layers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(SNN_ARCHS))
def ref(request):
    """JAX params, voxels and each firing non-depthwise conv's input and
    jnp currents for one reduced arch, walked once."""
    jcfg = jax_reduced_snn(request.param)
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_init_npu, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    vox = (rng.random((jcfg.time_steps, B, jcfg.height, jcfg.width, 2))
           < 0.15).astype(np.float32)
    layers = []

    def conv(name, p, x, stride, depthwise):
        kw = dict(stride=stride, depthwise=depthwise)
        z = np.asarray(jl.apply_spiking_conv(p, x, jcfg, fire=False, **kw))
        if not depthwise:
            layers.append((name, x, stride, z))
        return np.asarray(jl._fire(z, jcfg))

    def pool(name, x, window):
        return np.asarray(jl.max_pool(x, window, cfg=jcfg))

    cfg = convert.snn_config(jcfg)
    feats = chip_smoke.backbone_walk(
        cfg, jparams["backbone"], vox, conv, pool,
        lambda fs: np.concatenate(fs, axis=-1))
    conv("head_conv", jparams["head"]["conv"], feats, 1, False)
    return dict(name=request.param, cfg=cfg, jparams=jparams, vox=vox,
                layers=layers)


def _forced_for(params, cfg, vox):
    """A forced-fused table over every conv_lif key the forward hits
    (keys from a sweep, routes rewritten to the fused kernel)."""
    with tune.tuning(TuningTable(), SMOKE) as swept:
        npu_forward(params, vox, cfg)
    return swept, ops.fused_conv_lif_table(swept.entries)


def test_fused_layers_match_jax(ref):
    cfg = dataclasses.replace(ref["cfg"], backend="cuda")
    params = convert.params_from_numpy(ref["jparams"], device="cpu")
    bb = dict(params["backbone"], head_conv=params["head"]["conv"])
    keys = [tune.shape_key("conv_lif", **d)
            for d in chip_smoke.conv_lif_dims(params, cfg, B)]
    assert len(keys) == len(ref["layers"])
    forced = ops.fused_conv_lif_table(keys)
    for name, x, stride, z in ref["layers"]:
        tx = torch.tensor(x)
        got_z = tl.apply_spiking_conv(bb[name], tx, cfg, fire=False,
                                      stride=stride)
        np.testing.assert_allclose(got_z.numpy(), z, atol=PRE_ATOL, rtol=0,
                                   err_msg=name)
        with tune.pinned(forced):
            got = tl.apply_spiking_conv(bb[name], tx, cfg, stride=stride)
        res = spike_mismatch(z, got, tol=TOL)
        assert res["far"] == 0, (ref["name"], name, res)
        assert 0.0 < float(got.mean()) < 1.0, name


def test_interpret_fused_kernel_within_the_rule():
    """The reference's interpret-mode fused kernel on a small layer:
    held to the jnp currents by the near-threshold rule, as the port's
    fused route is (its Pallas outputs are never an exact oracle)."""
    T, Bn, stride, xf, w, scale, bias = _case("stride1")
    patches, (Ho, Wo) = tl.spike_im2col(xf, 3, 3, stride)
    wmat = w.reshape(-1, w.shape[-1])
    pallas = np.asarray(jsc.spike_conv_lif_pallas(
        jnp.asarray(patches.numpy()), jnp.asarray(wmat.numpy()),
        jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()), T=T, B=Bn,
        HW=Ho * Wo, eps=tl.NORM_EPS, interpret=True, **LIF))
    x = tl.unfold(xf, T, Bn)
    z = np.asarray(jl.apply_spiking_conv(
        {"w": jnp.asarray(w.numpy()), "scale": jnp.asarray(scale.numpy()),
         "bias": jnp.asarray(bias.numpy())}, x.numpy(),
        jax_reduced_snn("spiking_yolo"), fire=False)).reshape(pallas.shape)
    got = spike_conv_lif(xf, w, scale, bias, T=T, B=Bn, stride=stride,
                         **LIF).numpy()
    for spikes in (pallas, got):
        assert spike_mismatch(z, spikes, tol=TOL)["far"] == 0
    np.testing.assert_allclose(got.mean(), pallas.mean(), atol=0.02)


@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_npu_forward_forced_fused_equals_per_op(arch):
    cfg = reduced_snn(arch, backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    vox = (torch.rand((cfg.time_steps, B, cfg.height, cfg.width, 2),
                      generator=torch.Generator().manual_seed(1))
           < 0.15).float()
    want = npu_forward(params, vox, cfg)
    swept, forced = _forced_for(params, cfg, vox)
    dims = chip_smoke.conv_lif_dims(params, cfg, B)
    assert set(forced.entries) == {tune.shape_key("conv_lif", **d)
                                   for d in dims}
    for table in (forced, swept, TuningTable()):
        with tune.pinned(table):
            got = npu_forward(params, vox, cfg)
        assert torch.equal(got.raw_pred, want.raw_pred)
        assert torch.equal(got.control, want.control)


WRAPPERS = ("spike_conv", "spike_conv_lif", "norm_affine_lif",
            "spike_dwconv", "max_pool", "lif_scan", "spike_matmul",
            "backbone_segment")


@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_engine_launches_per_tick_under_a_table(arch, monkeypatch):
    """Reduced all-kernel engines built under a forced-fused, a swept
    and an empty table: kernel-wrapper calls per tick equal chip_smoke's
    formula (spike_conv_lif once per firing non-depthwise conv, the
    readout on spike_conv, norm_affine_lif on the depthwise layers
    alone; a backbone segment the sweep sent to its kernel one
    backbone_segment call for its layers), and the results equal the
    untuned engine's."""
    cfg = reduced_snn(arch, backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [dict(rid=i, voxels=(rng.random((cfg.time_steps, cfg.height,
                                            cfg.width, 2)) < 0.15)
                 .astype(np.float32),
                 bayer=rng.uniform(0.05, 0.95, (cfg.height, cfg.width))
                 .astype(np.float32)) for i in range(B)]
    vox = torch.tensor(np.stack([r["voxels"] for r in reqs], axis=1))
    swept, forced = _forced_for(params, cfg, vox)
    n_conv_lif = len(chip_smoke.conv_lif_dims(params, cfg, B))
    assert chip_smoke.fused_layers(params, cfg, B, forced) == n_conv_lif
    calls = collections.Counter()
    for name in WRAPPERS:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    results = {}
    for label, table in (("untuned", TuningTable()), ("forced", forced),
                         ("swept", swept)):
        with tune.pinned(table):
            eng = CognitiveEngine(params, cfg, isp_cfg=ISP_CONFIGS["cuda"],
                                  enc_cfg=ENCODING_CONFIGS["cuda"], batch=B,
                                  device="cpu")
        calls.clear()
        done = eng.run_to_completion([PerceptionRequest(**r) for r in reqs])
        assert eng.ticks == 1 and len(done) == B
        want = chip_smoke.npu_launches_per_tick(
            cfg, fused=chip_smoke.fused_layers(params, cfg, B, table),
            segments=chip_smoke.fused_segments(cfg, B, table))
        assert dict(calls) == {k: v for k, v in want.items() if v}, label
        results[label] = {r.rid: r.result for r in done}
    # at full width: the counts chip_smoke checks on the card
    full_params = init_npu(torch.Generator().manual_seed(0), SNN_ARCHS[arch],
                           device="cpu")
    full = chip_smoke.npu_launches_per_tick(SNN_ARCHS[arch], fused=len(
        chip_smoke.conv_lif_dims(full_params, SNN_ARCHS[arch], 8)))
    assert full["spike_conv"] == 1
    assert full["spike_conv_lif"] == {"spiking_yolo": 9, "spiking_vgg": 9,
                                      "spiking_mobilenet": 6,
                                      "spiking_densenet": 14}[arch]
    assert full["norm_affine_lif"] == full["spike_dwconv"]
    for label in ("forced", "swept"):
        for rid, res in results[label].items():
            for f in ("raw_pred", "control", "rgb"):
                np.testing.assert_array_equal(
                    getattr(res, f), getattr(results["untuned"][rid], f))
