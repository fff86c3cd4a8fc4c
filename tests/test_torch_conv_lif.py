"""Port parity: the fused spiking-conv layer (``spike_conv_lif``) and its
place in the tick, on the CPU, where its wrapper runs the plain version.

- The fused plain version equals the per-op pair's plain composition bit
  for bit under every gate: stride 1 and 2, T*HW not a multiple of the
  128-row chunk, K not a multiple of 128, an all-silent input (every tile
  skipped) and a layer whose membrane sits on v_th.
- Its slab occupancy mask equals the reference's ``slab_occupancy_mask``.
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
from repro_torch.kernels.spike_conv_lif import (GATES, slab_occupancy_mask,
                                                spike_conv_lif,
                                                spike_conv_lif_plain)
from repro_torch.kernels.tune import TuningTable
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)
from repro_torch.testing import spike_mismatch

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
    patches, (Ho, Wo) = tl.spike_im2col(xf, 3, 3, stride)
    wmat = w.reshape(-1, w.shape[-1]).contiguous()
    got = spike_conv_lif(patches, wmat, scale, bias, T=T, B=Bn, HW=Ho * Wo,
                         gate=gate, **LIF)
    want = _per_op_plain(T, Bn, stride, xf, w, scale, bias, gate)
    assert torch.equal(got.reshape(want.shape), want)
    assert torch.equal(got, spike_conv_lif_plain(
        patches, wmat, scale, bias, T=T, B=Bn, HW=Ho * Wo, **LIF))
    if case == "on_threshold":
        assert torch.equal(got[0], torch.ones_like(got[0]))
    if case == "all_silent":
        occ = slab_occupancy_mask(patches.reshape(Bn, T * Ho * Wo, -1))
        assert int(occ.sum()) == 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    T, Bn, stride, xf, w, scale, bias = _case("stride1")
    patches, (Ho, Wo) = tl.spike_im2col(xf, 3, 3, stride)
    wmat = w.reshape(-1, w.shape[-1]).contiguous()
    kw = dict(T=T, B=Bn, HW=Ho * Wo)
    with pytest.raises(ValueError, match="slice"):
        spike_conv_lif(patches, wmat, scale, bias, bn=128, **kw)
    with pytest.raises(ValueError, match="gate"):
        spike_conv_lif(patches, wmat, scale, bias, gate="tiles", **kw)
    with pytest.raises(ValueError, match="rows"):
        spike_conv_lif(patches, wmat, scale, bias, T=T, B=Bn + 1,
                       HW=Ho * Wo)
    with pytest.raises(ValueError, match="scale"):
        spike_conv_lif(patches, wmat, scale[:3], bias, **kw)


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
    got = spike_conv_lif(patches, wmat.contiguous(), scale, bias, T=T, B=Bn,
                         HW=Ho * Wo, **LIF).numpy()
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
