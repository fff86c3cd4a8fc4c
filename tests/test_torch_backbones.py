"""Port parity: the paper's other three backbones — spiking VGG,
MobileNet (depthwise convs) and DenseNet (concat blocks, 1x1
transitions) — layer by layer and through ``npu_forward`` whole, against
the JAX package's jnp path, on weights from the JAX ``init_npu`` carried
over by ``repro_torch.convert`` and numpy-made voxels (``reduced_snn``
sizes).

Each layer runs on the JAX layer's own input, so a near-threshold flip
cannot cascade through the deep stacks: pre-activations agree within
1e-5 and spikes equal the reference's except where its membrane lies
within 1e-5 of v_th; a pool is equal.  The whole forward is held at
1e-4 (raw_pred, control), as for spiking-YOLO, against the JAX forward
run eagerly (the layers' own op sequence).  Both port backends run:
on CPU tensors the ``"cuda"`` backend's ops take their kernels' plain
versions, so this covers the kernel path's composition; which kernel
each layer reaches is counted by wrapping the kernel wrappers.
"""
import collections
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import SNN_ARCHS as JAX_ARCHS
from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core import backbones as jbb
from repro.core import layers as jl
from repro.core.npu import init_npu as jax_init_npu
from repro.core.npu import npu_forward as jax_npu_forward
from repro_torch import convert
from repro_torch.configs.registry import (ENCODING_CONFIGS, ISP_CONFIGS,
                                          SNN_ARCHS, reduced_snn)
from repro_torch.core import backbones as tbb
from repro_torch.core import layers as tl
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.kernels import ops
from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                PerceptionRequest)
from repro_torch.testing import spike_mismatch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# its layer walk and launch table, held to the backbones' code here
import chip_smoke  # noqa: E402

TOL = 1e-5            # near-threshold band for spike flips
PRE_ATOL = 1e-5       # pre-activations (normalised currents)
OUT_ATOL = 1e-4       # raw_pred / control of the whole forward
B = 2
NEW_ARCHS = ("spiking_vgg", "spiking_mobilenet", "spiking_densenet")


@pytest.fixture(scope="module", params=NEW_ARCHS)
def ref(request):
    """JAX params, voxels, per-layer oracles and the whole forward of
    one reduced arch, computed once."""
    jcfg = jax_reduced_snn(request.param)
    jparams = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_init_npu, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    vox = (rng.random((jcfg.time_steps, B, jcfg.height, jcfg.width, 2))
           < 0.15).astype(np.float32)
    layers = []                   # (name, kind, x_in, kwargs, z, out)

    def conv(name, p, x, stride, depthwise):
        kw = dict(stride=stride, depthwise=depthwise)
        z = np.asarray(jl.apply_spiking_conv(p, x, jcfg, fire=False, **kw))
        s = np.asarray(jl._fire(z, jcfg))       # the layer's own LIF on z
        layers.append((name, "conv", x, kw, z, s))
        return s

    def pool(name, x, window):
        y = np.asarray(jl.max_pool(x, window, cfg=jcfg))
        layers.append((name + ".pool", "pool", x, dict(window=window), None,
                       y))
        return y

    feats = chip_smoke.backbone_walk(
        convert.snn_config(jcfg), jparams["backbone"], vox, conv, pool,
        lambda fs: np.concatenate(fs, axis=-1))
    # eager, op by op as the layers above: XLA's fusions under jit round
    # differently, and in the reduced VGG one flipped spike then
    # cascades (raw_pred 1.27 away from the eager run)
    out = jax.tree_util.tree_map(
        np.asarray, jax_npu_forward(jparams, vox, jcfg,
                                    collect_sparsity=True))
    return dict(jcfg=jcfg, jparams=jparams, vox=vox, layers=layers,
                feats=feats, out=out)


def _cfg(ref, backend):
    return dataclasses.replace(convert.snn_config(ref["jcfg"]),
                               backend=backend)


def _params(ref):
    return convert.params_from_numpy(ref["jparams"], device="cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_layers_match_jax(ref, backend):
    cfg, params = _cfg(ref, backend), _params(ref)
    bb = params["backbone"]
    kinds = collections.Counter(k for _, k, *_ in ref["layers"])
    assert kinds["pool"] == (cfg.num_stages if cfg.backbone != "mobilenet"
                             else 0)
    for name, kind, x, kw, z, want in ref["layers"]:
        tx = torch.tensor(x)
        if kind == "pool":
            got = tl.max_pool(tx, kw["window"], cfg)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            continue
        got_z = tl.apply_spiking_conv(bb[name], tx, cfg, fire=False, **kw)
        np.testing.assert_allclose(got_z.numpy(), z, atol=PRE_ATOL, rtol=0,
                                   err_msg=name)
        got = tl.apply_spiking_conv(bb[name], tx, cfg, **kw)
        assert got.shape == want.shape, name
        res = spike_mismatch(z, got, tol=TOL)
        assert res["far"] == 0, (name, res)
        assert 0.0 < float(got.mean()) < 1.0, name


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_backbone_matches_layer_walk(ref, backend):
    """The backbone's own apply (its per-layer executor) gives the
    features of ``chip_smoke.backbone_walk``: the walk is the route the
    backbone takes."""
    cfg, params = _cfg(ref, backend), _params(ref)
    _, apply_bb = tbb.BACKBONES[cfg.backbone]
    got = apply_bb(params["backbone"], torch.tensor(ref["vox"]), cfg)
    walked = chip_smoke.backbone_walk(
        cfg, params["backbone"], torch.tensor(ref["vox"]),
        lambda n, p, x, st, dw: tl.apply_spiking_conv(
            p, x, cfg, stride=st, depthwise=dw),
        lambda n, x, w: tl.max_pool(x, w, cfg),
        lambda fs: torch.cat(fs, dim=-1))
    assert torch.equal(got, walked)
    assert got.shape == ref["feats"].shape


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_npu_forward_matches_jax(ref, backend):
    cfg = _cfg(ref, backend)
    out = npu_forward(_params(ref), torch.tensor(ref["vox"]), cfg)
    want = ref["out"]
    assert out.raw_pred.shape == want.raw_pred.shape
    np.testing.assert_allclose(out.raw_pred.numpy(), want.raw_pred,
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(out.control.numpy(), want.control,
                               atol=OUT_ATOL, rtol=0)
    np.testing.assert_allclose(float(out.sparsity), float(want.sparsity),
                               atol=1e-6)
    np.testing.assert_allclose(float(out.tile_skip), float(want.tile_skip),
                               atol=1e-6)


def test_layer_rates_match_jax(ref):
    """The sparsity tape: the same tags (pools record nothing) and
    rates."""
    out = npu_forward(_params(ref), torch.tensor(ref["vox"]),
                      _cfg(ref, "cuda"), collect_sparsity=True)
    want = ref["out"].layer_rates
    assert sorted(out.layer_rates) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(out.layer_rates[k]), v, atol=1e-6,
                                   err_msg=k)


WRAPPERS = ("spike_conv", "norm_affine_lif", "spike_dwconv", "max_pool",
            "lif_scan", "spike_matmul")


@pytest.mark.parametrize("arch", sorted(SNN_ARCHS))
def test_kernel_calls_per_forward(arch, monkeypatch):
    """Under ``"cuda"`` every layer reaches its kernel wrapper: counted
    per forward, equal to chip_smoke's launch table (held at full width
    to the paper configs' numbers in test_launch_table_full_width)."""
    calls = collections.Counter()
    for name in WRAPPERS:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = reduced_snn(arch, backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    vox = (torch.rand((cfg.time_steps, B, cfg.height, cfg.width, 2),
                      generator=torch.Generator().manual_seed(1)) < 0.15)
    npu_forward(params, vox.float(), cfg)
    want = chip_smoke.npu_launches_per_tick(cfg)
    assert {k: v for k, v in calls.items()} == \
        {k: v for k, v in want.items() if v}


def test_launch_table_full_width():
    got = {a: chip_smoke.npu_launches_per_tick(SNN_ARCHS[a])
           for a in SNN_ARCHS}
    assert got["spiking_mobilenet"] == dict(
        spike_conv=7, norm_affine_lif=10, spike_dwconv=4, max_pool=0,
        lif_scan=1, spike_matmul=1)
    assert got["spiking_vgg"] == dict(
        spike_conv=10, norm_affine_lif=9, spike_dwconv=0, max_pool=4,
        lif_scan=1, spike_matmul=1)
    assert got["spiking_densenet"] == dict(
        spike_conv=15, norm_affine_lif=14, spike_dwconv=0, max_pool=3,
        lif_scan=1, spike_matmul=1)
    assert got["spiking_yolo"] == dict(
        spike_conv=10, norm_affine_lif=9, spike_dwconv=0, max_pool=0,
        lif_scan=1, spike_matmul=1)


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_configs_and_out_channels_match_jax(arch):
    for jcfg in (JAX_ARCHS[arch], jax_reduced_snn(arch)):
        cfg = convert.snn_config(jcfg)
        assert tbb.backbone_out_channels(cfg) == \
            jbb.backbone_out_channels(jcfg)
        assert tbb.spatial_reduction(cfg) == jbb.spatial_reduction(jcfg)
    assert convert.snn_config(JAX_ARCHS[arch]) == SNN_ARCHS[arch]
    assert reduced_snn(arch) == convert.snn_config(jax_reduced_snn(arch))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_port_init_matches_reference_shapes(arch):
    """The port's own init (for the card, which has no JAX): the
    reference's parameter names and shapes, He-normal scales,
    reproducible from a seed."""
    jcfg = jax_reduced_snn(arch)
    ref_p = jax.eval_shape(lambda k: jax_init_npu(k, jcfg),
                           jax.random.PRNGKey(0))
    cfg = convert.snn_config(jcfg)
    a = init_npu(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = init_npu(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert sorted(a["backbone"]) == sorted(ref_p["backbone"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref_p):
        node_a, node_b = a, b
        for k in path:
            node_a, node_b = node_a[k.key], node_b[k.key]
        assert tuple(node_a.shape) == leaf.shape, path
        torch.testing.assert_close(node_a, node_b, rtol=0, atol=0)
        if leaf.ndim >= 2:
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = float(node_a.std())
            assert 0.5 < std / (2.0 / fan_in) ** 0.5 < 1.5, path


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_engine_tick_serves_arch(arch):
    """A reduced CognitiveEngine on the all-kernel configs (on the CPU:
    the plain versions) answers its requests, equal to the plain
    engine."""
    cfg = reduced_snn(arch, backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(2)
    reqs = [dict(rid=i, voxels=(rng.random((cfg.time_steps, cfg.height,
                                            cfg.width, 2)) < 0.15)
                 .astype(np.float32),
                 bayer=rng.uniform(0.05, 0.95, (cfg.height, cfg.width))
                 .astype(np.float32)) for i in range(3)]
    results = {}
    for name, kw in {
            "all_kernels": dict(cfg=cfg, isp_cfg=ISP_CONFIGS["cuda"],
                                enc_cfg=ENCODING_CONFIGS["cuda"]),
            "plain": dict(cfg=dataclasses.replace(cfg, backend="torch"))
    }.items():
        eng = CognitiveEngine(params, batch=B, device="cpu", **kw)
        done = eng.run_to_completion([PerceptionRequest(**r) for r in reqs])
        assert sorted(r.rid for r in done) == [0, 1, 2]
        results[name] = {r.rid: r.result for r in done}
    h = cfg.height // tbb.spatial_reduction(cfg)
    for rid, res in results["all_kernels"].items():
        assert res.raw_pred.shape == (h, h, cfg.num_anchors,
                                      5 + cfg.num_classes)
        assert res.rgb.shape == (cfg.height, cfg.width, 3)
        for f in ("raw_pred", "control", "rgb"):
            a, b = getattr(res, f), getattr(results["plain"][rid], f)
            assert np.isfinite(a).all(), f
            np.testing.assert_allclose(a, b, atol=OUT_ATOL, rtol=0,
                                       err_msg=f)
