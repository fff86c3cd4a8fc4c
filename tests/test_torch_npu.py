"""Port parity: the NPU of the serving tick — every layer of the
reduced spiking-YOLO, then ``npu_forward`` whole — against the JAX
package's jnp path, on weights from the JAX ``init_npu`` carried over by
``repro_torch.convert`` and numpy-made voxels.

Each layer runs on the JAX layer's own input spikes, so a near-threshold
flip cannot cascade: its pre-activations must agree to float rounding
and its spikes must equal the reference's except where the reference
membrane lies within 1e-5 of v_th.  Both port backends run here: on CPU
tensors the ``"cuda"`` backend's ops take their kernels' plain versions,
so this covers the kernel path's composition too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core import layers as jl
from repro.core.npu import init_npu as jax_init_npu
from repro.core.npu import npu_forward as jax_npu_forward
from repro.core.yolo import decode_boxes as jax_decode_boxes
from repro_torch import convert
from repro_torch.core import layers as tl
from repro_torch.core.backbones import yolo_specs
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.core.sparsity import SparsityTape
from repro_torch.core.yolo import decode_boxes
from repro_torch.testing import spike_mismatch

TOL = 1e-5            # near-threshold band for spike flips
PRE_ATOL = 1e-5       # pre-activations (normalised currents)
OUT_ATOL = 1e-4       # raw_pred / control of the whole forward
B = 2


@pytest.fixture(scope="module")
def ref():
    """JAX params, inputs and per-layer oracles, computed once."""
    jcfg = jax_reduced_snn("spiking_yolo")
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_init_npu(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    vox = (rng.random((jcfg.time_steps, B, jcfg.height, jcfg.width, 2))
           < 0.15).astype(np.float32)
    layers = []                   # (name, x_in, conv kwargs, z, spikes)

    def conv(name, p, x, **kw):
        z = np.asarray(jl.apply_spiking_conv(p, x, jcfg, fire=False, **kw))
        s = np.asarray(jl.apply_spiking_conv(p, x, jcfg, **kw))
        layers.append((name, x, kw, z, s))
        return s

    x = vox
    for s in yolo_specs(convert.snn_config(jcfg)):
        x = conv(s.name, jparams["backbone"][s.name], x, stride=s.stride)
    feats = x
    h = conv("head_conv", jparams["head"]["conv"], feats)
    pred = np.asarray(jl.apply_spiking_conv(jparams["head"]["pred"], h, jcfg,
                                            fire=False))
    pooled = feats.mean(axis=(2, 3))
    zc = np.asarray(jl.apply_spiking_dense(jparams["ctrl_hidden"], pooled,
                                           jcfg, fire=False))
    hc = np.asarray(jl.apply_spiking_dense(jparams["ctrl_hidden"], pooled,
                                           jcfg))
    ctrl = np.asarray(jl.apply_spiking_dense(jparams["ctrl_out"], hc, jcfg,
                                             fire=False, spike_input=True))
    out = jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda p, v: jax_npu_forward(
            p, v, jcfg, collect_sparsity=True))(jparams, vox))
    return dict(jcfg=jcfg, jparams=jparams, vox=vox, layers=layers,
                head_in=h, pred=pred, pooled=pooled, zc=zc, hc=hc,
                ctrl=ctrl, out=out)


def _cfg(ref, backend):
    return dataclasses.replace(convert.snn_config(ref["jcfg"]),
                               backend=backend)


def _params(ref):
    return convert.params_from_numpy(ref["jparams"], device="cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_conv_layers_match_jax(ref, backend):
    cfg, params = _cfg(ref, backend), _params(ref)
    flat = dict(params["backbone"], head_conv=params["head"]["conv"])
    assert len(ref["layers"]) == 2 * cfg.num_stages + 1
    for name, x, kw, z, s in ref["layers"]:
        tx = torch.tensor(x)
        got_z = tl.apply_spiking_conv(flat[name], tx, cfg, fire=False, **kw)
        np.testing.assert_allclose(got_z.numpy(), z, atol=PRE_ATOL, rtol=0,
                                   err_msg=name)
        got = tl.apply_spiking_conv(flat[name], tx, cfg, **kw)
        assert got.shape == s.shape, name
        res = spike_mismatch(z, got, tol=TOL)
        assert res["far"] == 0, (name, res)
        assert 0.0 < float(got.mean()) < 1.0, name


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_readout_and_control_head_match_jax(ref, backend):
    cfg, params = _cfg(ref, backend), _params(ref)
    pred = tl.apply_spiking_conv(params["head"]["pred"],
                                 torch.tensor(ref["head_in"]), cfg,
                                 fire=False)
    np.testing.assert_allclose(pred.numpy(), ref["pred"], atol=PRE_ATOL,
                               rtol=0)
    hc = tl.apply_spiking_dense(params["ctrl_hidden"],
                                torch.tensor(ref["pooled"]), cfg)
    res = spike_mismatch(ref["zc"], hc, tol=TOL)
    assert res["far"] == 0, res
    ctrl = tl.apply_spiking_dense(params["ctrl_out"], torch.tensor(ref["hc"]),
                                  cfg, fire=False, spike_input=True)
    np.testing.assert_allclose(ctrl.numpy(), ref["ctrl"], atol=PRE_ATOL,
                               rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_firing_dense_bias_in_the_launch_matches_jax(ref, seed):
    """A firing dense layer with a non-zero bias (at init it is zero):
    under a "cuda" config (the bias handed to the LIF op, its add in the
    launch; on the CPU the op's plain version) equal to the "torch"
    config's spikes and tape, and within the near-threshold rule of the
    JAX jnp layer."""
    rng = np.random.default_rng(seed)
    jp = dict(ref["jparams"]["ctrl_hidden"])
    jp["bias"] = rng.normal(0.0, 0.5, jp["bias"].shape).astype(np.float32)
    x = rng.normal(0.5, 1.0, ref["pooled"].shape).astype(np.float32)
    z = np.asarray(jl.apply_spiking_dense(jp, x, ref["jcfg"], fire=False))
    p = {k: torch.tensor(v) for k, v in jp.items()}
    got = {}
    for backend in ("torch", "cuda"):
        tape = SparsityTape()
        got[backend] = tl.apply_spiking_dense(p, torch.tensor(x),
                                              _cfg(ref, backend), tape=tape,
                                              tag="ctrl_hidden")
        got[backend + "_tape"] = tape.rates()["ctrl_hidden"]
        np.testing.assert_allclose(
            tl.apply_spiking_dense(p, torch.tensor(x), _cfg(ref, backend),
                                   fire=False).numpy(), z, atol=PRE_ATOL,
            rtol=0)
    assert torch.equal(got["torch"], got["cuda"])
    assert torch.equal(got["torch_tape"], got["cuda_tape"])
    res = spike_mismatch(z, got["cuda"], tol=TOL)
    assert res["far"] == 0, res
    assert 0.0 < float(got["cuda"].mean()) < 1.0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_spike_input_dense_matches_jax(ref, backend):
    """ctrl_out on live spikes (at init ctrl_hidden seldom fires)."""
    cfg, params = _cfg(ref, backend), _params(ref)
    h = (np.random.default_rng(1).random(ref["hc"].shape) < 0.3).astype(
        np.float32)
    want = np.asarray(jl.apply_spiking_dense(
        ref["jparams"]["ctrl_out"], h, ref["jcfg"], fire=False,
        spike_input=True))
    got = tl.apply_spiking_dense(params["ctrl_out"], torch.tensor(h), cfg,
                                 fire=False, spike_input=True)
    np.testing.assert_allclose(got.numpy(), want, atol=PRE_ATOL, rtol=0)


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
    assert float(out.sparsity) == float(want.sparsity)
    assert float(out.tile_skip) == float(want.tile_skip)


def test_layer_rates_and_boxes_match_jax(ref):
    """The sparsity tape (collect_sparsity=True) and the box decoding."""
    out = npu_forward(_params(ref), torch.tensor(ref["vox"]),
                      _cfg(ref, "cuda"), collect_sparsity=True)
    want = ref["out"].layer_rates
    assert sorted(out.layer_rates) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(out.layer_rates[k]), v, atol=1e-6,
                                   err_msg=k)
    jcfg = ref["jcfg"]
    raw = np.random.default_rng(4).normal(
        0, 2, ref["out"].raw_pred.shape).astype(np.float32)
    jb = [np.asarray(a) for a in jax_decode_boxes(raw, jcfg)]
    tb = [a.numpy() for a in decode_boxes(torch.tensor(raw), _cfg(ref,
                                                                  "torch"))]
    np.testing.assert_allclose(tb[0], jb[0], atol=1e-6)
    np.testing.assert_allclose(tb[1], jb[1], atol=1e-6)
    np.testing.assert_array_equal(tb[2], jb[2])


def test_port_init_matches_reference_scales():
    """The port's own init (for the card, which has no JAX): the
    reference's shapes and He-normal scales, reproducible from a seed."""
    jcfg = jax_reduced_snn("spiking_yolo")
    cfg = convert.snn_config(jcfg)
    ref_p = jax.tree_util.tree_map(
        np.asarray, jax_init_npu(jax.random.PRNGKey(0), jcfg))
    a = init_npu(torch.Generator().manual_seed(3), cfg, device="cpu")
    b = init_npu(torch.Generator().manual_seed(3), cfg, device="cpu")
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_p)
    for path, leaf in flat_ref:
        node_a, node_b = a, b
        for k in path:
            node_a, node_b = node_a[k.key], node_b[k.key]
        assert tuple(node_a.shape) == leaf.shape, path
        torch.testing.assert_close(node_a, node_b, rtol=0, atol=0)
        if leaf.ndim >= 2:                    # weights: same scale
            fan_in = int(np.prod(leaf.shape[:-1]))
            std = float(node_a.std())
            assert 0.5 < std / (2.0 / fan_in) ** 0.5 < 1.5, path
