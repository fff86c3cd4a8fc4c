"""Port parity: the gradients of every spiking op and of ``npu_forward``
against ``jax.grad`` of the JAX package's jnp path, on the CPU.

Each op runs on both port backends: the kernel op of
``repro_torch.kernels.ops`` (its autograd Function: on CPU tensors the
kernel's plain version forward, the port's own backward) and the plain
``"torch"`` formulation under autograd (the surrogate ``spike``).  The
bar is the one ``tests/test_lif_backend.py`` holds the reference's
custom VJPs to: <= 1e-5 relative (max |diff| over max |want|).  The
fused routes (``spike_conv_lif`` and ``backbone_segment``) run under
forced launch tables.  The pool's tie cases are held exactly: a window's
gradient goes whole to its first maximum in (row, column) order.

Inputs are made with numpy and carried across; the JAX side is jitted
(``jax.grad`` of the jnp path).  Each op's spikes are checked equal to
JAX's (``npu_forward``'s raw_pred within 1e-4) before the gradients are
compared, so a difference is one of gradients, not of a near-threshold
forward flip.
"""
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
from repro.core import layers as jl
from repro.core.lif import lif_scan as jax_lif_scan
from repro.core.lif import spike as jax_spike
from repro.core.npu import npu_forward as jax_npu_forward
from repro.kernels import ops as jops
from repro.kernels.backbone_fuse import LayerSpec as JaxLayerSpec
from repro.kernels.ref import norm_affine_lif_ref
from repro_torch import convert
from repro_torch.core import layers as tl
from repro_torch.core.backbones import fused_route_segments
from repro_torch.core.lif import lif_scan, spike
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.core.train import grads_of, with_leaves
from repro_torch.kernels import ops, tune
from repro_torch.kernels.backbone_fuse import LayerSpec
from repro_torch.kernels.tune import TuningTable
from repro_torch.optim.adamw import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

REL = 1e-5
LIF = dict(tau=2.0, v_th=1.0, v_reset=0.0)


@pytest.fixture(autouse=True)
def _untuned_chain():
    assert tune.chain_is_untuned(), "an earlier test left a table set"
    yield
    leaked = not tune.chain_is_untuned()
    tune.reset()
    assert not leaked, "the test left a table set"


def _maxrel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _spikes(rng, shape, density):
    return (rng.random(shape) < density).astype(np.float32)


def _port_grads(fn, *arrays):
    """(output, grads) of sum(fn(*tensors)) w.r.t. every input."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    gs = torch.autograd.grad(out.sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in gs]


_JAX_MEMO = {}


def _jax_grads(fn, *arrays, key=None):
    """(output, grads) of sum(fn(*arrays)) by jax.grad, in one jit; with
    ``key``, computed once for the backends that share the case."""
    if key is not None and key in _JAX_MEMO:
        return _JAX_MEMO[key]

    def both(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.ones_like(out))
    out, gs = jax.jit(both)(*arrays)
    res = np.asarray(out), [np.asarray(g) for g in gs]
    if key is not None:
        _JAX_MEMO[key] = res
    return res


def _hold(got, want, spikes=True):
    """Outputs equal (spikes) or within 1e-5 (analog), every gradient
    within ``REL`` of JAX's, and the first one not all zero."""
    out_p, g_p = got
    out_j, g_j = want
    if spikes:
        np.testing.assert_array_equal(out_p, out_j)
    else:
        np.testing.assert_allclose(out_p, out_j, atol=1e-5, rtol=0)
    for gp, gj in zip(g_p, g_j):
        assert gp.shape == gj.shape
        assert _maxrel(gp, gj) <= REL
    assert float(np.abs(g_p[0]).sum()) > 0


# ---------------------------------------------------------------------------
# the surrogate spike and the LIF scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("beta", [4.0, 2.0, 10.0])
def test_spike_surrogate_matches_jax(beta):
    x = np.random.default_rng(1).normal(0, 1, (257,)).astype(np.float32)
    x[:3] = (0.0, -0.0, 1e-8)
    got = _port_grads(lambda t: spike(t, beta) * 1.5, x)
    want = _jax_grads(lambda a: jax_spike(a, beta) * 1.5, x)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1][0], want[1][0], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("tau,beta", [(2.0, 4.0), (3.0, 2.0)])
def test_lif_scan_grads_match_jax(backend, tau, beta):
    """lif_scan_op with a dense layer's bias in the launch (the kernel
    op) and the plain scan of currents + bias, vs the reference's
    lif_scan of currents + bias (test_lif_backend.py:55)."""
    rng = np.random.default_rng(3)
    cur = rng.normal(0.8, 0.5, (4, 3, 40)).astype(np.float32)
    bias = rng.normal(0, 0.3, (40,)).astype(np.float32)
    wv = rng.normal(0, 1, cur.shape).astype(np.float32)
    lif = dict(LIF, tau=tau)
    if backend == "cuda":
        def fn(c, b):
            return ops.lif_scan_op(c, bias=b, beta=beta, **lif) \
                * torch.tensor(wv)
    else:
        def fn(c, b):
            return lif_scan(c + b, beta=beta, **lif) * torch.tensor(wv)
    got = _port_grads(fn, cur, bias)
    want = _jax_grads(lambda c, b: jax_lif_scan(
        c + b, beta=beta, **lif) * wv, cur, bias, key=("lif", tau, beta))
    _hold(got, want)
    assert float(np.abs(got[1][1]).sum()) > 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("T,B,HW,C", [(3, 2, 48, 12), (5, 1, 100, 8),
                                      (2, 4, 33, 24)])
def test_norm_affine_lif_grads_match_jax(backend, T, B, HW, C):
    """test_lif_backend.py:84's grads (y, scale, bias) on the forward
    shapes of :69."""
    rng = np.random.default_rng(T * 100 + C)
    y = rng.normal(0.3, 1.0, (T, B, HW, C)).astype(np.float32)
    scale = rng.normal(1, 0.2, (C,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (C,)).astype(np.float32)
    wv = rng.normal(0, 1, y.shape).astype(np.float32)
    if backend == "cuda":
        def fn(y, s, b):
            return ops.norm_affine_lif_op(y, s, b, **LIF) * torch.tensor(wv)
    else:
        def fn(y, s, b):
            return lif_scan(tl.instance_norm_affine(y, s, b), **LIF) \
                * torch.tensor(wv)
    _hold(_port_grads(fn, y, scale, bias),
          _jax_grads(lambda y, s, b: norm_affine_lif_ref(y, s, b) * wv,
                     y, scale, bias, key=("norm", T, B, HW, C)))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("M,K,N,density", [(24, 64, 8, 0.3),
                                           (130, 257, 129, 0.05)])
def test_spike_matmul_grads_match_jax(backend, M, K, N, density):
    """test_lif_backend.py:140: sum(sin(x @ w)), both adjoints."""
    rng = np.random.default_rng(M)
    x = _spikes(rng, (M, K), density)
    w = rng.normal(0, 1, (K, N)).astype(np.float32)
    mm = ops.spike_matmul_op if backend == "cuda" else tl.blocked_matmul
    _hold(_port_grads(lambda x, w: torch.sin(mm(x, w)), x, w),
          _jax_grads(lambda x, w: jnp.sin(x @ w), x, w,
                     key=("mm", M, K, N)), spikes=False)


# (kernel, stride, cin, cout): 3x3 and 1x1 at strides 1 and 2
# (test_spike_conv.py:134, test_tune.py:139)
CONV_CASES = [(3, 1, 12, 20), (3, 2, 12, 20), (1, 1, 12, 20), (1, 2, 7, 5)]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", CONV_CASES)
def test_spike_conv_grads_match_jax(backend, case):
    k, stride, cin, cout = case
    rng = np.random.default_rng(k * 10 + stride)
    xf = _spikes(rng, (4, 11, 13, cin), 0.2)
    w = rng.normal(0, 0.5, (k, k, cin, cout)).astype(np.float32)
    if backend == "cuda":
        def conv(x, w):
            return ops.spike_conv_op(x, w, stride=stride)
    else:
        def conv(x, w):
            return tl.spike_conv(x, w, stride=stride)
    _hold(_port_grads(lambda x, w: torch.sin(conv(x, w)), xf, w),
          _jax_grads(lambda x, w: jnp.sin(jl.spike_conv_jnp(
              x, w, stride=stride)), xf, w, key=("conv", case)),
          spikes=False)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (5, 2)])
def test_spike_dwconv_grads_match_jax(backend, k, stride):
    """test_spike_conv.py:134's depthwise case, and other kernels."""
    rng = np.random.default_rng(k * 10 + stride + 1)
    xf = _spikes(rng, (4, 11, 13, 12), 0.2)
    w = rng.normal(0, 0.5, (k, k, 1, 12)).astype(np.float32)
    if backend == "cuda":
        def conv(x, w):
            return ops.spike_dwconv_op(x, w, stride=stride)
    else:
        def conv(x, w):
            return tl.spike_conv(x, w, stride=stride, depthwise=True)
    _hold(_port_grads(lambda x, w: torch.sin(conv(x, w)), xf, w),
          _jax_grads(lambda x, w: jnp.sin(jl.spike_conv_jnp(
              x, w, stride=stride, depthwise=True)), xf, w,
              key=("dw", k, stride)), spikes=False)


# ---------------------------------------------------------------------------
# whole layers: conv -> norm -> LIF on both routes, segments, pools
# ---------------------------------------------------------------------------

def _layer_inputs(rng, T, B, H, W, cin, cout, k=3, depthwise=False):
    x = _spikes(rng, (T, B, H, W, cin), 0.2)
    w = rng.normal(0, 0.5, (k, k, 1 if depthwise else cin,
                            cin if depthwise else cout)).astype(np.float32)
    n = cin if depthwise else cout
    scale = rng.normal(1, 0.2, (n,)).astype(np.float32)
    bias = rng.normal(0, 0.2, (n,)).astype(np.float32)
    return x, w, scale, bias


def _conv_lif_key(x, w, stride):
    T, B, H, W, _ = x.shape
    kh = w.shape[0]
    Ho, Wo = (-(-H // stride), -(-W // stride))
    return tune.shape_key("conv_lif", T=T, B=B, HW=Ho * Wo,
                          K=kh * kh * w.shape[2], N=w.shape[3])


# (route, stride, kernel, depthwise): a depthwise layer has no fused
# conv->LIF route
LAYER_CASES = [(r, s, k, False) for r in ("torch", "per_op", "fused")
               for s, k in ((1, 3), (2, 3), (1, 1))] + \
    [(r, 2, 3, True) for r in ("torch", "per_op")]


@pytest.mark.parametrize("route,stride,k,depthwise", LAYER_CASES)
def test_spiking_conv_layer_grads_match_jax(route, stride, k, depthwise):
    """apply_spiking_conv, conv + norm + LIF surrogate (test_spike_conv.py
    :153, test_tune.py:213): the plain layer, the per-op pair and the
    fused conv->LIF kernel op under a forced table, vs the jnp layer."""
    rng = np.random.default_rng(stride * 7 + k)
    x, w, scale, bias = _layer_inputs(rng, 3, 2, 12, 12, 4, 8, k=k,
                                      depthwise=depthwise)
    wv = rng.normal(0, 1, (3, 2, -(-12 // stride), -(-12 // stride),
                           4 if depthwise else 8)).astype(np.float32)
    jcfg = jax_reduced_snn("spiking_vgg")
    cfg = dataclasses.replace(convert.snn_config(jcfg),
                              backend="torch" if route == "torch" else "cuda")
    table = (ops.fused_conv_lif_table([_conv_lif_key(x, w, stride)])
             if route == "fused" else None)

    def fn(x, w, s, b):
        return tl.apply_spiking_conv({"w": w, "scale": s, "bias": b}, x, cfg,
                                     stride=stride, depthwise=depthwise) \
            * torch.tensor(wv)
    with tune.pinned(table):
        got = _port_grads(fn, x, w, scale, bias)
    want = _jax_grads(lambda x, w, s, b: jl.apply_spiking_conv(
        {"w": w, "scale": s, "bias": b}, x, jcfg, stride=stride,
        depthwise=depthwise) * wv, x, w, scale, bias,
        key=("layer", stride, k, depthwise))
    _hold(got, want)
    assert float(np.abs(got[1][1]).sum()) > 0


def test_fused_conv_lif_grads_equal_per_op_pair():
    """The fused route's backward is the pair's: the same arithmetic on
    the same saved spikes, so equal grads."""
    rng = np.random.default_rng(11)
    x, w, scale, bias = _layer_inputs(rng, 3, 2, 13, 11, 6, 10)
    xf = tl.fold(torch.tensor(x)).numpy()
    wv = torch.tensor(rng.normal(0, 1, (3, 2, 7, 6, 10)).astype(np.float32))

    def fn(x, w, s, b):
        return ops.spike_conv_lif_op(x, w, s, b, T=3, B=2, stride=2, **LIF) \
            * wv
    per_op = _port_grads(fn, xf, w, scale, bias)
    with tune.pinned(ops.fused_conv_lif_table(
            [_conv_lif_key(torch.tensor(x), w, 2)])):
        fused = _port_grads(fn, xf, w, scale, bias)
    np.testing.assert_array_equal(fused[0], per_op[0])
    for a, b in zip(fused[1], per_op[1]):
        np.testing.assert_array_equal(a, b)


SEGMENTS = {
    # 3x3 conv with a pool, 3x3, 1x1 (test_backbone_fuse.py:171, :218)
    "conv_pool": (JaxLayerSpec(name="", cin=2, cout=8),
                  JaxLayerSpec(name="", cin=8, cout=8, pool=2),
                  JaxLayerSpec(name="", kernel=1, cin=8, cout=16)),
    # MobileNet's stride-2 depthwise and 1x1 (test_backbone_fuse.py:245)
    "depthwise": (JaxLayerSpec(name="", stride=2, depthwise=True, cin=6,
                               cout=6),
                  JaxLayerSpec(name="", kernel=1, cin=6, cout=12)),
}


def _port_specs(jspecs):
    return tuple(LayerSpec(name=s.name, cin=s.cin, cout=s.cout,
                           kernel=s.kernel, stride=s.stride,
                           depthwise=s.depthwise, pool=s.pool)
                 for s in jspecs)


@pytest.mark.parametrize("route", ["torch", "per_layer", "fused"])
@pytest.mark.parametrize("seg", sorted(SEGMENTS))
def test_backbone_segment_grads_match_jax(route, seg):
    """backbone_segment_op on the per-layer route and on the segment
    kernel (forced table), and the plain per-layer layers, vs jax.grad of
    the reference's jnp segment composition (``_segment_ref``)."""
    jspecs = SEGMENTS[seg]
    specs = _port_specs(jspecs)
    rng = np.random.default_rng(len(seg))
    x = _spikes(rng, (3, 2, 12, 12, jspecs[0].cin), 0.15)
    flat = []
    for s in jspecs:
        n = s.cin if s.depthwise else s.cout
        flat += [rng.normal(0, 0.4, (s.kernel, s.kernel,
                                     1 if s.depthwise else s.cin, n)
                            ).astype(np.float32),
                 rng.normal(1, 0.2, (n,)).astype(np.float32),
                 rng.normal(0, 0.2, (n,)).astype(np.float32)]
    cfg = dataclasses.replace(convert.snn_config(
        jax_reduced_snn("spiking_vgg")),
        backend="torch" if route == "torch" else "cuda")

    def fn(x, *flat):
        params = [flat[i:i + 3] for i in range(0, len(flat), 3)]
        if route == "torch":
            for (w, s_, b), s in zip(params, specs):
                x = tl.apply_spiking_conv({"w": w, "scale": s_, "bias": b},
                                          x, cfg, stride=s.stride,
                                          depthwise=s.depthwise)
                if s.pool:
                    x = tl.max_pool(x, s.pool)
            return x * x
        out = ops.backbone_segment_op(x, params, specs=specs, **LIF)
        return out * out
    table = None
    if route == "fused":
        T, B, H, W, _ = x.shape
        key = tune.shape_key("backbone_seg", **ops.segment_dims(
            specs, T=T, B=B, H=H, W=W))
        table = ops.fused_segment_table([key])
        assert key in table.entries
    with tune.pinned(table):
        got = _port_grads(fn, x, *flat)

    def jfn(x, *flat):
        params = tuple(tuple(flat[i:i + 3]) for i in range(0, len(flat), 3))
        out = jops._segment_ref(x, params, jspecs, beta=4.0, **LIF)
        return out * out
    want = _jax_grads(jfn, x, *flat, key=("seg", seg))
    _hold(got, want)
    assert float(np.abs(got[1][1]).sum()) > 0


def _pool_window_grads(window_vals, backend):
    """The gradient of one 2x2 window's max w.r.t. its four inputs."""
    x = np.asarray(window_vals, np.float32).reshape(1, 1, 2, 2, 1)
    if backend == "cuda":
        fn = lambda t: ops.max_pool_op(t, window=2)       # noqa: E731
    else:
        fn = lambda t: tl.max_pool(t, 2)                  # noqa: E731
    return _port_grads(fn, x)[1][0].reshape(4)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("window,want", [
    ((0, 0, 0, 0), (1, 0, 0, 0)),          # all silent: the first element
    ((0, 1, 1, 0), (0, 1, 0, 0)),          # two spikes: the first in order
    ((1, 1, 1, 1), (1, 0, 0, 0)),
    ((0, 0, 0, 1), (0, 0, 0, 1))])
def test_max_pool_tie_grads_exact(backend, window, want):
    """The reference's reduce_window VJP gives a window's gradient whole
    to its first maximum in (row, column) order; a chain of
    torch.maximum would split ties ([0.125, 0.125, 0.25, 0.5] on a
    silent window)."""
    x = jnp.asarray(np.asarray(window, np.float32).reshape(1, 1, 2, 2, 1))
    jgrad = np.asarray(jax.grad(lambda v: jnp.sum(jl.max_pool(v, 2)))(x))
    np.testing.assert_array_equal(jgrad.reshape(4), np.asarray(want))
    np.testing.assert_array_equal(_pool_window_grads(window, backend),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shape,window", [((3, 2, 6, 6, 4), 2),
                                          ((2, 3, 7, 9, 5), 2),
                                          ((2, 2, 9, 9, 3), 3)])
def test_max_pool_grads_exact(backend, shape, window):
    """Spikes in [T, B] order, ragged tails included: every gradient
    equal to JAX's (test_backbone_fuse.py:330's sum(pool(2 v)^2))."""
    rng = np.random.default_rng(sum(shape))
    x = _spikes(rng, shape, 0.3)
    if backend == "cuda":
        pool = lambda t: ops.max_pool_op(t, window=window)  # noqa: E731
    else:
        pool = lambda t: tl.max_pool(t, window)             # noqa: E731
    got = _port_grads(lambda t: pool(t * 2.0) ** 2, x)
    want = _jax_grads(lambda v: jl.max_pool(v * 2.0, window) ** 2, x,
                      key=("pool", shape, window))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1][0], want[1][0])


def test_max_pool_op_folded_entry_grads():
    """The [N, H, W, C] entry of max_pool_op takes the same rule."""
    rng = np.random.default_rng(5)
    xf = _spikes(rng, (4, 6, 6, 3), 0.3)
    got = _port_grads(lambda t: ops.max_pool_op(t, window=2) * 3.0, xf)
    want = _jax_grads(lambda v: jops._pool_ref(v, 2) * 3.0, xf)
    np.testing.assert_array_equal(got[1][0], want[1][0])


# ---------------------------------------------------------------------------
# npu_forward: every parameter leaf, all four backbones
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(JAX_ARCHS))
def npu_ref(request):
    """The JAX params, voxels and jax.grad of the reference's loss on the
    jnp path (test_lif_backend.py:208), once per arch."""
    jcfg = jax_reduced_snn(request.param)
    # the port's He-normal init, carried to JAX as numpy (the JAX init
    # runs eagerly, op by op: 5-15 s an arch)
    params = jax.tree_util.tree_map(jnp.asarray, _numpy_tree(init_npu(
        torch.Generator().manual_seed(1), convert.snn_config(jcfg),
        device="cpu")))
    rng = np.random.default_rng(7)
    vox = _spikes(rng, (jcfg.time_steps, 2, jcfg.height, jcfg.width,
                        jcfg.in_channels), 0.1)

    def loss(p):
        out = jax_npu_forward(p, vox, jcfg)
        return (jnp.sum(jnp.sin(out.raw_pred)) + jnp.sum(out.control),
                out.raw_pred)
    (_, raw), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    return dict(jcfg=jcfg, vox=vox,
                params=jax.tree_util.tree_map(np.asarray, params),
                grads=dict(tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                              grads))),
                raw=np.asarray(raw))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _npu_grads(ref, backend, table=None):
    cfg = dataclasses.replace(convert.snn_config(ref["jcfg"]),
                              backend=backend)
    p, leaves = with_leaves(convert.params_from_numpy(ref["params"],
                                                      device="cpu"))
    with tune.pinned(table):
        out = npu_forward(p, torch.tensor(ref["vox"]), cfg)
        loss = torch.sin(out.raw_pred).sum() + out.control.sum()
        grads = grads_of(loss, p, leaves)
    return out, grads


def _hold_npu(ref, out, grads):
    np.testing.assert_allclose(out.raw_pred.detach().numpy(), ref["raw"],
                               atol=1e-4, rtol=0)
    worst = {k: _maxrel(g.numpy(), ref["grads"][k])
             for k, g in tree_leaves(grads)}
    assert set(worst) == set(ref["grads"])
    assert max(worst.values()) <= REL, sorted(worst.items(),
                                              key=lambda kv: -kv[1])[:3]
    assert sum(float(g.abs().sum()) for _, g in tree_leaves(grads)) > 0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_npu_forward_grads_match_jax(npu_ref, backend):
    out, grads = _npu_grads(npu_ref, backend)
    _hold_npu(npu_ref, out, grads)


@pytest.mark.parametrize("route", ["fused", "segment"])
def test_npu_forward_fused_routes_grads_match_jax(npu_ref, route):
    """The forced-fused table (every firing conv on spike_conv_lif) and
    the forced-segment table (every fused-route segment on
    backbone_segment), as the card's train phase runs them."""
    cfg = dataclasses.replace(convert.snn_config(npu_ref["jcfg"]),
                              backend="cuda")
    params = convert.params_from_numpy(npu_ref["params"], device="cpu")
    if route == "fused":
        keys = [tune.shape_key("conv_lif", **d)
                for d in chip_smoke.conv_lif_dims(params, cfg, 2)]
        table = ops.fused_conv_lif_table(keys)
    else:
        segs = fused_route_segments(cfg, 2)
        if not segs:
            pytest.skip(f"{cfg.name}: no fused-route segment at this size")
        table = ops.fused_segment_table([k for *_, k in segs])
    out, grads = _npu_grads(npu_ref, "cuda", table)
    _hold_npu(npu_ref, out, grads)


def test_sweep_under_grad_records_nothing():
    """A tuning sweep inside a grad step runs its candidates under
    no_grad: the step's grads equal the untuned route's."""
    from repro_torch.configs.base import TuneConfig
    rng = np.random.default_rng(2)
    x, w, scale, bias = _layer_inputs(rng, 3, 2, 8, 8, 4, 8)
    xf = tl.fold(torch.tensor(x)).numpy()

    def fn(x, w, s, b):
        return ops.spike_conv_lif_op(x, w, s, b, T=3, B=2, **LIF) ** 2
    want = _port_grads(fn, xf, w, scale, bias)
    smoke = TuneConfig(name="test", reps=1, prune_to=2, max_candidates=64)
    with tune.tuning(TuningTable(), smoke) as swept:
        got = _port_grads(fn, xf, w, scale, bias)
    assert any(k.startswith("conv_lif|") for k in swept.entries)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
