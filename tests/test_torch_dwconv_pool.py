"""Port parity: the depthwise spike conv and the spike max-pool — the
plain versions of the ``spike_dwconv`` and ``max_pool`` kernels, which
their wrappers take for CPU tensors — against the JAX package.

The depthwise conv is held to ``repro.core.layers.spike_conv_jnp
(depthwise=True)`` (and to the JAX kernel op in interpret mode): the
same in-order tap loop, so equal bits on 0/1 spikes (every product is
exact), and atol 1e-6 on real-valued inputs (XLA may contract a
multiply-add).  The pool is held to ``jax.lax.reduce_window`` and to the
JAX ``max_pool_op`` in interpret mode, both gate modes: max has no
rounding, so equal.  Inputs are made from a seed with numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core import layers as jl
from repro.kernels import ops as jops
from repro.kernels.spike_conv import tap_occupancy_mask as jax_tap_mask
from repro_torch import convert
from repro_torch.core import layers as tl
from repro_torch.kernels import ops
from repro_torch.kernels.max_pool import max_pool
from repro_torch.kernels.spike_dwconv import spike_dwconv, tap_occupancy_mask

DENSITIES = (0.0, 0.15, 1.0)


def _spikes(shape, density, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.float32)


def _dw_weights(C, seed, k=3):
    rng = np.random.default_rng(seed + 1000)
    return rng.normal(0, 0.5, (k, k, 1, C)).astype(np.float32)


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("C", [8, 24, 33])
@pytest.mark.parametrize("hw", [(9, 7), (8, 10)])
@pytest.mark.parametrize("stride", [1, 2])
def test_depthwise_conv_bitexact_on_spikes(stride, hw, C, density):
    seed = stride * 100 + hw[0] * 10 + C
    x = _spikes((3,) + hw + (C,), density, seed)
    w = _dw_weights(C, seed)
    want = np.asarray(jl.spike_conv_jnp(x, w, stride=stride, depthwise=True))
    got = tl.spike_conv(torch.tensor(x), torch.tensor(w), stride=stride,
                        depthwise=True)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel wrapper and the op take the plain version on the CPU
    wrapped = spike_dwconv(torch.tensor(x), torch.tensor(w), stride=stride)
    assert torch.equal(wrapped, got)
    assert torch.equal(ops.spike_dwconv_op(torch.tensor(x), torch.tensor(w),
                                           stride=stride), got)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(9, 7), (8, 10)])
def test_depthwise_conv_real_inputs(stride, hw):
    """Real-valued (negative too) activations: the same tap order, the
    reference's ops within 1e-6; also against the textbook lax.conv."""
    rng = np.random.default_rng(hw[0] + stride)
    x = rng.normal(0, 1, (2,) + hw + (24,)).astype(np.float32)
    w = _dw_weights(24, 7)
    want = np.asarray(jl.spike_conv_jnp(x, w, stride=stride, depthwise=True))
    got = tl.spike_conv(torch.tensor(x), torch.tensor(w), stride=stride,
                        depthwise=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    oracle = np.asarray(jl._conv2d(x, w, stride, True, 24))
    np.testing.assert_allclose(got.numpy(), oracle, atol=1e-5, rtol=0)


@pytest.mark.parametrize("density", DENSITIES)
def test_depthwise_conv_matches_jax_kernel_op(density):
    """The JAX kernel path (spike_dwconv_pallas, interpret mode) gives the
    same bits as the port's plain version."""
    x = _spikes((4, 8, 8, 16), density, 5)
    w = _dw_weights(16, 5)
    want = np.asarray(jops.spike_conv_op(x, w, stride=2, depthwise=True))
    got = ops.spike_dwconv_op(torch.tensor(x), torch.tensor(w), stride=2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("density", [0.0, 0.02, 0.15, 1.0])
@pytest.mark.parametrize("bm", [128, 16])
def test_tap_occupancy_mask_matches_jax(density, bm):
    x = _spikes((5, 9, 11, 6), density, 11)
    x[:2] = 0.0                                  # silent frames
    p3, _ = jl.dw_patches(x, 3, 3, 2)
    got_p3, hw = tl.dw_patches(torch.tensor(x), 3, 3, 2)
    np.testing.assert_array_equal(got_p3.numpy(), np.asarray(p3))
    assert hw == (5, 6)
    want = np.asarray(jax_tap_mask(p3, bm=bm))
    got = tap_occupancy_mask(got_p3, bm=bm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_depthwise_wrapper_rejects_bad_input():
    x = torch.zeros(2, 8, 8, 4)
    with pytest.raises(ValueError, match="kh, kw, 1, C"):
        spike_dwconv(x, torch.zeros(3, 3, 4, 4))
    with pytest.raises(ValueError, match="kh, kw, 1, C"):
        spike_dwconv(x, torch.zeros(3, 3, 1, 5))
    with pytest.raises(TypeError, match="float32"):
        spike_dwconv(x.double(), torch.zeros(3, 3, 1, 4).double())
    with pytest.raises(ValueError, match="stride"):
        spike_dwconv(x, torch.zeros(3, 3, 1, 4), stride=0)


def _reduce_window(x, window):
    return np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max, (1, window, window, 1),
        (1, window, window, 1), "VALID"))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("shape", [(4, 8, 10, 6), (3, 9, 7, 5),
                                   (2, 17, 15, 33)])
def test_max_pool_matches_jax(shape, density, gated):
    x = _spikes(shape, density, shape[1] * 10 + shape[3])
    x[0] = 0.0                                   # an all-silent frame
    want = _reduce_window(x, 2)
    got = max_pool(torch.tensor(x), window=2, gated=gated)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jops.max_pool_op(x, window=2, gated=gated)), want)
    assert torch.equal(ops.max_pool_op(torch.tensor(x), window=2,
                                       gated=gated), got)


@pytest.mark.parametrize("window", [2, 3])
def test_max_pool_real_inputs(window):
    """The plain max on real values (negatives, ties) and window 3."""
    rng = np.random.default_rng(window)
    x = np.round(rng.normal(0, 1, (3, 11, 13, 7)), 1).astype(np.float32)
    got = tl.pool_slices(torch.tensor(x), window)
    np.testing.assert_array_equal(got.numpy(), _reduce_window(x, window))
    assert torch.equal(max_pool(torch.tensor(x), window=window,
                                gated=False), got)


@pytest.mark.parametrize("density", DENSITIES)
def test_layer_max_pool_matches_jax(density):
    """``max_pool`` on the [T, B, H, W, C] layout, both port backends,
    against the JAX layer on its jnp path."""
    jcfg = jax_reduced_snn("spiking_vgg")
    x = _spikes((3, 2, 9, 10, 4), density, 3)
    want = np.asarray(jl.max_pool(x, 2, cfg=jcfg))
    for backend in ("torch", "cuda"):
        cfg = dataclasses.replace(convert.snn_config(jcfg), backend=backend)
        got = tl.max_pool(torch.tensor(x), 2, cfg)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tl.max_pool(torch.tensor(x), 2).numpy(),
                                  want)


def test_max_pool_wrapper_rejects_bad_input():
    with pytest.raises(ValueError, match="window"):
        max_pool(torch.zeros(1, 4, 4, 2), window=0)
    with pytest.raises(ValueError, match="window"):
        max_pool(torch.zeros(1, 8, 8, 2), window=5)
    with pytest.raises(ValueError, match=r"\[N, H, W, C\]"):
        max_pool(torch.zeros(4, 4, 2))
    with pytest.raises(TypeError, match="float32"):
        max_pool(torch.zeros(1, 4, 4, 2, dtype=torch.float64))


def _cuda_cfg():
    from repro_torch.configs.registry import reduced_snn
    return dataclasses.replace(reduced_snn("spiking_vgg"), backend="cuda")


@pytest.mark.parametrize("window", [2, 3])
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("shape", [(3, 2, 8, 10, 6), (5, 3, 9, 7, 66)])
def test_layer_max_pool_on_tb_spikes_matches_jax(shape, density, window):
    """layers.max_pool under a "cuda" config (max_pool_op, then the
    max_pool wrapper, which reads the [T, B] spikes where they lie; on
    the CPU its plain version) equals the JAX jnp pool, an all-silent
    frame included."""
    x = _spikes(shape, density, shape[-1] + window)
    x[0, 0] = 0.0
    want = np.asarray(jl.max_pool(jnp.asarray(x), window))
    got = tl.max_pool(torch.tensor(x), window, _cuda_cfg())
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tl.max_pool(torch.tensor(x), window, None), got)


def test_pool_output_folds_as_a_view():
    """The pool writes batch-major and returns its unfold view, so the
    next layer's fold is a view of the pool's output: same storage and
    base pointer, batch-major strides, no copy."""
    from repro_torch.kernels.max_pool import max_pool
    x = torch.tensor(_spikes((5, 3, 8, 8, 4), 0.3, 3))
    y = tl.max_pool(x, 2, _cuda_cfg())
    assert y.shape == (5, 3, 4, 4, 4)
    assert y.stride()[:2] == (4 * 4 * 4, 5 * 4 * 4 * 4)   # [B, T] storage
    f = tl.fold(y)
    assert f.data_ptr() == y.data_ptr()
    assert f.untyped_storage().data_ptr() == y.untyped_storage().data_ptr()
    assert f.is_contiguous() and f.shape == (15, 4, 4, 4)
    yf = max_pool(x)                       # the kernel's own output
    assert yf.is_contiguous() and yf.shape == (15, 4, 4, 4)
    assert torch.equal(ops.max_pool_op(x), tl.unfold(yf, 5, 3))


def test_max_pool_reads_images_where_they_lie():
    """The wrapper's [T, B] entry and its image strides: [T, B]
    contiguous spikes, the unfold view of a batch-major tensor and
    single-step or single-image dims; a layout that is not whole images
    raises (no hidden copy)."""
    from repro_torch.kernels.max_pool import image_strides, max_pool
    x = torch.tensor(_spikes((4, 3, 6, 6, 5), 0.4, 9))
    img = 6 * 6 * 5
    assert image_strides(x) == (3, 1)
    bm = tl.unfold(tl.fold(x).contiguous(), 4, 3)
    assert image_strides(bm) == (1, 4)
    assert image_strides(x[:1]) == (0, 1)
    assert image_strides(x[:, :1]) == (3, 0)
    assert x.stride(1) == img
    want = tl.pool_slices(tl.fold(x), 2)
    for inp in (x, bm):
        assert torch.equal(max_pool(inp), want)
    for bad in (x[:, :, :, ::2], x.permute(0, 1, 3, 2, 4), x[..., :4]):
        with pytest.raises(ValueError, match="not whole"):
            max_pool(bad)
        with pytest.raises(ValueError, match="not whole"):
            ops.max_pool_op(bad)
    # a folded batch of whole images, every other one: read in place
    xf = tl.fold(x)
    assert torch.equal(max_pool(xf[::2]), tl.pool_slices(xf[::2], 2))
    with pytest.raises(ValueError, match="T, B, H, W, C"):
        max_pool(x[0, 0, 0])
    with pytest.raises(ValueError, match="window"):
        max_pool(x, window=5)
    with pytest.raises(TypeError, match="float32"):
        max_pool(x.double())
