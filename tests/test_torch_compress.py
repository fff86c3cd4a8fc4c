"""The port's int8 block quantisation (``repro_torch.distributed.compress``)
held bit for bit to the reference's ``repro.distributed.compress``: the
int8 blocks, the float32 scales and the dequantised values, over the
case list of ``tests/test_properties.py:33-43`` (``normal(0, 3, (n,))``,
n in 10..2000, seeds up to 2**20), plus an all-zero block, a 2-D
gradient, lengths around the 256-wide block and exact .5 ties (both
round half to even); and the reference property's error bound (scale/2
an element) on the port's side.  Multi-rank ``compressed_psum`` and the
manual data-parallel step run in tests/test_torch_distributed.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compress as ref
from repro_torch.distributed import compress

CASES = [(0, 10), (1, 255), (2, 256), (3, 257), (7, 1000), (11, 2000),
         (2 ** 20, 1999), (12345, 513), (99, 1)]


def _both(x: np.ndarray):
    q, s = compress.quantize_int8(torch.from_numpy(x))
    d = compress.dequantize_int8(q, s, x.shape)
    jq, js = ref.quantize_int8(jnp.asarray(x))
    jd = ref.dequantize_int8(jq, js, x.shape)
    return (q.numpy(), s.numpy(), d.numpy()), \
        (np.asarray(jq), np.asarray(js), np.asarray(jd))


def _bit_equal(got, want):
    for g, w, name in zip(got, want, ("q", "scale", "deq")):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name


@pytest.mark.parametrize("seed,n", CASES)
def test_quantize_bit_equal_to_reference(seed, n):
    g = np.random.default_rng(seed).normal(0, 3, (n,)).astype(np.float32)
    got, want = _both(g)
    _bit_equal(got, want)
    q, s, d = got
    assert compress.BLOCK == ref.BLOCK == 256
    assert q.shape == (-(-n // 256), 256) and q.dtype == np.int8
    # the reference property: |deq - g| <= scale / 2 an element
    bound = np.repeat(s[:, 0] / 2 + 1e-7, 256)[:n]
    assert (np.abs(d - g) <= bound + 1e-6).all()


@pytest.mark.parametrize("x", [
    np.zeros(300, np.float32),                               # all-zero
    np.concatenate([np.zeros(256, np.float32),
                    np.linspace(-2, 2, 100, dtype=np.float32)]),
    np.random.default_rng(5).normal(0, 1e-3, (7, 45)).astype(np.float32),
    np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
             np.float32),                                    # .5 ties
], ids=["zeros", "zero-block", "2d", "ties"])
def test_quantize_edge_cases_bit_equal(x):
    got, want = _both(x)
    _bit_equal(got, want)
    if not x.any():
        assert not got[0].any() and not got[2].any()


def test_ties_round_half_to_even():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                 np.float32)
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert float(s[0, 0]) == 1.0
    assert q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]


def test_compressed_psum_without_a_group_is_local():
    """No process group: the sum is the local dequantised value and the
    residual what quantisation dropped (error feedback's carry)."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 2, (5, 100)).astype(np.float32))
    s, r = compress.compressed_psum(x, None)
    q, sc = compress.quantize_int8(x)
    assert torch.equal(s, compress.dequantize_int8(q, sc, x.shape))
    assert torch.equal(r, x - s)
