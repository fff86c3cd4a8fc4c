"""The port's MLA (``repro_torch.models.attention``: ``init_mla``,
``apply_mla``, ``decode_mla``, ``MLACache``) against the JAX package's
in float32 on reduced deepseek-v3 (d = 16 nope + 8 rope dims, dv 16, a
16-dim latent), weights drawn by the reference's ``init_mla`` and
carried across as numpy.

Tolerance: 1e-5 absolute and relative for the output, the prefill's
(c_kv, k_rope) and the cache the decode writes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.distributed.sharding import MeshAxes
from repro.models import attention as jattn
from repro_torch.configs import registry
from repro_torch.models import attention

AX = MeshAxes()
TOL = 1e-5
ARCH = "deepseek-v3-671b"


@functools.lru_cache(maxsize=None)
def mla():
    """(JAX cfg, port cfg, JAX params, port params) of one MLA mixer."""
    jcfg = dataclasses.replace(jreg.reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(registry.reduced(ARCH), dtype="float32")
    jp = jattn.init_mla(jax.random.PRNGKey(2), jcfg, dtype=jnp.float32)
    p = {"mla": {k: torch.tensor(np.asarray(v))
                 for k, v in jp["mla"].items()}}
    return jcfg, cfg, jp, p


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_init_mla_matches_reference_shapes():
    jcfg, cfg, _, _ = mla()
    want = jax.eval_shape(lambda: jattn.init_mla(jax.random.PRNGKey(0),
                                                 jcfg))["mla"]
    p = attention.init_mla(torch.Generator().manual_seed(0), cfg)["mla"]
    assert set(p) == set(want)
    for k, t in p.items():
        assert tuple(t.shape) == want[k].shape and t.dtype == torch.bfloat16
        fan_in = t.shape[0]
        assert abs(float(t.float().std()) * fan_in ** 0.5 - 1) < 0.1, k


@pytest.mark.parametrize("S", [12, 37])
def test_apply_mla_return_kv(S):
    jcfg, cfg, jp, p = mla()
    x = np.random.default_rng(S).normal(0, 1, (2, S, cfg.d_model)).astype(
        np.float32)
    jout, (jc, jkr) = jattn.apply_mla(jp, jnp.asarray(x), jnp.arange(S),
                                      jcfg, AX, return_kv=True)
    out, (c, kr) = attention.apply_mla(p, torch.tensor(x), torch.arange(S),
                                       cfg, return_kv=True)
    m = cfg.mla
    assert tuple(c.shape) == (2, S, m.kv_lora_rank)
    assert tuple(kr.shape) == (2, S, m.qk_rope_head_dim)
    for got, want in ((out, jout), (c, jc), (kr, jkr)):
        close(got, want)
    close(attention.apply_mla(p, torch.tensor(x), torch.arange(S), cfg),
          jout)


@pytest.mark.parametrize("pos", ["scalar", "per-slot"])
def test_decode_mla(pos):
    """The output and the written cache; the per-slot vector has an
    inactive slot (-1), which writes nothing, and a slot at the cache's
    last row."""
    jcfg, cfg, jp, p = mla()
    m = cfg.mla
    B, S = 3, 10
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
    cc = rng.normal(0, 1, (B, S, m.kv_lora_rank)).astype(np.float32)
    krc = rng.normal(0, 1, (B, S, m.qk_rope_head_dim)).astype(np.float32)
    posv = np.int32(6) if pos == "scalar" else np.array([6, -1, S - 1],
                                                        np.int32)
    jout, jcache = jattn.decode_mla(
        jp, jnp.asarray(x), jattn.MLACache(jnp.asarray(cc), jnp.asarray(krc)),
        jnp.asarray(posv), jcfg, AX)
    out, cache = attention.decode_mla(
        p, torch.tensor(x),
        attention.MLACache(torch.tensor(cc), torch.tensor(krc)),
        torch.tensor(posv), cfg)
    assert isinstance(cache, attention.MLACache)
    assert bool(torch.isfinite(out).all())
    close(out, jout)
    for got, want in zip(cache, jcache):
        close(got, want)
    if pos == "per-slot":
        np.testing.assert_array_equal(cache.c_kv[1].numpy(), cc[1])
        np.testing.assert_array_equal(cache.k_rope[1].numpy(), krc[1])


def test_decode_mla_writes_the_cache_in_place():
    _, cfg, _, p = mla()
    m = cfg.mla
    cache = attention.MLACache(torch.zeros(2, 8, m.kv_lora_rank),
                               torch.zeros(2, 8, m.qk_rope_head_dim))
    x = torch.ones(2, 1, cfg.d_model)
    _, out = attention.decode_mla(p, x, cache, 3, cfg)
    assert out.c_kv is cache.c_kv and out.k_rope is cache.k_rope
    assert bool(cache.c_kv[:, 3].abs().sum(-1).gt(0).all())
    assert float(cache.c_kv[:, :3].abs().sum()) == 0.0


def test_mla_under_a_mesh_raises():
    _, cfg, _, p = mla()
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="item 5.7"):
        attention.apply_mla(p, x, torch.arange(4), cfg, mesh=object())
    m = cfg.mla
    cache = attention.MLACache(torch.zeros(1, 8, m.kv_lora_rank),
                               torch.zeros(1, 8, m.qk_rope_head_dim))
    with pytest.raises(NotImplementedError, match="item 5.7"):
        attention.decode_mla(p, x[:, :1], cache, 0, cfg, mesh=object())
