"""The port's MoE (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe`` in float32 on ``reduced(...)`` configurations,
weights drawn by the reference's ``init_moe`` and carried across as
numpy.

Tolerances: the router's probabilities and renormalised weights at 1e-6
and its top-k indices exact (a token whose k-th and (k+1)-th
probabilities lie within 1e-6 of each other may order them either way:
such a token is named and left out of the index check); the dispatch's
slots bit-equal; the combine and the layer's output at 1e-5 relative to
the largest magnitude; the aux loss within 1e-6.
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
from repro.models import moe as jmoe
from repro_torch.configs import registry
from repro_torch.models import moe

AX = MeshAxes()
TOL = 1e-5
ROUTE_TOL = 1e-6
AUX_TOL = 1e-6
ARCHS = ["arctic-480b", "deepseek-v3-671b"]


def assert_rel(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < tol, rel


def _cfgs(arch, **moe_changes):
    """(JAX cfg, port cfg) of reduced ``arch`` in float32, ``moe_changes``
    applied to both MoE configs."""
    out = []
    for reg in (jreg, registry):
        c = dataclasses.replace(reg.reduced(arch), dtype="float32")
        out.append(dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, **moe_changes)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _params(arch, **moe_changes):
    """(JAX cfg, port cfg, JAX params, port params) of one MoE layer."""
    jcfg, cfg = _cfgs(arch, **moe_changes)
    jp = jmoe.init_moe(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    p = {"moe": {k: torch.tensor(v) for k, v in tree["moe"].items()}}
    return jcfg, cfg, jp, p


def _x(T, D, seed):
    return np.random.default_rng(seed).normal(0, 1, (T, D)).astype(
        np.float32)


def _jax_route(x2d, router, top_k):
    """The reference's routing, as its ``_moe_local`` computes it."""
    probs = jax.nn.softmax(jnp.asarray(x2d) @ jnp.asarray(router), axis=-1)
    top_w, top_idx = jax.lax.top_k(probs, top_k)
    top_w = top_w / jnp.maximum(jnp.sum(top_w, axis=-1, keepdims=True),
                                1e-9)
    return np.asarray(top_idx), np.asarray(top_w), np.asarray(probs)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

# (E, K, T, seed): reduced widths, and the full configs' expert counts
ROUTES = [(4, 2, 64, 0), (4, 2, 64, 1), (128, 2, 96, 2), (256, 8, 96, 3)]


@pytest.mark.parametrize("E,K,T,seed", ROUTES)
def test_route_matches_reference(E, K, T, seed):
    D = 64
    rng = np.random.default_rng(seed)
    x = _x(T, D, seed)
    router = rng.normal(0, D ** -0.5, (D, E)).astype(np.float32)
    j_idx, j_w, j_probs = _jax_route(x, router, K)
    idx, w, probs = moe.route(torch.tensor(x), torch.tensor(router), K)
    np.testing.assert_allclose(probs.numpy(), j_probs, atol=ROUTE_TOL,
                               rtol=ROUTE_TOL)
    np.testing.assert_allclose(w.numpy(), j_w, atol=ROUTE_TOL,
                               rtol=ROUTE_TOL)
    # a near-tie at the k-th place may order either way: name it
    srt = -np.sort(-j_probs, axis=-1)
    gaps = np.abs(np.diff(srt[:, :K + 1], axis=-1)).min(axis=-1)
    ties = np.flatnonzero(gaps < ROUTE_TOL)
    exact = np.setdiff1d(np.arange(T), ties)
    np.testing.assert_array_equal(idx.numpy()[exact], j_idx[exact],
                                  err_msg=f"near-tied tokens {ties}")
    assert idx.dtype == torch.int64 and w.dtype == torch.float32


# ---------------------------------------------------------------------------
# dispatch and combine on the reference's own routing
# ---------------------------------------------------------------------------

# (T, K, E, cap_e, e_lo, e_hi, drops): room for every pair; capacity
# overflow (pairs dropped); a shard's slice of the experts
DISPATCHES = [(32, 2, 4, 32, 0, 4, False), (32, 2, 4, 5, 0, 4, True),
              (40, 2, 8, 3, 2, 6, True), (24, 8, 16, 24, 0, 16, False)]


def _routing(T, K, E, seed):
    """The reference's top-K of a softmax over seeded logits, skewed
    toward expert 0 so that a small capacity binds."""
    logits = np.random.default_rng(seed).normal(0, 1, (T, E)).astype(
        np.float32)
    logits[:, 0] += 1.5
    return _jax_route(logits, np.eye(E, dtype=np.float32), K)[:2]


@pytest.mark.parametrize("T,K,E,cap_e,e_lo,e_hi,drops", DISPATCHES)
def test_dispatch_and_combine_match_reference(T, K, E, cap_e, e_lo, e_hi,
                                              drops):
    D = 16
    top_idx, top_w = _routing(T, K, E, seed=T + E)
    x = _x(T, D, seed=5)
    E_loc = e_hi - e_lo
    j_xe, j_info = jmoe._dispatch_local(
        jnp.asarray(x), jnp.asarray(top_idx), jnp.asarray(top_w), e_lo, e_hi,
        cap_e, E_loc)
    xe, info = moe._dispatch_local(
        torch.tensor(x), torch.tensor(top_idx, dtype=torch.int64),
        torch.tensor(top_w), e_lo, e_hi, cap_e, E_loc)
    for got, want in zip(info, j_info):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xe.numpy(), np.asarray(j_xe))
    # the pairs kept: each local expert's first cap_e
    counts = np.bincount(top_idx.reshape(-1), minlength=E)[e_lo:e_hi]
    assert int(info[2].sum()) == int(np.minimum(counts, cap_e).sum())
    assert bool((counts > cap_e).any()) == drops
    ye = np.random.default_rng(6).normal(0, 1, (E_loc, cap_e, D)).astype(
        np.float32)
    want = jmoe._combine_local(jnp.asarray(ye), j_info, T, D)
    got = moe._combine_local(torch.tensor(ye), info, T, D)
    assert got.dtype == torch.float32
    assert_rel(got, want)


# ---------------------------------------------------------------------------
# the layer: arctic's dense residual, deepseek's shared expert
# ---------------------------------------------------------------------------

LAYERS = [("arctic-480b", {}), ("deepseek-v3-671b", {}),
          ("arctic-480b", {"capacity_factor": 0.25}),      # pairs dropped
          ("deepseek-v3-671b", {"capacity_factor": 0.25})]


@pytest.mark.parametrize("arch,changes", LAYERS,
                         ids=[f"{a}-{'drop' if c else 'room'}"
                              for a, c in LAYERS])
def test_apply_moe_matches_reference(arch, changes):
    jcfg, cfg, jp, p = _params(arch, **changes)
    B, S = 2, 32
    x = np.random.default_rng(7).normal(0, 1, (B, S, cfg.d_model)).astype(
        np.float32)
    j_out, j_aux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, AX)
    out, aux = moe.apply_moe(p, torch.tensor(x), cfg)
    assert_rel(out, j_out)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert abs(float(aux) - float(j_aux)) < AUX_TOL
    # the experts alone on the reference's own routing
    x2d = x.reshape(B * S, -1)
    top_idx, top_w, _ = _jax_route(x2d, np.asarray(jp["moe"]["router"]),
                                   cfg.moe.top_k)
    got = moe.experts(torch.tensor(x2d), p["moe"], cfg,
                      torch.tensor(top_idx, dtype=torch.int64),
                      torch.tensor(top_w))
    assert_rel(got, np.asarray(j_out).reshape(B * S, -1))
    cap = moe.capacity(B * S, cfg)
    assert cap == int(max(8, -(-B * S * cfg.moe.top_k // cfg.moe.num_experts)
                          * cfg.moe.capacity_factor))
    if changes:                 # the small capacity drops pairs
        counts = np.bincount(top_idx.reshape(-1),
                             minlength=cfg.moe.num_experts)
        assert (counts > cap).any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zero_experts_give_zero_output_and_finite_aux(seed):
    """tests/test_properties.py's dispatch property on the port: with
    zero experts the layer's output is exactly zero, its aux finite."""
    rng = np.random.default_rng(seed)
    _, cfg = _cfgs("arctic-480b", num_experts=4, top_k=2, d_expert=16,
                   dense_residual=False, capacity_factor=4.0)
    T, D, E, F = 32, cfg.d_model, 4, 16
    x = torch.tensor(rng.normal(0, 1, (T, D)).astype(np.float32))
    p = {"router": torch.tensor(rng.normal(0, 1, (D, E)).astype(np.float32)),
         "wi": torch.zeros(E, D, F), "wg": torch.zeros(E, D, F),
         "wo": torch.zeros(E, F, D)}
    out, aux = moe._moe_local(x, p, cfg)
    assert float(out.abs().max()) == 0.0
    assert np.isfinite(float(aux))


def test_apply_moe_under_a_mesh_raises():
    _, cfg, _, p = _params("deepseek-v3-671b")
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="item 5.7"):
        moe.apply_moe(p, x, cfg, mesh=object())


@pytest.mark.parametrize("arch", ARCHS)
def test_init_moe_shapes_and_scales(arch):
    """The reference's keys, shapes and types, each expert weight's
    spread 1 / sqrt(fan_in)."""
    jcfg, cfg = _cfgs(arch)
    want = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0),
                                                jcfg))["moe"]
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg)["moe"]
    assert set(p) == set(want)
    for k, t in p.items():
        assert tuple(t.shape) == want[k].shape, k
        assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
    D, F = cfg.d_model, cfg.moe.d_expert
    for k, fan_in in (("wi", D), ("wg", D), ("wo", F)):
        std = float(p[k].float().std())
        assert abs(std * fan_in ** 0.5 - 1) < 0.05, (k, std)
