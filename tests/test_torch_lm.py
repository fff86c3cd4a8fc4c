"""The port's LM serving path (``repro_torch.models``, ``serve.engine``)
against the JAX package in float32 on ``reduced(...)`` configurations,
the weights carried across by ``convert.lm_params_from_numpy`` (random
qkv biases and norm scales, so both are exercised): the dense GQA
models, arctic-480b (MoE with a dense residual) and deepseek-v3-671b
(MLA, a dense first layer, MoE with a shared expert, the ``mtp``
subtree).

Tolerances: blocks, attention, the decode step and the caches at 1e-5
(absolute and relative); whole-model logits and hidden states within
1e-5 relative to their largest magnitude, the MoE aux loss within 1e-6;
the port's decode against its own full forward at 1e-4 relative, the
reference's bar (``tests/test_archs_smoke.py``); the slot engine's
tokens equal.
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
from repro.models import blocks as jblocks
from repro.models import transformer as jtfm
from repro.models.lm import serve_decode as jserve_decode
from repro.models.lm import serve_prefill as jserve_prefill
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import attention, blocks
from repro_torch.models import transformer as tfm
from repro_torch.models.lm import serve_decode, serve_prefill
from repro_torch.serve.engine import Request, ServeEngine

AX = MeshAxes()
TOL = 1e-5
DENSE = ["qwen2-7b", "qwen1.5-4b", "glm4-9b", "mistral-nemo-12b"]
MOE = ["arctic-480b", "deepseek-v3-671b"]
NOT_PORTED = sorted(set(jreg.ARCHS) - set(DENSE) - set(MOE))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def assert_rel(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    assert rel < tol, rel


@functools.lru_cache(maxsize=None)
def lm(arch):
    """(JAX cfg, port cfg, JAX params, port params) of reduced ``arch`` in
    float32, norm scales and qkv biases drawn at random."""
    jcfg = dataclasses.replace(jreg.reduced(arch), dtype="float32")
    cfg = dataclasses.replace(registry.reduced(arch), dtype="float32")
    jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(7)

    def perturb(path, a):
        a = np.array(a)
        name = jax.tree_util.keystr(path)
        if "norm_scale" in name:
            a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        elif any(f"'{b}'" in name for b in ("bq", "bk", "bv")):
            a = rng.normal(0, 0.5, a.shape).astype(np.float32)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, jp)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, cfg, jp, convert.lm_params_from_numpy(tree, cfg,
                                                       device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


# ---------------------------------------------------------------------------
# the registry and what is not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(jreg.ARCHS))
def test_registry_copies_the_reference(arch):
    for port, ref in ((registry.ARCHS[arch], jreg.ARCHS[arch]),
                      (registry.reduced(arch), jreg.reduced(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert registry.shape_cells(arch) == jreg.shape_cells(arch)
    assert tfm.layout(registry.ARCHS[arch]) == jtfm.layout(jreg.ARCHS[arch])


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_non_dense_configs_raise(arch):
    cfg = registry.reduced(arch)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="not ported"):
        tfm.init_params(gen, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        tfm.init_cache(cfg, 2, 8, device="cpu")


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    cfg = registry.reduced("qwen2-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_cache(cfg, 2, 8)
    jcfg, _, jp, _ = lm("qwen2-7b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jp), cfg)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_apply_norm(kind):
    cfg = dataclasses.replace(registry.reduced("qwen2-7b"), norm_kind=kind)
    jcfg = dataclasses.replace(jreg.reduced("qwen2-7b"), norm_kind=kind)
    rng = np.random.default_rng(1)
    x = rng.normal(0.3, 2.0, (2, 5, cfg.d_model)).astype(np.float32)
    p = {"norm_scale": rng.uniform(0.5, 1.5, cfg.d_model).astype(np.float32)}
    if kind == "ln":
        p["norm_bias"] = rng.normal(0, 1, cfg.d_model).astype(np.float32)
    want = jblocks.apply_norm(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), jcfg)
    got = blocks.apply_norm({k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    # bf16 in, bf16 out, f32 inside
    assert blocks.apply_norm({k: torch.tensor(v) for k, v in p.items()},
                             torch.tensor(x).bfloat16(), cfg).dtype == \
        torch.bfloat16


@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_rope(per_slot):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, 6, 4, 16)).astype(np.float32)
    if per_slot:     # decode: one position per slot, -1 for an inactive one
        x = x[:, :1]
        pos = np.array([[4], [-1], [37]], np.int32)
    else:
        pos = np.arange(6, dtype=np.int32) + 3
    want = jblocks.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = blocks.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp(act):
    jcfg = dataclasses.replace(jreg.reduced("qwen2-7b"), act=act)
    cfg = dataclasses.replace(registry.reduced("qwen2-7b"), act=act)
    jp = jblocks.init_mlp(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    p = {"mlp": {k: torch.tensor(v) for k, v in tree["mlp"].items()}}
    x = np.random.default_rng(3).normal(0, 1, (2, 5, cfg.d_model)).astype(
        np.float32)
    want = jblocks.apply_mlp(jp, jnp.asarray(x), jcfg, AX)
    got = blocks.apply_mlp(p, torch.tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def test_bf16_parts_sum_to_x_exactly():
    """The decode's f32 ``wo`` product splits its f32 input into three
    bf16 parts; their float32 sum is the input, bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 512)) * np.exp(rng.uniform(-20, 20, (4, 512)))
    x = torch.tensor(x, dtype=torch.float32)
    parts = attention.bf16_parts(x)
    assert parts.dtype == torch.bfloat16 and parts.shape == (3, 4, 512)
    p = parts.float()
    assert torch.equal((p[0] + p[1]) + p[2], x)


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen1.5-4b"])
def test_apply_attention_return_kv(arch):
    jcfg, cfg, jp, p = lm(arch)
    x = np.random.default_rng(4).normal(0, 1, (2, 12, cfg.d_model)).astype(
        np.float32)
    ja = jp["units"]["0"]["mixer"]
    ja = jax.tree_util.tree_map(lambda a: a[0], ja)
    jout, (jk, jv) = jattn.apply_attention(ja, jnp.asarray(x),
                                           jnp.arange(12), jcfg, AX,
                                           return_kv=True)
    out, (k, v) = attention.apply_attention(
        p["layers"][0]["mixer"], torch.tensor(x), torch.arange(12), cfg,
        return_kv=True)
    for got, want in ((out, jout), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


@pytest.mark.parametrize("pos", ["scalar", "per-slot"])
def test_decode_attention(pos):
    """The output and the written cache; the per-slot vector has an
    inactive slot (-1), which writes nothing."""
    jcfg, cfg, jp, p = lm("qwen2-7b")
    B, S = 3, 10
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
    hd = cfg.resolved_head_dim
    kc = rng.normal(0, 1, (B, S, cfg.num_kv_heads, hd)).astype(np.float32)
    vc = rng.normal(0, 1, (B, S, cfg.num_kv_heads, hd)).astype(np.float32)
    posv = np.int32(6) if pos == "scalar" else np.array([6, -1, 2], np.int32)
    ja = jax.tree_util.tree_map(lambda a: a[0], jp["units"]["0"]["mixer"])
    jout, jc = jattn.decode_attention(
        ja, jnp.asarray(x), jattn.KVCache(jnp.asarray(kc), jnp.asarray(vc)),
        jnp.asarray(posv), jcfg, AX)
    out, c = attention.decode_attention(
        p["layers"][0]["mixer"], torch.tensor(x),
        attention.KVCache(torch.tensor(kc), torch.tensor(vc)),
        torch.tensor(posv), cfg)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=TOL)
    for got, want in zip(c, jc):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    if pos == "per-slot":
        np.testing.assert_array_equal(c.k[1].numpy(), kc[1])


# ---------------------------------------------------------------------------
# whole model: forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE + MOE)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, cfg, jp, p = lm(arch)
    toks = _tokens(cfg, (2, 16))
    jh, jaux = jtfm.forward_lm(jp, jcfg, {"tokens": jnp.asarray(toks)}, AX,
                               remat="none")
    h, aux = tfm.forward_lm(p, cfg, {"tokens": torch.tensor(toks)})
    assert aux.dtype == torch.float32
    if arch in DENSE:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0.0
        assert abs(float(aux) - float(jaux)) < 1e-6
    assert_rel(h, jh)
    assert_rel(tfm.lm_logits(p, cfg, h), jtfm.lm_logits(jp, jcfg, jh, AX))

    jl, jc = jserve_prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :15])},
                            AX, cache_len=24)
    l, c = serve_prefill(p, cfg, {"tokens": torch.tensor(toks[:, :15])},
                         cache_len=24)
    assert l.dtype == torch.float32
    assert_rel(l, jl)
    want_c = convert.lm_cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, jc), cfg, device="cpu")
    assert len(c) == len(want_c) == cfg.num_layers
    for got, want in zip(c, want_c):
        assert type(got) is type(want)
        assert got[0].shape[:2] == (2, 24)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       rtol=TOL)

    jd, jc2 = jserve_decode(jp, jcfg, jc, jnp.asarray(toks[:, 15:16]),
                            jnp.int32(15), AX)
    d, c2 = serve_decode(p, cfg, c, torch.tensor(toks[:, 15:16]), 15)
    assert_rel(d, jd)
    want_c2 = convert.lm_cache_from_numpy(
        jax.tree_util.tree_map(np.asarray, jc2), cfg, device="cpu")
    for got, want in zip(c2, want_c2):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL,
                                       rtol=TOL)


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_decode_matches_full_forward(arch):
    """The reference's check on the port: prefill 15 tokens, decode the
    16th, against the full forward's last logits (rel < 1e-4)."""
    _, cfg, _, p = lm(arch)
    toks = torch.tensor(_tokens(cfg, (2, 16), seed=1))
    hidden, _ = tfm.forward_lm(p, cfg, {"tokens": toks})
    full = hidden[:, -1] @ p["lm_head"].t()
    _, cache = serve_prefill(p, cfg, {"tokens": toks[:, :15]}, cache_len=24)
    dec, _ = serve_decode(p, cfg, cache, toks[:, 15:16], 15)
    assert_rel(dec, full, 1e-4)


def test_init_params_shapes_and_device():
    cfg = registry.reduced("qwen2-7b")
    p = tfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert len(p["layers"]) == cfg.num_layers
    assert p["tok_embed"].dtype == torch.bfloat16
    assert p["final"]["norm_scale"].dtype == torch.float32
    assert p["layers"][0]["mixer"]["attn"]["bq"].shape == (
        cfg.num_heads * cfg.resolved_head_dim,)
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(
        p, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    norms = cfg.d_model * (2 * cfg.num_layers + 1)
    biases = cfg.num_layers * cfg.resolved_head_dim * (
        cfg.num_heads + 2 * cfg.num_kv_heads)
    assert n == cfg.param_count() + norms + biases


def _shapes(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict / list / NamedTuple."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _jax_per_layer_shapes(tree, cfg):
    """The reference's abstract tree with its units unstacked, keyed as
    the port's: ``layers/l`` for layer prefix + u * U + i."""
    pfx, U, n_units = tfm.layout(cfg)
    out = {}
    for k, v in tree.items():
        if k == "prefix":
            for i, blk in v.items():
                out.update(_shapes(blk, f"/layers/{i}"))
        elif k == "units":
            for i, blk in v.items():
                for path, (shape, dt) in _shapes(blk).items():
                    for u in range(n_units):
                        out[f"/layers/{pfx + u * U + int(i)}{path}"] = (
                            shape[1:], dt)
        else:
            out.update(_shapes(v, f"/{k}"))
    return out


@pytest.mark.parametrize("arch", MOE)
def test_init_params_tree_matches_reference(arch):
    """The port's parameters (bf16, norms and the router float32) have
    the reference's keys, shapes and types layer by layer, the ``mtp``
    subtree's MoE block included."""
    jcfg, cfg = jreg.reduced(arch), registry.reduced(arch)
    want = _jax_per_layer_shapes(jax.eval_shape(
        lambda: jtfm.init_params(jax.random.PRNGKey(0), jcfg)), jcfg)
    p = tfm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert _shapes(p) == want
    assert ("mtp" in p) == bool(cfg.mtp_depth)
    kinds = [("moe" in blk["ffn"]) for blk in p["layers"]]
    assert kinds == [m for _, m in tfm.layer_kinds(cfg)]


@pytest.mark.parametrize("arch", MOE)
def test_convert_carries_moe_mla_and_mtp_trees(arch):
    """``lm_params_from_numpy`` carries every leaf (the blocks' ``moe``
    and ``mla`` subtrees, the ``mtp`` subtree) bit for bit, unstacked per
    layer; ``lm_cache_from_numpy`` carries MLACache for an MLA model."""
    jcfg, cfg, jp, p = lm(arch)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    pfx, U, _ = tfm.layout(cfg)
    for l, blk in enumerate(p["layers"]):
        src = tree["prefix"][str(l)] if l < pfx else jax.tree_util.tree_map(
            lambda a: a[(l - pfx) // U], tree["units"][str((l - pfx) % U)])
        got = jax.tree_util.tree_leaves_with_path(
            blk, is_leaf=lambda t: isinstance(t, torch.Tensor))
        want = dict(jax.tree_util.tree_leaves_with_path(src))
        assert len(got) == len(want)
        for path, t in got:
            np.testing.assert_array_equal(t.numpy(), want[path])
    if cfg.mtp_depth:
        for path, t in jax.tree_util.tree_leaves_with_path(
                p["mtp"], is_leaf=lambda t: isinstance(t, torch.Tensor)):
            np.testing.assert_array_equal(
                t.numpy(), dict(jax.tree_util.tree_leaves_with_path(
                    tree["mtp"]))[path])
        assert "moe" in p["mtp"]["block"]["ffn"]
    jc = jtfm.init_cache(jcfg, 2, 8, dtype=jnp.float32)
    jc = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(a.size).normal(0, 1, a.shape).astype(
            np.float32), jc)
    c = convert.lm_cache_from_numpy(jc, cfg, device="cpu")
    kind = attention.MLACache if cfg.mla else attention.KVCache
    assert len(c) == cfg.num_layers and all(type(x) is kind for x in c)
    for got, want in zip(c, tfm.init_cache(cfg, 2, 8, device="cpu")):
        assert [t.shape for t in got] == [t.shape for t in want]
    last = jax.tree_util.tree_map(lambda a: a[-1], jc["units"]["0"])
    for a, b in zip(c[-1], last):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# the slot engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine_model():
    return lm("qwen2-7b")


def test_engine_matches_jax_engine(engine_model):
    """tests/test_serving.py's requests: batch 3, 5 requests, max_new 4."""
    jcfg, cfg, jp, p = engine_model
    prompts = [np.arange(3 + 2 * i) % cfg.vocab_size for i in range(5)]
    jeng = JServeEngine(jp, jcfg, AX, batch=3, max_len=64)
    jdone = jeng.run_to_completion(
        [JRequest(rid=i, prompt=jnp.asarray(pr), max_new=4)
         for i, pr in enumerate(prompts)])
    eng = ServeEngine(p, cfg, batch=3, max_len=64)
    done = eng.run_to_completion(
        [Request(rid=i, prompt=pr, max_new=4) for i, pr in enumerate(prompts)])
    assert len(done) == len(jdone) == 5
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.out_tokens == jr.out_tokens, r.rid
        assert all(0 <= t < cfg.vocab_size for t in r.out_tokens)


def test_engine_slot_reuse(engine_model):
    """Identical prompts give identical tokens whatever slot and history
    they meet; each equals its prefill + greedy decode continuation."""
    _, cfg, _, p = engine_model
    eng = ServeEngine(p, cfg, batch=2, max_len=64)
    done = eng.run_to_completion(
        [Request(rid=i, prompt=np.array([1, 2, 3]), max_new=3)
         for i in range(4)])
    assert len(done) == 4
    assert len({tuple(r.out_tokens) for r in done}) == 1
    toks = torch.tensor([[1, 2, 3]])
    logits, cache = serve_prefill(p, cfg, {"tokens": toks}, cache_len=64)
    want = [int(logits[0].argmax())]
    for t in range(2):
        logits, cache = serve_decode(p, cfg, cache,
                                     torch.tensor([[want[-1]]]), 3 + t)
        want.append(int(logits[0].argmax()))
    assert done[0].out_tokens == want


def test_engine_budget_and_eos(engine_model):
    _, cfg, _, p = engine_model
    eng = ServeEngine(p, cfg, batch=2, max_len=64)
    (r,) = eng.run_to_completion([Request(rid=0, prompt=np.array([5, 6]),
                                          max_new=5)])
    assert len(r.out_tokens) == 5
    eos = r.out_tokens[2]
    eng = ServeEngine(p, cfg, batch=2, max_len=64, eos_id=eos)
    (r2,) = eng.run_to_completion([Request(rid=0, prompt=np.array([5, 6]),
                                           max_new=5)])
    # the prefill's token is not checked against eos; the ticks' are
    stop = next(j for j in range(1, 5) if r.out_tokens[j] == eos)
    assert r2.out_tokens == r.out_tokens[:stop + 1]


@pytest.mark.parametrize("arch", MOE)
def test_engine_matches_jax_engine_moe(arch):
    """The slot engine on MoE and MLA models: tests/test_serving.py's
    requests (batch 3, 5 requests, max_new 4), tokens equal to the JAX
    engine's."""
    jcfg, cfg, jp, p = lm(arch)
    prompts = [np.arange(3 + 2 * i) % cfg.vocab_size for i in range(5)]
    jeng = JServeEngine(jp, jcfg, AX, batch=3, max_len=64)
    jdone = jeng.run_to_completion(
        [JRequest(rid=i, prompt=jnp.asarray(pr), max_new=4)
         for i, pr in enumerate(prompts)])
    eng = ServeEngine(p, cfg, batch=3, max_len=64)
    done = eng.run_to_completion(
        [Request(rid=i, prompt=pr, max_new=4) for i, pr in enumerate(prompts)])
    assert [type(c) for c in eng.cache] == [
        attention.MLACache if cfg.mla else attention.KVCache] * cfg.num_layers
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, jr in zip(done, jdone):
        assert r.out_tokens == jr.out_tokens, r.rid
