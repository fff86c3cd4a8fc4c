"""Port parity: AdamW and the warmup-cosine schedule against the JAX
package's (``repro.optim``), case for case of ``tests/test_optim.py``
(the exact-segment weight-decay mask), and on random trees: one update
from the same params, grads and optimizer state, within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import global_norm as jax_global_norm
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch import convert
from repro_torch.configs.registry import reduced_snn
from repro_torch.core.npu import init_npu
from repro_torch.optim.adamw import (AdamWConfig, _decay_mask, adamw_init,
                                     adamw_update, global_norm, tree_leaves)
from repro_torch.optim.schedule import warmup_cosine

REL = 1e-6

# (path, should_decay): the reference test's real parameter paths
DECAYED = [
    "backbone/d0/w",        # yolo downsample conv: the substring bug's victim
    "backbone/d1/w",
    "backbone/dw0/w",       # mobilenet depthwise kernel
    "backbone/f0/w",
    "mlp/dense/w",          # "/dense" contains "/d" as a substring
    "decoder/w",            # "/decoder" too
    "head/conv/w",
    "attn/wq",
    "blocks/3/w",
]
UNDECAYED = [
    "norm_scale",           # whole-name conventions
    "block/norm/scale",
    "head/bias",
    "conv/scale",           # folded-BN per-channel scale
    "qkv_bias",
    "mamba/D",              # exact-segment per-channel scalars
    "mamba/A_log",
    "mamba/dt_bias",
    "attn/bq",              # attention bias vectors
    "attn/bk",
    "attn/bv",
]


def _maxrel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


@pytest.mark.parametrize("path", DECAYED + UNDECAYED)
def test_decay_mask_segments(path):
    from repro.optim.adamw import _decay_mask as jax_decay_mask
    assert _decay_mask(path) == (path in DECAYED) == jax_decay_mask(path)


def test_weight_decay_applied_per_mask():
    """Zero grads + weight decay: decayed params shrink by lr*wd*p
    exactly, mask-exempt params stay bit-identical."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0)
    params = {"backbone": {"d0": {"w": torch.ones((3, 3))}},
              "norm": {"scale": torch.ones((4,))},
              "mamba": {"D": torch.ones((4,))}}
    grads = {"backbone": {"d0": {"w": torch.zeros((3, 3))}},
             "norm": {"scale": torch.zeros((4,))},
             "mamba": {"D": torch.zeros((4,))}}
    new, _, _ = adamw_update(params, grads, adamw_init(params, cfg), cfg)
    np.testing.assert_allclose(new["backbone"]["d0"]["w"].numpy(),
                               1.0 - cfg.lr * cfg.weight_decay, rtol=1e-6)
    np.testing.assert_array_equal(new["norm"]["scale"].numpy(), 1.0)
    np.testing.assert_array_equal(new["mamba"]["D"].numpy(), 1.0)


@pytest.mark.parametrize("arch", ["spiking_yolo", "spiking_mobilenet"])
def test_real_detector_params_decay_coverage(arch):
    """On the port's detector init tree the conv and dense kernels (w)
    decay and the folded-BN scale/bias vectors do not."""
    params = init_npu(torch.Generator().manual_seed(0), reduced_snn(arch),
                      device="cpu")
    paths = [p for p, _ in tree_leaves(params)]
    kernels = [p for p in paths if p.endswith("/w")]
    assert kernels and all(_decay_mask(p) for p in kernels)
    vecs = [p for p in paths if p.endswith(("/scale", "/bias"))]
    assert vecs and all(not _decay_mask(p) for p in vecs)


def _random_tree(rng):
    """A tree with decayed and exempt leaves, nested two deep."""
    return {"backbone": {"d0": {"w": rng.normal(0, 1, (3, 3, 2, 8)),
                                "scale": rng.normal(1, 0.1, (8,)),
                                "bias": rng.normal(0, 0.1, (8,))},
                         "dw0": {"w": rng.normal(0, 1, (3, 3, 1, 8))}},
            "ctrl_out": {"w": rng.normal(0, 1, (64, 8)),
                         "bias": rng.normal(0, 0.1, (8,))},
            "mamba": {"D": rng.normal(0, 1, (4,))}}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


CASES = {
    "default": dict(cfg={}, grad_scale=1.0, count=0, schedule=False),
    "clipped": dict(cfg={"grad_clip": 0.5}, grad_scale=10.0, count=3,
                    schedule=False),
    "no_clip": dict(cfg={"grad_clip": 0.0}, grad_scale=10.0, count=7,
                    schedule=False),
    "detector_recipe": dict(cfg={"lr": 4e-3, "weight_decay": 1e-4},
                            grad_scale=3.0, count=42, schedule=True),
    "late": dict(cfg={"b2": 0.999, "eps": 1e-6}, grad_scale=0.1,
                 count=999, schedule=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_update_matches_jax(case):
    """One update from the same params, grads and moments on a random
    tree: params, moments, count, grad_norm and lr within 1e-6."""
    c = CASES[case]
    rng = np.random.default_rng(len(case))
    params = _f32(_random_tree(rng))
    grads = _f32(jax.tree_util.tree_map(
        lambda a: a * c["grad_scale"], _random_tree(rng)))
    m = _f32(jax.tree_util.tree_map(lambda a: 0.1 * a, _random_tree(rng)))
    v = _f32(jax.tree_util.tree_map(lambda a: 0.01 * a * a,
                                    _random_tree(rng)))
    opt = {"m": m, "v": v, "count": np.int32(c["count"])}
    jcfg = JaxAdamWConfig(**c["cfg"])
    cfg = AdamWConfig(**c["cfg"])
    jsched = jax_warmup_cosine(jcfg.lr, warmup=100, total=2000,
                               min_ratio=0.3) if c["schedule"] else None
    sched = warmup_cosine(cfg.lr, warmup=100, total=2000,
                          min_ratio=0.3) if c["schedule"] else None
    jp, jopt, jm = jax_adamw_update(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, opt), jcfg, jsched)
    tp, topt, tm = adamw_update(
        convert.params_from_numpy(params, "cpu"),
        convert.params_from_numpy(grads, "cpu"),
        convert.opt_state_from_numpy(opt, "cpu"), cfg, sched)
    jpl = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jp)))
    for name, tree, jtree in (("params", tp, jp), ("m", topt["m"], jopt["m"]),
                              ("v", topt["v"], jopt["v"])):
        jl = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jtree)))
        for path, leaf in tree_leaves(tree):
            assert _maxrel(leaf.numpy(), jl[path]) <= REL, (name, path)
    # the update moved every parameter (decayed or not)
    for path, leaf in tree_leaves(tp):
        assert not np.array_equal(leaf.numpy(), params_leaf(params, path))
    assert int(topt["count"]) == int(jopt["count"]) == c["count"] + 1
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=REL)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=REL)
    assert set(jpl) == {p for p, _ in tree_leaves(tp)}


def params_leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def test_adamw_init_and_bf16_state_match_jax():
    rng = np.random.default_rng(0)
    params = _f32(_random_tree(rng))
    for dtype in ("float32", "bfloat16"):
        opt = adamw_init(convert.params_from_numpy(params, "cpu"),
                         AdamWConfig(state_dtype=dtype))
        jopt = jax_adamw_init(params, JaxAdamWConfig(state_dtype=dtype))
        assert int(opt["count"]) == int(jopt["count"]) == 0
        for (path, leaf), (_, jleaf) in zip(
                tree_leaves(opt["m"]),
                tree_leaves(jax.tree_util.tree_map(np.asarray, jopt["m"]))):
            assert leaf.shape == jleaf.shape and not leaf.any()
            assert str(leaf.dtype).endswith(dtype)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(4)
    tree = _f32(_random_tree(rng))
    got = float(global_norm(convert.params_from_numpy(tree, "cpu")))
    want = float(jax_global_norm(tree))
    assert got == pytest.approx(want, rel=REL)


@pytest.mark.parametrize("warmup,total,min_ratio", [(100, 10000, 0.1),
                                                    (20, 300, 0.3),
                                                    (0, 50, 0.0)])
def test_warmup_cosine_matches_jax(warmup, total, min_ratio):
    """Every step 0..total + 10 within 1e-6 of the reference, in float32."""
    steps = np.concatenate([np.arange(0, 130), np.arange(130, total + 10,
                                                         max(1, total // 97))
                            ]).astype(np.int32)
    got = warmup_cosine(4e-3, warmup=warmup, total=total,
                        min_ratio=min_ratio)(torch.tensor(steps))
    want = jax_warmup_cosine(4e-3, warmup=warmup, total=total,
                             min_ratio=min_ratio)(jnp.asarray(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL,
                               atol=1e-12)
