"""AdamW on nested dicts of tensors, the counterpart of
``repro.optim.adamw``.

Leaves are visited in the reference's order (a dict's keys sorted, as
``jax.tree_util`` flattens them; ``tree_leaves`` also takes the
NamedTuples and sequences of a train state, as the checkpoints do) and
named by their ``"/"``-joined keys, the paths the weight-decay mask
reads.  Scalars follow the
reference's float32 arithmetic: the bias corrections ``1 - b1**count``
and ``1 - b2**count`` are float32 powers of a float32 step count, not
Python floats.  The update writes new tensors (the reference's pure
function); it runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"


def tree_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a tree of dicts, NamedTuples, lists and
    tuples in JAX's flattening order, named by JAX's path strings: a
    dict's keys sorted (``a/b``), a NamedTuple's fields in order
    (``.field``), a sequence's items in order (``0``); ``None`` holds no
    leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += tree_leaves(sub, f"{prefix}/{key}" if prefix else key)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)

    def walk(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        return next(it)
    return walk(like)


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    dt = _DTYPES[cfg.state_dtype]
    leaves = [p for _, p in tree_leaves(params)]

    def zeros():
        return tree_unflatten(params, [torch.zeros(p.shape, dtype=dt,
                                                   device=p.device)
                                       for p in leaves])
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's sum of
    squares, in float32."""
    total = None
    for _, leaf in tree_leaves(tree):
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


# Exact path segments that carry no weight decay: mamba's per-channel
# D / A_log / dt_bias and the attention bias vectors.  Segment-exact
# matching: a substring test such as '"/d" in path' would silently
# disable decay on every kernel whose name starts with "d" (the YOLO
# backbone's "/d0" downsample convs, mobilenet's "/dw0" depthwise
# kernels, any "/dense" or "/decoder" layer).
_NO_DECAY_SEGMENTS = frozenset({"d", "a_log", "dt_bias", "bq", "bk", "bv"})
# Substrings that mark a segment as norm/bias/scale-like ("norm_scale",
# "qkv_bias", ...): whole-name conventions, not prefixes of kernel
# names, so substring matching within one segment is safe.
_NO_DECAY_SUBSTRINGS = ("norm", "bias", "scale")


def _decay_mask(path: str) -> bool:
    """No weight decay on norms/biases/per-channel scalars."""
    segments = path.lower().split("/")
    if any(s in _NO_DECAY_SEGMENTS for s in segments):
        return False
    return not any(sub in seg for seg in segments
                   for sub in _NO_DECAY_SUBSTRINGS)


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig,
                 lr_schedule: Optional[Callable] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step -> (params, opt_state, {"grad_norm", "lr"}): the
    global-norm clip of ``cfg.grad_clip``, bias-corrected moments, decay
    on the paths ``_decay_mask`` allows."""
    count = opt_state["count"] + 1
    lr = cfg.lr if lr_schedule is None else lr_schedule(count)

    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip else 1.0)

    b1, b2 = cfg.b1, cfg.b2
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=cf.device), cf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=cf.device), cf)
    dt = _DTYPES[cfg.state_dtype]
    g_of = dict(tree_leaves(grads))
    m_of = dict(tree_leaves(opt_state["m"]))
    v_of = dict(tree_leaves(opt_state["v"]))

    new_p, new_m, new_v = [], [], []
    for path, p in tree_leaves(params):
        gf = g_of[path].float() * scale
        mf = b1 * m_of[path].float() + (1 - b1) * gf
        vf = b2 * v_of[path].float() + (1 - b2) * torch.square(gf)
        upd = (mf / c1) / (torch.sqrt(vf / c2) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path):
            upd = upd + cfg.weight_decay * p.float()
        new_p.append((p.float() - lr * upd).to(p.dtype))
        new_m.append(mf.to(dt))
        new_v.append(vf.to(dt))

    opt2 = {"m": tree_unflatten(params, new_m),
            "v": tree_unflatten(params, new_v), "count": count}
    lr_t = lr if isinstance(lr, torch.Tensor) else torch.tensor(
        lr, dtype=torch.float32, device=count.device)
    return tree_unflatten(params, new_p), opt2, {"grad_norm": gnorm,
                                                 "lr": lr_t}
