"""Carry parameters and configs from the JAX package into the port, so
both compute the same function on the same weights.

Nothing here imports the JAX package: parameters arrive as a nested dict
of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the
JAX side), a config as any object with the reference's field names.
The SNN parameter trees have the same keys on both sides: HWIO conv
weights ``w`` with per-channel ``scale``/``bias``, dense ``w`` [cin,
cout] with ``bias``.  The LM trees differ in one place: the reference
stacks its repeated unit's layers along a leading axis (``units``, one
``lax.scan``), the port keeps one entry per layer (``layers``, and a
list of per-layer caches); the blocks' ``moe`` and ``mla`` subtrees and
the ``mtp`` subtree keep the reference's keys.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import (EncodingConfig, ISPConfig,
                                      ModelConfig, SNNConfig, TrainConfig)
from repro_torch.core.encoding import as_stream
from repro_torch.data.synthetic import SceneBatch
from repro_torch.device import resolve_device
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.transformer import check_supported, layout

# JAX backend name -> the port's (SNN layers, ISP stages, encoding)
BACKEND_NAMES = {"jnp": "torch", "pallas": "cuda"}
# the ISP stages have a third backend, the fusion planner's
ISP_BACKEND_NAMES = {**BACKEND_NAMES, "pallas_fused": "cuda_fused"}


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> nested dict of float32 tensors on
    ``device`` (raises for "cuda" without a card)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32)).to(device)


def scene_from_numpy(scene, device="cuda") -> SceneBatch:
    """The reference's ``SceneBatch`` (its leaves anything ``np.asarray``
    takes) -> the port's, on ``device``: events as float32 t, int32
    x/y/p and bool valid, float32 frames and boxes, bool valid."""
    device = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32)).to(device)
    ev = scene.events
    return SceneBatch(
        events=as_stream(type(ev)(*(np.array(a) for a in ev)), device),
        bayer=f32(scene.bayer), boxes=f32(scene.boxes),
        valid=torch.tensor(np.asarray(scene.valid, bool)).to(device),
        clean_rgb=f32(scene.clean_rgb))


def opt_state_from_numpy(opt, device="cuda"):
    """The reference's AdamW state ({"m", "v", "count"}, as numpy) -> the
    port's: the moments as float32 trees, ``count`` an int32 scalar."""
    device = resolve_device(device)
    return {"m": params_from_numpy(opt["m"], device),
            "v": params_from_numpy(opt["v"], device),
            "count": torch.tensor(int(np.asarray(opt["count"])),
                                  dtype=torch.int32, device=device)}


def _mapped(cls, cfg, names=BACKEND_NAMES):
    """A ``cls`` with ``cfg``'s fields, its backend name mapped."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)}
    backend = fields["backend"]
    if backend not in names:
        raise ValueError(f"{cls.__name__} backend {backend!r} has no port "
                         f"(known: {sorted(names)})")
    fields["backend"] = names[backend]
    if "stages" in fields:
        fields["stages"] = tuple(fields["stages"])
    return cls(**fields)


def snn_config(cfg) -> SNNConfig:
    """The port's SNNConfig with the same fields, backend name mapped."""
    return _mapped(SNNConfig, cfg)


def isp_config(cfg) -> ISPConfig:
    """The port's ISPConfig with the same fields, backend name mapped
    (``"pallas_fused"`` too)."""
    return _mapped(ISPConfig, cfg, ISP_BACKEND_NAMES)


def encoding_config(cfg) -> EncodingConfig:
    """The port's EncodingConfig with the same fields, backend name
    mapped."""
    return _mapped(EncodingConfig, cfg)


def train_config(cfg) -> TrainConfig:
    """The port's TrainConfig with the same fields, backend name
    mapped."""
    return _mapped(TrainConfig, cfg)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 too) -> a tensor of its type that
    owns a copy of the data (the decode step writes caches in place; an
    array from JAX is read-only)."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree(tree, device):
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _per_layer(tree, cfg: ModelConfig):
    """The reference's {"prefix": {i: x}, "units": {i: x stacked over
    units}} -> a list of x per layer, layer ``prefix + u * U + i``."""
    pfx, U, n_units = layout(cfg)
    layers = [tree["prefix"][str(i)] for i in range(pfx)]
    for u in range(n_units):
        for i in range(U):
            layers.append(_index(tree["units"][str(i)], u))
    return layers


def _index(tree, u):
    if isinstance(tree, dict):
        return {k: _index(v, u) for k, v in tree.items()}
    if isinstance(tree, tuple):      # a NamedTuple cache
        return type(tree)(*(np.asarray(t)[u] for t in tree))
    return np.asarray(tree)[u]


def lm_params_from_numpy(tree, cfg: ModelConfig, device=None):
    """The JAX LM parameter tree (as numpy) -> the port's, on ``device``
    (default the card; raises without one), each array in its own type:
    the same keys, ``prefix``/``units`` replaced by ``layers``."""
    check_supported(cfg)
    device = resolve_device(device or "cuda")
    out = {k: _tree(v, device) for k, v in tree.items()
           if k not in ("prefix", "units")}
    out["layers"] = [_tree(p, device) for p in _per_layer(tree, cfg)]
    return out


def lm_cache_from_numpy(tree, cfg: ModelConfig, device=None):
    """A JAX LM cache (``init_cache`` or ``forward_prefill``'s, as numpy;
    a KVCache or, for MLA, an MLACache per block) -> the port's list of
    per-layer caches of the same kind."""
    check_supported(cfg)
    device = resolve_device(device or "cuda")
    kind = KVCache if cfg.mla is None else MLACache
    return [kind(_tensor(c[0], device), _tensor(c[1], device))
            for c in _per_layer(tree, cfg)]
