"""Carry parameters and configs from the JAX package into the port, so
both compute the same function on the same weights.

Nothing here imports the JAX package: parameters arrive as a nested dict
of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the
JAX side), a config as any object with the reference's field names.
The parameter trees have the same keys on both sides: HWIO conv weights
``w`` with per-channel ``scale``/``bias``, dense ``w`` [cin, cout] with
``bias``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import EncodingConfig, ISPConfig, SNNConfig
from repro_torch.core.npu import resolve_device

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
