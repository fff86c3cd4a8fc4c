"""Carry parameters and configs from the JAX package into the port, so
both compute the same function on the same weights.

Nothing here imports the JAX package: parameters arrive as a nested dict
of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the
JAX side), an ``SNNConfig`` as any object with the reference's field
names.  The parameter trees have the same keys on both sides: HWIO conv
weights ``w`` with per-channel ``scale``/``bias``, dense ``w`` [cin,
cout] with ``bias``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import SNNConfig

# JAX backend name -> the port's
SNN_BACKENDS = {"jnp": "torch", "pallas": "cuda"}


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays -> nested dict of float32 tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32)).to(device)


def snn_config(cfg) -> SNNConfig:
    """The port's SNNConfig with the same fields, backend name mapped."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(SNNConfig)}
    if fields["backend"] not in SNN_BACKENDS:
        raise ValueError(f"SNNConfig backend {fields['backend']!r} has no "
                         f"port (known: {sorted(SNN_BACKENDS)})")
    fields["backend"] = SNN_BACKENDS[fields["backend"]]
    return SNNConfig(**fields)
