"""Shared building blocks of the LM stack: norms, the gated MLP, RoPE
and the initialiser (the counterpart of ``repro.models.blocks``)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def dense_init(gen: torch.Generator, shape, in_axis=0, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Normal(0, 1 / fan_in) weights drawn from ``gen`` on its device,
    then moved to ``device`` (default: the generator's) in ``dtype``."""
    fan_in = shape[in_axis] if in_axis is not None else shape[0]
    scale = (1.0 / max(fan_in, 1)) ** 0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32).mul_(scale)
    return w.to(device=device or gen.device, dtype=dtype)


def stacked_init(gen: torch.Generator, shape, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """A stack of ``shape[0]`` matrices ``shape[1:]`` (experts), each
    Normal(0, 1 / shape[1]) as ``dense_init(gen, shape, in_axis=1)``,
    drawn one matrix at a time: a full-width expert stack never exists in
    float32 (arctic-480b's is 17.8 GB)."""
    out = torch.empty(shape, dtype=dtype, device=device or gen.device)
    for e in range(shape[0]):
        out[e] = dense_init(gen, shape[1:], dtype=dtype, device=out.device)
    return out


def refuse_mesh(mesh, what: str) -> None:
    """Raise ``NotImplementedError`` for a mesh: ``what`` runs on one
    device; its sharded form waits for ROADMAP.md queue 1 item 5.7."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what} under a mesh is not ported yet (ROADMAP.md queue 1, "
            "item 5.7: the LM's sharding)")


def act_fn(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, d: Optional[int] = None, device=None):
    d = d or cfg.d_model
    p = {"norm_scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_kind == "ln":
        p["norm_bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    """RMS or layer norm over the last axis, in float32; x's type out."""
    xf = x.float()
    if cfg.norm_kind == "ln":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["norm_scale"] + p["norm_bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["norm_scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (the split-half form)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    """The inverse frequencies, computed on ``device`` (no host-to-device
    copy, which would stall the host behind the card every layer)."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(theta, expo)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, hd]; positions: [..., S] (broadcastable)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, device=x.device)              # [hd/2]
    ang = positions.float()[..., None, None] * inv            # [..., S, 1, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GELU-MLP)
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, d_ff: Optional[int] = None,
             dtype=torch.bfloat16, device=None):
    d_ff = d_ff or cfg.d_ff
    return {"mlp": {
        "wi": dense_init(gen, (cfg.d_model, d_ff), dtype=dtype, device=device),
        "wg": dense_init(gen, (cfg.d_model, d_ff), dtype=dtype, device=device),
        "wo": dense_init(gen, (d_ff, cfg.d_model), dtype=dtype, device=device),
    }}


def apply_mlp(p, x, cfg: ModelConfig):
    m = p["mlp"]
    h = act_fn(cfg.act)(x @ m["wg"]) * (x @ m["wi"])
    return h @ m["wo"]
