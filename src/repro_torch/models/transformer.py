"""The LM model for attention blocks (GQA or MLA) with a dense or MoE
FFN: parameters, the full-sequence forward, prefill and one-token decode
(the counterpart of ``repro.models.transformer``).

The reference groups its layers into a prefix and a repeated unit whose
parameters ``jax.vmap`` stacks for one ``lax.scan``; PyTorch runs
eagerly, so the port keeps one entry per layer: ``params["layers"][l]``
and ``cache[l]`` (``repro_torch.convert`` unstacks the reference's
units, layer ``prefix + u * U + i``).  ``layout`` is kept for that
mapping.  A ``mtp_depth`` config gets the reference's ``mtp`` parameter
subtree; its loss comes with LM training.  Configurations that need
mamba or xLSTM blocks or the audio/VLM front ends raise
``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.blocks import (apply_mlp, apply_norm, dense_init,
                                       init_mlp, init_norm)
from repro_torch.models.moe import apply_moe, init_moe

# what is not ported yet, and where ROADMAP.md queues it
_NOT_PORTED = ("is not ported yet (ROADMAP.md queue 1, item 5: mamba "
               "5.3, xLSTM 5.4, the audio and VLM front ends 5.6)")


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    return [(cfg.pattern_at(l), cfg.is_moe_layer(l))
            for l in range(cfg.num_layers)]


@functools.lru_cache(maxsize=None)
def layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """-> (prefix_len, unit_len, n_units), the reference's grouping."""
    kinds = layer_kinds(cfg)
    L = cfg.num_layers
    for p in range(0, min(L, 9)):
        rest = kinds[p:]
        n = len(rest)
        if n == 0:
            return p, 0, 0
        for U in range(1, min(n, 17)):
            if n % U:
                continue
            if all(rest[i] == rest[i % U] for i in range(n)):
                return p, U, n // U
    return L, 0, 0   # fully unrolled fallback


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port cannot build."""
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} front end {_NOT_PORTED}")
    for l, (kind, _) in enumerate(layer_kinds(cfg)):
        if kind != "A":
            what = {"M": "mamba", "L": "mLSTM", "S": "sLSTM"}.get(kind, kind)
            raise NotImplementedError(
                f"{cfg.name}: layer {l} is a {what} block {_NOT_PORTED}")


def _dtype(cfg: ModelConfig, dtype):
    return dtype or getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ModelConfig, is_moe: bool, dtype=torch.bfloat16,
               device=None):
    p: Dict[str, Any] = {"ln1": init_norm(cfg, device=device)}
    init_mixer = attn_mod.init_attention if cfg.mla is None \
        else attn_mod.init_mla
    p["mixer"] = init_mixer(gen, cfg, dtype, device=device)
    if is_moe:
        p["ln2"] = init_norm(cfg, device=device)
        p["ffn"] = init_moe(gen, cfg, dtype, device=device)
    elif cfg.d_ff:
        p["ln2"] = init_norm(cfg, device=device)
        p["ffn"] = init_mlp(gen, cfg, dtype=dtype, device=device)
    return p


def _ffn(p, x, cfg: ModelConfig, is_moe: bool):
    """x + the block's FFN (dense or MoE) -> (x, the MoE aux loss or
    None)."""
    if "ffn" not in p:
        return x, None
    h = apply_norm(p["ln2"], x, cfg)
    aux = None
    if is_moe:
        out, aux = apply_moe(p["ffn"], h, cfg)
    else:
        out = apply_mlp(p["ffn"], h, cfg)
    return x + out.to(x.dtype), aux


def _mix(p, h, positions, cfg: ModelConfig, return_kv=False):
    mix = attn_mod.apply_attention if cfg.mla is None \
        else attn_mod.apply_mla
    return mix(p["mixer"], h, positions, cfg, return_kv=return_kv)


def apply_block(p, x, positions, cfg: ModelConfig, is_moe: bool = False):
    """Full-sequence block: x [B, S, D] -> (x, the MoE aux loss or None)."""
    x = x + _mix(p, apply_norm(p["ln1"], x, cfg), positions, cfg).to(x.dtype)
    return _ffn(p, x, cfg, is_moe)


def init_block_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     dtype=torch.bfloat16, device=None):
    """A zero KVCache, or an MLACache for an MLA config."""
    if cfg.mla is not None:
        m = cfg.mla
        return MLACache(
            c_kv=torch.zeros((batch, seq_len, m.kv_lora_rank), dtype=dtype,
                             device=device),
            k_rope=torch.zeros((batch, seq_len, m.qk_rope_head_dim),
                               dtype=dtype, device=device))
    shape = (batch, seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def apply_block_decode(p, x, cache, pos, cfg: ModelConfig,
                       is_moe: bool = False):
    h = apply_norm(p["ln1"], x, cfg)
    decode = attn_mod.decode_attention if cfg.mla is None \
        else attn_mod.decode_mla
    mix, cache = decode(p["mixer"], h, cache, pos, cfg)
    x, _ = _ffn(p, x + mix.to(x.dtype), cfg, is_moe)
    return x, cache


# ---------------------------------------------------------------------------
# Whole-model params
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=None,
                device="cuda") -> Dict[str, Any]:
    """Random parameters (the reference's scales) drawn from ``gen`` on
    its device and placed on ``device`` (raises for "cuda" without a
    card).  ``dtype`` defaults to ``cfg.dtype``; norms stay float32."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = _dtype(cfg, dtype)
    params: Dict[str, Any] = {
        "tok_embed": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                in_axis=1, dtype=dtype, device=device),
        "final": init_norm(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                       in_axis=1, dtype=dtype, device=device)
    params["layers"] = [init_block(gen, cfg, is_moe, dtype, device=device)
                        for _, is_moe in layer_kinds(cfg)]
    if cfg.mtp_depth:
        D = cfg.d_model
        params["mtp"] = {
            "proj": dense_init(gen, (2 * D, D), dtype=dtype, device=device),
            "block": init_block(gen, cfg,
                                cfg.is_moe_layer(cfg.num_layers - 1),
                                dtype, device=device),
            "norm_h": init_norm(cfg, device=device),
            "norm_e": init_norm(cfg, device=device),
            "final": init_norm(cfg, device=device),
        }
    return params


# ---------------------------------------------------------------------------
# Whole-model forward (full sequence)
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """Token embedding: batch["tokens"] [B, S] -> x [B, S, D]."""
    check_supported(cfg)
    return params["tok_embed"][batch["tokens"]]


def forward_lm(params, cfg: ModelConfig, batch):
    """Full-sequence forward -> (hidden [B, S, D], aux_loss): the MoE
    layers' aux losses summed, float32 (0 for a dense model)."""
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, (_, is_moe) in zip(params["layers"], layer_kinds(cfg)):
        x, a = apply_block(p, x, positions, cfg, is_moe)
        if a is not None:
            aux = aux + a
    x = apply_norm(params["final"], x, cfg)
    return x, aux


def _head(params, cfg: ModelConfig):
    return params["tok_embed"] if cfg.tie_embeddings else params["lm_head"]


def _logits_matmul(h2, w):
    """h2 [T, D] x w [V, D] -> [T, V] float32.  Two bfloat16 CUDA operands
    go through one bf16 GEMM with an f32 output (f32 accumulation, as the
    reference's preferred_element_type); anything else is multiplied in
    float32."""
    if h2.dtype == w.dtype == torch.bfloat16 and h2.device.type == "cuda":
        return torch.mm(h2, w.t(), out_dtype=torch.float32)
    return h2.float() @ w.float().t()


def lm_logits(params, cfg: ModelConfig, hidden):
    """hidden [B, S, D] -> logits [B * S, V] float32."""
    B, S, D = hidden.shape
    return _logits_matmul(hidden.reshape(B * S, D), _head(params, cfg))


# ---------------------------------------------------------------------------
# Decode forward (one token)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
               device="cuda") -> List[Any]:
    """One zero KVCache (MLACache for MLA) per layer.  ``dtype``
    defaults to ``cfg.dtype``: the reference allocates bf16, and its
    first write promotes a float32 model's cache to float32; the port
    writes in place, so it allocates the activations' type."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = _dtype(cfg, dtype)
    return [init_block_cache(cfg, batch, seq_len, dtype, device)
            for _ in range(cfg.num_layers)]


def forward_decode(params, cfg: ModelConfig, tokens, cache, pos):
    """One-token decode. tokens: [B, 1]; pos: a scalar, or per-slot [B]
    (-1 = inactive).  Returns (logits [B, V] float32, cache), the cache
    updated in place."""
    x = embed_inputs(params, cfg, {"tokens": tokens})
    # once per step, not once per layer
    pos = attn_mod.positions_vector(pos, x.shape[0], x.device)
    new_cache = []
    for p, c, (_, is_moe) in zip(params["layers"], cache, layer_kinds(cfg)):
        x, c = apply_block_decode(p, x, c, pos, cfg, is_moe)
        new_cache.append(c)
    x = apply_norm(params["final"], x, cfg)
    return _logits_matmul(x[:, 0], _head(params, cfg)), new_cache


# ---------------------------------------------------------------------------
# Prefill (full sequence -> cache + last-token logits)
# ---------------------------------------------------------------------------

def _block_prefill(p, x, positions, cfg: ModelConfig, is_moe: bool,
                   cache_len: int):
    """Full-sequence block that also emits its decode cache (k and v, or
    MLA's c_kv and k_rope) padded with zeros to ``cache_len``."""
    mix, kv = _mix(p, apply_norm(p["ln1"], x, cfg), positions, cfg,
                   return_kv=True)
    pad = cache_len - x.shape[1]
    if cfg.mla is not None:
        state = MLACache(*(F.pad(t, (0, 0, 0, pad)) for t in kv))
    else:
        state = KVCache(*(F.pad(t, (0, 0, 0, 0, 0, pad)) for t in kv))
    x, _ = _ffn(p, x + mix.to(x.dtype), cfg, is_moe)
    return x, state


def forward_prefill(params, cfg: ModelConfig, batch, cache_len=None):
    """Prefill: the full-sequence forward, threading each layer's decode
    cache out.  Returns (last_logits [B, V] float32, cache)."""
    x = embed_inputs(params, cfg, batch)
    S = x.shape[1]
    clen = cache_len or S
    if clen < S:
        raise ValueError(f"forward_prefill: cache_len {clen} < {S} tokens")
    positions = torch.arange(S, device=x.device)
    cache = []
    for p, (_, is_moe) in zip(params["layers"], layer_kinds(cfg)):
        x, st = _block_prefill(p, x, positions, cfg, is_moe, clen)
        cache.append(st)
    x = apply_norm(params["final"], x, cfg)
    return _logits_matmul(x[:, -1], _head(params, cfg)), cache
