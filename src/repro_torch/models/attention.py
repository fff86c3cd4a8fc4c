"""GQA and MLA attention: the full-sequence block (train / prefill)
through the flash-attention kernel, and one-token decode against a cache
(the counterpart of ``repro.models.attention``, without a mesh: the
reference's ``shard`` calls and its shard_map / LSE-merge paths are
no-ops on one device; MLA raises for a mesh, ROADMAP.md queue 1 item
5.7).

Layouts as the reference's: q [B, S, Hq, hd], k and v [B, S, Hkv, hd],
the GQA cache [B, max_len, Hkv, hd], the MLA cache c_kv [B, max_len,
kv_lora_rank] and k_rope [B, max_len, rope dim], weights applied as
``x @ w``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
# the model-layout flash attention (the reference's twin of the TPU
# kernel): the kernel on a CUDA tensor, its plain scan on a CPU one
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.blocks import apply_rope, dense_init, refuse_mesh

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    hd = cfg.resolved_head_dim
    D, Hq, Hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, (D, Hq * hd), dtype=dtype, device=device),
        "wk": dense_init(gen, (D, Hkv * hd), dtype=dtype, device=device),
        "wv": dense_init(gen, (D, Hkv * hd), dtype=dtype, device=device),
        "wo": dense_init(gen, (Hq * hd, D), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        dev = p["wq"].device
        for name, n in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
            p[name] = torch.zeros((n * hd,), dtype=dtype, device=dev)
    return {"attn": p}


def init_mla(gen, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    """DeepSeek's multi-head latent attention: the q down/up projections,
    the down-projection to the kv latent and the decoupled RoPE key, the
    latent's up-projection to each head's nope key and value, and wo."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    shapes = {
        "wq_a": (D, m.q_lora_rank),
        "wq_b": (m.q_lora_rank, H * qk),
        "wkv_a": (D, m.kv_lora_rank + m.qk_rope_head_dim),
        "wkv_b": (m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim)),
        "wo": (H * m.v_head_dim, D),
    }
    return {"mla": {k: dense_init(gen, s, dtype=dtype, device=device)
                    for k, s in shapes.items()}}


def _project_qkv(a, x, cfg: ModelConfig):
    """x [..., D] -> q [..., Hq * hd], k, v [..., Hkv * hd], biases added
    before RoPE as the reference adds them."""
    q, k, v = x @ a["wq"], x @ a["wk"], x @ a["wv"]
    if cfg.qkv_bias:
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    return q, k, v


def apply_attention(p, x, positions, cfg: ModelConfig, *,
                    window: Optional[int] = None, return_kv: bool = False):
    """x: [B, S, D]; positions: [S]. Returns [B, S, D] (+ (k, v))."""
    a = p["attn"]
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    q, k, v = _project_qkv(a, x, cfg)
    q = apply_rope(q.reshape(B, S, Hq, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, hd)
    w = (window if window is not None else cfg.attention_window) or 0
    out = flash_attention(q, k, v, causal=cfg.causal, q_offset=0, window=w)
    out = out.reshape(B, S, Hq * hd) @ a["wo"]
    if return_kv:
        return out, (k, v)
    return out


def apply_mla(p, x, positions, cfg: ModelConfig, *, return_kv: bool = False,
              mesh=None):
    """MLA's full-sequence block in the non-absorbed form: every head's
    key is its nope part from the latent and the one RoPE key, broadcast
    over the H heads (so Hkv = H), and attention runs at (d, dv) = (nope
    + rope dim, v_head_dim) with scale d^-0.5.  x: [B, S, D];
    positions: [S].  Returns [B, S, D] (+ (c_kv [B, S, c], k_rope [B, S,
    dr]), the decode cache's state)."""
    refuse_mesh(mesh, "MLA")
    m = cfg.mla
    w = p["mla"]
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    q = ((x @ w["wq_a"]) @ w["wq_b"]).reshape(B, S, H, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)

    kv_a = x @ w["wkv_a"]                                # [B, S, c + dr]
    c_kv = kv_a[..., :m.kv_lora_rank]
    k_rope = apply_rope(kv_a[:, :, None, m.kv_lora_rank:], positions,
                        cfg.rope_theta)                  # [B, S, 1, dr]
    kv = (c_kv @ w["wkv_b"]).reshape(B, S, H, dn + dv)

    q_full = torch.cat([q[..., :dn], q_rope], dim=-1)
    k_full = torch.cat([kv[..., :dn], k_rope.expand(B, S, H, dr)], dim=-1)
    out = flash_attention(q_full, k_full, kv[..., dn:].contiguous(),
                          causal=cfg.causal, q_offset=0)
    out = out.reshape(B, S, H * dv) @ w["wo"]
    if return_kv:
        return out, (c_kv, k_rope[:, :, 0, :])
    return out


class KVCache(NamedTuple):
    """GQA cache. k/v: [B, S, Hkv, hd]."""
    k: torch.Tensor
    v: torch.Tensor


class MLACache(NamedTuple):
    """MLA compressed cache. c_kv: [B, S, c], k_rope: [B, S, dr]."""
    c_kv: torch.Tensor
    k_rope: torch.Tensor


def _decode_attn(q, kc, vc, cache_len):
    """q: [B, Hq, hd]; kc/vc: [B, S, Hkv, hd]; ``cache_len`` [B]: the
    valid tokens of each row.  A row with none (an inactive slot) gives
    the mean of v over the cache, finite, as the reference's -1e30 mask
    does."""
    B, S, Hkv, hd = kc.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kc.float()) * hd ** -0.5
    k_pos = torch.arange(S, device=kc.device)
    valid = k_pos[None, :] < cache_len[:, None]                  # [B, S]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, vc.float())
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Hq, hd)


def bf16_parts(x: torch.Tensor) -> torch.Tensor:
    """float32 x [T, K] -> bf16 [3, T, K] whose sum in float32 is x
    exactly: each part holds the next 8 significant bits (x's 24 in all;
    the rest of each rounding is exact in float32)."""
    hi = x.bfloat16()
    rest = x - hi.float()
    mid = rest.bfloat16()
    return torch.stack((hi, mid, (rest - mid.float()).bfloat16()))


def _f32_matmul(x, w):
    """float32 x [T, K] @ w [K, N] -> float32, the reference's promoted
    product.  A bfloat16 CUDA w is not copied to float32 (every layer's
    wo, each decode step): the three bf16 parts of x go through one bf16
    GEMM with an f32 output (exact products, f32 accumulation), summed."""
    if w.dtype != torch.bfloat16 or w.device.type != "cuda":
        return x @ w.to(x.dtype)
    T = x.shape[0]
    y = torch.mm(bf16_parts(x).reshape(3 * T, -1), w,
                 out_dtype=torch.float32)
    return y.reshape(3, T, -1).sum(dim=0)


def positions_vector(pos, batch: int, device) -> torch.Tensor:
    """A scalar or per-slot position as an int64 [batch] tensor on
    ``device``; a Python int becomes one without a host-to-device copy."""
    if isinstance(pos, int):
        return torch.full((batch,), pos, dtype=torch.int64, device=device)
    return torch.as_tensor(pos, device=device).reshape(-1).expand(batch)


def _write_slot(cache_t, rows, idx, ok, new):
    """cache_t[b, idx[b]] = new[b] where ok[b], in place (a masked
    select: an inactive or out-of-range slot writes its old value back)."""
    ok = ok.reshape(ok.shape + (1,) * (new.dim() - 1))
    cache_t[rows, idx] = torch.where(ok, new.to(cache_t.dtype),
                                     cache_t[rows, idx])


def decode_attention(p, x, cache: KVCache, pos, cfg: ModelConfig):
    """One-token decode. x: [B, 1, D]; pos: a scalar position, or a
    per-slot [B] vector (continuous batching; -1 marks an inactive slot,
    which writes nothing).  Returns ([B, 1, D], cache).

    The new token's k and v are written into ``cache`` in place (the
    reference returns a new cache; the returned KVCache holds the same
    tensors).  A scalar position is the vector of B equal positions."""
    a = p["attn"]
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.num_heads, cfg.num_kv_heads
    q, k, v = _project_qkv(a, x[:, 0, :], cfg)
    posv = positions_vector(pos, B, x.device)
    rope_pos = posv[:, None]
    q = apply_rope(q.reshape(B, 1, Hq, hd), rope_pos, cfg.rope_theta)[:, 0]
    k = apply_rope(k.reshape(B, 1, Hkv, hd), rope_pos, cfg.rope_theta)[:, 0]
    v = v.reshape(B, Hkv, hd)

    kc, vc = cache
    S = kc.shape[1]
    # write slot b's token at pos[b] when 0 <= pos[b] < S
    rows = torch.arange(B, device=x.device)
    ok = (posv >= 0) & (posv < S)
    idx = posv.clamp(0, S - 1)
    _write_slot(kc, rows, idx, ok, k)
    _write_slot(vc, rows, idx, ok, v)

    out = _decode_attn(q, kc, vc, posv + 1)
    # f32 attention output against the weights' type: the reference
    # promotes the product to f32
    out = _f32_matmul(out.reshape(B, Hq * hd), a["wo"])
    return out[:, None, :], KVCache(kc, vc)


def decode_mla(p, x, cache: MLACache, pos, cfg: ModelConfig, *, mesh=None):
    """MLA one-token decode with the absorbed weights: the query's nope
    part is taken into the latent space (q_lat = q_nope . wk, float32), the
    scores run against the compressed cache (c_kv and k_rope), the output
    is un-absorbed through wv.  x: [B, 1, D]; pos: a scalar, or per-slot
    [B] (-1 = inactive, writes nothing).  Returns ([B, 1, D], cache), the
    new token's latent and RoPE key written into ``cache`` in place."""
    refuse_mesh(mesh, "MLA")
    m = cfg.mla
    w = p["mla"]
    B = x.shape[0]
    H = cfg.num_heads
    dn, dr, dv, c = (m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim,
                     m.kv_lora_rank)
    posv = positions_vector(pos, B, x.device)
    rope_pos = posv[:, None]

    xq = x[:, 0, :]
    q = ((xq @ w["wq_a"]) @ w["wq_b"]).reshape(B, H, dn + dr)
    q_rope = apply_rope(q[:, None, :, dn:], rope_pos, cfg.rope_theta)[:, 0]
    kv_a = xq @ w["wkv_a"]
    kr_new = apply_rope(kv_a[:, None, None, c:], rope_pos,
                        cfg.rope_theta)[:, 0, 0]

    wkv_b = w["wkv_b"].reshape(c, H, dn + dv)
    q_lat = torch.einsum("bhd,chd->bhc", q[..., :dn].float(),
                         wkv_b[..., :dn].float())

    cc, krc = cache
    S = cc.shape[1]
    rows = torch.arange(B, device=x.device)
    ok = (posv >= 0) & (posv < S)
    idx = posv.clamp(0, S - 1)
    _write_slot(cc, rows, idx, ok, kv_a[:, :c])
    _write_slot(krc, rows, idx, ok, kr_new)

    ccf = cc.float()
    s = (torch.einsum("bhc,bkc->bhk", q_lat, ccf)
         + torch.einsum("bhd,bkd->bhk", q_rope.float(), krc.float())) \
        * (dn + dr) ** -0.5
    k_pos = torch.arange(S, device=x.device)
    s = torch.where(k_pos[None, None, :] < (posv + 1)[:, None, None], s,
                    NEG_INF)
    mx = s.amax(dim=-1)
    pr = torch.exp(s - mx[..., None])
    o_lat = torch.einsum("bhk,bkc->bhc", pr, ccf) / torch.clamp(
        pr.sum(dim=-1)[..., None], min=1e-30)
    out = torch.einsum("bhc,chd->bhd", o_lat, wkv_b[..., dn:].float())
    out = out.reshape(B, H * dv).to(x.dtype) @ w["wo"]
    return out[:, None, :], MLACache(cc, krc)
