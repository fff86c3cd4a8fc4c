"""Mixture-of-Experts on one device: top-k routing with the aux
load-balance loss, the capacity-bucketed dispatch, the expert products,
DeepSeek's shared experts and Arctic's dense residual FFN (the
counterpart of ``repro.models.moe``).

The dispatch is the reference's: the (token, expert) pairs are sorted
by expert (stable, so a group keeps token order), each pair's place in
its group comes from per-expert counts, pairs past an expert's capacity
``cap_e`` are dropped (they go to a trash slot), and only the
``E * cap_e`` slots' token indices and weights are built -- no [T, E, C]
one-hot and no [T * K, D] copy of the tokens.  The expert products are
the reference's three einsums as batched GEMMs (they were plain XLA
products, outside any TPU kernel); the results are scattered back in
float32 by ``index_add_``.

``route`` is split from the expert body (``experts``) so that a test
can run the experts on the reference's own routing.  The
expert-parallel path under a mesh is ROADMAP.md queue 1 item 5.7:
``apply_moe`` raises for a mesh.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (act_fn, dense_init, refuse_mesh,
                                       stacked_init)


def init_moe(gen, cfg: ModelConfig, dtype=torch.bfloat16, device=None):
    """Router f32 [D, E]; wi, wg [E, D, F] and wo [E, F, D]; the shared
    experts' and the dense residual's gated FFNs where ``cfg.moe`` asks
    for them (the reference's shapes and scales)."""
    m = cfg.moe
    E, D, F = m.num_experts, cfg.d_model, m.d_expert
    p = {
        "router": dense_init(gen, (D, E), dtype=torch.float32,
                             device=device),
        "wi": stacked_init(gen, (E, D, F), dtype=dtype, device=device),
        "wg": stacked_init(gen, (E, D, F), dtype=dtype, device=device),
        "wo": stacked_init(gen, (E, F, D), dtype=dtype, device=device),
    }
    ffns = []
    if m.num_shared_experts:
        ffns.append(("shared", m.d_expert * m.num_shared_experts))
    if m.dense_residual:
        ffns.append(("dense", cfg.d_ff))
    for name, width in ffns:
        p[f"{name}_wi"] = dense_init(gen, (D, width), dtype=dtype,
                                     device=device)
        p[f"{name}_wg"] = dense_init(gen, (D, width), dtype=dtype,
                                     device=device)
        p[f"{name}_wo"] = dense_init(gen, (width, D), dtype=dtype,
                                     device=device)
    return {"moe": p}


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots per expert for T tokens: the reference's static capacity."""
    m = cfg.moe
    return int(max(8, -(-T * m.top_k // m.num_experts) * m.capacity_factor))


def route(x2d, router, top_k: int):
    """x2d [T, D] -> (top_idx [T, K] int64, top_w [T, K] float32, probs
    [T, E] float32): the softmax router in float32, its top k (largest
    first), the weights renormalised with the 1e-9 floor."""
    probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
    top_w, top_idx = torch.topk(probs, top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    return top_idx, top_w, probs


def aux_loss(probs, top_idx, cfg: ModelConfig):
    """E * sum(mean router prob * share of assignments) * weight."""
    m = cfg.moe
    E = m.num_experts
    T, K = top_idx.shape
    me = probs.mean(dim=0)
    flat = top_idx.reshape(-1)
    assign = torch.zeros(E, dtype=torch.float32, device=probs.device)
    assign.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    ce = assign / (T * K)
    return E * (me * ce).sum() * m.router_aux_weight


def _dispatch_local(x2d, top_idx, top_w, e_lo: int, e_hi: int, cap_e: int,
                    E_loc: int):
    """The pairs routed to experts [e_lo, e_hi) in [E_loc, cap_e, D]
    buckets -> (xe, (slot_token, slot_w, slot_valid)), each of the last
    three [E_loc * cap_e]; an empty slot has token 0, weight 0 and is
    not valid."""
    T, D = x2d.shape
    K = top_idx.shape[1]
    dev = x2d.device
    flat_e = top_idx.reshape(-1)
    flat_t = torch.arange(T * K, device=dev) // K
    flat_w = top_w.reshape(-1)

    is_local = (flat_e >= e_lo) & (flat_e < e_hi)
    local_e = torch.where(is_local, flat_e - e_lo, E_loc)  # sorts last
    order = torch.argsort(local_e, stable=True)
    se, st, sw = local_e[order], flat_t[order], flat_w[order]

    # each pair's place in its expert's group: its index less the group's
    # start, the starts from per-expert counts
    counts = torch.bincount(se, minlength=E_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_group = torch.arange(T * K, device=dev) - starts[se]

    keep = (se < E_loc) & (pos_in_group < cap_e)
    nslots = E_loc * cap_e
    slot = torch.where(keep, se * cap_e + pos_in_group, nslots)  # trash

    slot_token = torch.zeros(nslots + 1, dtype=torch.int64, device=dev)
    slot_w = torch.zeros(nslots + 1, dtype=torch.float32, device=dev)
    slot_valid = torch.zeros(nslots + 1, dtype=torch.bool, device=dev)
    slot_token[slot] = st
    slot_w[slot] = sw.float()
    slot_valid[slot] = True
    slot_token, slot_w, slot_valid = (slot_token[:-1], slot_w[:-1],
                                      slot_valid[:-1])

    # the gather is a new tensor: zero the empty slots in place
    xe = x2d[slot_token].mul_(slot_valid[:, None].to(x2d.dtype))
    return xe.reshape(E_loc, cap_e, D), (slot_token, slot_w, slot_valid)


def _combine_local(ye, info, T: int, D: int):
    """The weighted expert outputs [E_loc, cap_e, D] summed back per
    token in float32 -> [T, D]."""
    slot_token, slot_w, slot_valid = info
    w = (slot_w * slot_valid).float()[:, None]
    out = torch.zeros((T, D), dtype=torch.float32, device=ye.device)
    # ye promoted to float32 inside the product: one [E * cap_e, D] buffer
    return out.index_add_(0, slot_token, ye.reshape(-1, D) * w)


def _gated(x, wg, wi, wo, cfg: ModelConfig):
    return (act_fn(cfg.act)(x @ wg) * (x @ wi)) @ wo


def experts(x2d, p, cfg: ModelConfig, top_idx, top_w):
    """The expert body on a given routing: dispatch, the gated expert
    FFN per bucket, combine, plus the shared experts and the dense
    residual in float32 -> [T, D] in x2d's type."""
    m = cfg.moe
    T, D = x2d.shape
    E_loc = p["wi"].shape[0]
    xe, info = _dispatch_local(x2d, top_idx, top_w, 0, E_loc,
                               capacity(T, cfg), E_loc)
    out = _combine_local(_gated(xe, p["wg"], p["wi"], p["wo"], cfg), info,
                         T, D)
    if m.num_shared_experts:
        out = out + _gated(x2d, p["shared_wg"], p["shared_wi"],
                           p["shared_wo"], cfg).float()
    if m.dense_residual:
        out = out + _gated(x2d, p["dense_wg"], p["dense_wi"],
                           p["dense_wo"], cfg).float()
    return out.to(x2d.dtype)


def _moe_local(x2d, p, cfg: ModelConfig):
    """x2d [T, D] -> (out [T, D], aux loss scalar)."""
    top_idx, top_w, probs = route(x2d, p["router"], cfg.moe.top_k)
    return (experts(x2d, p, cfg, top_idx, top_w),
            aux_loss(probs, top_idx, cfg))


def apply_moe(p, x, cfg: ModelConfig, *, mesh=None) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss scalar float32)."""
    refuse_mesh(mesh, "expert-parallel MoE")
    B, S, D = x.shape
    out, aux = _moe_local(x.reshape(B * S, D), p["moe"], cfg)
    return out.reshape(B, S, D), aux
