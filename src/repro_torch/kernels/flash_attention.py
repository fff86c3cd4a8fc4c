"""Blocked flash attention on the model's layout: the plain versions and
the wrapper of its CUDA kernel (``csrc/flash_attention.cu``).

``flash_attention_plain`` ports the reference model's online-softmax
scan over KV blocks (``repro.models.attention.flash_attention``, the twin
of the TPU kernel): q [B, Sq, Hq, d], k [B, Sk, Hkv, d], v [B, Sk, Hkv,
dv], GQA by repeating each KV head over its Hq / Hkv query heads, f32
math, q's type out.  ``flash_attention_ref_plain`` is the one-shot
softmax of ``repro.kernels.ref.flash_attention_ref`` on [BH, S, d].

``flash_attention`` is the wrapper: a CPU tensor takes the plain scan, a
CUDA tensor launches the kernel or raises.  ``kernel_design`` names the
kernel from the type and head dims alone: bfloat16 at
``WGMMA_HEAD_DIMS`` (every full-width LM config's head) runs "wgmma"
(wgmma on a TMA-fed K/V ring, warp-specialised, persistent), other
bfloat16 head dims "mma_sync", float32 "f32" (CUDA cores).  Each launch
adds one to ``build.LAUNCHES["flash_attention"]`` and one to
``build.LAUNCHES["flash_attention:<design>"]``.  ``wgmma_schedule`` is
the "wgmma" kernel's work list and its split over the blocks;
``wgmma_products`` runs that kernel's two tensor-core products alone.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import (LAUNCHES, check_launch, load,
                                      refuse_grad, stream_of)

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
# the (d, dv) pairs the "f32" and "mma_sync" kernels are built for
# (csrc/flash_attention.cu), and those of the "wgmma" kernel
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (32, 16))
WGMMA_HEAD_DIMS = ((64, 64), (128, 128))
# csrc/flash_attention.cu `Design`
DESIGNS = {"f32": 0, "mma_sync": 1, "wgmma": 2}
# the "wgmma" kernel's query rows per work item and keys per tile
WGMMA_BM = WGMMA_BN = 128
# a launch error at or past this is a failed tensor-map encode, plus its
# CUresult
TENSOR_MAP_ERR = 1 << 16
BF16_U = 2.0 ** -8      # bfloat16's unit roundoff (8 significant bits)

_SIG = ("flash_attention_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
         ctypes.c_void_p])
_PROBE_SIG = ("flash_attention_probe",
              [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p])


def visible_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, Sk: int,
                 causal: bool, window: int) -> torch.Tensor:
    """bool [Sq, Sk']: key position k_pos visible to query position q_pos
    (absolute positions; k_pos past Sk is padding)."""
    mask = (k_pos[None, :] < Sk).expand(q_pos.shape[0], -1)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def flash_attention_plain(q, k, v, *, causal: bool, q_offset: int = 0,
                          window: int = 0, block: int = 512):
    """The reference model's blocked scan, in its order: per KV block
    ``s = (q . k) * scale``, mask to -1e30, running max, exp, correction;
    out = acc / max(l, 1e-30) in q's type."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = Hq // Hkv
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    qg = q.float()
    scale = hd ** -0.5
    nblk = -(-Sk // block)
    pad = nblk * block - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, Hq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hq, hdv), dtype=torch.float32, device=dev)
    for bidx in range(nblk):
        sl = slice(bidx * block, (bidx + 1) * block)
        k_pos = bidx * block + torch.arange(block, device=dev)
        s = torch.einsum("bqhd,bkhd->bqhk", qg, k[:, sl].float()) * scale
        mask = visible_mask(q_pos, k_pos, Sk=Sk, causal=causal, window=window)
        s = torch.where(mask[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p, v[:, sl].float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def flash_attention_ref_plain(q, k, v, *, causal: bool = True):
    """One-shot softmax attention: q [BH, Sq, d]; k, v [BH, Sk, d(v)]."""
    BH, Sq, d = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkv->bqv", p, v.float()).to(q.dtype)


def bf16_error_bound(q, k, v, got, want, *, causal: bool, q_offset: int = 0,
                     window: int = 0, atol: float = 1e-5) -> torch.Tensor:
    """Elementwise bound on |got - want| for the bfloat16 kernel's output
    ``got`` against the plain scan's ``want`` on the same bf16 inputs.

    The kernel rounds each softmax weight p_j to bf16 for the P.V product
    (a relative error of at most BF16_U), which moves the output by at
    most BF16_U * A, A = sum_j p_j |v_j| / l (attention over |v|); each
    output then rounds to bf16 (at most BF16_U of itself).  So |got -
    want| <= BF16_U (A + |got| + |want|) + atol, where atol, the float32
    kernel's bar, covers the f32 arithmetic.  A dropped or doubled key
    tile moves the output by a share of A far past BF16_U."""
    a = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                              causal=causal, q_offset=q_offset, window=window)
    return BF16_U * (a + got.float().abs() + want.float().abs()) + atol


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, H, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, Hq, d = q.shape
    if k.shape[0] != B or v.shape[0] != B or k.shape[1:3] != v.shape[1:3] \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads over {Hkv} KV "
                         "heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def kernel_design(dtype, d: int, dv: int) -> str:
    """The kernel a CUDA call of ``flash_attention`` runs, from its type
    and head dims alone."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if (d, dv) in WGMMA_HEAD_DIMS else "mma_sync"


def key_range(q0: int, q1: int, *, Sk: int, causal: bool, q_offset: int,
              window: int):
    """The keys [lo, hi) some query row of [q0, q1) can see (the kernels'
    ``key_range``)."""
    hi = min(Sk, q1 + q_offset) if causal else Sk
    lo = max(0, q0 + q_offset - window + 1) if window > 0 else 0
    return lo, max(hi, lo)


def wgmma_schedule(B: int, Sq: int, Sk: int, Hq: int, *, causal: bool,
                   q_offset: int = 0, window: int = 0, n_blocks: int):
    """The "wgmma" kernel's work: per block, its items (b, h, q0, key
    tiles) in the order it runs them.  The list runs query tiles
    outermost (causal: the last, longest, first), then batch, then query
    head, so a KV head's G query heads are adjacent; block x takes item x
    of each even round of ``n_blocks`` items and item n_blocks - 1 - x of
    each odd one."""
    n_mb = -(-Sq // WGMMA_BM)
    items = []
    for mi in range(n_mb):
        q0 = ((n_mb - 1 - mi) if causal else mi) * WGMMA_BM
        lo, hi = key_range(q0, min(q0 + WGMMA_BM, Sq), Sk=Sk, causal=causal,
                           q_offset=q_offset, window=window)
        tiles = -(-(hi - lo) // WGMMA_BN)
        items += [(b, h, q0, tiles) for b in range(B) for h in range(Hq)]
    blocks = [[] for _ in range(min(n_blocks, len(items)))]
    n = len(blocks)
    for r in range(-(-len(items) // max(n, 1))):
        for x in range(n):
            idx = r * n + (n - 1 - x if r % 2 else x)
            if idx < len(items):
                blocks[x].append(items[idx])
    return blocks


def _launch(q, k, v, *, causal: bool, q_offset: int, window: int,
            design: str) -> torch.Tensor:
    """Launch ``design`` on CUDA tensors.  The model path passes
    ``kernel_design``'s choice; timing code may pass "mma_sync" to time
    the earlier design at (128, 128) beside "wgmma"."""
    _check(q, k, v)
    B, Sq, Hq, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if (design == "f32") != (q.dtype == torch.float32):
        raise TypeError(f"flash_attention: {q.dtype} on design {design!r}")
    built = WGMMA_HEAD_DIMS if design == "wgmma" else HEAD_DIMS
    if (d, dv) not in built:
        raise ValueError(f"flash_attention: head dims (d={d}, dv={dv}) are "
                         f"not built for {design!r}; built: {built}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if design == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the TMA loads need q, k, v on "
                         "16-byte boundaries")
    out = torch.empty((B, Sq, Hq, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = load("flash_attention", _SIG)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, Hq, Hkv, d, dv, int(causal), int(q_offset),
            int(window), d ** -0.5, DESIGNS[design], stream_of(q.device))
    _check_launch("flash_attention", err)
    LAUNCHES[f"flash_attention:{design}"] += 1
    return out


def _check_launch(name: str, err: int) -> None:
    """``build.check_launch``, naming a failed tensor-map encode."""
    if err >= TENSOR_MAP_ERR:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: "
                           f"CUresult {err - TENSOR_MAP_ERR}")
    check_launch(name, err)


def flash_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                    window: int = 0) -> torch.Tensor:
    """q [B, Sq, Hq, d], k [B, Sk, Hkv, d], v [B, Sk, Hkv, dv] (float32 or
    bfloat16, one type) -> [B, Sq, Hq, dv] in q's type.  A CPU tensor
    takes ``flash_attention_plain``; a CUDA tensor launches the kernel of
    ``kernel_design``."""
    if q.device.type == "cpu":
        _check(q, k, v)
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, window=window)
    refuse_grad("flash_attention", q, k, v)
    return _launch(q, k, v, causal=causal, q_offset=q_offset, window=window,
                   design=kernel_design(q.dtype, q.shape[3], v.shape[3]))


def wgmma_products(q, k, v):
    """The "wgmma" kernel's two tensor-core products alone: bf16 q, k
    [128, d] and v [128, dv] -> (s = q k^T, o = bf16(s) v), both float32
    [128, 128] and [128, dv].  CPU tensors take the plain products; CUDA
    tensors one block of ``flash_attention_probe`` (the kernel's own TMA
    loads, descriptors and register fragments)."""
    d, dv = q.shape[1], v.shape[1]
    if (q.dtype, k.dtype, v.dtype) != (torch.bfloat16,) * 3 or q.shape[0] \
            != WGMMA_BN or k.shape != q.shape or v.shape[0] != WGMMA_BN:
        raise ValueError("wgmma_products: bf16 q, k [128, d], v [128, dv]")
    if q.device.type == "cpu":
        s = q.float() @ k.float().T
        return s, s.bfloat16().float() @ v.float()
    if (d, dv) not in WGMMA_HEAD_DIMS:
        raise ValueError(f"wgmma_products: (d={d}, dv={dv}) not built")
    q, k, v = (t.contiguous() for t in (q, k, v))
    s = torch.empty((WGMMA_BN, WGMMA_BN), dtype=torch.float32,
                    device=q.device)
    o = torch.empty((WGMMA_BN, dv), dtype=torch.float32, device=q.device)
    lib = load("flash_attention", _PROBE_SIG)
    with torch.cuda.device(q.device):
        err = lib.flash_attention_probe(q.data_ptr(), k.data_ptr(),
                                        v.data_ptr(), s.data_ptr(),
                                        o.data_ptr(), d, dv,
                                        stream_of(q.device))
    _check_launch("flash_attention_probe", err)
    return s, o
