"""The fused spiking-conv layer — conv, instance norm over (T, HW),
affine and the T-step LIF in one kernel: its plain version, the wrapper
of its CUDA kernel (``csrc/spike_conv_lif.cu``) and the slab occupancy
mask of its ``"mask"`` gate.

The kernel runs one block per (batch element, slice of ``bn`` channels)
and keeps the slice's whole [T*HW, bn] conv output in shared memory, so
a slice width is usable at a shape only where that slab fits
(``slice_widths``).  Its conv sums K in canonical 128-wide blocks as
``spike_conv`` does and its statistics replay ``norm_affine_lif``'s, so
its spikes equal the per-op pair's; the plain version is the per-op
pair's plain composition on the patch matrix.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.layers import NORM_EPS, blocked_matmul
from repro_torch.core.lif import f32_decay
from repro_torch.kernels.blocks import CANONICAL_K_BLOCK, DEFAULT_BM
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)
from repro_torch.kernels.lif_scan import norm_affine_lif_plain

_SIG = ("spike_conv_lif_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float] * 4
        + [ctypes.c_void_p])

GATES = ("mask", "inline", "none")      # the kernel's GateMode order
SLICE_WIDTHS = (64, 32, 16, 8, 4, 2, 1)  # channels per block, widest first
THREADS = 256
SMEM_LIMIT = 232448     # dynamic shared memory a Hopper block may opt into
_SLICE_K = 64           # K staged per step (spike_conv_lif.cu kSliceK)
_ROW_CLASSES = 32       # statistics row classes (lif_common.cuh)


def smem_bytes(rows: int, nc: int) -> int:
    """Dynamic shared memory of one block at slice width ``nc`` over
    ``rows`` = T*HW rows: the kernel's layout (spike_conv_lif.cu)."""
    bm = max(64, THREADS // nc)
    return 8 * _ROW_CLASSES * nc + 4 * (2 * nc + _SLICE_K * (bm + 4)
                                        + _SLICE_K * nc + rows * nc)


def slice_widths(rows: int, n: int) -> Tuple[int, ...]:
    """Slice widths the kernel can launch at a layer of ``rows`` = T*HW
    rows and ``n`` channels, widest first: the slab fits in shared
    memory, and the width is at most ``n`` rounded up to a power of two."""
    return tuple(w for w in SLICE_WIDTHS
                 if w < 2 * n and smem_bytes(rows, w) <= SMEM_LIMIT)


def slab_occupancy_mask(x3: torch.Tensor, *,
                        bm: int = DEFAULT_BM) -> torch.Tensor:
    """Per-(batch, row chunk, canonical K block) occupancy of the batched
    patch slab x3 [B, T*HW, K]: int32 [B, ceil(T*HW/bm), ceil(K/128)],
    1 where the tile holds a live activation (a copy of the reference's
    ``slab_occupancy_mask``; K is padded here, not by the caller)."""
    B, THW, K = x3.shape
    pr, pk = (-THW) % bm, (-K) % CANONICAL_K_BLOCK
    if pr or pk:
        x3 = F.pad(x3, (0, pk, 0, pr))
    t = x3.reshape(B, (THW + pr) // bm, bm, (K + pk) // CANONICAL_K_BLOCK,
                   CANONICAL_K_BLOCK)
    return (t != 0).any(dim=4).any(dim=2).to(torch.int32)


def spike_conv_lif_plain(patches, wmat, scale, bias, *, T: int, B: int,
                         HW: int, tau: float = 2.0, v_th: float = 1.0,
                         v_reset: float = 0.0,
                         eps: float = NORM_EPS) -> torch.Tensor:
    """``blocked_matmul`` -> instance norm + affine -> LIF on the patch
    matrix, in the per-op pair's layout (a contiguous [T, B, HW, N]
    conv output), so its bits are the per-op composition's."""
    y = blocked_matmul(patches, wmat).reshape(B, T, HW, -1)
    return norm_affine_lif_plain(y.transpose(0, 1).contiguous(), scale, bias,
                                 tau=tau, v_th=v_th, v_reset=v_reset, eps=eps)


def spike_conv_lif(patches: torch.Tensor, wmat: torch.Tensor,
                   scale: torch.Tensor, bias: torch.Tensor, *, T: int,
                   B: int, HW: int, gate: str = "mask",
                   bn: Optional[int] = None,
                   occ: Optional[torch.Tensor] = None, tau: float = 2.0,
                   v_th: float = 1.0, v_reset: float = 0.0,
                   eps: float = NORM_EPS) -> torch.Tensor:
    """patches [B*T*HW, K] (batch-major rows), wmat [K, N], scale/bias
    [N] -> spikes [T, B, HW, N].  ``gate`` is "mask", "inline" or
    "none"; ``bn`` the channels per block (default the widest that
    fits); ``occ`` the ``"mask"`` gate's ``slab_occupancy_mask``
    (computed here when None)."""
    if patches.dim() != 2 or wmat.dim() != 2 \
            or patches.shape[1] != wmat.shape[0]:
        raise ValueError(f"spike_conv_lif: shapes {tuple(patches.shape)} @ "
                         f"{tuple(wmat.shape)} do not chain")
    M, K = patches.shape
    N = wmat.shape[1]
    if M != B * T * HW:
        raise ValueError(f"spike_conv_lif: {M} patch rows != B*T*HW = "
                         f"{B * T * HW}")
    if scale.shape != (N,) or bias.shape != (N,):
        raise ValueError(f"spike_conv_lif: scale/bias must be [{N}], got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if gate not in GATES:
        raise ValueError(f"spike_conv_lif: gate must be one of {GATES}, "
                         f"got {gate!r}")
    widths = slice_widths(T * HW, N)
    if bn is None and widths:
        bn = widths[0]
    if bn not in widths:
        raise ValueError(f"spike_conv_lif: no {bn}-channel slice of a "
                         f"[{T * HW}, {N}] slab fits a block (widths that "
                         f"do: {widths})")
    dev = check_f32("spike_conv_lif", patches, wmat, scale, bias)
    if dev.type == "cpu":
        return spike_conv_lif_plain(patches, wmat, scale, bias, T=T, B=B,
                                    HW=HW, tau=tau, v_th=v_th,
                                    v_reset=v_reset, eps=eps)
    occ_ptr = 0
    if gate == "mask":
        if occ is None:
            occ = slab_occupancy_mask(patches.reshape(B, T * HW, K))
        want = (B, -(-(T * HW) // DEFAULT_BM), -(-K // CANONICAL_K_BLOCK))
        if occ.dtype != torch.int32 or tuple(occ.shape) != want \
                or occ.device != dev or not occ.is_contiguous():
            raise ValueError(f"spike_conv_lif: occ must be a contiguous "
                             f"int32 {want} on {dev}")
        occ_ptr = occ.data_ptr()
    out = torch.empty((T, B, HW, N), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = load("spike_conv_lif", _SIG)
    with torch.cuda.device(dev):
        err = lib.spike_conv_lif_launch(
            patches.data_ptr(), wmat.data_ptr(), occ_ptr, scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), T, B, HW, K, N, bn,
            GATES.index(gate), f32_decay(tau), v_th, v_reset, eps,
            stream_of(dev))
    check_launch("spike_conv_lif", err)
    return out
