"""Activity-gated spike conv as a GEMM over the spike-im2col patch
matrix: the plain version and the wrapper of its CUDA kernel
(``csrc/spike_conv.cu``).

``occupancy_mask`` is one plain torch reduction per call: one int32 per
(128-row, 128-K) tile of the patch matrix, 1 where the tile holds a
spike.  The kernel skips the loads and multiply-adds of every tile whose
bit is 0 (the ``"mask"`` gate; an all-ones mask is ``"none"``), or,
given no mask, checks each tile itself (``"inline"``).  A skipped
tile's contribution is exact zeros, so the plain version
(``blocked_matmul``, canonical 128-wide K blocks) is the same function
under every gate.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.layers import blocked_matmul
from repro_torch.kernels.blocks import DEFAULT_BK, DEFAULT_BM
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)

_SIG = ("spike_conv_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p])
_GATE_MASK, _GATE_INLINE = 0, 1         # gated_gemm.cuh GateMode


def occupancy_mask(patches: torch.Tensor, *, bm: int = DEFAULT_BM,
                   bk: int = DEFAULT_BK) -> torch.Tensor:
    """int32 [ceil(M/bm), ceil(K/bk)]: 1 where the tile holds a live
    (non-zero) activation."""
    M, K = patches.shape
    pm, pk = (-M) % bm, (-K) % bk
    if pm or pk:
        patches = F.pad(patches, (0, pk, 0, pm))
    t = patches.reshape((M + pm) // bm, bm, (K + pk) // bk, bk)
    return (t != 0).any(dim=3).any(dim=1).to(torch.int32)


def spike_conv(patches: torch.Tensor, wmat: torch.Tensor,
               occ: Optional[torch.Tensor]) -> torch.Tensor:
    """patches [M, K] spike patch matrix, wmat [K, N], occ the patches'
    ``occupancy_mask`` (an all-ones mask computes every tile; None
    checks each tile in the kernel instead) -> patches @ wmat [M, N]
    float32."""
    if patches.dim() != 2 or wmat.dim() != 2 \
            or patches.shape[1] != wmat.shape[0]:
        raise ValueError(f"spike_conv: shapes {tuple(patches.shape)} @ "
                         f"{tuple(wmat.shape)} do not chain")
    M, K = patches.shape
    N = wmat.shape[1]
    want = (-(-M // DEFAULT_BM), -(-K // DEFAULT_BK))
    dev = check_f32("spike_conv", patches, wmat)
    if occ is not None:
        if occ.dtype != torch.int32 or tuple(occ.shape) != want:
            raise ValueError(f"spike_conv: occ must be int32 {want}, got "
                             f"{occ.dtype} {tuple(occ.shape)}")
        if occ.device != dev or not occ.is_contiguous():
            raise ValueError("spike_conv: occ must be contiguous on the "
                             "patches' device")
    if dev.type == "cpu":
        return blocked_matmul(patches, wmat)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = load("spike_conv", _SIG)
    with torch.cuda.device(dev):
        err = lib.spike_conv_launch(
            patches.data_ptr(), wmat.data_ptr(),
            0 if occ is None else occ.data_ptr(), want[1], out.data_ptr(),
            M, K, N, _GATE_INLINE if occ is None else _GATE_MASK,
            stream_of(dev))
    check_launch("spike_conv", err)
    return out
