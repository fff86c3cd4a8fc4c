"""Activity-gated depthwise spike conv: the wrapper of its CUDA kernel
(``csrc/spike_dwconv.cu``).  The plain version is the tap loop of
:func:`repro_torch.core.layers.spike_conv` (``depthwise=True``), which
the wrapper takes for CPU tensors; for CUDA tensors it launches the
kernel or raises.  The kernel reads the folded activation directly (no
patch tensor) and skips a tap whose input is zero; both sum the taps in
the same order with the same roundings, so they give the same bits for
finite weights.

``tap_occupancy_mask`` is the reference's per-(row block, tap) gate of
the TPU kernel, kept as telemetry: the share of tap slabs with no spike.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.core.layers import _same_pads, spike_conv
from repro_torch.kernels.blocks import DEFAULT_BM
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)

_SIG = ("spike_dwconv_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def tap_occupancy_mask(patches3: torch.Tensor, *,
                       bm: int = DEFAULT_BM) -> torch.Tensor:
    """patches3 [M, taps, C] -> int32 [ceil(M/bm), taps]: 1 where the row
    block has a live (non-zero) activation under the tap, any channel."""
    M, taps, C = patches3.shape
    pm = (-M) % bm
    if pm:
        patches3 = F.pad(patches3, (0, 0, 0, 0, 0, pm))
    t = patches3.reshape((M + pm) // bm, bm, taps, C)
    return (t != 0).any(dim=3).any(dim=1).to(torch.int32)


def spike_dwconv(xf: torch.Tensor, w: torch.Tensor, *,
                 stride: int = 1) -> torch.Tensor:
    """xf [N, H, W, C] folded activations, w [kh, kw, 1, C] -> the
    depthwise conv [N, Ho, Wo, C], SAME padding."""
    if xf.dim() != 4 or w.dim() != 4 or w.shape[2] != 1 \
            or w.shape[3] != xf.shape[3]:
        raise ValueError(f"spike_dwconv: expected xf [N, H, W, C] and w "
                         f"[kh, kw, 1, C], got {tuple(xf.shape)} and "
                         f"{tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"spike_dwconv: stride {stride} < 1")
    dev = check_f32("spike_dwconv", xf, w)
    if dev.type == "cpu":
        return spike_conv(xf, w, stride=stride, depthwise=True)
    N, H, W, C = xf.shape
    kh, kw = w.shape[:2]
    pad_h, _, Ho = _same_pads(H, kh, stride)
    pad_w, _, Wo = _same_pads(W, kw, stride)
    out = torch.empty((N, Ho, Wo, C), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = load("spike_dwconv", _SIG)
    with torch.cuda.device(dev):
        err = lib.spike_dwconv_launch(
            xf.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, Ho, Wo,
            kh, kw, stride, pad_h, pad_w, stream_of(dev))
    check_launch("spike_dwconv", err)
    return out
