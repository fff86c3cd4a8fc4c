"""The LIF recurrence and the fused norm+affine+LIF epilogue: plain
PyTorch versions and the wrappers of their CUDA kernels
(``csrc/lif_scan.cu``, ``csrc/norm_affine_lif.cu``).

A wrapper takes the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``decay`` reaches the kernels
as the float32 ``exp(-1/tau)`` that torch computes
(``repro_torch.core.lif.f32_decay``), never an ``expf`` of their own.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layers import NORM_EPS, instance_norm_affine
from repro_torch.core.lif import f32_decay, lif_scan as lif_scan_plain
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)

_LIF_SIG = ("lif_scan_launch",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
             ctypes.c_float, ctypes.c_float, ctypes.c_float,
             ctypes.c_void_p])
_NORM_SIG = ("norm_affine_lif_launch",
             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])


# ---------------------------------------------------------------------------
# lif_scan: flat [T, N] recurrence
# ---------------------------------------------------------------------------

def lif_scan(currents: torch.Tensor, *, tau: float = 2.0, v_th: float = 1.0,
             v_reset: float = 0.0) -> torch.Tensor:
    """currents [T, N] float32 -> spikes [T, N] (forward only)."""
    if currents.dim() != 2:
        raise ValueError(f"lif_scan: expected [T, N], got {currents.shape}")
    dev = check_f32("lif_scan", currents)
    if dev.type == "cpu":
        return lif_scan_plain(currents, tau=tau, v_th=v_th, v_reset=v_reset)
    T, N = currents.shape
    out = torch.empty_like(currents)
    if N == 0 or T == 0:
        return out
    lib = load("lif_scan", _LIF_SIG)
    with torch.cuda.device(dev):
        err = lib.lif_scan_launch(currents.data_ptr(), out.data_ptr(), T, N,
                                  f32_decay(tau), v_th, v_reset, stream_of(dev))
    check_launch("lif_scan", err)
    return out


# ---------------------------------------------------------------------------
# norm_affine_lif: instance norm over (T, HW) + affine + T-step LIF
# ---------------------------------------------------------------------------

def norm_affine_lif_plain(y, scale, bias, *, tau: float = 2.0,
                          v_th: float = 1.0, v_reset: float = 0.0,
                          eps: float = NORM_EPS) -> torch.Tensor:
    return lif_scan_plain(instance_norm_affine(y, scale, bias, eps), tau=tau,
                          v_th=v_th, v_reset=v_reset)


def norm_affine_lif(y: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, tau: float = 2.0,
                    v_th: float = 1.0, v_reset: float = 0.0,
                    eps: float = NORM_EPS) -> torch.Tensor:
    """y [T, B, HW, C] pre-norm conv output, scale/bias [C] -> spikes
    [T, B, HW, C]."""
    if y.dim() != 4:
        raise ValueError(f"norm_affine_lif: expected [T, B, HW, C], got "
                         f"{tuple(y.shape)}")
    T, B, HW, C = y.shape
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"norm_affine_lif: scale/bias must be [{C}], got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    dev = check_f32("norm_affine_lif", y, scale, bias)
    if dev.type == "cpu":
        return norm_affine_lif_plain(y, scale, bias, tau=tau, v_th=v_th,
                                     v_reset=v_reset, eps=eps)
    if B > 65535:
        raise ValueError(f"norm_affine_lif: batch {B} exceeds the grid")
    out = torch.empty_like(y)
    if y.numel() == 0:
        return out
    lib = load("norm_affine_lif", _NORM_SIG)
    with torch.cuda.device(dev):
        err = lib.norm_affine_lif_launch(
            y.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            T, B, HW, C, f32_decay(tau), v_th, v_reset, eps, stream_of(dev))
    check_launch("norm_affine_lif", err)
    return out
