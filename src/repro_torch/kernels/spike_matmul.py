"""Tile-skip spike matmul: the plain version and the wrapper of its CUDA
kernel (``csrc/spike_matmul.cu``), which checks each x tile for a spike
inside the kernel and skips the all-zero ones."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layers import blocked_matmul
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)

_SIG = ("spike_matmul_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def spike_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] spikes (0/1), w [K, N] -> x @ w [M, N] float32."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"spike_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    dev = check_f32("spike_matmul", x, w)
    if dev.type == "cpu":
        return blocked_matmul(x, w)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = load("spike_matmul", _SIG)
    with torch.cuda.device(dev):
        err = lib.spike_matmul_launch(x.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), M, K, N, stream_of(dev))
    check_launch("spike_matmul", err)
    return out
