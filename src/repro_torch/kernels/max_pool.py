"""Gated spike max-pool: the wrapper of its CUDA kernel
(``csrc/max_pool.cu``).  The plain version is
:func:`repro_torch.core.layers.pool_slices` (the elementwise max of the
window's strided slices), which the wrapper takes for CPU tensors; for
CUDA tensors it launches the kernel or raises.  Max has no rounding, so
the two give the same bits."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layers import pool_slices
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)

_SIG = ("max_pool_launch",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])

MAX_WINDOW = 4


def max_pool(xf: torch.Tensor, *, window: int = 2,
             gated: bool = True) -> torch.Tensor:
    """xf [N, H, W, C] -> [N, H//window, W//window, C], VALID windows with
    stride = window (a ragged tail is dropped).

    ``gated=True`` is the TPU kernel's gate: a block of outputs whose
    inputs are all zero writes zeros without the reduction.  The
    reference states it exact for non-negative inputs (spikes, the only
    tensor it pools); a max of zeros is zero for any input, so it
    changes no value here, only a ``-0`` input's sign.  ``gated=False``
    is the plain max for any input."""
    if xf.dim() != 4:
        raise ValueError(f"max_pool: expected [N, H, W, C], got "
                         f"{tuple(xf.shape)}")
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"max_pool: window {window} not in "
                         f"[1, {MAX_WINDOW}]")
    dev = check_f32("max_pool", xf)
    if dev.type == "cpu":
        return pool_slices(xf, window)
    N, H, W, C = xf.shape
    out = torch.empty((N, H // window, W // window, C), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = load("max_pool", _SIG)
    with torch.cuda.device(dev):
        err = lib.max_pool_launch(xf.data_ptr(), out.data_ptr(), N, H, W, C,
                                  window, int(gated), stream_of(dev))
    check_launch("max_pool", err)
    return out
