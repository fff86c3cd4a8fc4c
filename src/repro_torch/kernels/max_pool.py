"""Gated spike max-pool: the wrapper of its CUDA kernel
(``csrc/max_pool.cu``).  The plain version is
:func:`repro_torch.core.layers.pool_slices` (the elementwise max of the
window's strided slices) on the batch-major fold, which the wrapper
takes for CPU tensors; for CUDA tensors it launches the kernel or
raises.  Max has no rounding, so the two give the same bits.

On the layer's spikes [T, B, H, W, C] the kernel reads them where they
lie (no fold copy before it) and writes the batch-major [B*T, Ho, Wo,
C] that ``unfold`` views as [T, B, ...]; a folded [N, H, W, C] tensor is
the case ``T = 1``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layers import fold, pool_slices
from repro_torch.kernels.build import (check_launch, load, refuse_grad,
                                       stream_of)

_SIG = ("max_pool_launch",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])

MAX_WINDOW = 4


def image_strides(x: torch.Tensor):
    """(img_t, img_b): the strides of x [T, B, H, W, C]'s first two dims
    in images, for the kernel to read each image where it lies.  Raises
    where an image is not one contiguous [H, W, C] block at a whole
    number of images from the base (a layout the kernel does not take:
    no copy is made)."""
    T, B, H, W, C = x.shape
    img = H * W * C
    if img == 0:
        return 0, 0
    inner = (W * C, C, 1)
    dense = all(s == e or n == 1 for s, e, n in
                zip(x.stride()[2:], inner, x.shape[2:]))
    st = x.stride(0) if T > 1 else 0
    sb = x.stride(1) if B > 1 else 0
    if not dense or st % img or sb % img:
        raise ValueError(f"max_pool: spikes of shape {tuple(x.shape)} with "
                         f"strides {x.stride()} are not whole [H, W, C] "
                         f"images; the kernel takes [T, B] or batch-major "
                         f"layouts only")
    return st // img, sb // img


def max_pool(x: torch.Tensor, *, window: int = 2,
             gated: bool = True) -> torch.Tensor:
    """Batch-major pooled images, VALID windows with stride = window (a
    ragged tail is dropped):

      * x [T, B, H, W, C] spikes as they lie (contiguous in [T, B] order,
        or the ``unfold`` view of a batch-major tensor; no copy) -> the
        [B*T, H//window, W//window, C] of ``pool_slices(fold(x), window)``;
      * x [N, H, W, C] contiguous -> [N, H//window, W//window, C] (the
        case T = 1).

    ``gated=True`` is the TPU kernel's gate: a block of outputs whose
    inputs are all zero writes zeros without the reduction.  The
    reference states it exact for non-negative inputs (spikes, the only
    tensor it pools); a max of zeros is zero for any input, so it
    changes no value here, only a ``-0`` input's sign.  ``gated=False``
    is the plain max for any input."""
    if x.dim() not in (4, 5):
        raise ValueError(f"max_pool: expected [T, B, H, W, C] or "
                         f"[N, H, W, C], got {tuple(x.shape)}")
    if not 1 <= window <= MAX_WINDOW:
        raise ValueError(f"max_pool: window {window} not in "
                         f"[1, {MAX_WINDOW}]")
    if x.dtype != torch.float32:
        raise TypeError(f"max_pool: expected float32, got {x.dtype}")
    x5 = x if x.dim() == 5 else x.unsqueeze(0)
    img_t, img_b = image_strides(x5)
    dev = x.device
    if dev.type == "cpu":
        return pool_slices(fold(x5), window)
    if dev.type != "cuda":
        raise ValueError(f"max_pool: unsupported device {dev}")
    refuse_grad("max_pool", x)
    T, B, H, W, C = x5.shape
    out = torch.empty((B * T, H // window, W // window, C),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = load("max_pool", _SIG)
    with torch.cuda.device(dev):
        err = lib.max_pool_launch(x5.data_ptr(), out.data_ptr(), T, B, H, W,
                                  C, img_t, img_b, window, int(gated),
                                  stream_of(dev))
    check_launch("max_pool", err)
    return out
