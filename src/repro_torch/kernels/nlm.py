"""Non-local means: the wrapper of its CUDA kernel (``csrc/nlm.cu``).
The plain version is :func:`repro_torch.isp.nlm.nlm_denoise`, which the
wrapper takes for CPU tensors; for CUDA tensors it launches the kernel
or raises.  Like the TPU kernel, the kernel takes the luminance plane
and the bandwidth ``h`` as inputs, computed here with the plain
version's own torch ops (``luminance``, ``nlm_bandwidth``), on the device
and without a host sync."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.isp.nlm import luminance, nlm_bandwidth, nlm_denoise
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)

_SIG = ("nlm_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p])
MAX_CHANNELS = 4


def nlm(img: torch.Tensor, strength=0.1) -> torch.Tensor:
    """img [B, H, W] or [B, H, W, C] (C <= 4) in [0, 1]; strength a
    scalar or [B] (a tensor on img's device keeps the call free of host
    syncs) -> the denoised image, same shape."""
    if img.dim() not in (3, 4):
        raise ValueError(f"nlm: expected [B, H, W(, C)], got "
                         f"{tuple(img.shape)}")
    dev = check_f32("nlm", img)
    if dev.type == "cpu":
        return nlm_denoise(img, strength=strength)
    chans = img[..., None] if img.dim() == 3 else img
    B, H, W, C = chans.shape
    if C > MAX_CHANNELS:
        raise ValueError(f"nlm: at most {MAX_CHANNELS} channels, got {C}")
    h = nlm_bandwidth(strength, dev)
    if h.dim() == 0:
        h = h.expand(B)
    if h.shape != (B,):
        raise ValueError(f"nlm: strength must be a scalar or [{B}], got "
                         f"{tuple(h.shape)}")
    h = h.contiguous()
    lum = luminance(chans)
    out = torch.empty_like(chans)
    if out.numel() == 0:
        return out.reshape(img.shape)
    lib = load("nlm", _SIG)
    with torch.cuda.device(dev):
        err = lib.nlm_launch(chans.data_ptr(), lum.data_ptr(), h.data_ptr(),
                             out.data_ptr(), B, H, W, C, stream_of(dev))
    check_launch("nlm", err)
    return out.reshape(img.shape)
