"""Non-local means: the wrapper of its CUDA kernel (``csrc/nlm.cu``).
The plain version is :func:`repro_torch.isp.nlm.nlm_denoise`, which the
wrapper takes for CPU tensors; for CUDA tensors it launches the kernel
or raises.  The kernel computes the luminance and the bandwidth ``h`` in
the block with the plain version's ops (``luminance``,
``nlm_bandwidth``) and reads a ``[B]`` strength tensor in place, so a
call is one device op: the launch (the output's ``torch.empty`` runs
none).  Its tile and threads come from the stencil segment's plan
(``isp_fused.stencil_plan("nlm", ...)``): the two kernels share the NLM
tile of ``csrc/nlm_tile.cuh``."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.isp.nlm import nlm_denoise
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       refuse_grad, stream_of)
from repro_torch.kernels.isp_fused import nlm_tile_smem, stencil_plan

# img, strength, its stride, a scalar strength, out, B H W C, th tw
# threads smem, stream
_SIG = ("nlm_launch", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_float, ctypes.c_void_p]
        + [ctypes.c_int] * 8 + [ctypes.c_void_p])
MAX_CHANNELS = 4


def _strength(strength, B: int, dev: torch.device):
    """(tensor, stride, value) of the kernel's strength: a float32
    tensor on ``dev`` is read in place (a 0-d one at stride 0); another
    tensor or a sequence is copied there first; a scalar goes in as the
    value, with no tensor."""
    if not isinstance(strength, torch.Tensor):
        if np.ndim(strength) == 0:
            return None, 0, float(np.float32(strength))
        strength = torch.as_tensor(strength, dtype=torch.float32)
    s = strength.to(device=dev, dtype=torch.float32)
    if s.dim() == 0:
        return s, 0, 0.0
    if s.shape != (B,):
        raise ValueError(f"nlm: strength must be a scalar or [{B}], got "
                         f"{tuple(s.shape)}")
    return s, s.stride(0), 0.0


def nlm(img: torch.Tensor, strength=0.1) -> torch.Tensor:
    """img [B, H, W] or [B, H, W, C] (C <= 4) in [0, 1]; strength a
    scalar or [B] (a float32 tensor on img's device is read in place,
    with no host sync) -> the denoised image, same shape."""
    if img.dim() not in (3, 4):
        raise ValueError(f"nlm: expected [B, H, W(, C)], got "
                         f"{tuple(img.shape)}")
    dev = check_f32("nlm", img)
    if dev.type == "cpu":
        return nlm_denoise(img, strength=strength)
    chans = img[..., None] if img.dim() == 3 else img
    B, H, W, C = chans.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"nlm: 1 to {MAX_CHANNELS} channels, got {C}")
    refuse_grad("nlm", strength)
    s, stride, value = _strength(strength, B, dev)
    out = torch.empty_like(chans)
    if out.numel() == 0:
        return out.reshape(img.shape)
    plan = stencil_plan("nlm", B, H, W, C)
    lib = load("nlm", _SIG)
    with torch.cuda.device(dev):
        err = lib.nlm_launch(chans.data_ptr(),
                             None if s is None else s.data_ptr(), stride,
                             value,
                             out.data_ptr(), B, H, W, C, plan.th, plan.tw,
                             plan.threads,
                             nlm_tile_smem(C, plan.th, plan.tw),
                             stream_of(dev))
    check_launch("nlm", err)
    return out.reshape(img.shape)
