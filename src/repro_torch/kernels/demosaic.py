"""Malvar-He-Cutler demosaic: the wrapper of its CUDA kernel
(``csrc/demosaic.cu``).  The plain version is
:func:`repro_torch.isp.demosaic.demosaic_mhc`, which the wrapper takes
for CPU tensors; for CUDA tensors it launches the kernel or raises.
Both give bit-identical RGB.  A call is one device op: the launch (the
output's ``torch.empty`` runs none).  Its tile and threads come from the
stencil segment's plan (``isp_fused.stencil_plan("demosaic", ...)``):
the two kernels share the demosaic tile of ``csrc/demosaic_tile.cuh``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.isp.demosaic import demosaic_mhc
from repro_torch.kernels.build import check_f32, launch, load
from repro_torch.kernels.isp_fused import demosaic_tile_smem, stencil_plan

# raw, out, B H W, th tw threads smem, stream
_SIG = ("demosaic_launch",
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 7
        + [ctypes.c_void_p])


def demosaic(raw: torch.Tensor) -> torch.Tensor:
    """raw [B, H, W] RGGB mosaics in [0, 1] -> RGB [B, H, W, 3]."""
    if raw.dim() != 3:
        raise ValueError(f"demosaic: expected [B, H, W], got "
                         f"{tuple(raw.shape)}")
    dev = check_f32("demosaic", raw)
    if dev.type == "cpu":
        return demosaic_mhc(raw)
    B, H, W = raw.shape
    out = torch.empty((B, H, W, 3), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    plan = stencil_plan("demosaic", B, H, W, 1)
    lib = load("demosaic", _SIG)
    launch("demosaic", dev, lib.demosaic_launch,
           raw.data_ptr(), out.data_ptr(), B, H, W, plan.th, plan.tw,
           plan.threads, demosaic_tile_smem(plan.th, plan.tw))
    return out
