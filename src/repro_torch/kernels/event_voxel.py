"""DVS event voxelization: the wrapper of its CUDA kernel
(``csrc/event_voxel.cu``).  The plain version is
:func:`repro_torch.core.encoding.events_to_voxel_batch`, which the
wrapper takes for CPU tensors; for CUDA tensors it launches the kernel
or raises.  Both give bit-identical grids."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.encoding import (EventStream, check_oob,
                                       events_to_voxel_batch, resolve_mode)
from repro_torch.kernels.build import check_launch, load, stream_of

_SIG = ("event_voxel_launch",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_MODE_IDS = {"binary": 0, "count": 1, "signed": 2}
_DTYPES = {"t": torch.float32, "x": torch.int32, "y": torch.int32,
           "p": torch.int32, "valid": torch.bool}


def _check_stream(evs: EventStream) -> torch.device:
    shape, dev = evs.t.shape, evs.t.device
    if len(shape) != 2:
        raise ValueError(f"event_voxel: expected [B, N] leaves, got "
                         f"{tuple(shape)}")
    for name, a in zip(EventStream._fields, evs):
        if a.dtype != _DTYPES[name]:
            raise TypeError(f"event_voxel: {name} must be {_DTYPES[name]}, "
                            f"got {a.dtype}")
        if a.shape != shape or a.device != dev:
            raise ValueError(f"event_voxel: {name} is {tuple(a.shape)} on "
                             f"{a.device}, t is {tuple(shape)} on {dev}")
        if not a.is_contiguous():
            raise ValueError(f"event_voxel: {name} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"event_voxel: unsupported device {dev}")
    return dev


def event_voxel(evs: EventStream, *, time_steps: int, height: int,
                width: int, window: float = 1.0, binary: bool = True,
                mode: Optional[str] = None,
                oob: str = "clip") -> torch.Tensor:
    """Batched event buffers (``t`` float32, ``x``/``y``/``p`` int32,
    ``valid`` bool, all [B, N]) -> voxel grids [B, T, H, W, 2]; the
    arguments of the plain version."""
    mode = resolve_mode(mode, binary)
    check_oob(oob)
    dev = _check_stream(evs)
    if dev.type == "cpu":
        return events_to_voxel_batch(evs, time_steps=time_steps,
                                     height=height, width=width,
                                     window=window, mode=mode, oob=oob)
    B, N = evs.t.shape
    out = torch.empty((B, time_steps, height, width, 2), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    lib = load("event_voxel", _SIG)
    with torch.cuda.device(dev):
        err = lib.event_voxel_launch(
            *(a.data_ptr() for a in evs), out.data_ptr(), B, N, time_steps,
            height, width, window, _MODE_IDS[mode], int(oob == "drop"),
            stream_of(dev))
    check_launch("event_voxel", err)
    return out
