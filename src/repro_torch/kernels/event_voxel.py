"""DVS event voxelization: the wrappers of its CUDA kernel
(``csrc/event_voxel.cu``).  The plain versions are
:func:`repro_torch.core.encoding.events_to_voxel_batch` (``event_voxel``)
and that scatter under the tick's ``torch.where`` select
(``event_voxel_encode``), which the wrappers take for CPU tensors; for
CUDA tensors they launch the kernel or raise.  Both give bit-identical
grids.

The kernel's launch plan (``voxel_plan``, cached per shape): a
thread-block cluster owns a contiguous range of a window's flattened
``(t, y, x, p)`` cells, ``cells`` a block in its shared memory; a window
takes one cluster where its grid fits 16 blocks, else several, each
reading the window's events once."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core.encoding import (EventStream, check_oob,
                                       events_to_voxel_batch, resolve_mode)
from repro_torch.kernels.build import launch, load, refuse_grad

# t x y p valid from_events vox out, B N T H W, window, mode drop,
# cluster cells clusters share threads smem, stream
_SIG = ("event_voxel_launch",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_float] + [ctypes.c_int] * 8 + [ctypes.c_void_p])
_MODE_IDS = {"binary": 0, "count": 1, "signed": 2}
_DTYPES = {"t": torch.float32, "x": torch.int32, "y": torch.int32,
           "p": torch.int32, "valid": torch.bool}

VOXEL_THREADS = 128     # threads a block (csrc kThreads): on the H100
#                         faster than 64, 256 or 512 at the tick, at
#                         DAVIS346 and at 720p
MAX_CLUSTER = 16        # blocks a cluster (csrc kMaxCluster; non-portable)
MAX_CELLS = 6144        # cells a block at most (24 KB; csrc kMaxCells):
#                         nine blocks fit an SM's shared memory
MIN_CELLS = 512         # cells a block at least: a small grid takes fewer
#                         blocks, not blocks of a few cells
GRID_LIMIT = 2 ** 31 - 1   # blocks on gridDim.x
SMEM_LIMIT = 232448        # shared bytes a block can use (227 KB)


class VoxelPlan(NamedTuple):
    """One launch: ``clusters`` clusters of ``cluster`` blocks a window,
    each block holding ``cells`` consecutive cells of the window's
    flattened grid (a multiple of 4: whole (OFF, ON) pairs and 16-byte
    rows), window-major then cluster then rank on gridDim.x (``blocks``
    in all), ``threads`` a block and ``smem`` shared bytes a block."""
    cluster: int
    cells: int
    clusters: int
    blocks: int
    threads: int
    smem: int


def _up4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=None)
def voxel_plan(B: int, T: int, H: int, W: int) -> VoxelPlan:
    """The kernel's plan for B windows of T x H x W x 2 cells: a grid of
    at most 16 x MAX_CELLS cells is one cluster of up to 16 blocks of at
    least MIN_CELLS (the tick's 64x64, T 5: 16 blocks of 2560 cells, 10
    KB); a larger one spreads over the fewest 16-block clusters with at
    most MAX_CELLS a block.  Cached per shape."""
    grid = T * H * W * 2
    if min(B, T, H, W) < 1:
        raise ValueError(f"voxel_plan: empty grid {(B, T, H, W)}")
    per = -(-grid // MAX_CLUSTER)
    if per <= MAX_CELLS:
        cells = max(MIN_CELLS, _up4(per))
        cluster, clusters = -(-grid // cells), 1
    else:
        cells = _up4(-(-grid // (MAX_CLUSTER * -(-grid // (MAX_CLUSTER
                                                          * MAX_CELLS)))))
        cluster, clusters = MAX_CLUSTER, -(-grid // (MAX_CLUSTER * cells))
    if grid + cluster * cells >= 2 ** 31:
        raise ValueError(f"voxel_plan: {grid} cells a window, past int32")
    blocks = B * clusters * cluster
    if blocks > GRID_LIMIT:
        raise ValueError(f"voxel_plan: {blocks} blocks past gridDim.x")
    return VoxelPlan(cluster, cells, clusters, blocks, VOXEL_THREADS,
                     4 * cells)


def event_share(n_events: int, cluster: int) -> int:
    """Events each block of a cluster reads (csrc: block r of the
    cluster reads [r * share, min(N, (r + 1) * share)) of its window's
    events): the window's events split over the cluster in whole groups
    of four, so a group is one 16-byte load of each field."""
    return _up4(-(-n_events // cluster))


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
    if dev.type == "cuda":
        refuse_grad("event_voxel", evs.t)
    return dev


def _launch(evs, out, *, select, time_steps, height, width, window, mode,
            oob):
    """One launch of the kernel into ``out`` [B, T, H, W, 2]; ``select``
    is None or (from_events [B] bool, the staged [T, B, H, W, 2] grid)."""
    B, N = evs.t.shape
    plan = voxel_plan(B, time_steps, height, width)
    dev = out.device
    flags, vox = (0, 0) if select is None else (select[0].data_ptr(),
                                                select[1].data_ptr())
    lib = load("event_voxel", _SIG)
    launch("event_voxel", dev, lib.event_voxel_launch,
           *(a.data_ptr() for a in evs), flags, vox, out.data_ptr(), B, N,
           time_steps, height, width, window, _MODE_IDS[mode], int(oob ==
           "drop"), plan.cluster, plan.cells, plan.clusters, event_share(N,
           plan.cluster), plan.threads, plan.smem)
    return out


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
    B = evs.t.shape[0]
    out = torch.empty((B, time_steps, height, width, 2), dtype=torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    return _launch(evs, out, select=None, time_steps=time_steps,
                   height=height, width=width, window=window, mode=mode,
                   oob=oob)


def event_voxel_encode(evs: EventStream, voxels: torch.Tensor,
                       from_events: torch.Tensor, *, time_steps: int,
                       height: int, width: int, window: float = 1.0,
                       binary: bool = True, mode: Optional[str] = None,
                       oob: str = "clip") -> torch.Tensor:
    """The tick's encode and select: window b's voxel grid from its
    events where ``from_events[b]``, else its staged grid from
    ``voxels`` [T, B, H, W, 2] float32 -> [T, B, H, W, 2].  On a CUDA
    tensor one launch: the kernel copies a staged window in place of
    binning it and writes the batch-major grid, returned as its [T, B]
    view (so ``layers.fold`` of it is a view, as of ``voxel_batch``'s)."""
    mode = resolve_mode(mode, binary)
    check_oob(oob)
    dev = _check_stream(evs)
    B = evs.t.shape[0]
    shape = (time_steps, B, height, width, 2)
    if tuple(voxels.shape) != shape or voxels.dtype != torch.float32:
        raise ValueError(f"event_voxel_encode: voxels must be float32 "
                         f"{shape}, got {voxels.dtype} "
                         f"{tuple(voxels.shape)}")
    if tuple(from_events.shape) != (B,) or from_events.dtype != torch.bool:
        raise ValueError(f"event_voxel_encode: from_events must be bool "
                         f"[{B}], got {from_events.dtype} "
                         f"{tuple(from_events.shape)}")
    if voxels.device != dev or from_events.device != dev:
        raise ValueError(f"event_voxel_encode: voxels on {voxels.device}, "
                         f"from_events on {from_events.device}, events on "
                         f"{dev}")
    if not voxels.is_contiguous():
        raise ValueError("event_voxel_encode: voxels must be contiguous")
    if dev.type == "cpu":
        enc = events_to_voxel_batch(evs, time_steps=time_steps,
                                    height=height, width=width,
                                    window=window, mode=mode, oob=oob)
        return torch.where(from_events[None, :, None, None, None],
                           enc.transpose(0, 1), voxels)
    refuse_grad("event_voxel_encode", voxels)
    out = torch.empty((B, time_steps, height, width, 2),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out.transpose(0, 1)
    return _launch(evs, out, select=(from_events.contiguous(), voxels),
                   time_steps=time_steps, height=height, width=width,
                   window=window, mode=mode, oob=oob).transpose(0, 1)
