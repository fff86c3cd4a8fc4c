"""Activity-gated spike conv read straight from the folded spikes: the
wrapper of its CUDA kernel (``csrc/spike_conv.cu``, implicit im2col) and
the tile choice it launches with.

The plain version is :func:`repro_torch.core.layers.spike_conv` (the
spike-im2col patch matrix and ``blocked_matmul``, canonical 128-wide K
blocks), which the wrapper takes for CPU tensors; for CUDA tensors it
launches the kernel or raises.  The kernel reads ``xf`` and the HWIO
weights directly (no patch matrix) and gives, under every gate, the bits
of the gated GEMM on the materialised patches (``spike_matmul`` on
``spike_im2col(xf)``): each K block's partial is an fmaf chain from +0,
the partials are added in block order, and a block with no spike adds
nothing.  Gates: ``"mask"`` checks, per (128-row tile, K block), the
channels its taps read in ``xf`` before any copy (the occupancy tiles of
the patch matrix) and skips the copies and multiply-adds of the dead
ones; ``"inline"`` checks each staged slice and skips an all-zero one's
multiply-adds; ``"none"`` computes every block.

``occupancy_mask`` is the reference's per-(128-row, 128-K) tile gate of a
materialised patch matrix, kept as telemetry (the live tiles that set an
operations bound); no route of the port computes it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.layers import _same_pads, spike_conv as conv_plain
from repro_torch.kernels.blocks import (CANONICAL_K_BLOCK, DEFAULT_BK,
                                        DEFAULT_BM)
from repro_torch.kernels.build import check_f32, launch, load
from repro_torch.launch.roofline import SMS

GATES = ("mask", "inline", "none")
TILE_M = 128                # output rows per block
TILE_K = 32                 # K slice staged per ring stage
TILE_WIDTHS = (32, 64, 128)  # output columns per block
# blocks an SM holds at each width (128 threads at 32 columns, 256 at 64
# and 128), from the registers ptxas gives them: ~255 a thread at 128
# columns, at most 128 at 64, at most 170 at 32
BLOCKS_PER_SM = {32: 3, 64: 2, 128: 1}

_SIG = ("spike_conv_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 15 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class ConvTiles:
    """The launch shape of one conv: ``row_tiles`` x ``col_tiles``
    blocks of ``TILE_M`` x ``bn`` outputs, K staged in ``TILE_K``
    slices; with ``split``, each tile's K blocks cut into ``groups``
    runs of ``kgroup`` consecutive blocks, one block each, whose
    per-K-block partials a second kernel adds in block order."""
    bn: int
    row_tiles: int
    col_tiles: int
    kblocks: int
    kgroup: int
    split: bool

    @property
    def groups(self) -> int:
        return -(-self.kblocks // self.kgroup)


def conv_tiles(M: int, K: int, N: int, *, sms: int = SMS) -> ConvTiles:
    """The kernel's tiles at (M, K, N): the narrowest of 32/64/128
    columns that holds cout (wider tiles re-read fewer patches, narrower
    ones leave fewer dead columns).  Split-K only where the output tiles
    alone are fewer than the SMs: into as many runs of K blocks as one
    wave of blocks holds, no run longer than it must be."""
    bn = next((w for w in TILE_WIDTHS if N <= w), TILE_WIDTHS[-1])
    rows, cols = -(-M // TILE_M), -(-N // bn)
    kblocks = -(-K // CANONICAL_K_BLOCK)
    kgroup = kblocks
    if rows * cols < sms:
        groups = min(kblocks, sms * BLOCKS_PER_SM[bn] // (rows * cols))
        kgroup = -(-kblocks // groups)
    return ConvTiles(bn=bn, row_tiles=rows, col_tiles=cols,
                     kblocks=kblocks, kgroup=kgroup, split=kgroup < kblocks)


def occupancy_mask(patches: torch.Tensor, *, bm: int = DEFAULT_BM,
                   bk: int = DEFAULT_BK) -> torch.Tensor:
    """int32 [ceil(M/bm), ceil(K/bk)]: 1 where the tile of the patch
    matrix holds a live (non-zero) activation."""
    M, K = patches.shape
    pm, pk = (-M) % bm, (-K) % bk
    if pm or pk:
        patches = F.pad(patches, (0, pk, 0, pm))
    t = patches.reshape((M + pm) // bm, bm, (K + pk) // bk, bk)
    return (t != 0).any(dim=3).any(dim=1).to(torch.int32)


def spike_conv(xf: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               gate: str = "mask") -> torch.Tensor:
    """xf [N, H, W, C] folded spikes, w HWIO [kh, kw, C, cout] -> the
    conv [N, Ho, Wo, cout] float32, SAME padding; ``gate`` one of
    ``GATES`` (the same result under each)."""
    if gate not in GATES:
        raise ValueError(f"spike_conv: gate must be one of {GATES}, got "
                         f"{gate!r}")
    if xf.dim() != 4 or w.dim() != 4 or w.shape[2] != xf.shape[3]:
        raise ValueError(f"spike_conv: expected xf [N, H, W, C] and w "
                         f"[kh, kw, C, cout], got {tuple(xf.shape)} and "
                         f"{tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"spike_conv: stride {stride} < 1")
    dev = check_f32("spike_conv", xf, w)
    if dev.type == "cpu":
        return conv_plain(xf, w, stride=stride)
    Nimg, H, W, C = xf.shape
    kh, kw, _, N = w.shape
    pad_h, _, Ho = _same_pads(H, kh, stride)
    pad_w, _, Wo = _same_pads(W, kw, stride)
    M, K = Nimg * Ho * Wo, kh * kw * C
    if max(M, K, N, Nimg * H * W) >= 2 ** 31:
        raise ValueError(f"spike_conv: M={M}, K={K}, N={N} or the "
                         f"{Nimg * H * W} input pixels pass the int range")
    out = torch.empty((Nimg, Ho, Wo, N), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    t = conv_tiles(M, K, N)
    ws = flags = None
    if t.split:
        ws = torch.empty((t.kblocks, M, N), dtype=torch.float32, device=dev)
        flags = torch.empty((t.kblocks, t.row_tiles, t.col_tiles),
                            dtype=torch.int32, device=dev)
    lib = load("spike_conv", _SIG)
    launch("spike_conv", dev, lib.spike_conv_launch,
           xf.data_ptr(), w.data_ptr(), out.data_ptr(), *(0 if a is None else
           a.data_ptr() for a in (ws, flags)), Nimg, H, W, C, Ho, Wo, kh, kw,
           stride, pad_h, pad_w, N, t.bn, t.kgroup if t.split else 0,
           GATES.index(gate))
    return out
