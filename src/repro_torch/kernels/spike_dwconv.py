"""Activity-gated depthwise spike conv: the wrapper of its CUDA kernel
(``csrc/spike_dwconv.cu``) and the tiles it launches with.  The plain
version is the tap loop of :func:`repro_torch.core.layers.spike_conv`
(``depthwise=True``), which the wrapper takes for CPU tensors; for CUDA
tensors it launches the kernel or raises.  The kernel reads the folded
activation directly (no patch tensor): a block stages a band of input
rows with its halo in shared memory and computes the band's outputs
from there (``dw_tiles``), summing the taps in the plain loop's order
with its roundings, so both give the same bits.

``tap_occupancy_mask`` is the reference's per-(row block, tap) gate of
the TPU kernel, kept as telemetry: the share of tap slabs with no spike.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.layers import _same_pads, spike_conv
from repro_torch.kernels.blocks import DEFAULT_BM
from repro_torch.kernels.build import check_f32, launch, load
from repro_torch.launch.roofline import SMS

MAX_THREADS = 256           # threads a block at most (csrc kMaxThreads)
MAX_BAND = 8                # output rows a block (csrc kMaxBand)
MAX_SMEM = 48 * 1024        # shared memory a block, bytes (csrc kMaxSmem)
GROUP = 64                  # channels a block
BLOCK_THREADS = 128         # threads a block where the columns fill them
# the fewest blocks a row band may leave: four an SM
MIN_BLOCKS = 4 * SMS

_SIG = ("spike_dwconv_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 16 + [ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class DwTiles:
    """The launch shape of one depthwise conv: a block per (frame, band
    of ``bh`` output rows, band of ``bw`` output columns, group of ``cg``
    channels), the group fastest, every block on gridDim.x.  A block
    stages its input rows and columns, the halo included, in shared
    memory: ``rows_in`` x ``cols_in`` pixels of ``cg`` channels.  Its
    threads are ``cg // vec`` lanes by ``col_threads`` columns; a thread
    stages and computes every ``col_threads``-th column of its lane."""
    N: int
    H: int
    W: int
    C: int
    Ho: int
    Wo: int
    kh: int
    kw: int
    stride: int
    pad_h: int
    pad_w: int
    vec: int
    cg: int
    bh: int
    bw: int
    col_threads: int

    @property
    def threads(self) -> int:
        """Threads a block: a lane of ``vec`` channels by a column."""
        return self.cg // self.vec * self.col_threads

    @property
    def groups(self) -> int:
        return -(-self.C // self.cg)

    @property
    def col_bands(self) -> int:
        return -(-self.Wo // self.bw)

    @property
    def row_bands(self) -> int:
        return -(-self.Ho // self.bh)

    @property
    def blocks_per_frame(self) -> int:
        return self.groups * self.col_bands * self.row_bands

    @property
    def blocks(self) -> int:
        return self.N * self.blocks_per_frame

    @property
    def grid(self):
        return (self.blocks, 1, 1)

    @property
    def rows_in(self) -> int:
        return (self.bh - 1) * self.stride + self.kh

    @property
    def cols_in(self) -> int:
        return (self.bw - 1) * self.stride + self.kw

    @property
    def smem_bytes(self) -> int:
        return self.rows_in * self.cols_in * min(self.cg, self.C) * 4

    def block(self, b: int):
        """Block ``b``, decoded as the kernel decodes it: its frame, the
        output rows, columns and channels it writes, and the input rows
        and columns it stages (some may lie in the zero padding)."""
        n, r = divmod(b, self.blocks_per_frame)
        r, g = divmod(r, self.groups)
        band, cb = divmod(r, self.col_bands)
        ho0, wo0, c0 = band * self.bh, cb * self.bw, g * self.cg
        ho1, wo1 = min(ho0 + self.bh, self.Ho), min(wo0 + self.bw, self.Wo)
        hi0 = ho0 * self.stride - self.pad_h
        wi0 = wo0 * self.stride - self.pad_w
        return (n, range(ho0, ho1), range(wo0, wo1),
                range(c0, min(c0 + self.cg, self.C)),
                range(hi0, hi0 + (ho1 - ho0 - 1) * self.stride + self.kh),
                range(wi0, wi0 + (wo1 - wo0 - 1) * self.stride + self.kw))


def dw_tiles(N: int, H: int, W: int, C: int, kh: int, kw: int, stride: int,
             *, vec: bool = True) -> DwTiles:
    """The kernel's tiles: 16-byte lanes where ``vec`` (x and w 16-byte
    aligned) and C % 4 == 0, else one channel a lane; ``GROUP`` channels
    a block; the whole output width a block, halved while one row band's
    tile passes ``MAX_SMEM`` (then fewer channels, down to one, for a
    very large kernel); the tallest row band (up to ``MAX_BAND``) that
    still leaves ``MIN_BLOCKS`` blocks and fits; ``BLOCK_THREADS``
    threads, or one a lane and output column where that is fewer."""
    pad_h, _, Ho = _same_pads(H, kh, stride)
    pad_w, _, Wo = _same_pads(W, kw, stride)

    def tiles(bh, bw, cg, v):
        col_threads = max(1, min(bw, BLOCK_THREADS // (cg // v)))
        return DwTiles(N=N, H=H, W=W, C=C, Ho=Ho, Wo=Wo, kh=kh, kw=kw,
                       stride=stride, pad_h=pad_h, pad_w=pad_w, vec=v,
                       cg=cg, bh=bh, bw=bw, col_threads=col_threads)

    t = tiles(1, Wo, min(C, GROUP), 4 if vec and C % 4 == 0 else 1)
    while t.smem_bytes > MAX_SMEM and t.bw > 1:
        t = dataclasses.replace(t, bw=-(-t.bw // 2))
    while t.smem_bytes > MAX_SMEM and t.cg > 1:
        cg = t.cg // 2 // t.vec * t.vec
        t = tiles(1, 1, cg, t.vec) if cg else tiles(1, 1, 1, 1)
    if t.smem_bytes > MAX_SMEM:
        raise ValueError(f"spike_dwconv: a {kh}x{kw} kernel's taps of one "
                         f"output need {t.smem_bytes} bytes of shared "
                         f"memory, more than {MAX_SMEM}")
    t = tiles(1, t.bw, t.cg, t.vec)
    bh = 2
    while bh <= min(MAX_BAND, Ho):
        taller = tiles(bh, t.bw, t.cg, t.vec)
        if taller.blocks < MIN_BLOCKS or taller.smem_bytes > MAX_SMEM:
            break
        t, bh = taller, 2 * bh
    return t


def tap_occupancy_mask(patches3: torch.Tensor, *,
                       bm: int = DEFAULT_BM) -> torch.Tensor:
    """patches3 [M, taps, C] -> int32 [ceil(M/bm), taps]: 1 where the row
    block has a live (non-zero) activation under the tap, any channel."""
    M, taps, C = patches3.shape
    pm = (-M) % bm
    if pm:
        patches3 = F.pad(patches3, (0, 0, 0, 0, 0, pm))
    t = patches3.reshape((M + pm) // bm, bm, taps, C)
    return (t != 0).any(dim=3).any(dim=1).to(torch.int32)


def _launch(xf: torch.Tensor, w: torch.Tensor, stride: int,
            t: DwTiles) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with tiles ``t``: the wrapper
    passes ``dw_tiles``' choice; tests may pass other tiles."""
    dev = xf.device
    N, H, W, C = xf.shape
    kh, kw = w.shape[:2]
    out = torch.empty((N, t.Ho, t.Wo, C), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    if t.blocks >= 2 ** 31:
        raise ValueError(f"spike_dwconv: {t.blocks} blocks pass the int "
                         f"range")
    lib = load("spike_dwconv", _SIG)
    launch("spike_dwconv", dev, lib.spike_dwconv_launch,
           xf.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C, t.Ho, t.Wo,
           kh, kw, stride, t.pad_h, t.pad_w, t.vec, t.cg, t.bh, t.bw,
           t.col_threads)
    return out


def spike_dwconv(xf: torch.Tensor, w: torch.Tensor, *,
                 stride: int = 1) -> torch.Tensor:
    """xf [N, H, W, C] folded activations, w [kh, kw, 1, C] -> the
    depthwise conv [N, Ho, Wo, C], SAME padding."""
    if xf.dim() != 4 or w.dim() != 4 or w.shape[2] != 1 \
            or w.shape[3] != xf.shape[3]:
        raise ValueError(f"spike_dwconv: expected xf [N, H, W, C] and w "
                         f"[kh, kw, 1, C], got {tuple(xf.shape)} and "
                         f"{tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"spike_dwconv: stride {stride} < 1")
    dev = check_f32("spike_dwconv", xf, w)
    if dev.type == "cpu":
        return spike_conv(xf, w, stride=stride, depthwise=True)
    N, H, W, C = xf.shape
    aligned = xf.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return _launch(xf, w, stride, dw_tiles(N, H, W, C, *w.shape[:2], stride,
                                           vec=aligned))
