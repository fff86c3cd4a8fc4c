"""The fused spiking-conv layer — a SAME conv read straight from the
folded spikes, instance norm over (T, HW), affine and the T-step LIF in
one kernel: its plain version, the launch plan and the wrapper of its
CUDA kernel (``csrc/spike_conv_lif.cu``).

The kernel runs one thread-block cluster per (batch element, tile of at
most 32 channels).  Block ``k`` of a cluster owns the row classes
``[k * classes, (k + 1) * classes)`` of the statistics contract
(``csrc/lif_common.cuh``; ``norm_affine_lif``'s ownership) and computes
exactly the conv rows of its classes into its shared memory, so the
cluster holds the whole [T*HW, tile] slab; it sums each (class, channel)
in row order in one thread, gathers the class sums in class order and
fires the neurons whose first row it holds.  Its conv sums K in
canonical 128-wide blocks as ``spike_conv`` does, so its spikes equal the
per-op pair's (``spike_conv``, then ``norm_affine_lif``); the plain
version is that pair's plain composition.  ``conv_lif_plan`` makes the
launch plan (cached per shape) and refuses a shape whose slab fits no
cluster.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.layers import (NORM_EPS, _same_pads,
                                     spike_conv as conv_plain)
from repro_torch.core.lif import f32_decay
from repro_torch.kernels.blocks import CANONICAL_K_BLOCK
from repro_torch.kernels.build import check_f32, launch, load
from repro_torch.kernels.lif_scan import norm_affine_lif_plain

_SIG = ("spike_conv_lif_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 19 + [ctypes.c_float] * 4
        + [ctypes.c_void_p])

GATES = ("mask", "inline", "none")      # the kernel's Gate order
# the launch plan (csrc/spike_conv_lif.cu's constants)
THREADS = 256               # threads a block (kThreads)
TILE_N = 32                 # GEMM columns: the widest channel tile (kBN)
TILE_K = 32                 # K slice a ring stage (patch_stage.cuh)
LDA = TILE_K + 4            # padded A row of a stage (floats)
# local rows a GEMM tile (BM: 8, 4, 2 or 1 rows a thread) and the
# relative time a row takes on each, as measured on an H100 (a thread's
# larger register tile reads shared memory less per multiply-add)
ROW_TILES = {256: 0.78, 128: 1.0, 64: 1.5, 32: 2.3}
STAGES = (3, 2)             # ring depths, deepest first
CLASSES = 32                # row classes of the statistics contract
MAX_CLUSTER = 16            # blocks a cluster (the non-portable size)
MAX_SMEM = 232448           # shared memory a block, bytes (kMaxSmem)
SM_SMEM = 233472            # shared memory an SM, bytes ...
BLOCK_RESERVE = 1024        # ... of which each resident block takes this
# the fewest local rows a block computes where a smaller cluster allows
# it: more, smaller blocks then lose more to their fixed cost and to
# re-reading the weights than they gain in parallelism (H100 timings,
# chip_smoke.py --conv-lif-phase)
MIN_ROWS = 48


@dataclasses.dataclass(frozen=True)
class ConvLifPlan:
    """The launch of one fused layer on a [T*HW, N] slab per batch
    element, K = kh*kw*C: a cluster of ``cluster`` blocks per (batch
    element, tile of ``ct`` channels), the tile fastest, every block on
    gridDim.x.  Each block computes its ``rows`` local rows in GEMM
    tiles of ``bm`` rows through a ``stages``-deep ring and fires
    ``vec`` channels a thread."""
    T: int
    B: int
    HW: int
    N: int
    K: int
    ct: int
    cluster: int
    bm: int
    stages: int
    vec: int

    @property
    def R(self) -> int:
        """Rows of a (b, c) slab, i = t * HW + hw."""
        return self.T * self.HW

    @property
    def J(self) -> int:
        """Rows of a class at most."""
        return -(-self.R // CLASSES)

    @property
    def classes(self) -> int:
        """Row classes a block."""
        return CLASSES // self.cluster

    @property
    def rows(self) -> int:
        """Local rows a block (the last of a class may lie past R)."""
        return self.classes * self.J

    @property
    def kblocks(self) -> int:
        return -(-self.K // CANONICAL_K_BLOCK)

    @property
    def tiles(self) -> int:
        return -(-self.N // self.ct)

    @property
    def blocks(self) -> int:
        return self.B * self.tiles * self.cluster

    @property
    def grid(self):
        return (self.blocks, 1, 1)

    @property
    def slab_offset(self) -> int:
        head = 8 * (2 * self.classes + CLASSES) * self.ct + 4 * 2 * self.ct
        return -(-head // 16) * 16

    @property
    def slab_bytes(self) -> int:
        """A block's rows of the slab in shared memory."""
        return -(-4 * self.rows * self.ct // 16) * 16

    @property
    def ring_bytes(self) -> int:
        return 4 * self.stages * (self.bm * LDA + TILE_K * TILE_N)

    @property
    def smem_bytes(self) -> int:
        tables = 16 * self.bm + 4 * self.kblocks
        return self.slab_offset + self.slab_bytes + self.ring_bytes + tables

    def block(self, k: int):
        """Block ``k`` decoded as the kernel decodes it: its batch
        element, its channels and its row classes."""
        cid, rank = divmod(k, self.cluster)
        b, tile = divmod(cid, self.tiles)
        c0 = tile * self.ct
        cls0 = rank * self.classes
        return (b, range(c0, min(c0 + self.ct, self.N)),
                range(cls0, cls0 + self.classes))

    def slab_row(self, rank: int, q: int) -> int:
        """The slab row i held in local row ``q`` of block ``rank``
        (i >= R: computed as zeros, never read)."""
        lg = self.classes.bit_length() - 1
        return ((q >> lg) << 5) + rank * self.classes \
            + (q & (self.classes - 1))

    def row_tiles(self):
        """The GEMM tiles of a block: ranges of local rows."""
        return [range(q0, min(q0 + self.bm, self.rows))
                for q0 in range(0, self.rows, self.bm)]

    def chains(self, rank: int):
        """Each statistics chain of block ``rank`` as the kernel runs it:
        (thread, class, channel offset in the tile, the local rows it
        sums in order)."""
        out = []
        for p in range(self.classes * self.ct):
            lc, ch = divmod(p, self.ct)
            cls = rank * self.classes + lc
            n = -(-(self.R - cls) // CLASSES) if cls < self.R else 0
            out.append((p % THREADS, cls, ch,
                        [j * self.classes + lc for j in range(n)]))
        return out

    def owner(self, i: int):
        """(block rank, local row) of slab row ``i``, as the fire pass
        looks a row up."""
        k = i & (CLASSES - 1)
        lg = self.classes.bit_length() - 1
        return k >> lg, ((i >> 5) << lg) + (k & (self.classes - 1))

    def neurons(self, rank: int):
        """The hw the block of rank ``rank`` fires (each with every
        channel of its tile), as the kernel decodes them."""
        lg = self.classes.bit_length() - 1
        out = []
        for n in range(self.classes * -(-self.HW // CLASSES)):
            hw = ((n >> lg) << 5) + rank * self.classes \
                + (n & (self.classes - 1))
            if hw < self.HW:
                out.append(hw)
        return out


def channel_tile(N: int) -> int:
    """The channel tile at N output channels: the widest (<= 32) that
    splits N evenly, a multiple of 4 where N is."""
    vec = 4 if N % 4 == 0 else 1
    w = -(-N // -(-N // TILE_N))
    return -(-w // vec) * vec


def _row_tiles(rows: int):
    """The GEMM tiles for a block of ``rows`` local rows, the cheapest
    first: padded rows times ROW_TILES' time a row, ties to the wider."""
    return sorted(ROW_TILES, key=lambda bm: (
        -(-rows // bm) * bm * ROW_TILES[bm], -bm))


def resident_blocks(smem_bytes: int) -> int:
    """Blocks of ``smem_bytes`` of shared memory an SM holds at once."""
    return SM_SMEM // (smem_bytes + BLOCK_RESERVE)


def _fit(T, B, HW, N, K, ct, cluster, vec) -> Optional[ConvLifPlan]:
    """The plan at (ct, cluster): the cheapest row tile that fits, with
    the ring depth that leaves the most blocks resident on an SM, the
    deeper of two that leave as many; None where no tile fits."""
    rows = (CLASSES // cluster) * -(-T * HW // CLASSES)
    for bm in _row_tiles(rows):
        plans = [p for p in (ConvLifPlan(T=T, B=B, HW=HW, N=N, K=K, ct=ct,
                                         cluster=cluster, bm=bm, stages=st,
                                         vec=vec) for st in STAGES)
                 if p.smem_bytes <= MAX_SMEM]
        if plans:
            return max(plans, key=lambda p: (resident_blocks(p.smem_bytes),
                                             p.stages))
    return None


CLUSTERS = tuple(1 << i for i in range(MAX_CLUSTER.bit_length()))


@functools.lru_cache(maxsize=512)
def conv_lif_plan(T: int, B: int, HW: int, N: int, K: int, *,
                  cluster: Optional[int] = None) -> ConvLifPlan:
    """The kernel's plan: 4-channel fire lanes where N % 4 == 0; the
    channel tile ``channel_tile(N)``; the largest cluster whose blocks
    each compute ``MIN_ROWS`` rows or more, else the smallest whose slab
    fits; the cheapest GEMM row tile and its ring (``_fit``).
    ``cluster`` pins the cluster size (a launch table's choice).  Raises
    ValueError where no cluster holds the slab.  Cached per shape: the
    tick asks for the same few plans every time."""
    if min(T, B, HW, N, K) < 1:
        raise ValueError(f"spike_conv_lif: empty shape {(T, B, HW, N, K)}")
    if T * HW >= 2 ** 31 or K >= 2 ** 31:
        raise ValueError(f"spike_conv_lif: {T * HW} rows or K = {K} pass "
                         f"the int range")
    vec = 4 if N % 4 == 0 else 1
    ct = channel_tile(N)
    if cluster is not None and cluster not in CLUSTERS:
        raise ValueError(f"spike_conv_lif: cluster {cluster} not one of "
                         f"{CLUSTERS}")
    fits = [p for p in (_fit(T, B, HW, N, K, ct, c, vec)
                        for c in ((cluster,) if cluster else CLUSTERS))
            if p is not None]
    if not fits:
        raise ValueError(f"spike_conv_lif: a [{T * HW}, {ct}] slab fits "
                         f"no cluster of "
                         f"{cluster or f'up to {MAX_CLUSTER}'} blocks")
    p = next((p for p in reversed(fits) if p.rows >= MIN_ROWS), fits[0])
    if p.blocks >= 2 ** 31:
        raise ValueError(f"spike_conv_lif: {p.blocks} blocks pass the int "
                         f"range")
    return p


def spike_conv_lif_plain(xf, w, scale, bias, *, T: int, B: int,
                         stride: int = 1, tau: float = 2.0,
                         v_th: float = 1.0, v_reset: float = 0.0,
                         eps: float = NORM_EPS) -> torch.Tensor:
    """The plain conv (spike im2col + ``blocked_matmul``) -> instance
    norm + affine -> LIF, in the per-op pair's layout (a contiguous
    [T, B, HW, N] conv output), so its bits are the per-op
    composition's."""
    y = conv_plain(xf, w, stride=stride)
    y = y.reshape(B, T, y.shape[1] * y.shape[2], y.shape[3])
    return norm_affine_lif_plain(y.transpose(0, 1).contiguous(), scale, bias,
                                 tau=tau, v_th=v_th, v_reset=v_reset, eps=eps)


def spike_conv_lif(xf: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, *, T: int, B: int, stride: int = 1,
                   gate: str = "mask", cluster: Optional[int] = None,
                   tau: float = 2.0,
                   v_th: float = 1.0, v_reset: float = 0.0,
                   eps: float = NORM_EPS) -> torch.Tensor:
    """xf [B*T, H, W, C] folded spikes (batch-major), w HWIO [kh, kw, C,
    N], scale/bias [N] -> spikes [T, B, Ho*Wo, N], SAME padding.
    ``gate`` is "mask", "inline" or "none" (the same spikes under
    each); ``cluster`` pins the plan's cluster size (default
    ``conv_lif_plan``'s)."""
    if xf.dim() != 4 or w.dim() != 4 or w.shape[2] != xf.shape[3]:
        raise ValueError(f"spike_conv_lif: expected xf [B*T, H, W, C] and "
                         f"w [kh, kw, C, N], got {tuple(xf.shape)} and "
                         f"{tuple(w.shape)}")
    if xf.shape[0] != B * T:
        raise ValueError(f"spike_conv_lif: {xf.shape[0]} folded frames != "
                         f"B*T = {B * T}")
    N = w.shape[3]
    if scale.shape != (N,) or bias.shape != (N,):
        raise ValueError(f"spike_conv_lif: scale/bias must be [{N}], got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    if gate not in GATES:
        raise ValueError(f"spike_conv_lif: gate must be one of {GATES}, "
                         f"got {gate!r}")
    if stride < 1:
        raise ValueError(f"spike_conv_lif: stride {stride} < 1")
    _, H, W, C = xf.shape
    kh, kw = w.shape[:2]
    Ho, Wo = _same_pads(H, kh, stride)[2], _same_pads(W, kw, stride)[2]
    plan = conv_lif_plan(T, B, Ho * Wo, N, kh * kw * C, cluster=cluster)
    dev = check_f32("spike_conv_lif", xf, w, scale, bias)
    if dev.type == "cpu":
        return spike_conv_lif_plain(xf, w, scale, bias, T=T, B=B,
                                    stride=stride, tau=tau, v_th=v_th,
                                    v_reset=v_reset, eps=eps)
    return _conv_lif_launch(xf, w, scale, bias, plan, stride=stride,
                            gate=gate, tau=tau, v_th=v_th, v_reset=v_reset,
                            eps=eps)


def _conv_lif_launch(xf, w, scale, bias, plan: ConvLifPlan, *, stride: int,
                     gate: str, tau: float, v_th: float, v_reset: float,
                     eps: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with ``plan``: the wrapper passes
    ``conv_lif_plan``'s choice; timing code may pass other plans."""
    dev = xf.device
    _, H, W, C = xf.shape
    kh, kw, _, N = w.shape
    pad_h, _, Ho = _same_pads(H, kh, stride)
    pad_w, _, Wo = _same_pads(W, kw, stride)
    out = torch.empty((plan.T, plan.B, Ho * Wo, N), dtype=torch.float32,
                      device=dev)
    lib = load("spike_conv_lif", _SIG)
    launch("spike_conv_lif", dev, lib.spike_conv_lif_launch,
           xf.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
           out.data_ptr(), plan.T, plan.B, H, W, C, Ho, Wo, kh, kw, stride,
           pad_h, pad_w, N, plan.ct, plan.cluster, plan.bm, plan.stages,
           plan.vec, GATES.index(gate), f32_decay(tau), v_th, v_reset, eps)
    return out
