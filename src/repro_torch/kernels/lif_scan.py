"""The LIF recurrence and the fused norm+affine+LIF epilogue: plain
PyTorch versions and the wrappers of their CUDA kernels
(``csrc/lif_scan.cu``, ``csrc/norm_affine_lif.cu``), and the launch plan
of the epilogue's kernel (``norm_lif_plan``).

A wrapper takes the plain version for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``decay`` reaches the kernels
as the float32 ``exp(-1/tau)`` that torch computes
(``repro_torch.core.lif.f32_decay``), never an ``expf`` of their own.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.layers import NORM_EPS, instance_norm_affine
from repro_torch.core.lif import f32_decay, lif_scan as lif_scan_plain
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)
from repro_torch.launch.roofline import SMS

# cur, bias (or null), out, T, N, C, decay, v_th, v_reset, stream
_LIF_SIG = ("lif_scan_launch",
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int64,
                                     ctypes.c_int]
            + [ctypes.c_float] * 3 + [ctypes.c_void_p])
_NORM_SIG = ("norm_affine_lif_launch",
             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])


# ---------------------------------------------------------------------------
# lif_scan: flat [T, N] recurrence
# ---------------------------------------------------------------------------

def lif_scan(currents: torch.Tensor, *, bias=None, tau: float = 2.0,
             v_th: float = 1.0, v_reset: float = 0.0) -> torch.Tensor:
    """currents [T, N] float32 -> spikes [T, N] of ``currents + bias``:
    ``bias`` is None or [C], C dividing N (the currents are [T, N / C, C]
    flattened, as a dense layer's [T, B, C] folds), and its add is part
    of the one launch.  Its gradient: ``kernels.ops.lif_scan_op``."""
    if currents.dim() != 2:
        raise ValueError(f"lif_scan: expected [T, N], got {currents.shape}")
    T, N = currents.shape
    if bias is not None and (bias.dim() != 1 or bias.shape[0] == 0
                             or N % bias.shape[0]):
        raise ValueError(f"lif_scan: a bias of shape {tuple(bias.shape)} "
                         f"does not divide currents of [T, N] = [{T}, {N}]")
    dev = check_f32("lif_scan", currents,
                    *(() if bias is None else (bias,)))
    if dev.type == "cpu":
        if bias is not None:
            currents = (currents.reshape(T, -1, bias.shape[0])
                        + bias).reshape(T, N)
        return lif_scan_plain(currents, tau=tau, v_th=v_th, v_reset=v_reset)
    out = torch.empty_like(currents)
    if N == 0 or T == 0:
        return out
    lib = load("lif_scan", _LIF_SIG)
    with torch.cuda.device(dev):
        err = lib.lif_scan_launch(
            currents.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), T, N, 0 if bias is None else bias.shape[0],
            f32_decay(tau), v_th, v_reset, stream_of(dev))
    check_launch("lif_scan", err)
    return out


# ---------------------------------------------------------------------------
# norm_affine_lif: instance norm over (T, HW) + affine + T-step LIF
# ---------------------------------------------------------------------------

def norm_affine_lif_plain(y, scale, bias, *, tau: float = 2.0,
                          v_th: float = 1.0, v_reset: float = 0.0,
                          eps: float = NORM_EPS) -> torch.Tensor:
    return lif_scan_plain(instance_norm_affine(y, scale, bias, eps), tau=tau,
                          v_th=v_th, v_reset=v_reset)


# the launch plan (csrc/norm_affine_lif.cu's constants)
CLASSES = 32                # row classes of the statistics contract
MAX_CLUSTER = 16            # blocks a cluster (the non-portable size)
MAX_TILE = 32               # channels a cluster at most (kMaxTile)
MIN_TILE = 8                # the narrowest tile a split of C goes down to
MAX_THREADS = 1024          # threads a block at most (kMaxThreads)
THREADS = 256               # threads a block, unless the chains need more
MAX_SMEM = 232448           # shared memory a block, bytes (kMaxSmem)
# a block's slab at most where the plan has a choice: where a class has
# LONG_CHAIN rows or more (64x64 at T = 5) more, smaller blocks finish
# their copies and fires while the chains run; at 32x32 fewer, larger
# ones are faster (H100 timings, PERF.md)
SLAB_TARGET = 64 * 1024
SLAB_TARGET_LONG = 32 * 1024
LONG_CHAIN = 320
# where a class has at most this many rows (16x16 and 8x8 frames at
# T = 5), one block a (b, tile) holds all 32 classes: a plain launch with
# block barriers beats a cluster's there
SHORT_CHAIN = 16
MIN_BLOCKS = SMS            # the fewest blocks a plan leaves, if it can
MIN_SLAB = 16 * 1024        # ...unless its blocks' slabs are this small


@dataclasses.dataclass(frozen=True)
class NormLifPlan:
    """The launch of one ``norm_affine_lif``: a cluster of ``cluster``
    blocks per (batch element, tile of ``ct`` channels), the tile
    fastest, every block on gridDim.x.  Block ``k`` of a cluster owns
    row classes ``[k * classes, (k + 1) * classes)``: one thread sums
    each (class, channel) and it fires the neurons whose t = 0 row is in
    its classes.  ``staged``: the block's rows of the slab sit in shared
    memory (copied ``vec`` floats at a time), else each pass reads y."""
    T: int
    B: int
    HW: int
    C: int
    ct: int
    cluster: int
    vec: int
    staged: bool
    threads: int

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
    def tiles(self) -> int:
        return -(-self.C // self.ct)

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
        return 4 * self.classes * self.J * self.ct

    @property
    def smem_bytes(self) -> int:
        return self.slab_offset + (self.slab_bytes if self.staged else 0)

    def block(self, k: int):
        """Block ``k`` decoded as the kernel decodes it: its batch
        element, its channels and its row classes."""
        cid, rank = divmod(k, self.cluster)
        b, tile = divmod(cid, self.tiles)
        c0 = tile * self.ct
        cls0 = rank * self.classes
        return (b, range(c0, min(c0 + self.ct, self.C)),
                range(cls0, cls0 + self.classes))

    def chain(self, tid: int):
        """Thread ``tid``'s (class offset in the block, channel in the
        tile) in the statistics passes, as the kernel decodes it; None
        for a thread that sums no class."""
        lc, ch = divmod(tid, self.ct)
        return (lc, ch) if lc < self.classes else None

    def slab_row(self, rank: int, q: int) -> int:
        """The slab row i held in local row ``q`` of block ``rank``
        (i >= R: not copied)."""
        lg = self.classes.bit_length() - 1
        return ((q >> lg) << 5) + rank * self.classes \
            + (q & (self.classes - 1))

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


def _tile_width(C: int, tiles: int, vec: int) -> int:
    w = -(-C // tiles)
    return -(-w // vec) * vec


@functools.lru_cache(maxsize=256)
def norm_lif_plan(T: int, B: int, HW: int, C: int, *,
                  aligned: bool = True) -> NormLifPlan:
    """The kernel's plan: 16-byte copies where ``aligned`` (y 16-byte
    aligned) and C % 4 == 0; the widest channel tile (<= 32, C split
    evenly), narrowed (down to ``MIN_TILE``) while 16-block clusters
    would leave fewer than ``MIN_BLOCKS`` blocks (of slabs over
    ``MIN_SLAB``) or a block's slab would pass the slab target; the
    smallest cluster that leaves ``MIN_BLOCKS`` blocks, or slabs within
    ``MIN_SLAB``, with a slab within the target (else 16), or, where a
    class has at most ``SHORT_CHAIN`` rows, a cluster of one if its slab
    fits; the slab staged where it fits a block's shared memory;
    ``THREADS`` threads, or one a (class, channel) chain where that is
    more.  The slab target is ``SLAB_TARGET_LONG`` where a class has
    ``LONG_CHAIN`` rows or more, else ``SLAB_TARGET``.  Cached per
    shape: the tick asks for the same few plans every time."""
    if min(T, B, HW, C) < 1:
        raise ValueError(f"norm_affine_lif: empty shape {(T, B, HW, C)}")
    if T * HW >= 2 ** 31:
        raise ValueError(f"norm_affine_lif: {T * HW} rows a slab pass the "
                         f"int range")
    vec = 4 if aligned and C % 4 == 0 else 1
    J = -(-T * HW // CLASSES)
    slab_target = SLAB_TARGET_LONG if J >= LONG_CHAIN else SLAB_TARGET

    def plan(ct, cluster, staged=True):
        classes = CLASSES // cluster
        threads = max(THREADS, -(-classes * ct // 32) * 32)
        return NormLifPlan(T=T, B=B, HW=HW, C=C, ct=ct, cluster=cluster,
                           vec=vec, staged=staged, threads=threads)

    def fits(p, limit):
        return p.slab_offset + p.slab_bytes <= limit

    def good(p):
        return fits(p, slab_target) and (p.blocks >= MIN_BLOCKS
                                         or p.slab_bytes <= MIN_SLAB)

    # the widest even split of C that is good with 16-block clusters
    widths = sorted({w for w in (_tile_width(C, t, vec) for t in range(
        -(-C // MAX_TILE), C + 1)) if min(MIN_TILE, C) <= w <= MAX_TILE},
        reverse=True)
    ct = next((w for w in widths if good(plan(w, MAX_CLUSTER))), widths[-1])
    cluster = 1
    short = J <= SHORT_CHAIN
    while cluster < MAX_CLUSTER and not good(plan(ct, cluster)) \
            and not (short and fits(plan(ct, cluster), MAX_SMEM)):
        cluster *= 2
    p = plan(ct, cluster)
    if not fits(p, MAX_SMEM):
        p = plan(ct, cluster, staged=False)
    if p.blocks >= 2 ** 31:
        raise ValueError(f"norm_affine_lif: {p.blocks} blocks pass the int "
                         f"range")
    return p


def _norm_launch(y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 plan: NormLifPlan, *, tau: float, v_th: float,
                 v_reset: float, eps: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with ``plan``: the wrapper passes
    ``norm_lif_plan``'s choice; tests may pass other plans."""
    dev = y.device
    out = torch.empty_like(y)
    lib = load("norm_affine_lif", _NORM_SIG)
    T, B, HW, C = y.shape
    with torch.cuda.device(dev):
        err = lib.norm_affine_lif_launch(
            y.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            T, B, HW, C, plan.ct, plan.cluster, plan.vec, int(plan.staged),
            plan.threads, f32_decay(tau), v_th, v_reset, eps, stream_of(dev))
    check_launch("norm_affine_lif", err)
    return out


def norm_affine_lif(y: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, *, tau: float = 2.0,
                    v_th: float = 1.0, v_reset: float = 0.0,
                    eps: float = NORM_EPS) -> torch.Tensor:
    """y [T, B, HW, C] pre-norm conv output, scale/bias [C] -> spikes
    [T, B, HW, C]."""
    if y.dim() != 4:
        raise ValueError(f"norm_affine_lif: expected [T, B, HW, C], got "
                         f"{tuple(y.shape)}")
    T, B, HW, C = y.shape
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"norm_affine_lif: scale/bias must be [{C}], got "
                         f"{tuple(scale.shape)}, {tuple(bias.shape)}")
    dev = check_f32("norm_affine_lif", y, scale, bias)
    if dev.type == "cpu":
        return norm_affine_lif_plain(y, scale, bias, tau=tau, v_th=v_th,
                                     v_reset=v_reset, eps=eps)
    if y.numel() == 0:
        return torch.empty_like(y)
    plan = norm_lif_plan(T, B, HW, C, aligned=y.data_ptr() % 16 == 0)
    return _norm_launch(y, scale, bias, plan, tau=tau, v_th=v_th,
                        v_reset=v_reset, eps=eps)
