"""A planned backbone segment in one launch: the wrapper of its CUDA
kernel (``csrc/backbone_segment.cu``), its launch plan and its plain
version.

The kernel runs one thread-block cluster per batch element.  Block ``k``
owns the row classes ``[k * classes, (k + 1) * classes)`` of the
statistics contract (``csrc/lif_common.cuh``) and holds their rows of
each layer's [T*Ho*Wo, N] conv output in its shared memory; per layer
the conv (implicit im2col from the layer's input spikes, canonical K
blocks; or the depthwise tap loop), the instance-norm statistics from
the slabs, normalise + affine + LIF and the optional pool, the spikes
handed to the next layer through a per-element ping-pong buffer.  Its
conv sums as ``spike_conv``/``spike_conv_lif``/``spike_dwconv`` sum and
its statistics as ``norm_affine_lif``'s, so its spikes equal the
per-layer kernel route's bit for bit under either gate.
``segment_plan`` makes the launch plan (cached per shape) and refuses a
segment whose largest slab fits no cluster.

The plain version is the counterpart of the reference's ``_segment_ref``
in the per-layer route's own plain arithmetic (``blocked_matmul`` on the
patch matrix or the tap loop, ``norm_affine_lif_plain``,
``pool_slices``), so on the CPU a segment equals the per-layer route
exactly.  The wrapper takes it for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.layers import (NORM_EPS, _same_pads, blocked_matmul,
                                     fold, pool_slices, spike_conv,
                                     spike_im2col, unfold)
from repro_torch.core.lif import f32_decay
from repro_torch.kernels.backbone_fuse import (MAX_FUSED_STRIDE, LayerSpec,
                                               conv_out_hw, layer_out_hw,
                                               out_channels)
from repro_torch.kernels.build import (check_f32, check_launch, launch,
                                       load)
from repro_torch.kernels.lif_scan import norm_affine_lif_plain
from repro_torch.kernels.spike_conv_lif import (BLOCK_RESERVE, CLASSES,
                                                CLUSTERS, LDA, MAX_CLUSTER,
                                                MAX_SMEM, ROW_TILES,
                                                SM_SMEM, STAGES, TILE_K,
                                                TILE_N, channel_tile)
from repro_torch.launch.roofline import SMS

_SIG = ("backbone_segment_launch",
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4
        + [ctypes.c_int64] + [ctypes.c_int] * 3 + [ctypes.c_void_p])

GATES = ("inline", "none")
_GATE_CODES = {"inline": 1, "none": 2}     # Gate of backbone_segment.cu
CLUSTER_SIZES = CLUSTERS                   # blocks per batch element
MAX_LAYERS = 16
MAX_POOL = 4
_UNSCHEDULABLE = -1
# GEMM row tiles: 32 rows a thread row (TM = 1..8 rows a thread)
ROW_TILE_SIZES = tuple(32 * tm for tm in range(1, 9))
# the largest row tile cap first, then the deeper ring: the ring sizes a
# plan tries until one fits beside the slab
_RINGS = tuple((bm, st) for bm in sorted(ROW_TILES, reverse=True)
               for st in STAGES)
# blocks an SM the kernel's registers leave room for: 1, or 2 (128
# registers a thread, so no 256-row tile, and shared memory within half
# an SM's)
OCCUPANCIES = (1, 2)
_SMEM_AT = {1: MAX_SMEM, 2: SM_SMEM // 2 - BLOCK_RESERVE}
_BM_AT = {1: max(ROW_TILE_SIZES), 2: 128}
# clusters of 16 blocks an H100 holds at once at one block an SM (its
# GPCs; cudaOccupancyMaxActiveClusters, chip_smoke.py): a larger batch on
# 16-block clusters runs in two waves
RESIDENT_16 = 7


def weight_rows(spec: LayerSpec) -> int:
    """Rows of a layer's weight operand: K = kh*kw*cin for a normal
    conv, the taps for a depthwise one."""
    taps = spec.kernel * spec.kernel
    return taps if spec.depthwise else taps * spec.cin


def segment_operands(params, specs: Sequence[LayerSpec]) -> Tuple:
    """Per-layer (w HWIO, scale, bias) -> the kernel's flat operands,
    views with no copy: a normal layer's [K, N] weight matrix, a
    depthwise layer's [taps, C] tap matrix (both the HWIO weight
    reshaped), then scale and bias."""
    flat = []
    for (w, scale, bias), _ in zip(params, specs):
        flat += [w.reshape(-1, w.shape[-1]), scale, bias]
    return tuple(flat)


@dataclasses.dataclass(frozen=True)
class SegmentLayer:
    """One layer of a plan: its shape and its conv's tiles -- ``bm``
    cluster rows x ``ct`` channels, the block's own rows (``spread``
    False) or the cluster's rows dealt round its blocks (True)."""
    spec: LayerSpec
    H: int
    W: int
    Ho: int
    Wo: int
    R: int              # slab rows T * Ho * Wo
    rows: int           # local rows a block: classes * ceil(R / 32)
    bm: int
    spread: bool
    ct: int

    @property
    def N(self) -> int:
        return out_channels(self.spec)

    @property
    def K(self) -> int:
        return self.spec.kernel ** 2 * self.spec.cin

    @property
    def tiles_n(self) -> int:
        return -(-self.N // self.ct)

    @property
    def pads(self) -> Tuple[int, int]:
        k, s = self.spec.kernel, self.spec.stride
        return _same_pads(self.H, k, s)[0], _same_pads(self.W, k, s)[0]


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    """The launch of one segment on a [T, B, H, W, C] input: a cluster
    of ``cluster`` blocks per batch element on gridDim.x, a
    ``stages``-deep cp.async ring, and each layer's conv tiles."""
    T: int
    B: int
    cluster: int
    stages: int
    occupancy: int
    layers: Tuple[SegmentLayer, ...]

    @property
    def classes(self) -> int:
        """Row classes a block."""
        return CLASSES // self.cluster

    @property
    def blocks(self) -> int:
        return self.B * self.cluster

    @property
    def max_n(self) -> int:
        return max(ly.N for ly in self.layers)

    @property
    def bm(self) -> int:
        """The ring's row tile: the largest of the normal layers'."""
        return max([ly.bm for ly in self.layers if not ly.spec.depthwise]
                   + [min(ROW_TILES)])

    @property
    def slab_offset(self) -> int:
        return _align16((2 * 8 * self.classes + 4 * 4) * self.max_n)

    @property
    def slab_bytes(self) -> int:
        """A block's rows of the largest layer's slab."""
        return _align16(max(4 * ly.rows * ly.N for ly in self.layers))

    @property
    def ring_bytes(self) -> int:
        return 4 * self.stages * (self.bm * LDA + TILE_K * TILE_N)

    @property
    def smem_bytes(self) -> int:
        return (self.slab_offset + self.slab_bytes + self.ring_bytes
                + 16 * self.bm)

    @property
    def act_elems(self) -> int:
        """Floats a batch element's spike buffer holds: the largest
        interior layer's spikes, rounded up to 16 bytes (0 for one
        layer)."""
        n = max([self.T * (ly.Ho // (ly.spec.pool or 1))
                 * (ly.Wo // (ly.spec.pool or 1)) * ly.N
                 for ly in self.layers[:-1]] + [0])
        return -(-n // 4) * 4

    def describe(self) -> str:
        """cluster, occupancy, ring and each layer's tile, e.g. ``cluster
        16, 2 block(s) an SM, ring 3, smem 95296 B, tiles 128s/64o/dw``."""
        tiles = "/".join("dw" if ly.spec.depthwise else
                         f"{ly.bm}{'s' if ly.spread else 'o'}"
                         for ly in self.layers)
        return (f"cluster {self.cluster}, {self.occupancy} block(s) an SM, "
                f"ring {self.stages}, smem {self.smem_bytes} B, tiles "
                f"{tiles}")

    def slab_row(self, o: int, q: int) -> int:
        """The slab row i held in local row ``q`` of block ``o``."""
        cpb = self.classes
        return (q // cpb) * CLASSES + o * cpb + q % cpb

    def owner(self, i: int) -> Tuple[int, int]:
        """(block, local row) holding slab row ``i``."""
        cpb = self.classes
        k = i % CLASSES
        return k // cpb, (i // CLASSES) * cpb + k % cpb

    def tiles(self, l: int, rank: int):
        """The conv tiles block ``rank`` computes in layer ``l``, as the
        kernel deals them: (first cluster row g0, first channel c0,
        channels); a tile's row r is cluster row g0 + r, held by block
        (g0 + r) // rows at local row (g0 + r) % rows."""
        ly = self.layers[l]
        lo = 0 if ly.spread else rank * ly.rows
        hi = self.cluster * ly.rows if ly.spread else lo + ly.rows
        n = -(-(hi - lo) // ly.bm) * ly.tiles_n
        out = []
        for t in (range(rank, n, self.cluster) if ly.spread else range(n)):
            c0 = t % ly.tiles_n * ly.ct
            out.append((lo + t // ly.tiles_n * ly.bm, c0,
                        min(ly.ct, ly.N - c0)))
        return out

    def tile_rows(self, l: int, rank: int, g0: int):
        """The (cluster row, slab row) of a tile's rows that hold a slab
        row, as the kernel decodes them."""
        ly = self.layers[l]
        hi = self.cluster * ly.rows if ly.spread else (rank + 1) * ly.rows
        out = []
        for g in range(g0, min(g0 + ly.bm, hi)):
            i = self.slab_row(g // ly.rows, g % ly.rows)
            if i < ly.R:
                out.append((g, i))
        return out

    def block_macs(self, l: int) -> int:
        """Multiply-adds the busiest block does in layer ``l``'s conv, pad
        rows and idle tile columns included."""
        ly = self.layers[l]
        if ly.spec.depthwise:
            return ly.rows * ly.N * ly.spec.kernel ** 2
        most = max(len(self.tiles(l, k)) for k in range(self.cluster))
        return most * ly.bm * TILE_N * ly.K


def _align16(v: int) -> int:
    return -(-v // 16) * 16


def _segment_shapes(specs, T: int, H: int, W: int):
    """Each layer's (input h, w, conv output ho, wo, slab rows R)."""
    out, h, w = [], H, W
    for s in specs:
        ho, wo = conv_out_hw(s, h, w)
        out.append((h, w, ho, wo, T * ho * wo))
        h, w = layer_out_hw(s, h, w)
    return out


def row_time(bm: int) -> float:
    """A tile row's relative time at a row tile of ``bm`` rows: the
    H100's times at 32-256 rows (``spike_conv_lif.ROW_TILES``: a larger
    thread tile reads shared memory less per multiply-add), as 0.56 +
    1.76 / TM between them."""
    return ROW_TILES.get(bm, 0.56 + 1.76 * 32 / bm)


def _tile_cost(rows: int, bm: int, tiles_n: int, cluster: int,
               spread: bool) -> float:
    """The relative time of a conv's tiles on the busiest block: tiles a
    block times rows a tile times a row's time at that tile
    (``row_time``)."""
    if spread:
        n = -(-cluster * rows // bm) * tiles_n
        per_block = -(-n // cluster)
    else:
        per_block = -(-rows // bm) * tiles_n
    return per_block * bm * row_time(bm)


def _conv_tiles(rows: int, N: int, cluster: int, cap: int):
    """A normal layer's (bm, spread): the cheapest tiles at a row tile of
    at most ``cap``, own rows on ties (a spread conv costs a barrier)."""
    tiles_n = -(-N // channel_tile(N))
    opts = [(bm, spread) for bm in ROW_TILE_SIZES if bm <= cap
            for spread in ((False, True) if cluster > 1 else (False,))]
    return min(opts, key=lambda o: (_tile_cost(rows, o[0], tiles_n, cluster,
                                               o[1]), o[1], -o[0]))


def _fit(specs, shapes, T, B, cluster, occupancy,
         rings) -> Optional[SegmentPlan]:
    """The plan at ``cluster`` and ``occupancy`` with the first ring of
    ``rings`` that fits beside the slab; None where none does."""
    cpb = CLASSES // cluster
    for cap, stages in rings:
        if cap > _BM_AT[occupancy]:
            continue
        layers = []
        for s, (h, w, ho, wo, R) in zip(specs, shapes):
            rows = cpb * -(-R // CLASSES)
            n = out_channels(s)
            bm, spread = ((min(ROW_TILES), False) if s.depthwise
                          else _conv_tiles(rows, n, cluster, cap))
            layers.append(SegmentLayer(spec=s, H=h, W=w, Ho=ho, Wo=wo, R=R,
                                       rows=rows, bm=bm, spread=spread,
                                       ct=channel_tile(n)))
        p = SegmentPlan(T=T, B=B, cluster=cluster, stages=stages,
                        occupancy=occupancy, layers=tuple(layers))
        if p.smem_bytes <= _SMEM_AT[occupancy]:
            return p
    return None


def _resident(B: int, cluster: int, occupancy: int) -> bool:
    """Whether the card holds all B clusters at once, each block on an SM
    of its own where it can."""
    return (B * cluster <= SMS
            and (cluster < MAX_CLUSTER or B <= RESIDENT_16 * occupancy))


def _at_cluster(specs, shapes, T, B, cluster):
    """The plan at ``cluster``, at the fewest blocks an SM that hold all B
    clusters at once (one where none does)."""
    occs = tuple(o for o in OCCUPANCIES if _resident(B, cluster, o)) or (1,)
    for o in occs:
        p = _fit(specs, shapes, T, B, cluster, o, _RINGS)
        if p is not None:
            return p
    return None


@functools.lru_cache(maxsize=512)
def segment_plan(specs: Tuple[LayerSpec, ...], T: int, B: int, H: int,
                 W: int, *, cluster: Optional[int] = None) -> SegmentPlan:
    """The kernel's plan for ``specs`` on a [T, B, H, W, C] input: the
    largest cluster whose B clusters the card holds at once with every
    block on an SM of its own (B * cluster <= 132 SMs; ``_resident``)
    and whose blocks hold their share of the segment's largest slab
    beside a ring (else the smallest cluster that fits); the largest row
    tile and ring (``_RINGS``) that fit; per layer the cheapest tiles
    (``_conv_tiles``).  A pinned ``cluster`` (a launch table's choice)
    takes the fewest blocks an SM that hold all B clusters at once: at
    batch 8, 16-block clusters at two blocks an SM, where the eighth
    shares its SMs with another (slower on the 3x3 segments, faster on
    the light ones; chip_smoke.py --segment-phase times the other
    clusters, rings and blocks an SM).  Raises ValueError where no
    cluster holds the slab.  Cached per shape: the tick asks for the
    same few plans every time."""
    specs = tuple(s.anon() for s in specs)
    if not 1 <= len(specs) <= MAX_LAYERS:
        raise ValueError(f"backbone_segment: 1 to {MAX_LAYERS} layers, got "
                         f"{len(specs)}")
    if min(T, B, H, W) < 1:
        raise ValueError(f"backbone_segment: empty shape {(T, B, H, W)}")
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"backbone_segment: cluster must be one of "
                         f"{CLUSTER_SIZES}, got {cluster!r}")
    shapes = _segment_shapes(specs, T, H, W)
    if any(R >= 2 ** 31 for *_, R in shapes) or B * MAX_CLUSTER >= 2 ** 31:
        raise ValueError(f"backbone_segment: {shapes} or batch {B} pass "
                         f"the int range")
    fits = [p for p in (_at_cluster(specs, shapes, T, B, c)
                        for c in ((cluster,) if cluster else CLUSTER_SIZES))
            if p is not None]
    if not fits:
        raise ValueError(f"backbone_segment: the largest slab of "
                         f"{[s.dim_token for s in specs]} at T={T}, "
                         f"{H}x{W} fits no cluster of "
                         f"{cluster or f'up to {MAX_CLUSTER}'} blocks")
    alone = [p for p in fits if _resident(B, p.cluster, 1)]
    return (max(alone, key=lambda p: p.cluster) if alone
            else min(fits, key=lambda p: p.cluster))


def plan_clusters(specs, T: int, B: int, H: int, W: int):
    """The cluster sizes a launch table may choose for a segment: the
    plan's, and twice and half it where the slab fits; none where no
    cluster holds the slab."""
    try:
        c = segment_plan(tuple(specs), T, B, H, W).cluster
    except ValueError:
        return ()
    out = [c]
    for f in (c * 2, c // 2):
        if f in CLUSTER_SIZES:
            try:
                segment_plan(tuple(specs), T, B, H, W, cluster=f)
            except ValueError:
                continue
            out.append(f)
    return tuple(out)


def segment_layer_plain(x, w, spec: LayerSpec):
    """One layer's conv on x [T, B, H, W, C] with the kernel's weight
    operand -> the pre-norm conv output [T, B, Ho*Wo, n], contiguous:
    the per-layer route's plain conv (``blocked_matmul`` of the patch
    matrix over the first K weight rows, or the tap loop)."""
    T, B = x.shape[:2]
    xf = fold(x)
    if spec.depthwise:
        y = spike_conv(xf, w.reshape(spec.kernel, spec.kernel, 1, -1),
                       stride=spec.stride, depthwise=True)
    else:
        patches, (ho, wo) = spike_im2col(xf, spec.kernel, spec.kernel,
                                         spec.stride)
        k = spec.kernel * spec.kernel * spec.cin
        y = blocked_matmul(patches, w[:k]).reshape(xf.shape[0], ho, wo, -1)
    y = unfold(y, T, B)
    return y.reshape(T, B, -1, y.shape[-1]).contiguous(), y.shape[2:4]


def backbone_segment_plain(x, flat, *, specs, tau: float = 2.0,
                           v_th: float = 1.0, v_reset: float = 0.0,
                           eps: float = NORM_EPS) -> torch.Tensor:
    """The segment layer by layer: conv, ``norm_affine_lif_plain``, then
    ``pool_slices`` where the layer pools."""
    cur = x
    for i, s in enumerate(specs):
        w, scale, bias = flat[3 * i:3 * i + 3]
        y4, (ho, wo) = segment_layer_plain(cur, w, s)
        T, B, _, n = y4.shape
        cur = norm_affine_lif_plain(y4, scale, bias, tau=tau, v_th=v_th,
                                    v_reset=v_reset, eps=eps).reshape(
            T, B, ho, wo, n)
        if s.pool:
            cur = unfold(pool_slices(fold(cur), s.pool), T, B)
    return cur


def _check(x, flat, specs, gate, cluster):
    if gate not in GATES:
        raise ValueError(f"backbone_segment: gate must be one of {GATES}, "
                         f"got {gate!r}")
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"backbone_segment: cluster must be one of "
                         f"{CLUSTER_SIZES}, got {cluster!r}")
    if not specs or len(specs) > MAX_LAYERS:
        raise ValueError(f"backbone_segment: 1 to {MAX_LAYERS} layers, got "
                         f"{len(specs)}")
    if len(flat) != 3 * len(specs):
        raise ValueError("backbone_segment: flat must hold (w, scale, bias) "
                         "per layer")
    if x.dim() != 5 or x.shape[-1] != specs[0].cin:
        raise ValueError(f"backbone_segment: x must be [T, B, H, W, "
                         f"{specs[0].cin}], got {tuple(x.shape)}")
    cin = specs[0].cin
    for i, s in enumerate(specs):
        if s.stride > MAX_FUSED_STRIDE or s.stride < 1:
            raise ValueError(f"backbone_segment: layer {i} stride "
                             f"{s.stride} is not chained (1 to "
                             f"{MAX_FUSED_STRIDE})")
        if not 0 <= s.pool <= MAX_POOL:
            raise ValueError(f"backbone_segment: layer {i} pool {s.pool} not "
                             f"in [0, {MAX_POOL}]")
        if s.cin != cin or (s.depthwise and s.cout != s.cin):
            raise ValueError(f"backbone_segment: layer {i} ({s}) does not "
                             f"chain from {cin} channels")
        w, scale, bias = flat[3 * i:3 * i + 3]
        n = out_channels(s)
        want = (weight_rows(s), n)
        if tuple(w.shape) != want or scale.shape != (n,) \
                or bias.shape != (n,):
            raise ValueError(f"backbone_segment: layer {i} operands "
                             f"{tuple(w.shape)}, {tuple(scale.shape)}, "
                             f"{tuple(bias.shape)}; want {want}, ({n},)")
        cin = n


def backbone_segment(x: torch.Tensor, flat, *, specs, gate: str = "inline",
                     cluster: Optional[int] = None, tau: float = 2.0,
                     v_th: float = 1.0, v_reset: float = 0.0,
                     eps: float = NORM_EPS) -> torch.Tensor:
    """x [T, B, H, W, C] spikes; ``flat`` the per-layer (w, scale, bias)
    of ``segment_operands``; ``specs`` the segment's ``LayerSpec``s ->
    spikes [T, B, Hf, Wf, Cf] after the last layer, pooling absorbed.
    ``gate``: "inline" (zero activations skipped) or "none";
    ``cluster``: blocks per batch element (default ``segment_plan``'s)."""
    specs = tuple(specs)
    _check(x, flat, specs, gate, cluster)
    dev = check_f32("backbone_segment", x, *flat)
    T, B, H, W, _ = x.shape
    plan = segment_plan(specs, T, B, H, W, cluster=cluster)
    lif = dict(tau=tau, v_th=v_th, v_reset=v_reset, eps=eps)
    if dev.type == "cpu":
        return backbone_segment_plain(x, flat, specs=specs, **lif)
    return segment_launch(x, flat, plan, gate=gate, **lif)


def segment_launch(x, flat, plan: SegmentPlan, *, gate: str, tau: float,
                   v_th: float, v_reset: float,
                   eps: float) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with ``plan``: the wrapper passes
    ``segment_plan``'s choice; timing code may pass other plans."""
    dev = x.device
    T, B = x.shape[:2]
    dims, ptrs = [], []
    for i, ly in enumerate(plan.layers):
        s = ly.spec
        dims += [ly.H, ly.W, s.cin, ly.Ho, ly.Wo, ly.N, s.kernel, s.stride,
                 *ly.pads, int(s.depthwise), s.pool, ly.bm, int(ly.spread),
                 ly.ct]
        ptrs += [t.data_ptr() for t in flat[3 * i:3 * i + 3]]
    last = plan.layers[-1]
    p = last.spec.pool or 1
    out = torch.empty((T, B, last.Ho // p, last.Wo // p, last.N),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # the spike buffers between layers (none for one layer)
    act = (torch.empty((2, B, plan.act_elems), dtype=torch.float32,
                       device=dev) if plan.act_elems else (out, out))
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    lib = load("backbone_segment", _SIG)

    def check(name, err):
        if err == _UNSCHEDULABLE:
            raise RuntimeError(f"backbone_segment: the card cannot schedule "
                               f"a cluster of {plan.cluster} blocks")
        check_launch(name, err)
    launch("backbone_segment", dev, lib.backbone_segment_launch,
           c_dims, c_ptrs, len(plan.layers), T, B, _GATE_CODES[gate],
           f32_decay(tau), v_th, v_reset, eps, x.data_ptr(), out.data_ptr(),
           act[0].data_ptr(), act[1].data_ptr(), plan.act_elems, plan.cluster,
           plan.stages, plan.occupancy, check=check)
    return out
