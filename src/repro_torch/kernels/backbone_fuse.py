"""The cross-layer segment planner of the fused-segment NPU tier — the
counterpart of ``repro.kernels.backbone_fuse``'s planner half.

A backbone's linear run of spiking conv layers is declared as a tuple
of :class:`LayerSpec`.  :func:`plan_segments` cuts it into maximal
fusible segments, forcing a boundary where residency breaks: a
segment's per-batch-element working set over the budget
(``repro_torch.launch.roofline.SEGMENT_BUDGET_BYTES``, derived from the
H100's L2), a stride the kernel does not chain (> ``MAX_FUSED_STRIDE``),
or a non-float32 activation dtype.  A fusible segment of more than one
layer, or of one layer with a pool, runs as ONE launch of the
``backbone_segment`` kernel (``repro_torch.kernels.backbone_segment``)
where the launch table routes it there
(``repro_torch.kernels.ops.backbone_segment_op``).

The working-set formula is the reference's, the patch matrix the TPU
kernel materialises included: it is a monotone budget signal, and
keeping it makes the port's plans equal JAX's at any budget.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import List, Optional, Tuple

import torch

from repro_torch.core.layers import _same_pads
from repro_torch.kernels.blocks import CANONICAL_K_BLOCK
from repro_torch.launch.roofline import (SEGMENT_BUDGET_BYTES,
                                         residency_estimate)

# The kernel chains strides 1 and 2 (every backbone here); a larger
# stride forces a segment boundary.
MAX_FUSED_STRIDE = 2

# device operations of the per-layer route at its untuned default, per
# layer: the conv kernel (read from the folded spikes), the copy to
# [T, B, HW, N] and the epilogue for a normal conv; the fold, the
# depthwise conv and the epilogue for a depthwise one; fold and pool
_UNFUSED_OPS_CONV = 3
_UNFUSED_OPS_DW = 3
_UNFUSED_OPS_POOL = 2


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One spiking conv layer of a backbone's linear run: the param-dict
    key and the static shape facts that decide fusibility.  ``pool`` is
    the window of a max-pool right after the layer (0: none), so the
    planner absorbs it as an epilogue instead of a segment break.
    Frozen and hashable: plans are cached on tuples of specs."""
    name: str
    kernel: int = 3
    stride: int = 1
    depthwise: bool = False
    cin: int = 1
    cout: int = 1
    pool: int = 0

    @property
    def dim_token(self) -> str:
        """Anonymous shape token for launch-table keys (no layer name:
        same-shaped segments share one entry)."""
        return (f"k{self.kernel}s{self.stride}c{self.cin}n{self.cout}"
                f"d{int(self.depthwise)}p{self.pool}")

    def anon(self) -> "LayerSpec":
        return dataclasses.replace(self, name="")


_TOKEN = re.compile(r"k(\d+)s(\d+)c(\d+)n(\d+)d([01])p(\d+)")


def spec_from_token(token: str) -> LayerSpec:
    """The anonymous ``LayerSpec`` of a ``dim_token``."""
    m = _TOKEN.fullmatch(token)
    if m is None:
        raise ValueError(f"bad layer token {token!r}")
    k, s, c, n, d, p = (int(v) for v in m.groups())
    return LayerSpec("", kernel=k, stride=s, depthwise=bool(d), cin=c,
                     cout=n, pool=p)


def conv_out_hw(spec: LayerSpec, h: int, w: int) -> Tuple[int, int]:
    """SAME conv output extent of one layer, before its pool."""
    return (_same_pads(h, spec.kernel, spec.stride)[2],
            _same_pads(w, spec.kernel, spec.stride)[2])


def layer_out_hw(spec: LayerSpec, h: int, w: int) -> Tuple[int, int]:
    """Output extent of one layer (SAME conv, then pool)."""
    ho, wo = conv_out_hw(spec, h, w)
    if spec.pool:
        ho, wo = ho // spec.pool, wo // spec.pool
    return ho, wo


def out_channels(spec: LayerSpec) -> int:
    return spec.cin if spec.depthwise else spec.cout


@dataclasses.dataclass(frozen=True)
class Segment:
    """One planned launch: a maximal run of layers whose activations stay
    on chip across layer boundaries.  ``fusible=False`` marks a run the
    kernel must not take (a single layer over the budget, an unchainable
    stride, a non-f32 dtype): it runs on the per-layer route."""
    layers: Tuple[LayerSpec, ...]
    fusible: bool = True

    def describe(self) -> str:
        mark = "" if self.fusible else "?"
        names = [s.name + ("+pool" if s.pool else "") for s in self.layers]
        return "[" + "+".join(names) + mark + "]"

    @property
    def fused_route(self) -> bool:
        """Whether the segment goes to ``backbone_segment_op``: fusible,
        and more than one layer or a pool to absorb."""
        return self.fusible and (len(self.layers) > 1
                                 or bool(self.layers[0].pool))


def segment_vmem_bytes(specs: Tuple[LayerSpec, ...], *, H: int, W: int,
                       T: int) -> int:
    """Per-batch-element working set of a fused segment, the reference's
    formula: the input slab and, per layer, the patch matrix (K
    canonical-padded), the f32 accumulator, the spike scratch and the
    membranes."""
    elems: List[int] = [T * H * W * (specs[0].cin if specs else 0)]
    h, w = H, W
    for s in specs:
        ho, wo = conv_out_hw(s, h, w)
        taps = s.kernel * s.kernel
        if s.depthwise:
            k = taps * s.cin
        else:
            kk = taps * s.cin
            k = kk + ((-kk) % CANONICAL_K_BLOCK)
        elems.append(T * ho * wo * k)                  # patch matrix
        elems.append(T * ho * wo * s.cout)             # accumulator
        elems.append(T * ho * wo * s.cout)             # spike scratch
        elems.append(ho * wo * s.cout)                 # membrane u
        h, w = layer_out_hw(s, h, w)
    return residency_estimate(*elems)


def segment_macs(specs: Tuple[LayerSpec, ...], *, H: int, W: int,
                 T: int, B: int) -> int:
    """Total multiply-adds of a segment."""
    total, h, w = 0, H, W
    for s in specs:
        ho, wo = conv_out_hw(s, h, w)
        taps = s.kernel * s.kernel
        k = taps * s.cin if not s.depthwise else taps
        total += T * B * ho * wo * k * out_channels(s)
        h, w = layer_out_hw(s, h, w)
    return total


def segment_activation_elems(specs: Tuple[LayerSpec, ...], *, H: int,
                             W: int, T: int, B: int) -> int:
    """Total per-layer conv-output elements: what the per-layer route
    round-trips through device memory and the kernel keeps in L2."""
    total, h, w = 0, H, W
    for s in specs:
        ho, wo = conv_out_hw(s, h, w)
        total += T * B * ho * wo * s.cout
        h, w = layer_out_hw(s, h, w)
    return total


def segment_edge_elems(specs: Tuple[LayerSpec, ...], *, H: int, W: int,
                       T: int, B: int) -> int:
    """Elements a fused segment must move through device memory: its
    input, every layer's weights, scale and bias, and its output."""
    total, h, w = T * B * H * W * specs[0].cin, H, W
    for s in specs:
        n = out_channels(s)
        taps = s.kernel * s.kernel
        total += (taps if s.depthwise else taps * s.cin) * n + 2 * n
        h, w = layer_out_hw(s, h, w)
    return total + T * B * h * w * out_channels(specs[-1])


def segment_unfused_launches(specs: Tuple[LayerSpec, ...]) -> int:
    """Device operations the per-layer route runs for the segment at its
    untuned default (the launch-count term of the tuner's estimate)."""
    return sum((_UNFUSED_OPS_DW if s.depthwise else _UNFUSED_OPS_CONV)
               + (_UNFUSED_OPS_POOL if s.pool else 0) for s in specs)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def _plan(specs: Tuple[LayerSpec, ...], H: int, W: int, T: int,
          f32: bool, budget: int) -> Tuple[Segment, ...]:
    segments: List[Segment] = []
    run: List[LayerSpec] = []
    h, w = H, W
    run_h, run_w = H, W                     # input extent of the open run

    def flush():
        nonlocal run, run_h, run_w
        if run:
            segments.append(Segment(layers=tuple(run)))
        run, run_h, run_w = [], h, w

    for s in specs:
        if not f32 or s.stride > MAX_FUSED_STRIDE:
            # residency break: the layer cannot enter any fused segment
            flush()
            segments.append(Segment(layers=(s,), fusible=False))
            h, w = layer_out_hw(s, h, w)
            run_h, run_w = h, w
            continue
        cand = tuple(run) + (s,)
        if segment_vmem_bytes(cand, H=run_h, W=run_w, T=T) > budget:
            flush()
            # the layer alone against the budget at its own input
            # extent: a single over-budget layer stays per-layer
            if segment_vmem_bytes((s,), H=h, W=w, T=T) > budget:
                segments.append(Segment(layers=(s,), fusible=False))
                h, w = layer_out_hw(s, h, w)
                run_h, run_w = h, w
                continue
        run.append(s)
        h, w = layer_out_hw(s, h, w)
    flush()
    return tuple(segments)


@functools.lru_cache(maxsize=None)
def _plan_cached(specs, H, W, T, f32, budget):
    return _plan(specs, H, W, T, f32, budget)


def plan_segments(specs, *, H: int, W: int, T: int, dtype=torch.float32,
                  vmem_budget: Optional[int] = None) -> Tuple[Segment, ...]:
    """Cut a linear layer run into maximal fusible segments.

    * greedy maximal runs: a layer joins the open segment unless the
      segment's working set (``segment_vmem_bytes``) would exceed
      ``vmem_budget`` (default ``roofline.SEGMENT_BUDGET_BYTES``);
    * ``stride > MAX_FUSED_STRIDE`` makes the layer its own non-fusible
      segment;
    * a non-float32 dtype makes every layer its own non-fusible segment;
    * a single layer over the budget by itself is non-fusible.

    Plans are static per (specs, extent, dtype, budget) and cached."""
    budget = SEGMENT_BUDGET_BYTES if vmem_budget is None else int(vmem_budget)
    return _plan_cached(tuple(specs), int(H), int(W), int(T),
                        dtype == torch.float32, budget)


def plan_inputs(plan: Tuple[Segment, ...], *, H: int,
                W: int) -> List[Tuple[int, int]]:
    """The input extent (h, w) of each segment of ``plan``."""
    out = []
    for seg in plan:
        out.append((H, W))
        for s in seg.layers:
            H, W = layer_out_hw(s, H, W)
    return out


def describe_plan(specs, *, H: int, W: int, T: int,
                  vmem_budget: Optional[int] = None) -> str:
    """Readable segment diagram, e.g. spiking-YOLO's
    ``[d0] [f0?] [d1] [f1+d2] [f2+d3+f3]``."""
    return " ".join(s.describe() for s in plan_segments(
        specs, H=H, W=W, T=T, vmem_budget=vmem_budget))
