"""Stage-fusion planner for the Cognitive ISP (the ``"cuda_fused"``
backend), the counterpart of ``repro.isp.fuse``.

The paper's ISP (§V) is a line-buffered streaming datapath: one pass, no
round trips to external memory between stages.  The per-stage backends
run one whole-image op (or many) per stage instead.  :func:`plan_stages`
cuts any ``ISPConfig.stages`` ordering into maximal fused segments from
the fusion metadata each :class:`~repro_torch.isp.stages.Stage`
declares, and :func:`run_fused_stages` runs each segment as one pass
through the segment kernels of ``repro_torch.kernels.isp_fused``.

Planning rules (one :class:`Segment` per pass), as in the reference:

  * ``pointwise`` stages accumulate into the current segment;
  * a ``reduce`` stage (AWB) starts a fresh segment: its global stats
    need the stage's materialised input, so the executor runs one stats
    pass there, then fuses the stage's pointwise ``apply_fn``;
  * a ``stencil`` stage ends the current segment: the pointwise run
    before it becomes the segment's prologue, recomputed on the halo;
  * a stage without fusion metadata becomes an opaque single-stage
    segment run through its ``"torch"`` impl.

The default ordering plans as ``[exposure+dpc] [demosaic] [awb*+nlm]
[gamma+sharpen]`` (``*``: the stats pass): 4 segment launches and one
stats pass.  Plans are cached per ordering against the registry
version.  A segment whose stages all have a device form launches a CUDA
kernel on a CUDA tensor (:attr:`_SegmentExec.launches_kernel`); any
other runs the plain segment version, decided when the plan is compiled.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.isp import stages as stage_registry
from repro_torch.isp.stages import (ParamSpec, Stage, get_stage,
                                    resolve_stage_params)
from repro_torch.kernels.isp_fused import (ChainStep, pointwise_segment,
                                           pointwise_segment_torch,
                                           stencil_segment,
                                           stencil_segment_torch)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One fused pass: optional leading reduce stage, a run of pointwise
    stages, an optional terminal stencil, or a single opaque stage."""
    reduce: Optional[str] = None
    pointwise: Tuple[str, ...] = ()
    stencil: Optional[str] = None
    opaque: Optional[str] = None

    @property
    def stages(self) -> Tuple[str, ...]:
        if self.opaque is not None:
            return (self.opaque,)
        head = (self.reduce,) if self.reduce is not None else ()
        tail = (self.stencil,) if self.stencil is not None else ()
        return head + self.pointwise + tail

    def describe(self) -> str:
        if self.opaque is not None:
            return f"[{self.opaque}?]"
        names = [self.reduce + "*"] if self.reduce is not None else []
        names += list(self.pointwise)
        if self.stencil is not None:
            names.append(self.stencil)
        return "[" + "+".join(names) + "]"


def _plan(stage_names: Tuple[str, ...]) -> Tuple[Segment, ...]:
    segments: List[Segment] = []
    reduce_name: Optional[str] = None
    run: List[str] = []

    def flush(stencil: Optional[str] = None):
        nonlocal reduce_name, run
        if reduce_name is not None or run or stencil is not None:
            segments.append(Segment(reduce=reduce_name,
                                    pointwise=tuple(run), stencil=stencil))
        reduce_name, run = None, []

    for name in stage_names:
        stage = get_stage(name)
        if stage.kind == "pointwise":
            run.append(name)
        elif stage.kind == "reduce":
            flush()
            reduce_name = name
        elif stage.kind == "stencil":
            flush(stencil=name)
        else:                                   # unannotated: opaque
            flush()
            segments.append(Segment(opaque=name))
    flush()
    return tuple(segments)


@functools.lru_cache(maxsize=None)
def _plan_cached(stage_names: Tuple[str, ...],
                 registry_version: int) -> Tuple[Segment, ...]:
    return _plan(stage_names)


def plan_stages(stage_names) -> Tuple[Segment, ...]:
    """Cut a stage ordering into fused segments (cached per ordering;
    the key includes the registry version, so re-registering a stage
    invalidates stale plans)."""
    return _plan_cached(tuple(stage_names), stage_registry.REGISTRY_VERSION)


def describe_plan(stage_names) -> str:
    """The segment diagram, e.g. the default ordering's
    ``[exposure+dpc] [demosaic] [awb*+nlm] [gamma+sharpen]``."""
    return " ".join(s.describe() for s in plan_stages(stage_names))


def memory_passes(stage_names) -> int:
    """Frame-sized passes of the plan: segment launches plus one stats
    pass per reduce stage."""
    plan = plan_stages(stage_names)
    return len(plan) + sum(1 for s in plan if s.reduce is not None)


# ---------------------------------------------------------------------------
# Compiled plan: per-segment chains with packed-parameter offsets
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class _SegmentExec:
    segment: Segment
    # packing order of the [B, P] parameter tensor: (stage, spec) pairs
    param_order: Tuple[Tuple[str, ParamSpec], ...]
    chain: Tuple[ChainStep, ...]       # pointwise chain (incl. reduce apply)
    wstep: Optional[ChainStep]         # the stencil stage's param slice
    consts: Tuple[torch.Tensor, ...]   # fuse_consts of the segment's stages
    # every stage has a device form: a CUDA tensor launches a kernel
    launches_kernel: bool
    _consts_on: Dict[torch.device, Tuple[torch.Tensor, ...]] = \
        dataclasses.field(default_factory=dict)

    def consts_on(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """The segment's constants on ``device``, copied there once."""
        if device not in self._consts_on:
            self._consts_on[device] = tuple(
                torch.as_tensor(c, dtype=torch.float32).to(device)
                for c in self.consts)
        return self._consts_on[device]


def _compile_segment(seg: Segment) -> _SegmentExec:
    param_order: List[Tuple[str, ParamSpec]] = []
    chain: List[ChainStep] = []
    wstep: Optional[ChainStep] = None
    offset = 0
    c_offset = 0

    def step_for(stage: Stage, fn, uses_stats: bool = False,
                 uses_consts: bool = False) -> ChainStep:
        nonlocal offset, c_offset
        names = tuple(spec.name for spec in stage.params)
        step = ChainStep(fn=fn, names=names, offset=offset,
                         uses_stats=uses_stats, uses_consts=uses_consts,
                         c_offset=c_offset,
                         n_consts=len(stage.fuse_consts),
                         op=stage.device_op)
        param_order.extend((stage.name, spec) for spec in stage.params)
        offset += len(names)
        c_offset += len(stage.fuse_consts)
        return step

    if seg.reduce is not None:
        stage = get_stage(seg.reduce)
        chain.append(step_for(stage, stage.apply_fn, uses_stats=True))
    for name in seg.pointwise:
        stage = get_stage(name)
        if stage.tile_fn is not None:
            chain.append(step_for(stage, stage.tile_fn, uses_consts=True))
        else:
            chain.append(step_for(stage, stage.impls["torch"]))
    if seg.stencil is not None:
        wstep = step_for(get_stage(seg.stencil), None)
    consts = tuple(c for name in seg.stages
                   for c in get_stage(name).fuse_consts)
    launches = seg.opaque is None and all(
        get_stage(name).device_op is not None for name in seg.stages)
    return _SegmentExec(segment=seg, param_order=tuple(param_order),
                        chain=tuple(chain), wstep=wstep, consts=consts,
                        launches_kernel=launches)


@functools.lru_cache(maxsize=None)
def _compiled_plan(stage_names: Tuple[str, ...],
                   registry_version: int) -> Tuple[_SegmentExec, ...]:
    return tuple(_compile_segment(s)
                 for s in _plan_cached(stage_names, registry_version))


def compile_plan(stage_names) -> Tuple[_SegmentExec, ...]:
    """The plan of an ordering with its chains, parameter layout and
    which segments launch a kernel (cached like :func:`plan_stages`)."""
    return _compiled_plan(tuple(stage_names),
                          stage_registry.REGISTRY_VERSION)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def _pack_params(ex: _SegmentExec, stage_params, x: torch.Tensor):
    """The segment's parameters as one [B, P] float32 tensor on x's
    device, a scalar broadcast over the batch (no host sync)."""
    B = x.shape[0]
    resolved = {name: resolve_stage_params(name, stage_params)
                for name in ex.segment.stages}
    slots = [torch.as_tensor(resolved[sname][spec.name],
                             dtype=torch.float32,
                             device=x.device).expand(B)
             for sname, spec in ex.param_order]
    if not slots:
        return torch.zeros((B, 1), dtype=torch.float32, device=x.device)
    return torch.stack(slots, dim=1)


def segment_call(ex: _SegmentExec, x: torch.Tensor, stage_params,
                 block: Optional[Tuple[int, int]] = None):
    """What segment ``ex`` runs on its input x [B, H, W(, C)]: (the
    kernel's wrapper, its plain version, args, kwargs), one call of
    either computing the segment.  ``block`` sets the plain versions'
    tile."""
    seg = ex.segment
    kw = {} if block is None else {"bh": block[0], "bw": block[1]}
    pvec = _pack_params(ex, stage_params, x)
    if seg.reduce is not None:
        stage = get_stage(seg.reduce)
        stats = stage.stats_fn(
            x, resolve_stage_params(seg.reduce, stage_params))
        stats = stats.to(torch.float32).contiguous()
    else:
        stats = torch.zeros((x.shape[0], 1), dtype=torch.float32,
                            device=x.device)
    args = (x, pvec, stats, ex.consts_on(x.device))
    if seg.stencil is None:
        kw["chain"] = ex.chain
        return pointwise_segment, pointwise_segment_torch, args, kw
    stage = get_stage(seg.stencil)
    kw.update(prologue=ex.chain, window_fn=stage.window_fn, wstep=ex.wstep,
              radius=stage.radius, pad=stage.pad,
              out_tail=((3,) if stage.out_domain == "rgb" and x.dim() == 3
                        else tuple(x.shape[3:])))
    return stencil_segment, stencil_segment_torch, args, kw


def run_fused_stages(raw: torch.Tensor, stage_params, stage_names,
                     block: Optional[Tuple[int, int]] = None):
    """Run a batch ``raw`` [B, H, W] through the fusion plan of
    ``stage_names``: one pass per segment, through its kernel where
    every stage has a device form, else its plain version.  ``block``
    sets the plain versions' tile (for tests; the CUDA tile is fixed)."""
    x = raw
    for ex in compile_plan(stage_names):
        x = x.contiguous()
        if ex.segment.opaque is not None:
            x = get_stage(ex.segment.opaque).impls["torch"](
                x, resolve_stage_params(ex.segment.opaque, stage_params))
            continue
        kernel, plain, args, kw = segment_call(ex, x, stage_params, block)
        x = (kernel if ex.launches_kernel else plain)(*args, **kw)
    return x
