"""Pluggable ISP stage registry (paper §V–§VI), the counterpart of
``repro.isp.stages``.

Each stage declares its NPU-controllable parameters (``ParamSpec``
ranges and defaults) and one implementation per backend; a pipeline is
an ordered tuple of stage names, and the NPU control vector maps onto
the declared ranges in pipeline order, so ``control_dim`` is derived.
Backends: ``"torch"`` (every stage's plain implementation), ``"cuda"``
(demosaic and NLM on their CUDA kernels; a stage without an
implementation for the requested backend runs its ``"torch"`` one) and
``"cuda_fused"`` (the fusion planner of :mod:`repro_torch.isp.fuse` and
its two segment kernels).

Stage implementations take a batch — ``x`` [B, H, W] or [B, H, W, 3] —
and ``p``, a ``{param: scalar or [B]}`` dict: one compiled-free eager
path serves every control setting.

Fusion metadata (the ``"cuda_fused"`` path), as in the reference:

  * ``kind="pointwise"``: a contiguous run of pointwise stages fuses
    into one segment; its ``"torch"`` impl (or ``tile_fn(x, p, consts)``
    where it needs array constants, ``fuse_consts``) is the plain form.
  * ``kind="stencil"``: ``radius``, ``pad`` ("wrap" for cyclic-roll
    references, "zero" for SAME-padded ones) and ``window_fn(win, p, *,
    y0, x0, bh, bw)`` mapping a halo'd [B, bh+2r, bw+2r(, C)] window to
    the [B, bh, bw(, C')] tile; it ends its segment, the pointwise run
    before it becomes the segment's prologue.
  * ``kind="reduce"``: ``stats_fn(image, p) -> [B, stats_width]`` runs
    once on the stage's materialised input, and the pointwise
    ``apply_fn(image, p, stats)`` fuses into the segment.
  * ``kind=None``: no metadata; the stage runs alone through its
    ``"torch"`` impl.

``device_op`` names a stage's form inside the CUDA segment kernels
(``repro_torch.kernels.isp_fused.DEVICE_OPS``).  A CUDA kernel cannot
call a Python function, so a segment holding a stage without one runs
through the plain segment version, on the card too.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.isp._util import bcast
from repro_torch.isp.awb import (AWB_STATS_WIDTH, awb_apply_stats,
                                 awb_gains, awb_stats)
from repro_torch.isp.demosaic import (DEMOSAIC_RADIUS, demosaic_mhc,
                                      demosaic_window)
from repro_torch.isp.dpc import DPC_RADIUS, dpc_correct, dpc_window
from repro_torch.isp.gamma import (SHARPEN_CONSTS, SHARPEN_RADIUS,
                                   apply_gamma, gamma_lut, sharpen_luma,
                                   sharpen_window)
from repro_torch.isp.nlm import NLM_RADIUS, nlm_denoise, nlm_window
from repro_torch.isp.tone import (CCM_CONSTS, apply_saturation,
                                  apply_saturation_tile, reinhard_tonemap)
from repro_torch.kernels.demosaic import demosaic as demosaic_kernel
from repro_torch.kernels.isp_fused import DEVICE_OPS
from repro_torch.kernels.nlm import nlm as nlm_kernel


class ParamSpec(NamedTuple):
    """One NPU-controllable parameter: the control vector's [0, 1]
    sigmoid output maps onto ``[lo, hi]`` by lerp."""
    name: str
    lo: float
    hi: float
    default: float


StageFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Stage:
    name: str
    params: Tuple[ParamSpec, ...]
    impls: Dict[str, StageFn]       # backend name -> implementation
    domain: str = "rgb"             # "bayer" | "rgb" | "any": input domain
    out_domain: Optional[str] = None  # None => unchanged (demosaic: "rgb")
    doc: str = ""
    # --- fusion metadata (see module docstring) ------------------------
    kind: Optional[str] = None      # "pointwise" | "stencil" | "reduce"
    radius: int = 0                 # stencil halo width
    pad: str = "wrap"               # stencil halo fill: "wrap" | "zero"
    window_fn: Optional[Callable] = None   # stencil: halo'd window -> tile
    tile_fn: Optional[Callable] = None     # pointwise form taking consts
    fuse_consts: Tuple = ()         # array constants of the fused form
    stats_fn: Optional[Callable] = None    # reduce: (image, p) -> [B, w]
    stats_width: int = 0
    apply_fn: Optional[Callable] = None    # reduce: (image, p, stats)
    device_op: Optional[str] = None  # its form in the CUDA segment kernels

    def impl_for(self, backend: str) -> StageFn:
        fn = self.impls.get(backend)
        return fn if fn is not None else self.impls["torch"]


STAGES: Dict[str, Stage] = {}
BACKENDS: List[str] = []

# Bumped on every (re-)registration; the fusion planner keys its plan
# cache on it, so replacing a stage invalidates stale plans.
REGISTRY_VERSION = 0


def _bump_registry_version() -> None:
    global REGISTRY_VERSION
    REGISTRY_VERSION += 1


def register_backend(name: str) -> None:
    if name not in BACKENDS:
        BACKENDS.append(name)


def register_stage(name: str, params: Tuple[ParamSpec, ...], impl: StageFn,
                   domain: str = "rgb", out_domain: Optional[str] = None,
                   doc: str = "", kind: Optional[str] = None,
                   radius: int = 0, pad: str = "wrap",
                   window_fn: Optional[Callable] = None,
                   tile_fn: Optional[Callable] = None,
                   fuse_consts: Tuple = (),
                   stats_fn: Optional[Callable] = None,
                   stats_width: int = 0,
                   apply_fn: Optional[Callable] = None,
                   device_op: Optional[str] = None) -> Stage:
    """Register (or replace) a stage with its plain ``torch`` impl and
    optional fusion metadata (see module docstring).  Replacing keeps
    the stage's other backend impls."""
    if kind not in (None, "pointwise", "stencil", "reduce"):
        raise ValueError(f"stage {name!r}: unknown fusion kind {kind!r}")
    if kind == "stencil" and (window_fn is None or radius <= 0):
        raise ValueError(f"stencil stage {name!r} needs window_fn and a "
                         f"positive radius")
    if pad not in ("wrap", "zero"):
        raise ValueError(f"stage {name!r}: pad must be 'wrap' or 'zero'")
    if kind == "reduce" and (stats_fn is None or apply_fn is None
                             or stats_width <= 0):
        raise ValueError(f"reduce stage {name!r} needs stats_fn, apply_fn "
                         f"and a positive stats_width")
    if kind == "pointwise" and fuse_consts and tile_fn is None:
        raise ValueError(
            f"pointwise stage {name!r} declares fuse_consts but no "
            f"tile_fn to receive them (a torch impl cannot take consts)")
    if device_op is not None and device_op not in DEVICE_OPS:
        raise ValueError(f"stage {name!r}: unknown device op {device_op!r}; "
                         f"known: {DEVICE_OPS}")
    impls = dict(STAGES[name].impls) if name in STAGES else {}
    impls["torch"] = impl
    stage = Stage(name=name, params=tuple(params), impls=impls,
                  domain=domain, out_domain=out_domain, doc=doc,
                  kind=kind, radius=radius, pad=pad, window_fn=window_fn,
                  tile_fn=tile_fn, fuse_consts=tuple(fuse_consts),
                  stats_fn=stats_fn, stats_width=stats_width,
                  apply_fn=apply_fn, device_op=device_op)
    STAGES[name] = stage
    _bump_registry_version()
    return stage


def register_stage_impl(name: str, backend: str, impl: StageFn) -> None:
    """Attach an implementation on ``backend`` to a registered stage.
    The ``Stage`` is rebuilt with a fresh ``impls`` dict, so a ``Stage``
    object handed out before keeps the impls it had."""
    if name not in STAGES:
        raise KeyError(f"unknown ISP stage {name!r}")
    register_backend(backend)
    stage = STAGES[name]
    STAGES[name] = dataclasses.replace(stage,
                                       impls={**stage.impls, backend: impl})
    _bump_registry_version()


def get_stage(name: str) -> Stage:
    try:
        return STAGES[name]
    except KeyError:
        raise KeyError(f"unknown ISP stage {name!r}; registered: "
                       f"{sorted(STAGES)}") from None


# ---------------------------------------------------------------------------
# Control-vector <-> per-stage parameter mapping
# ---------------------------------------------------------------------------

def stage_param_specs(stage_names) -> List[Tuple[str, ParamSpec]]:
    """Flattened (stage, spec) list in pipeline order — the layout of the
    control vector.  Duplicate stage names are rejected (they would
    alias their control slots)."""
    if len(set(stage_names)) != len(tuple(stage_names)):
        raise ValueError(
            f"duplicate ISP stage in {tuple(stage_names)}: control-vector "
            f"mapping is keyed by stage name")
    return [(name, spec) for name in stage_names
            for spec in get_stage(name).params]


def control_dim_for(stage_names) -> int:
    return len(stage_param_specs(stage_names))


def control_to_stage_params(ctrl: torch.Tensor, stage_names) \
        -> Dict[str, Dict[str, torch.Tensor]]:
    """Map a [..., control_dim] vector in [0, 1] onto the declared
    ranges: slot ``i`` drives the ``i``-th (stage, param) in order."""
    out: Dict[str, Dict[str, torch.Tensor]] = {n: {} for n in stage_names}
    for i, (sname, spec) in enumerate(stage_param_specs(stage_names)):
        out[sname][spec.name] = spec.lo + (spec.hi - spec.lo) * ctrl[..., i]
    return out


# ---------------------------------------------------------------------------
# Pipeline runner
# ---------------------------------------------------------------------------

def check_stage_order(stage_names) -> None:
    """A stage declaring ``domain="rgb"`` cannot run before demosaic,
    and vice versa."""
    domain = "bayer"
    for name in stage_names:
        stage = get_stage(name)
        if stage.domain not in ("any", domain):
            raise ValueError(
                f"stage {name!r} expects {stage.domain!r} input but the "
                f"pipeline {tuple(stage_names)} is in the {domain!r} "
                f"domain at that point")
        domain = stage.out_domain or domain


def resolve_stage_params(name: str, stage_params) -> Dict[str, torch.Tensor]:
    """One stage's {param: value} dict with missing entries defaulted."""
    p = dict(stage_params.get(name, {})) if stage_params else {}
    for spec in get_stage(name).params:
        p.setdefault(spec.name, torch.tensor(spec.default,
                                             dtype=torch.float32))
    return p


def run_stages(raw: torch.Tensor, stage_params, stage_names,
               backend: str = "torch") -> torch.Tensor:
    """Run a batch of Bayer mosaics ``raw`` [B, H, W] through the named
    stages in order.  ``stage_params``: {stage: {param: scalar or [B]}};
    missing stages and params take their defaults.  ``"cuda_fused"``
    runs the ordering's fusion plan (:mod:`repro_torch.isp.fuse`)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown ISP backend {backend!r}; registered: "
                         f"{BACKENDS}")
    for sname, sp in (stage_params or {}).items():
        declared = {spec.name for spec in get_stage(sname).params}
        unknown = set(sp) - declared
        if unknown:
            raise ValueError(
                f"unknown param(s) {sorted(unknown)} for ISP stage "
                f"{sname!r}; declared: {sorted(declared)}")
    check_stage_order(stage_names)
    if backend == "cuda_fused":
        from repro_torch.isp.fuse import run_fused_stages   # import cycle
        return run_fused_stages(raw, stage_params, tuple(stage_names))
    x = raw
    for name in stage_names:
        p = resolve_stage_params(name, stage_params)
        x = get_stage(name).impl_for(backend)(x, p)
    return x


# ---------------------------------------------------------------------------
# Built-in stages (paper §V)
# ---------------------------------------------------------------------------

def _exposure(x, p):
    return torch.clamp(x * bcast(p["gain"], x), 0.0, 1.0)


def _dpc(x, p):
    return dpc_correct(x, threshold=p["threshold"])[0]


def _demosaic(x, p):
    return demosaic_mhc(x)


def _demosaic_cuda(x, p):
    return demosaic_kernel(x)


def _awb(x, p):
    return awb_apply_stats(x, p, awb_gains(x))


def _nlm(x, p):
    return nlm_denoise(x, strength=p["strength"])


def _nlm_cuda(x, p):
    return nlm_kernel(x, p["strength"])


def _gamma(x, p):
    return apply_gamma(x, gamma_lut(p["gamma"], device=x.device))


def _sharpen(x, p):
    return sharpen_luma(x, p["amount"])


def _tonemap(x, p):
    return reinhard_tonemap(x, p["strength"])


def _ccm(x, p):
    return apply_saturation(x, p["saturation"])


register_backend("torch")
register_backend("cuda")
register_backend("cuda_fused")

register_stage(
    "exposure", (ParamSpec("gain", 0.5, 2.0, 1.0),), _exposure,
    domain="any", kind="pointwise", device_op="exposure",
    doc="digital gain, clipped to [0,1] (either domain)")
register_stage(
    "dpc", (ParamSpec("threshold", 0.05, 0.5, 0.2),), _dpc,
    domain="bayer", kind="stencil", radius=DPC_RADIUS, pad="wrap",
    window_fn=dpc_window, device_op="dpc",
    doc="dynamic defective pixel correction (§V-B.1)")
register_stage(
    "demosaic", (), _demosaic, domain="bayer", out_domain="rgb",
    kind="stencil", radius=DEMOSAIC_RADIUS, pad="zero",
    window_fn=demosaic_window, device_op="demosaic",
    doc="Malvar-He-Cutler 5x5 demosaic (§V-B.3)")
register_stage(
    "awb", (ParamSpec("enable", 0.0, 1.0, 1.0),
            ParamSpec("bias_r", 0.5, 2.0, 1.0),
            ParamSpec("bias_b", 0.5, 2.0, 1.0)), _awb,
    kind="reduce", stats_fn=awb_stats, stats_width=AWB_STATS_WIDTH,
    apply_fn=awb_apply_stats, device_op="awb",
    doc="grey-world AWB, softly blended, with NPU r/b bias (§V-B.2)")
register_stage(
    "nlm", (ParamSpec("strength", 0.0, 1.0, 0.3),), _nlm,
    kind="stencil", radius=NLM_RADIUS, pad="wrap", window_fn=nlm_window,
    device_op="nlm",
    doc="bounded-window non-local-means denoise (§V-B.4)")
register_stage(
    "gamma", (ParamSpec("gamma", 0.4, 3.0, 2.2),), _gamma,
    kind="pointwise", device_op="gamma",
    doc="256-entry gamma LUT with linear interp (§V-B.5)")
register_stage(
    "sharpen", (ParamSpec("amount", 0.0, 1.0, 0.3),), _sharpen,
    kind="stencil", radius=SHARPEN_RADIUS, pad="wrap",
    window_fn=sharpen_window, fuse_consts=SHARPEN_CONSTS,
    device_op="sharpen",
    doc="luma sharpening in YCbCr (§V-B.5)")
register_stage(
    "tonemap", (ParamSpec("strength", 0.0, 1.0, 0.5),), _tonemap,
    kind="pointwise", device_op="tonemap",
    doc="global Reinhard tone-mapping; strength 0 ~= identity")
register_stage(
    "ccm", (ParamSpec("saturation", 0.0, 2.0, 1.0),), _ccm,
    kind="pointwise", tile_fn=apply_saturation_tile,
    fuse_consts=CCM_CONSTS, device_op="ccm",
    doc="luma-preserving saturation matrix (CCM analogue)")

register_stage_impl("demosaic", "cuda", _demosaic_cuda)
register_stage_impl("nlm", "cuda", _nlm_cuda)
