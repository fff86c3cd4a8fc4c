"""The Cognitive ISP pipeline (paper §V), built from the stage registry
in :mod:`repro_torch.isp.stages` — the counterpart of
``repro.isp.pipeline``.  The single-image functions take [H, W] mosaics
like the reference's; the ``_batch`` ones take [B, H, W] with per-image
([B]) or shared (scalar) parameters, what the reference gets by
vmapping.

Back-compat shims, as in the reference: ``ISPParams`` /
``default_params`` / ``control_to_params`` / ``isp_pipeline(raw,
params, use_cuda)`` keep the seed's fixed-8-field API working on top of
the registry (``use_pallas`` there, ``use_cuda`` here: the ``"cuda"``
backend)."""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import DEFAULT_ISP_STAGES, ISPConfig
from repro_torch.isp.stages import (control_to_stage_params, run_stages,
                                    stage_param_specs)


def run_pipeline_batch(raws: torch.Tensor, stage_params=None,
                       config: Optional[ISPConfig] = None) -> torch.Tensor:
    """raws [B, H, W] RGGB mosaics in [0, 1] -> RGB [B, H, W, 3]."""
    cfg = config if config is not None else ISPConfig()
    return run_stages(raws, stage_params, cfg.stages, backend=cfg.backend)


def run_pipeline(raw: torch.Tensor, stage_params=None,
                 config: Optional[ISPConfig] = None) -> torch.Tensor:
    """raw [H, W] -> RGB [H, W, 3]."""
    return run_pipeline_batch(raw[None], stage_params, config)[0]


def control_vector_pipeline_batch(raws: torch.Tensor, ctrl: torch.Tensor,
                                  config: Optional[ISPConfig] = None):
    """raws [B, H, W], NPU control vectors ctrl [B, control_dim] -> RGB
    [B, H, W, 3] — the §VI hot path."""
    cfg = config if config is not None else ISPConfig()
    return run_pipeline_batch(raws, control_to_stage_params(ctrl, cfg.stages),
                              cfg)


def control_vector_pipeline(raw: torch.Tensor, ctrl: torch.Tensor,
                            config: Optional[ISPConfig] = None):
    """raw [H, W], ctrl [control_dim] -> RGB [H, W, 3]."""
    return control_vector_pipeline_batch(raw[None], ctrl[None], config)[0]


def plan_summary(config: Optional[ISPConfig] = None) -> str:
    """The fusion-plan diagram of a config, e.g. the default's
    ``[exposure+dpc] [demosaic] [awb*+nlm] [gamma+sharpen]``: what the
    ``"cuda_fused"`` backend runs (``*`` the stats pass, ``?`` an opaque
    stage)."""
    from repro_torch.isp.fuse import describe_plan   # import cycle
    cfg = config if config is not None else ISPConfig()
    return describe_plan(cfg.stages)


# The legacy shim's control-slot order, as (stage, param) pairs.
_LEGACY_CONTROL_ORDER = (
    ("exposure", "gain"), ("awb", "bias_r"), ("awb", "bias_b"),
    ("gamma", "gamma"), ("nlm", "strength"), ("sharpen", "amount"),
    ("dpc", "threshold"), ("awb", "enable"))


def legacy_control_permutation(stage_names=DEFAULT_ISP_STAGES):
    """``perm`` with ``perm[i]`` = legacy slot feeding pipeline-ordered
    slot ``i`` (``ctrl_pipeline = ctrl_legacy[perm]``), for control
    heads trained through the reference's legacy shim."""
    pairs = [(s, spec.name) for s, spec in stage_param_specs(stage_names)]
    missing = [p for p in pairs if p not in _LEGACY_CONTROL_ORDER]
    if missing:
        raise ValueError(
            f"stages declare params outside the legacy control layout: "
            f"{missing}; retrain the head with the pipeline-order mapping")
    return tuple(_LEGACY_CONTROL_ORDER.index(p) for p in pairs)


# ---------------------------------------------------------------------------
# Back-compat shims (seed API)
# ---------------------------------------------------------------------------

class ISPParams(NamedTuple):
    """Legacy fixed control state (seed API); each leaf a scalar or a
    [B] tensor.  New code uses the {stage: {param: value}} dicts of
    :mod:`repro_torch.isp.stages`."""
    exposure_gain: torch.Tensor    # [0.5, 2.0] digital gain pre-pipeline
    wb_bias_r: torch.Tensor        # [0.5, 2.0] multiplicative AWB bias
    wb_bias_b: torch.Tensor        # [0.5, 2.0]
    gamma: torch.Tensor            # [0.4, 3.0]
    nlm_strength: torch.Tensor     # [0, 1]
    sharpen: torch.Tensor          # [0, 1]
    dpc_threshold: torch.Tensor    # [0.05, 0.5]
    awb_enable: torch.Tensor       # [0, 1] soft blend of auto gains


def default_params() -> ISPParams:
    return ISPParams(*(torch.tensor(v, dtype=torch.float32) for v in
                       (1.0, 1.0, 1.0, 2.2, 0.3, 0.3, 0.2, 1.0)))


def control_to_params(ctrl: torch.Tensor) -> ISPParams:
    """Legacy hand-ordered mapping of the NPU's sigmoid control vector
    [..., control_dim >= 8] to ranges (leaves [...]).  The registry
    derives its mapping from the ParamSpecs instead, in pipeline order
    (``control_to_stage_params``)."""
    def lerp(lo, hi, t):
        return lo + (hi - lo) * t
    c = [ctrl[..., i] for i in range(8)]
    return ISPParams(
        exposure_gain=lerp(0.5, 2.0, c[0]), wb_bias_r=lerp(0.5, 2.0, c[1]),
        wb_bias_b=lerp(0.5, 2.0, c[2]), gamma=lerp(0.4, 3.0, c[3]),
        nlm_strength=c[4], sharpen=c[5],
        dpc_threshold=lerp(0.05, 0.5, c[6]), awb_enable=c[7])


def params_to_stage_params(p: ISPParams) \
        -> Dict[str, Dict[str, torch.Tensor]]:
    """Lift the legacy NamedTuple onto the default stage ordering."""
    return {
        "exposure": {"gain": p.exposure_gain},
        "dpc": {"threshold": p.dpc_threshold},
        "demosaic": {},
        "awb": {"enable": p.awb_enable, "bias_r": p.wb_bias_r,
                "bias_b": p.wb_bias_b},
        "nlm": {"strength": p.nlm_strength},
        "gamma": {"gamma": p.gamma},
        "sharpen": {"amount": p.sharpen},
    }


def isp_pipeline_batch(raws: torch.Tensor, params: ISPParams,
                       use_cuda: bool = False) -> torch.Tensor:
    """raws [B, H, W]; params leaves scalars or [B] -> RGB [B, H, W, 3]
    through the default stage ordering, ``use_cuda`` selecting the
    ``"cuda"`` backend."""
    cfg = ISPConfig(stages=DEFAULT_ISP_STAGES,
                    backend="cuda" if use_cuda else "torch")
    return run_pipeline_batch(raws, params_to_stage_params(params), cfg)


def isp_pipeline(raw: torch.Tensor, params: Optional[ISPParams] = None,
                 use_cuda: bool = False) -> torch.Tensor:
    """Legacy entry point: raw [H, W] -> RGB [H, W, 3] with scalar
    params (the defaults when None)."""
    p = params if params is not None else default_params()
    return isp_pipeline_batch(raw[None], p, use_cuda)[0]
