"""The Cognitive ISP pipeline (paper §V), built from the stage registry
in :mod:`repro_torch.isp.stages` — the counterpart of
``repro.isp.pipeline``.  The single-image functions take [H, W] mosaics
like the reference's; the ``_batch`` ones take [B, H, W] with per-image
([B]) or shared (scalar) parameters, what the reference gets by
vmapping.  The legacy ``ISPParams`` shims come later."""
from __future__ import annotations

from typing import Optional

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
