"""The closed cognitive loop (paper §VI), the counterpart of
``repro.core.cognitive``: the NPU watches the DVS window and its control
vector reconfigures the ISP for the RGB frame.

``cognitive_forward`` maps the control vector onto the stage ordering an
``ISPConfig`` names (ranges from the registered ``ParamSpec``s);
``cognitive_step`` is the seed-API shim over the legacy fixed 8-field
mapping.  Both take the batch whole, where the reference vmaps the
per-image pipeline.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.configs.base import ISPConfig, SNNConfig
from repro_torch.core.npu import NPUOutput, npu_forward
from repro_torch.isp.pipeline import (control_to_params,
                                      control_vector_pipeline_batch,
                                      isp_pipeline_batch)
from repro_torch.isp.stages import control_to_stage_params


class CognitiveOutput(NamedTuple):
    npu: NPUOutput
    isp_params: Any          # ISPParams (legacy) or {stage: {param: [B]}}
    rgb: torch.Tensor        # [B, H, W, 3] corrected RGB


def cognitive_forward(npu_params, voxels: torch.Tensor, bayer: torch.Tensor,
                      cfg: SNNConfig,
                      isp_cfg: Optional[ISPConfig] = None) -> CognitiveOutput:
    """voxels [T, B, Hd, Wd, 2] DVS window, bayer [B, H, W] mosaics.
    The first ``isp_cfg.control_dim`` slots of the control vector drive
    the pipeline's declared parameters in stage order."""
    icfg = isp_cfg if isp_cfg is not None else ISPConfig()
    need = icfg.control_dim
    if cfg.control_dim < need:
        raise ValueError(
            f"NPU control_dim={cfg.control_dim} < {need} required by ISP "
            f"pipeline {icfg.name!r} ({icfg.stages}); rebuild the NPU via "
            f"configure_for_isp")
    npu_out = npu_forward(npu_params, voxels, cfg)
    ctrl = npu_out.control[:, :need]
    return CognitiveOutput(
        npu=npu_out, isp_params=control_to_stage_params(ctrl, icfg.stages),
        rgb=control_vector_pipeline_batch(bayer, ctrl, icfg))


def cognitive_step(npu_params, voxels: torch.Tensor, bayer: torch.Tensor,
                   cfg: SNNConfig, use_cuda: bool = False) -> CognitiveOutput:
    """Seed-API shim: the legacy fixed control mapping and the default
    pipeline, ``use_cuda`` selecting the ``"cuda"`` ISP backend."""
    npu_out = npu_forward(npu_params, voxels, cfg)
    isp_p = control_to_params(npu_out.control)
    return CognitiveOutput(npu=npu_out, isp_params=isp_p,
                           rgb=isp_pipeline_batch(bayer, isp_p, use_cuda))


def exposure_reward(rgb: torch.Tensor) -> torch.Tensor:
    """Differentiable image-quality proxy for training the control head:
    well-exposed (mean luma near 0.5), decent contrast, low clipping.
    rgb [..., H, W, 3] -> [...]."""
    lum = rgb.mean(dim=-1)
    mean_term = -(lum.mean(dim=(-2, -1)) - 0.5) ** 2
    contrast = lum.std(dim=(-2, -1), correction=0)
    clip_frac = ((lum < 0.02) | (lum > 0.98)).to(rgb.dtype).mean(
        dim=(-2, -1))
    return mean_term + 0.5 * contrast - 0.5 * clip_frac
