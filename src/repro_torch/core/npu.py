"""The NPU (paper §IV): spiking backbone + YOLO detection head + the
cognitive control head that drives the ISP (§VI) — the counterpart of
``repro.core.npu``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ISPConfig, SNNConfig
from repro_torch.core.backbones import BACKBONES, backbone_out_channels
from repro_torch.core.layers import apply_spiking_dense, init_spiking_dense
from repro_torch.core.sparsity import (SparsityTape, activity_sparsity,
                                       tile_skip_fraction)
from repro_torch.core.yolo import apply_yolo_head, init_yolo_head


class NPUOutput(NamedTuple):
    raw_pred: torch.Tensor     # [B, h, w, A, 5+nc] detection head output
    control: torch.Tensor      # [B, control_dim] in [0, 1]
    sparsity: torch.Tensor     # scalar: network activity sparsity
    tile_skip: torch.Tensor    # scalar: tile-skip fraction of the features
    layer_rates: Optional[Dict[str, torch.Tensor]] = None


def configure_for_isp(cfg: SNNConfig, isp_cfg: ISPConfig,
                      spare: int = 0) -> SNNConfig:
    """Size the control head from the ISP pipeline's declared stage
    parameters (plus ``spare`` slots)."""
    return dataclasses.replace(cfg,
                               control_dim=isp_cfg.control_dim + spare)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA without a card
    instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; pass "
            "device='cpu' to run the plain path on the CPU")
    return device


def init_npu(gen: torch.Generator, cfg: SNNConfig,
             device="cuda") -> Dict[str, Any]:
    """Random He-normal parameters (the reference's scales) drawn from
    ``gen`` on the CPU, then moved to ``device``."""
    device = resolve_device(device)
    if not cfg.detect:
        raise NotImplementedError("the classification head is not ported")
    init_bb, _ = BACKBONES[cfg.backbone]
    cout = backbone_out_channels(cfg)
    p: Dict[str, Any] = {
        "backbone": init_bb(gen, cfg),
        "head": init_yolo_head(gen, cout, cfg),
        "ctrl_hidden": init_spiking_dense(gen, cout, 64),
        "ctrl_out": init_spiking_dense(gen, 64, cfg.control_dim),
    }
    return params_to(p, device)


def params_to(p, device):
    """A copy of a nested parameter dict with every tensor on ``device``."""
    if isinstance(p, dict):
        return {k: params_to(v, device) for k, v in p.items()}
    return p.to(device=device, dtype=torch.float32).contiguous()


def npu_forward(params, voxels: torch.Tensor, cfg: SNNConfig, *,
                collect_sparsity: bool = False) -> NPUOutput:
    """voxels: [T, B, H, W, 2] (from repro_torch.core.encoding)."""
    if not cfg.detect:
        raise NotImplementedError("the classification head is not ported")
    tape = SparsityTape() if collect_sparsity else None
    _, apply_bb = BACKBONES[cfg.backbone]
    feats = apply_bb(params["backbone"], voxels, cfg, tape=tape)
    raw = apply_yolo_head(params["head"], feats, cfg, tape=tape)

    # cognitive control head: scene lighting/motion profile -> ISP params
    pooled = feats.mean(dim=(2, 3))                    # [T, B, C]
    h = apply_spiking_dense(params["ctrl_hidden"], pooled, cfg,
                            tape=tape, tag="ctrl_hidden")
    # h is a 0/1 spike tensor, so the kernel backend routes this matmul
    # through the tile-skip spike kernel
    ctrl = apply_spiking_dense(params["ctrl_out"], h, cfg, fire=False,
                               spike_input=True)
    ctrl = torch.sigmoid(ctrl.mean(dim=0))             # [B, control_dim]

    layer_rates = None
    if tape is not None:
        layer_rates = dict(tape.rates(),
                           network_sparsity=tape.network_sparsity())
    return NPUOutput(raw_pred=raw, control=ctrl,
                     sparsity=activity_sparsity([feats]),
                     tile_skip=tile_skip_fraction(feats),
                     layer_rates=layer_rates)
