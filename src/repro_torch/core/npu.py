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
from repro_torch.device import resolve_device


class NPUOutput(NamedTuple):
    raw_pred: torch.Tensor     # [B, h, w, A, 5+nc] detections ([B, nc]
    #                            logits with the classification head)
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


def init_npu(gen: torch.Generator, cfg: SNNConfig,
             device="cuda") -> Dict[str, Any]:
    """Random He-normal parameters (the reference's scales) drawn from
    ``gen`` on the CPU, then moved to ``device``."""
    device = resolve_device(device)
    init_bb, _ = BACKBONES[cfg.backbone]
    cout = backbone_out_channels(cfg)
    p: Dict[str, Any] = {"backbone": init_bb(gen, cfg)}
    if cfg.detect:
        p["head"] = init_yolo_head(gen, cout, cfg)
    else:
        p["cls"] = init_spiking_dense(gen, cout, cfg.num_classes)
    p["ctrl_hidden"] = init_spiking_dense(gen, cout, 64)
    p["ctrl_out"] = init_spiking_dense(gen, 64, cfg.control_dim)
    return params_to(p, device)


def params_to(p, device):
    """A copy of a nested parameter dict with every tensor on ``device``."""
    if isinstance(p, dict):
        return {k: params_to(v, device) for k, v in p.items()}
    return p.to(device=device, dtype=torch.float32).contiguous()


def npu_forward(params, voxels: torch.Tensor, cfg: SNNConfig, *,
                collect_sparsity: bool = False) -> NPUOutput:
    """voxels: [T, B, H, W, 2] (from repro_torch.core.encoding).
    ``raw_pred`` is the detection head's [B, h, w, A, 5+nc], or with
    ``cfg.detect`` off the classification head's logits [B, nc]: the
    features' spatial mean through a non-firing dense layer, averaged
    over T (a plain product, no kernel)."""
    tape = SparsityTape() if collect_sparsity else None
    _, apply_bb = BACKBONES[cfg.backbone]
    feats = apply_bb(params["backbone"], voxels, cfg, tape=tape)
    if cfg.detect:
        raw = apply_yolo_head(params["head"], feats, cfg, tape=tape)
    else:
        pooled_t = feats.mean(dim=(2, 3))              # [T, B, C]
        logits = apply_spiking_dense(params["cls"], pooled_t, cfg,
                                     fire=False)
        raw = logits.mean(dim=0)                       # [B, nc]

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
