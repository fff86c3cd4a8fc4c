"""The spiking-YOLO backbone (paper §IV-C), the counterpart of the yolo
part of ``repro.core.backbones``: stride-2 3x3 conv->norm->LIF, then
3x3 conv->norm->LIF, per stage, no pooling.  Layers run one by one (the
per-layer route); vgg, mobilenet and densenet come with the depthwise
and max-pool ports.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import SNNConfig
from repro_torch.core.layers import apply_spiking_conv, init_spiking_conv


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One spiking conv layer of a linear backbone run (a copy of
    ``repro.kernels.backbone_fuse.LayerSpec``)."""
    name: str
    kernel: int = 3
    stride: int = 1
    depthwise: bool = False
    cin: int = 0
    cout: int = 0
    pool: int = 0


def _stage_channels(cfg: SNNConfig) -> List[int]:
    return [cfg.base_channels * (2 ** i) for i in range(cfg.num_stages)]


def yolo_specs(cfg: SNNConfig) -> Tuple[LayerSpec, ...]:
    chans = _stage_channels(cfg)
    specs, cin = [], cfg.in_channels
    for i, c in enumerate(chans):
        specs.append(LayerSpec(name=f"d{i}", stride=2, cin=cin, cout=c))
        specs.append(LayerSpec(name=f"f{i}", cin=c, cout=c))
        cin = c
    return tuple(specs)


def init_yolo_backbone(gen: torch.Generator, cfg: SNNConfig):
    """Tiny-YOLO-style: stride-2 downsample convs + 3x3 feature convs."""
    params: Dict[str, Any] = {}
    for s in yolo_specs(cfg):
        params[s.name] = init_spiking_conv(gen, s.cin, s.cout,
                                           kernel=s.kernel)
    return params


def apply_yolo_backbone(p, x, cfg: SNNConfig, tape=None):
    for s in yolo_specs(cfg):
        x = apply_spiking_conv(p[s.name], x, cfg, stride=s.stride,
                               tape=tape, tag=s.name)
    return x


BACKBONES = {
    "yolo": (init_yolo_backbone, apply_yolo_backbone),
}


def backbone_out_channels(cfg: SNNConfig) -> int:
    return _stage_channels(cfg)[-1]
