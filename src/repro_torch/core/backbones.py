"""The paper's four spiking backbones (§IV-C), the counterpart of
``repro.core.backbones``: spiking VGG, DenseNet, MobileNet and YOLO.

All take a voxel grid [T, B, H, W, 2] and return features
[T, B, H/2^stages, W/2^stages, C_out]; an optional ``tape``
(``repro_torch.core.sparsity.SparsityTape``) records per-layer spike
rates under the reference's tags.  Layers run one at a time, each
through its own backend dispatch (the reference's per-layer route,
``_run_per_layer``); DenseNet's concats are plain ``torch.cat``, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import SNNConfig
from repro_torch.core.layers import (apply_spiking_conv, init_spiking_conv,
                                     max_pool)

DENSE_LAYERS_PER_BLOCK = 3


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One spiking conv layer of a linear backbone run (a copy of
    ``repro.kernels.backbone_fuse.LayerSpec``): a max-pool of ``pool``
    follows it when ``pool`` is non-zero."""
    name: str
    kernel: int = 3
    stride: int = 1
    depthwise: bool = False
    cin: int = 0
    cout: int = 0
    pool: int = 0


def _stage_channels(cfg: SNNConfig) -> List[int]:
    return [cfg.base_channels * (2 ** i) for i in range(cfg.num_stages)]


def _init_specs(gen: torch.Generator, specs) -> Dict[str, Any]:
    return {s.name: init_spiking_conv(gen, s.cin, s.cout, kernel=s.kernel,
                                      depthwise=s.depthwise)
            for s in specs}


def _run_per_layer(p, x, cfg: SNNConfig, specs, tape=None):
    """The reference per-layer sequence: one ``apply_spiking_conv`` (its
    own backend dispatch) and the optional pool per spec."""
    for s in specs:
        x = apply_spiking_conv(p[s.name], x, cfg, stride=s.stride,
                               depthwise=s.depthwise, tape=tape,
                               tag=s.name)
        if s.pool:
            x = max_pool(x, s.pool, cfg=cfg)
    return x


# --------------------------------------------------------------------- VGG

def vgg_specs(cfg: SNNConfig) -> Tuple[LayerSpec, ...]:
    """Per stage a 3x3 conv, a 3x3 conv, then a 2x2 max-pool."""
    specs, cin = [], cfg.in_channels
    for i, c in enumerate(_stage_channels(cfg)):
        specs.append(LayerSpec(name=f"s{i}_a", cin=cin, cout=c))
        specs.append(LayerSpec(name=f"s{i}_b", cin=c, cout=c, pool=2))
        cin = c
    return tuple(specs)


def init_vgg(gen: torch.Generator, cfg: SNNConfig):
    return _init_specs(gen, vgg_specs(cfg))


def apply_vgg(p, x, cfg: SNNConfig, tape=None):
    return _run_per_layer(p, x, cfg, vgg_specs(cfg), tape=tape)


# ---------------------------------------------------------------- DenseNet

def init_densenet(gen: torch.Generator, cfg: SNNConfig,
                  layers_per_block: int = DENSE_LAYERS_PER_BLOCK):
    """A 3x3 stem of ``growth`` channels, then per stage a dense block
    (each 3x3 conv sees the concat of every earlier output of the block
    and adds ``growth`` channels) and a 1x1 transition halving the
    channels."""
    growth = cfg.base_channels
    params: Dict[str, Any] = {
        "stem": init_spiking_conv(gen, cfg.in_channels, growth)}
    cin = growth
    for s in range(cfg.num_stages):
        for l in range(layers_per_block):
            params[f"b{s}_l{l}"] = init_spiking_conv(gen, cin, growth)
            cin += growth                       # dense concat
        params[f"t{s}"] = init_spiking_conv(gen, cin, cin // 2, kernel=1)
        cin = cin // 2
    return params


def apply_densenet(p, x, cfg: SNNConfig,
                   layers_per_block: int = DENSE_LAYERS_PER_BLOCK,
                   tape=None):
    x = apply_spiking_conv(p["stem"], x, cfg, tape=tape, tag="stem")
    cin = cfg.base_channels
    for s in range(cfg.num_stages):
        feats = [x]
        for l in range(layers_per_block):
            feats.append(apply_spiking_conv(
                p[f"b{s}_l{l}"], torch.cat(feats, dim=-1), cfg, tape=tape,
                tag=f"b{s}_l{l}"))
        x = torch.cat(feats, dim=-1)
        cin += layers_per_block * cfg.base_channels
        # the block's linear tail: 1x1 transition, then a 2x2 max-pool
        x = _run_per_layer(p, x, cfg, (LayerSpec(
            name=f"t{s}", kernel=1, cin=cin, cout=cin // 2, pool=2),),
            tape=tape)
        cin = cin // 2
    return x


# --------------------------------------------------------------- MobileNet

def mobilenet_specs(cfg: SNNConfig) -> Tuple[LayerSpec, ...]:
    """A 3x3 stem, then per stage a stride-2 3x3 depthwise conv and a 1x1
    pointwise conv."""
    chans = _stage_channels(cfg)
    specs = [LayerSpec(name="stem", cin=cfg.in_channels, cout=chans[0])]
    cin = chans[0]
    for i, c in enumerate(chans):
        specs.append(LayerSpec(name=f"dw{i}", stride=2, depthwise=True,
                               cin=cin, cout=cin))
        specs.append(LayerSpec(name=f"pw{i}", kernel=1, cin=cin, cout=c))
        cin = c
    return tuple(specs)


def init_mobilenet(gen: torch.Generator, cfg: SNNConfig):
    return _init_specs(gen, mobilenet_specs(cfg))


def apply_mobilenet(p, x, cfg: SNNConfig, tape=None):
    return _run_per_layer(p, x, cfg, mobilenet_specs(cfg), tape=tape)


# -------------------------------------------------------------------- YOLO

def yolo_specs(cfg: SNNConfig) -> Tuple[LayerSpec, ...]:
    """Tiny-YOLO-style: per stage a stride-2 3x3 downsample conv and a 3x3
    feature conv, no pooling."""
    specs, cin = [], cfg.in_channels
    for i, c in enumerate(_stage_channels(cfg)):
        specs.append(LayerSpec(name=f"d{i}", stride=2, cin=cin, cout=c))
        specs.append(LayerSpec(name=f"f{i}", cin=c, cout=c))
        cin = c
    return tuple(specs)


def init_yolo_backbone(gen: torch.Generator, cfg: SNNConfig):
    return _init_specs(gen, yolo_specs(cfg))


def apply_yolo_backbone(p, x, cfg: SNNConfig, tape=None):
    return _run_per_layer(p, x, cfg, yolo_specs(cfg), tape=tape)


BACKBONES = {
    "vgg": (init_vgg, apply_vgg),
    "densenet": (init_densenet, apply_densenet),
    "mobilenet": (init_mobilenet, apply_mobilenet),
    "yolo": (init_yolo_backbone, apply_yolo_backbone),
}


def backbone_out_channels(cfg: SNNConfig) -> int:
    if cfg.backbone == "densenet":
        cin = cfg.base_channels
        for _ in range(cfg.num_stages):
            cin = (cin + DENSE_LAYERS_PER_BLOCK * cfg.base_channels) // 2
        return cin
    return _stage_channels(cfg)[-1]


def spatial_reduction(cfg: SNNConfig) -> int:
    """H / h of the features: every backbone halves the frame once per
    stage."""
    return 2 ** cfg.num_stages
