"""The paper's four spiking backbones (§IV-C), the counterpart of
``repro.core.backbones``: spiking VGG, DenseNet, MobileNet and YOLO.

All take a voxel grid [T, B, H, W, 2] and return features
[T, B, H/2^stages, W/2^stages, C_out]; an optional ``tape``
(``repro_torch.core.sparsity.SparsityTape``) records per-layer spike
rates under the reference's tags.

Each backbone's linear layer run is declared as a tuple of
``LayerSpec`` (``repro_torch.kernels.backbone_fuse``, re-exported here)
and executed through ``_run_layers``: on the ``"cuda"`` backend (f32,
no tape) the segment planner cuts the run into segments and each
fusible segment of more than one layer, or of one layer with a pool,
goes through ``repro_torch.kernels.ops.backbone_segment_op``, where the
launch table picks the ``backbone_segment`` kernel or the per-layer
route.  Every other case (the ``"torch"`` backend, a sparsity tape
recording, non-f32 activations) runs the per-layer route
(``_run_per_layer``: each layer through its own backend dispatch).
DenseNet's concats are plain ``torch.cat``, as the reference leaves
them to XLA; only its linear pieces, the 1x1 transition and its pool,
go through the planner.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import SNNConfig
from repro_torch.core.layers import (_check_backend, apply_spiking_conv,
                                     init_spiking_conv, max_pool)
# LayerSpec lives with the planner; imported from here it still works
from repro_torch.kernels.backbone_fuse import LayerSpec, plan_segments

DENSE_LAYERS_PER_BLOCK = 3


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


def _run_layers(p, x, cfg: SNNConfig, specs, tape=None):
    """A linear run of layers, fused across layer boundaries where the
    planner allows.  The per-layer route whenever fusion cannot apply
    (the "torch" backend, a tape recording, non-f32 activations)."""
    if (not _check_backend(cfg) or tape is not None
            or x.dtype != torch.float32):
        return _run_per_layer(p, x, cfg, specs, tape)
    from repro_torch.kernels.ops import backbone_segment_op
    T, B, H, W, _ = x.shape
    for seg in plan_segments(specs, H=H, W=W, T=T, dtype=x.dtype):
        if seg.fused_route:
            params = tuple((p[s.name]["w"], p[s.name]["scale"],
                            p[s.name]["bias"]) for s in seg.layers)
            # anonymous specs: the table key carries only shape facts,
            # so same-shaped segments share one entry
            x = backbone_segment_op(
                x, params, specs=tuple(s.anon() for s in seg.layers),
                tau=cfg.tau_mem, v_th=cfg.v_threshold, v_reset=cfg.v_reset,
                beta=cfg.surrogate_beta)
        else:
            x = _run_per_layer(p, x, cfg, seg.layers, tape)
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
    return _run_layers(p, x, cfg, vgg_specs(cfg), tape=tape)


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
        # the block's linear tail, the piece the planner can take (a
        # concat input has several consumers and stays per-layer)
        x = _run_layers(p, x, cfg, densenet_transition(s, cin), tape=tape)
        cin = cin // 2
    return x


def densenet_transition(stage: int, cin: int) -> Tuple[LayerSpec, ...]:
    """A dense block's tail: a 1x1 transition halving its ``cin``
    channels, then a 2x2 max-pool."""
    return (LayerSpec(name=f"t{stage}", kernel=1, cin=cin, cout=cin // 2,
                      pool=2),)


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
    return _run_layers(p, x, cfg, mobilenet_specs(cfg), tape=tape)


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
    return _run_layers(p, x, cfg, yolo_specs(cfg), tape=tape)


def layer_runs(cfg: SNNConfig) -> List[Tuple[Tuple[LayerSpec, ...], int,
                                             int]]:
    """The linear runs one forward sends through ``_run_layers``, each
    with its input extent (H, W): the whole backbone for VGG, MobileNet
    and YOLO, each transition for DenseNet."""
    if cfg.backbone != "densenet":
        specs = {"vgg": vgg_specs, "mobilenet": mobilenet_specs,
                 "yolo": yolo_specs}[cfg.backbone](cfg)
        return [(specs, cfg.height, cfg.width)]
    runs, cin = [], cfg.base_channels
    for s in range(cfg.num_stages):
        cin += DENSE_LAYERS_PER_BLOCK * cfg.base_channels
        runs.append((densenet_transition(s, cin), cfg.height >> s,
                     cfg.width >> s))
        cin //= 2
    return runs


def fused_route_segments(cfg: SNNConfig, batch: int):
    """Every segment one forward at ``batch`` sends to
    ``backbone_segment_op`` (planned at the default budget), in order:
    (segment, its input extent (h, w), its ``backbone_seg`` table key)."""
    from repro_torch.kernels import tune
    from repro_torch.kernels.backbone_fuse import plan_inputs
    from repro_torch.kernels.ops import segment_dims
    out, T = [], cfg.time_steps
    for specs, H, W in layer_runs(cfg):
        plan = plan_segments(specs, H=H, W=W, T=T)
        for seg, (h, w) in zip(plan, plan_inputs(plan, H=H, W=W)):
            if seg.fused_route:
                dims = segment_dims(tuple(s.anon() for s in seg.layers), T=T,
                                    B=batch, H=h, W=w)
                out.append((seg, (h, w), tune.shape_key("backbone_seg",
                                                        **dims)))
    return out


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
