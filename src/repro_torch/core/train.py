"""Training steps for the SNN stack (surrogate-gradient BPTT + AdamW,
paper §IV-B), the counterpart of ``repro.core.train``: detection
training and cognitive-loop control training.

Gradients come from ``torch.autograd.grad`` over the parameter leaves:
through the surrogate ``spike`` on the ``"torch"`` backend, through the
kernel ops' own backwards on ``"cuda"`` (``repro_torch.kernels.ops``).
The step is a function of (state, scene), as the reference's: it builds
new parameter and optimizer trees and leaves the old ones as they were.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import SNNConfig
from repro_torch.core.cognitive import cognitive_step, exposure_reward
from repro_torch.core.encoding import voxel_batch
from repro_torch.core.npu import npu_forward
from repro_torch.core.yolo import yolo_loss
from repro_torch.data.synthetic import SceneBatch
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     tree_leaves, tree_unflatten)

MODES = ("detect", "cognitive")


class SNNTrainState(NamedTuple):
    params: Any
    opt: Dict[str, Any]
    step: torch.Tensor


def init_snn_state(params, opt_cfg: AdamWConfig) -> SNNTrainState:
    device = tree_leaves(params)[0][1].device
    return SNNTrainState(params=params, opt=adamw_init(params, opt_cfg),
                         step=torch.zeros((), dtype=torch.int32,
                                          device=device))


def _voxels(scene: SceneBatch, cfg: SNNConfig) -> torch.Tensor:
    # the plain encoding, as the reference's loss voxelizes with jnp
    return voxel_batch(scene.events, time_steps=cfg.time_steps,
                       height=cfg.height, width=cfg.width)


def detection_loss(params, scene: SceneBatch, cfg: SNNConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = npu_forward(params, _voxels(scene, cfg), cfg)
    loss, parts = yolo_loss(out.raw_pred, scene.boxes, scene.valid, cfg)
    parts["sparsity"] = out.sparsity
    parts["tile_skip"] = out.tile_skip
    return loss, parts


def cognitive_loss(params, scene: SceneBatch, cfg: SNNConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Detection + control: the ISP output should match the clean scene,
    differentiated through the whole plain ISP (the reference's
    ``use_pallas=False``: the ISP kernels have no backward)."""
    out = cognitive_step(params, _voxels(scene, cfg), scene.bayer, cfg,
                         use_cuda=False)
    det_loss, parts = yolo_loss(out.npu.raw_pred, scene.boxes, scene.valid,
                                cfg)
    recon = torch.mean(torch.square(out.rgb - scene.clean_rgb))
    reward = torch.mean(exposure_reward(out.rgb))
    total = det_loss + 10.0 * recon - 0.1 * reward
    parts.update({"recon": recon, "reward": reward, "det": det_loss})
    return total, parts


LOSSES = {"detect": detection_loss, "cognitive": cognitive_loss}


def with_leaves(params):
    """(a copy of ``params`` whose leaves are fresh tensors that require
    grad, those leaves in ``tree_leaves`` order)."""
    leaves = [p.detach().requires_grad_() for _, p in tree_leaves(params)]
    return tree_unflatten(params, leaves), leaves


def grads_of(loss: torch.Tensor, params, leaves):
    """dloss/dleaf for each leaf of ``with_leaves``, as a tree shaped like
    ``params`` (a leaf the loss does not reach gets zeros)."""
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return tree_unflatten(params, [torch.zeros_like(t) if g is None else g
                                   for t, g in zip(leaves, gs)])


def value_and_grad(loss_fn: Callable, params, scene: SceneBatch,
                   cfg: SNNConfig):
    """(loss, parts, grads) of ``loss_fn(params, scene, cfg)``."""
    p, leaves = with_leaves(params)
    with torch.enable_grad():
        loss, parts = loss_fn(p, scene, cfg)
    grads = grads_of(loss, p, leaves)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_snn_train_step(cfg: SNNConfig, opt_cfg: AdamWConfig,
                        mode: str = "detect",
                        lr_schedule: Optional[Callable] = None):
    """step(state, scene) -> (state, parts): one surrogate-BPTT AdamW
    step on ``mode``'s loss; parts hold the loss's terms, ``loss``,
    ``grad_norm`` and ``lr``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    loss_fn = LOSSES[mode]

    def step(state: SNNTrainState, scene: SceneBatch):
        loss, parts, grads = value_and_grad(loss_fn, state.params, scene,
                                            cfg)
        params, opt, om = adamw_update(state.params, grads, state.opt,
                                       opt_cfg, lr_schedule)
        parts.update(om)
        parts["loss"] = loss
        return SNNTrainState(params, opt, state.step + 1), parts

    return step
