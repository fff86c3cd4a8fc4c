"""End-to-end spiking-YOLO detector training (paper §IV-B/C), the
counterpart of ``repro.train.detector`` on one device.

``npu_forward`` (backbone + YOLO head) differentiated through the spike
path under either ``SNNConfig.backend`` (``"torch"`` or the kernel-backed
``"cuda"``), AdamW under a warmup-cosine schedule, checkpointed and
resumed through :class:`CheckpointManager` inside :class:`Trainer`.  The
step is ``core.train``'s detection step.

Data is the synthetic GEN1-like corpus (``data.synthetic``): the batch
of step ``s`` comes from ``stream_generator(tc.seed, s)``, so a killed
and resumed run replays the uninterrupted data order bit for bit; the
eval scenes come from the eval stream under ``tc.eval_seed``, held out
by construction.  Eval decodes boxes (:func:`decode_boxes`) and reports
dataset AP@IoU0.50 (:func:`average_precision`), the paper's §IV-C
metric.

Data-parallel training over several cards (the reference's
``make_train_mesh``, ``shard_scene``, ``replicate_state``) is not
ported: with one card ``tc.shard`` runs the local path, as the
reference's one-device mesh does; with more cards visible it raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, NamedTuple, \
    Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import SNNConfig, TrainConfig
from repro_torch.configs.registry import get_snn_config, reduced_snn
from repro_torch.core.encoding import voxel_batch
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.core.train import (detection_loss, init_snn_state,
                                    make_snn_train_step)
from repro_torch.core.yolo import average_precision, decode_boxes
from repro_torch.data.synthetic import (EVAL_STREAM, TRAIN_STREAM,
                                        SceneBatch, make_scene_batch,
                                        stream_generator)
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.trainer import Trainer


class DetectorTrainState(NamedTuple):
    """Detector training state (params + AdamW moments + step)."""
    params: Any
    opt: Dict[str, Any]
    step: torch.Tensor


def init_detector_state(gen: torch.Generator, cfg: SNNConfig,
                        opt_cfg: AdamWConfig,
                        device="cuda") -> DetectorTrainState:
    params = init_npu(gen, cfg, device=device)
    return DetectorTrainState(*init_snn_state(params, opt_cfg))


# voxelise -> backbone + YOLO head -> YOLO loss (+ sparsity telemetry)
detector_loss = detection_loss


def make_detector_train_step(cfg: SNNConfig, opt_cfg: AdamWConfig,
                             lr_schedule: Optional[Callable] = None):
    """(state, scene) -> (state, metrics): ``value_and_grad`` of
    :func:`detector_loss` then ``adamw_update`` under the schedule, the
    steps of ``make_snn_train_step(mode="detect")``."""
    inner = make_snn_train_step(cfg, opt_cfg, "detect", lr_schedule)

    def step(state: DetectorTrainState, scene: SceneBatch):
        new, metrics = inner(state, scene)
        return DetectorTrainState(*new), metrics

    return step


def _check_one_device(tc: TrainConfig, device: torch.device) -> None:
    if tc.shard and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "train_detector trains on one card: data-parallel training "
            "over a mesh waits for the port's distributed package "
            "(ROADMAP.md queue 1 item 4); pass shard=False")


# ---------------------------------------------------------------------------
# Held-out evaluation: decode boxes, dataset AP@0.5
# ---------------------------------------------------------------------------

def _gt_xyxy(boxes: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """[M,5] (cls,cx,cy,w,h) + valid mask -> [n,4] xyxy."""
    gt = boxes[valid]
    if not len(gt):
        return np.zeros((0, 4))
    c = gt[:, 1:]
    return np.stack([c[:, 0] - c[:, 2] / 2, c[:, 1] - c[:, 3] / 2,
                     c[:, 0] + c[:, 2] / 2, c[:, 1] + c[:, 3] / 2], -1)


@torch.no_grad()
def _evaluate_scenes(params, cfg: SNNConfig, scenes: Iterable[SceneBatch],
                     forward=None) -> Tuple[float, float]:
    """AP@IoU0.50 and mean network sparsity of ``params`` on ``scenes``;
    ``forward(params, voxels)`` stands in for ``npu_forward`` where a
    test feeds another network's outputs."""
    if forward is None:
        def forward(p, v):
            return npu_forward(p, v, cfg)
    pb: List[np.ndarray] = []
    ps: List[np.ndarray] = []
    gb: List[np.ndarray] = []
    sparsity: List[float] = []
    for scene in scenes:
        vox = voxel_batch(scene.events, time_steps=cfg.time_steps,
                          height=cfg.height, width=cfg.width)
        out = forward(params, vox)
        sparsity.append(float(out.sparsity))
        boxes, scores, _ = decode_boxes(out.raw_pred, cfg)
        boxes, scores = boxes.cpu().numpy(), scores.cpu().numpy()
        sc_boxes = scene.boxes.cpu().numpy()
        sc_valid = scene.valid.cpu().numpy()
        for b in range(boxes.shape[0]):
            pb.append(boxes[b])
            ps.append(scores[b])
            gb.append(_gt_xyxy(sc_boxes[b], sc_valid[b]))
    return average_precision(pb, ps, gb), float(np.mean(sparsity))


def evaluate_detector(params, cfg: SNNConfig, *, eval_seed: int = 1000,
                      batches: int = 4, batch: int = 8,
                      max_boxes: int = 4,
                      n_events: int = 2048) -> Tuple[float, float]:
    """AP@IoU0.50 + mean network sparsity on the held-out scene set
    (``batches`` batches of the eval stream under ``eval_seed``), on the
    parameters' device."""
    device = tree_leaves(params)[0][1].device
    scenes = (make_scene_batch(
        stream_generator(eval_seed, i, EVAL_STREAM), batch=batch,
        height=cfg.height, width=cfg.width, time_steps=cfg.time_steps,
        max_boxes=max_boxes, n_events=n_events, device=device)
        for i in range(batches))
    return _evaluate_scenes(params, cfg, scenes)


# ---------------------------------------------------------------------------
# The end-to-end run
# ---------------------------------------------------------------------------

class TrainReport(NamedTuple):
    state: DetectorTrainState
    history: List[Dict[str, float]]   # per-step metric records
    ap_before: float                  # held-out AP@0.5, untrained params
    ap_after: float                   # held-out AP@0.5 after training
    sparsity: float                   # mean network sparsity at eval
    step_time_s: float                # steady mean (the first step, which
    #                                   loads the kernels, is excluded)
    snn_cfg: SNNConfig
    drain_s: float = 0.0              # host seconds draining metrics


def resolve_snn_config(tc: TrainConfig) -> SNNConfig:
    if tc.reduced:
        return reduced_snn(tc.arch, backend=tc.backend)
    return dataclasses.replace(get_snn_config(tc.arch), backend=tc.backend)


def make_data_fn(tc: TrainConfig, cfg: SNNConfig, device="cuda"):
    """Training batches on ``device``, deterministic in the step."""
    device = resolve_device(device)

    def data(step: int) -> SceneBatch:
        return make_scene_batch(
            stream_generator(tc.seed, step, TRAIN_STREAM), batch=tc.batch,
            height=cfg.height, width=cfg.width, time_steps=cfg.time_steps,
            max_boxes=tc.max_boxes, n_events=tc.n_events, device=device)

    return data


def _recipe(tc: TrainConfig):
    opt_cfg = AdamWConfig(lr=tc.lr, weight_decay=tc.weight_decay,
                          grad_clip=tc.grad_clip)
    # the schedule spans the run's whole horizon, a resumed run's too
    schedule = warmup_cosine(tc.lr, warmup=tc.warmup, total=tc.steps,
                             min_ratio=tc.min_lr_ratio)
    return opt_cfg, schedule


def train_detector(tc: TrainConfig, *, ckpt_dir: Optional[str] = None,
                   log: Callable[[str], None] = print,
                   device="cuda") -> TrainReport:
    """Train per ``tc`` on ``device``; resume automatically from the
    newest checkpoint in ``ckpt_dir`` (if any); return the report."""
    device = resolve_device(device)
    _check_one_device(tc, device)
    cfg = resolve_snn_config(tc)
    opt_cfg, schedule = _recipe(tc)
    state = init_detector_state(torch.Generator().manual_seed(tc.seed), cfg,
                                opt_cfg, device)
    step_fn = make_detector_train_step(cfg, opt_cfg, schedule)
    eval_kw = dict(eval_seed=tc.eval_seed, batches=tc.eval_batches,
                   batch=tc.eval_batch, max_boxes=tc.max_boxes,
                   n_events=tc.n_events)
    ap0, sp0 = evaluate_detector(state.params, cfg, **eval_kw)
    log(f"[detector] untrained: AP@0.5={ap0:.4f} sparsity={sp0:.3f}")

    ckpt = None
    if ckpt_dir is not None:
        ckpt = CheckpointManager(ckpt_dir, keep=tc.keep_ckpts)
    trainer = Trainer(step_fn, state, make_data_fn(tc, cfg, device),
                      ckpt=ckpt, ckpt_every=tc.ckpt_every,
                      log_every=tc.log_every, log_fn=log)
    t0 = time.perf_counter()
    state = trainer.run(tc.steps)
    wall = time.perf_counter() - t0

    ap1, sp1 = evaluate_detector(state.params, cfg, **eval_kw)
    steady = [h["dt_s"] for h in trainer.history[1:]] or [wall]
    report = TrainReport(state=state, history=trainer.history,
                         ap_before=ap0, ap_after=ap1, sparsity=sp1,
                         step_time_s=float(np.mean(steady)), snn_cfg=cfg,
                         drain_s=trainer.drain_s)
    log(f"[detector] {tc.steps} steps ({wall:.1f}s): AP@0.5 {ap0:.4f} -> "
        f"{ap1:.4f}, sparsity {sp1:.3f}, "
        f"{report.step_time_s * 1e3:.0f} ms/step")
    return report


def resume_from(tc: TrainConfig, ckpt_dir: str, *,
                at_step: Optional[int] = None,
                log: Callable[[str], None] = print,
                device="cuda") -> DetectorTrainState:
    """Kill-and-resume: restore the checkpoint at ``at_step`` (the newest
    if None) and replay to ``tc.steps``.  Batches are keyed on the step
    and the step is deterministic, so the continued trajectory is the
    uninterrupted run's, bit for bit."""
    device = resolve_device(device)
    _check_one_device(tc, device)
    cfg = resolve_snn_config(tc)
    opt_cfg, schedule = _recipe(tc)
    template = init_detector_state(torch.Generator().manual_seed(tc.seed),
                                   cfg, opt_cfg, device)
    ckpt = CheckpointManager(ckpt_dir, keep=tc.keep_ckpts)
    at = at_step if at_step is not None else ckpt.latest_step()
    if at is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    state = ckpt.restore(at, like=template)
    log(f"[detector] resuming from step {at}")
    trainer = Trainer(make_detector_train_step(cfg, opt_cfg, schedule),
                      state, make_data_fn(tc, cfg, device), log_fn=log)
    return trainer.run(tc.steps, start_step=at)
