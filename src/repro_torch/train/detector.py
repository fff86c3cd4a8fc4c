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

Data parallelism (the reference's ``make_train_mesh``, ``shard_scene``,
``replicate_state``): one rank per card (``torchrun``; gloo processes
on the CPU), a ``("data",)`` mesh over the ranks of the process group
(``distributed.sharding.rank_mesh``).  Every rank builds the *global*
batch of step ``s`` and takes its rows, so the batch is the one-process
batch by construction; the state is broadcast from rank 0 and stays
bit-equal on every rank, since every rank applies the same summed
gradients.  The step computes the reference's sharded loss, the global
batch's: each rank divides its sums by the all-reduced positives and
the global anchor count (``core.yolo.yolo_loss(psum=)``), and the
gradients and metrics are summed over the ranks in one ``all_reduce``
of a flat buffer, so ``grad_clip``'s global norm sees the one-process
gradients.  Only rank 0 logs, evaluates and writes checkpoints.  A world
that does not divide ``tc.batch`` raises (under ``torchrun`` the world
is fixed at launch; the reference shrinks its mesh to a divisor); with
several cards visible and no process group, ``tc.shard`` raises rather
than train on one card.
"""
from __future__ import annotations

import dataclasses
import functools
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
                                    make_snn_train_step, value_and_grad)
from repro_torch.core.yolo import average_precision, decode_boxes
from repro_torch.data.synthetic import (EVAL_STREAM, TRAIN_STREAM,
                                        SceneBatch, make_scene_batch,
                                        stream_generator)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (Mesh, MeshAxes,
                                              batch_sharding, from_mesh,
                                              maybe_psum, rank_mesh,
                                              replicated_sharding, tree_map)
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     tree_leaves, tree_unflatten)
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


# the metrics that are means over the batch: the ranks' values averaged
# (equal shards); every other metric is a rank's share of the global sum
_BATCH_MEANS = ("sparsity", "tile_skip")


def data_parallel_grads(params, scene: SceneBatch, cfg: SNNConfig,
                        ax: MeshAxes):
    """(loss, parts, grads) of the global batch from this rank's shard
    ``scene``: this shard's share of the global loss
    (``detection_loss(psum=)``), then the loss, the parts and the
    gradients summed over the data-parallel ranks in one ``all_reduce``
    of a flat buffer (the batch means averaged).  Every rank returns the
    same values."""
    group = ax.mesh.group(ax.dp)
    loss, parts, grads = value_and_grad(
        functools.partial(detection_loss,
                          psum=functools.partial(maybe_psum, group=group)),
        params, scene, cfg)
    leaves = [g for _, g in tree_leaves(grads)]
    names = list(parts)
    flat = torch.cat([g.reshape(-1) for g in leaves] + [torch.stack(
        [loss] + [parts[k].to(loss.dtype) for k in names])])
    flat = maybe_psum(flat, group)
    sizes = [g.numel() for g in leaves]
    *gs, scalars = torch.split(flat, sizes + [1 + len(names)])
    grads = tree_unflatten(grads, [g.view_as(x) for g, x in zip(gs, leaves)])
    parts = {k: scalars[1 + i] / ax.dp_size if k in _BATCH_MEANS
             else scalars[1 + i] for i, k in enumerate(names)}
    return scalars[0], parts, grads


def make_detector_train_step(cfg: SNNConfig, opt_cfg: AdamWConfig,
                             lr_schedule: Optional[Callable] = None,
                             ax: MeshAxes = MeshAxes()):
    """(state, scene) -> (state, metrics): ``value_and_grad`` of
    :func:`detector_loss` then ``adamw_update`` under the schedule, the
    steps of ``make_snn_train_step(mode="detect")``.  With a mesh
    (``ax``, over ranks) ``scene`` is this rank's shard
    (:func:`shard_scene`) and the gradients are the global batch's
    (:func:`data_parallel_grads`)."""
    if ax.mesh is None:
        inner = make_snn_train_step(cfg, opt_cfg, "detect", lr_schedule)

        def step(state: DetectorTrainState, scene: SceneBatch):
            new, metrics = inner(state, scene)
            return DetectorTrainState(*new), metrics
        return step

    def dp_step(state: DetectorTrainState, scene: SceneBatch):
        loss, parts, grads = data_parallel_grads(state.params, scene, cfg,
                                                 ax)
        params, opt, om = adamw_update(state.params, grads, state.opt,
                                       opt_cfg, lr_schedule)
        parts.update(om)
        parts["loss"] = loss
        return DetectorTrainState(params, opt, state.step + 1), parts

    return dp_step


# ---------------------------------------------------------------------------
# Data-parallel placement over a ("data",) mesh of ranks
# ---------------------------------------------------------------------------

def make_train_mesh(tc: TrainConfig, device="cuda") -> Optional[Mesh]:
    """The ``("data",)`` mesh over the ranks of the process group when
    ``tc.shard`` and the group holds more than one; ``None`` for one
    process (callers take the local path).  Raises for a world that does
    not divide ``tc.batch``, and, with no process group, for several
    visible cards on ``device="cuda"``: start one rank per card with
    ``torchrun`` instead of training on one."""
    import torch.distributed as dist
    if not tc.shard:
        return None
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if world == 1:
            return None
        if tc.batch % world:
            raise ValueError(f"batch={tc.batch} does not split over the "
                             f"{world} ranks of the process group")
        return rank_mesh((world,), ("data",))
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() > 1:
        raise RuntimeError(
            f"{torch.cuda.device_count()} cards are visible and no process "
            f"group is up: start one rank per card (torchrun "
            f"--nproc-per-node N -m repro_torch.launch.train ...), or pass "
            f"shard=False to train on one card")
    return None


def shard_scene(scene: SceneBatch, ax: MeshAxes) -> SceneBatch:
    """This rank's rows of every SceneBatch leaf (dim 0)."""
    s = batch_sharding(ax)
    if s is None:
        return scene
    return tree_map(s.place, scene)


def replicate_state(state: DetectorTrainState,
                    ax: MeshAxes) -> DetectorTrainState:
    """The mesh's first rank's state on every rank (each leaf
    broadcast), so all start bit-equal."""
    s = replicated_sharding(ax)
    if s is None:
        return state
    return tree_map(s.place, state)


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


def make_data_fn(tc: TrainConfig, cfg: SNNConfig, ax: MeshAxes = MeshAxes(),
                 device="cuda"):
    """Training batches on ``device``, deterministic in the step: the
    global batch, and on a mesh this rank's rows of it."""
    device = resolve_device(device)

    def data(step: int) -> SceneBatch:
        return shard_scene(make_scene_batch(
            stream_generator(tc.seed, step, TRAIN_STREAM), batch=tc.batch,
            height=cfg.height, width=cfg.width, time_steps=cfg.time_steps,
            max_boxes=tc.max_boxes, n_events=tc.n_events, device=device),
            ax)

    return data


def _recipe(tc: TrainConfig):
    opt_cfg = AdamWConfig(lr=tc.lr, weight_decay=tc.weight_decay,
                          grad_clip=tc.grad_clip)
    # the schedule spans the run's whole horizon, a resumed run's too
    schedule = warmup_cosine(tc.lr, warmup=tc.warmup, total=tc.steps,
                             min_ratio=tc.min_lr_ratio)
    return opt_cfg, schedule


def _place(state, ax: MeshAxes, ckpt, lead: bool, log):
    """-> (start step, state, checkpoint manager) of a run.  One process:
    the trainer resumes by itself (start None).  On a mesh every rank
    restores the newest checkpoint, rank 0's state is broadcast, and only
    rank 0 keeps the manager to write."""
    if ax.mesh is None:
        return None, state, ckpt
    log(f"[detector] data-parallel over {ax.dp_size} ranks "
        f"(mesh axes {ax.mesh.axis_names})")
    start = ckpt.latest_step() if ckpt is not None else None
    if start is not None:
        state = ckpt.restore(start, like=state)
        log(f"[detector] resuming from step {start}")
    return start or 0, replicate_state(state, ax), ckpt if lead else None


def train_detector(tc: TrainConfig, *, ckpt_dir: Optional[str] = None,
                   log: Callable[[str], None] = print,
                   device="cuda") -> TrainReport:
    """Train per ``tc`` on ``device``; resume automatically from the
    newest checkpoint in ``ckpt_dir`` (if any); return the report.
    Under a process group of more than one rank with ``tc.shard``, train
    data-parallel (:func:`make_train_mesh`): every rank returns the
    report, rank 0's with the held-out AP (NaN on the others)."""
    device = resolve_device(device)
    cfg = resolve_snn_config(tc)
    opt_cfg, schedule = _recipe(tc)
    ax = from_mesh(make_train_mesh(tc, device))
    lead = ax.mesh is None or ax.mesh.rank == 0
    if not lead:
        def log(_msg):
            return None
    state = init_detector_state(torch.Generator().manual_seed(tc.seed), cfg,
                                opt_cfg, device)
    ckpt = None
    if ckpt_dir is not None:
        ckpt = CheckpointManager(ckpt_dir, keep=tc.keep_ckpts)
    start, state, ckpt = _place(state, ax, ckpt, lead, log)
    step_fn = make_detector_train_step(cfg, opt_cfg, schedule, ax)
    eval_kw = dict(eval_seed=tc.eval_seed, batches=tc.eval_batches,
                   batch=tc.eval_batch, max_boxes=tc.max_boxes,
                   n_events=tc.n_events)
    ap0 = sp0 = ap1 = sp1 = float("nan")
    if lead:
        ap0, sp0 = evaluate_detector(state.params, cfg, **eval_kw)
        log(f"[detector] untrained: AP@0.5={ap0:.4f} sparsity={sp0:.3f}")

    trainer = Trainer(step_fn, state, make_data_fn(tc, cfg, ax, device),
                      ckpt=ckpt, ckpt_every=tc.ckpt_every,
                      log_every=tc.log_every, log_fn=log)
    t0 = time.perf_counter()
    state = trainer.run(tc.steps, start_step=start)
    wall = time.perf_counter() - t0

    if lead:
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
    cfg = resolve_snn_config(tc)
    opt_cfg, schedule = _recipe(tc)
    ax = from_mesh(make_train_mesh(tc, device))
    if ax.mesh is not None and ax.mesh.rank != 0:
        def log(_msg):
            return None
    template = init_detector_state(torch.Generator().manual_seed(tc.seed),
                                   cfg, opt_cfg, device)
    ckpt = CheckpointManager(ckpt_dir, keep=tc.keep_ckpts)
    at = at_step if at_step is not None else ckpt.latest_step()
    if at is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    state = replicate_state(ckpt.restore(at, like=template), ax)
    log(f"[detector] resuming from step {at}")
    trainer = Trainer(make_detector_train_step(cfg, opt_cfg, schedule, ax),
                      state, make_data_fn(tc, cfg, ax, device), log_fn=log)
    return trainer.run(tc.steps, start_step=at)
