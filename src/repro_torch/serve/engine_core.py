"""EngineCore: the device-side half of the cognitive serving tick, the
counterpart of ``repro.serve.engine_core``.

A tick is ``encode -> npu_forward -> control -> ISP`` run eagerly on the
engine's device, each stage on the backend its config names
(``EncodingConfig``, ``SNNConfig``, ``ISPConfig``): ONE host->device
copy of the staging bank (the bank is one contiguous, pinned buffer),
the tick's kernels on the current stream, and ONE device->host copy of
every output packed into a single flat tensor.  The engine snapshots the
launch table once at construction (``tune_table``) and runs every tick
pinned to it, so a later ``tune.set_table`` never reaches a built
engine.  CUDA graphs for the tick are later work.

The tick splits as the reference's does: ``upload`` (the bank's copy,
non-blocking, an event recorded behind it on the bank), ``dispatch``
(the tick's launches and the packed outputs' copy into a pinned host
buffer of this tick's own, an event recorded behind it; returns at
once) and ``fetch`` (waits on that event alone, then unpacks views of
that buffer).  So on one stream the harvest of tick k waits for tick k,
never for a tick k+1 dispatched after it.  The host buffer comes from
PyTorch's caching host allocator, which records the non-blocking copy
and hands the block out again only once the copy has completed and the
last view of it is gone.  On the CPU, ``dispatch`` computes the tick
and ``fetch`` unpacks it.  ``torch.profiler`` spans ``tick.upload``,
``tick.encode``, ``tick.npu``, ``tick.isp`` and ``tick.fetch`` mark the
stages (``python -m repro_torch.profile_tick`` reads them).

The tick is data-parallel over the engine's devices, as the reference's
sharded executable is: one device without a mesh, every device of a
serving ``mesh`` (a ``("data",)`` mesh over local devices,
``launch.mesh.make_serving_mesh``).  Each device holds a parameter copy
and is one shard of the bank (``bank.shards``: a ``ShardedBank`` holds
one ``StagingBank`` per device, a ``StagingBank`` is its own only
shard), whose rows go up in one copy of their own.  Each shard's tick is
dispatched under ``torch.cuda.device`` of its device (its current
stream; every kernel wrapper launches on its tensors' device,
``kernels/build.py`` ``launch``) and copied back behind an event of its
own, and ``fetch`` waits on every shard's event and reassembles each
output in slot order; the batch-reduced scalars (``sparsity``,
``tile_skip``, ``layer_rates``) are the shards' mean, as the one-device
tick's mean over equal shards.  One shard's outputs are its own.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.configs.base import EncodingConfig, ISPConfig, SNNConfig
from repro_torch.core.encoding import ENCODING_BACKENDS, encode_batch
from repro_torch.core.npu import NPUOutput, npu_forward, params_to
from repro_torch.device import resolve_device
from repro_torch.isp.pipeline import (control_vector_pipeline_batch,
                                      legacy_control_permutation)
from repro_torch.isp.stages import BACKENDS as ISP_BACKENDS
from repro_torch.isp.stages import control_to_stage_params
from repro_torch.kernels import tune


def on_device(dev: torch.device):
    """``torch.cuda.device(dev)`` on a card, nothing on the CPU."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


class Dispatched:
    """One dispatched tick: its outputs packed into ``flat`` (a pinned
    host tensor of its own, with ``event`` behind its copy, or the CPU
    tensor itself) and what ``fetch`` needs to unpack them."""

    def __init__(self, flat, event, layout, stages, has_rates):
        self.flat = flat
        self.event = event
        self.layout: List[Tuple[tuple, tuple]] = layout  # (key, shape)
        self.stages = stages                             # {stage: [param]}
        self.has_rates = has_rates


class EngineCore:
    """Owns the tick, the engine's device and its parameter copy."""

    def __init__(self, npu_params, cfg: SNNConfig,
                 isp_cfg: Optional[ISPConfig] = None, *,
                 frame_hw: Optional[tuple] = None,
                 control_order: str = "pipeline",
                 enc_cfg: Optional[EncodingConfig] = None,
                 collect_sparsity: bool = False, device="cuda",
                 tune_table="active", mesh=None,
                 batch: Optional[int] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.isp_cfg = isp_cfg if isp_cfg is not None else ISPConfig()
        self.enc_cfg = enc_cfg if enc_cfg is not None else EncodingConfig()
        need = self.isp_cfg.control_dim
        if cfg.control_dim < need:
            raise ValueError(
                f"NPU control_dim={cfg.control_dim} < {need} needed by ISP "
                f"pipeline {self.isp_cfg.name!r}; build the SNNConfig with "
                f"repro_torch.core.npu.configure_for_isp")
        if self.enc_cfg.backend not in ENCODING_BACKENDS:
            raise ValueError(f"unknown encoding backend "
                             f"{self.enc_cfg.backend!r}; known: "
                             f"{ENCODING_BACKENDS}")
        if self.isp_cfg.backend not in ISP_BACKENDS:
            raise ValueError(
                f"unknown ISP backend {self.isp_cfg.backend!r}; "
                f"registered: {ISP_BACKENDS}")
        self.frame_hw: Tuple[int, int] = (
            frame_hw if frame_hw is not None else (cfg.height, cfg.width))
        if control_order not in ("pipeline", "legacy"):
            raise ValueError(f"control_order must be 'pipeline' or "
                             f"'legacy', got {control_order!r}")
        perm = None
        if control_order == "legacy":
            perm = legacy_control_permutation(self.isp_cfg.stages)
            if cfg.control_dim <= max(perm):
                raise ValueError(
                    f"NPU control_dim={cfg.control_dim} too narrow for "
                    f"the legacy slot layout (needs > {max(perm)})")
        self.collect_sparsity = bool(collect_sparsity)

        # a parameter copy per device: the engine's device, or every
        # device of the mesh's data axis
        self.devices = [self.device]
        if mesh is not None:
            if mesh.axis_names != ("data",) or mesh.devices is None:
                raise ValueError(f"a serving mesh is one ('data',) axis "
                                 f"over local devices, got {mesh!r}")
            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"mesh {mesh!r} is not on device="
                                 f"{self.device.type!r}")
            self.devices = list(mesh.devices)
            self.device = self.devices[0]
        self.n_devices = len(self.devices)
        if batch is not None and batch % self.n_devices:
            raise ValueError(
                f"tick batch={batch} not divisible by the mesh's "
                f"{self.n_devices} data-parallel devices")
        self.replicas = [params_to(npu_params, d) for d in self.devices]
        self.params = self.replicas[0]
        self.perms = [None if perm is None else
                      torch.tensor(perm, dtype=torch.int64, device=d)
                      for d in self.devices]
        # The launch table every tick resolves through: "active" snapshots
        # the table active now (an empty one, the untuned defaults, when
        # none is), an explicit TuningTable pins that one (an empty table
        # pins the per-op route), None follows the live chain.
        if isinstance(tune_table, str):
            if tune_table != "active":
                raise ValueError(f"tune_table must be 'active', a "
                                 f"TuningTable or None, got {tune_table!r}")
            tune_table = tune.active_table() or tune.TuningTable()
        self.tune_table: Optional[tune.TuningTable] = tune_table

    # ------------------------------------------------------------------
    def _encode(self, events, voxels, from_events):
        """Every slot's event FIFO, or its staged voxels where it was
        submitted as voxels -> [T, B, H, W, 2] on the encoding backend
        ("cuda": one launch of the voxelization kernel)."""
        c, e = self.cfg, self.enc_cfg
        return encode_batch(events, voxels, from_events, backend=e.backend,
                            time_steps=c.time_steps, height=c.height,
                            width=c.width, window=e.window, mode=e.mode,
                            oob=e.oob)

    @torch.no_grad()
    def step(self, voxels, bayer, events, from_events, shard: int = 0):
        """The tick on device tensors of ``shard`` (its device's parameter
        copy) -> (NPUOutput, rgb [B, H, W, 3], stage params {stage:
        {param: [B]}})."""
        perm = self.perms[shard]
        with tune.pinned(self.tune_table):
            if self.cfg.in_channels == 2:
                with record_function("tick.encode"):
                    voxels = self._encode(events, voxels, from_events)
            with record_function("tick.npu"):
                out = npu_forward(self.replicas[shard], voxels, self.cfg,
                                  collect_sparsity=self.collect_sparsity)
            ctrl = out.control[:, perm] if perm is not None \
                else out.control[:, :self.isp_cfg.control_dim]
            with record_function("tick.isp"):
                rgb = control_vector_pipeline_batch(bayer, ctrl,
                                                    self.isp_cfg)
                sp = control_to_stage_params(ctrl, self.isp_cfg.stages)
        return out, rgb, sp

    def upload(self, bank) -> List[tuple]:
        """ONE host->device copy of each shard's bank to its device;
        returns each shard's device views ``(voxels, bayer, events,
        from_events)``.  On a card the copy is non-blocking from the
        pinned bank, and the event recorded behind it on the bank keeps
        the bank from being re-packed before the copy lands."""
        with record_function("tick.upload"):
            views = []
            for sub, dev in zip(bank.shards, self.devices, strict=True):
                with on_device(dev):
                    buf = sub.buffer.to(dev, non_blocking=True, copy=True)
                    if dev.type == "cuda":
                        ev = torch.cuda.Event()
                        ev.record()
                        sub.mark_copied(ev)
                views.append(sub.device_views(buf))
            return views

    def dispatch(self, dev_views) -> List[Dispatched]:
        """Launch each shard's tick on its uploaded device views, under
        its device, and return at once: its outputs are packed into one
        flat float32 tensor and, on a card, copied without blocking into
        a pinned host buffer of this tick's own, an event recorded behind
        the copy."""
        out = []
        for i, (views, dev) in enumerate(zip(dev_views, self.devices,
                                             strict=True)):
            with on_device(dev):
                out.append(self._dispatch(i, views))
        return out

    def _dispatch(self, shard: int, dev_views) -> Dispatched:
        out, rgb, sp = self.step(*dev_views, shard=shard)
        leaves: Dict[tuple, torch.Tensor] = {
            ("raw_pred",): out.raw_pred, ("control",): out.control,
            ("sparsity",): out.sparsity, ("tile_skip",): out.tile_skip,
            ("rgb",): rgb}
        for s, params in sp.items():
            for k, v in params.items():
                leaves[("sp", s, k)] = v
        for k, v in (out.layer_rates or {}).items():
            leaves[("rates", k)] = v
        layout = [(key, tuple(t.shape)) for key, t in leaves.items()]
        stages = {s: list(params) for s, params in sp.items()}
        with record_function("tick.fetch"):
            flat = torch.cat([t.reshape(-1).to(torch.float32)
                              for t in leaves.values()])
            if flat.device.type != "cuda":
                return Dispatched(flat, None, layout, stages,
                                  out.layer_rates is not None)
            host = torch.empty(flat.numel(), dtype=torch.float32,
                               pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return Dispatched(host, event, layout, stages,
                          out.layer_rates is not None)

    def fetch(self, outputs: List[Dispatched]):
        """The dispatched tick's outputs as numpy arrays of the step's
        structure: waits on each shard's own copy event alone (never on a
        tick dispatched after it), the shards reassembled in slot
        order."""
        return _gather([self._fetch(o) for o in outputs])

    def _fetch(self, outputs: Dispatched):
        with record_function("tick.fetch"):
            if outputs.event is not None:
                outputs.event.synchronize()
            flat = outputs.flat.numpy()
        host, off = {}, 0
        for key, shape in outputs.layout:
            n = int(np.prod(shape, dtype=np.int64))
            host[key] = flat[off:off + n].reshape(shape)
            off += n
        rates = ({k[1]: host[k] for k in host if k[0] == "rates"}
                 if outputs.has_rates else None)
        npu = NPUOutput(raw_pred=host[("raw_pred",)],
                        control=host[("control",)],
                        sparsity=np.float32(host[("sparsity",)]),
                        tile_skip=np.float32(host[("tile_skip",)]),
                        layer_rates=rates)
        stage_params = {s: {k: host[("sp", s, k)] for k in params}
                        for s, params in outputs.stages.items()}
        return npu, host[("rgb",)], stage_params

    def tick(self, bank):
        """upload -> dispatch -> fetch in one call."""
        return self.fetch(self.dispatch(self.upload(bank)))


def _gather(parts):
    """Shards' ``(NPUOutput, rgb, stage params)`` -> the whole tick's:
    every batch leaf concatenated in slot order, the batch-reduced
    scalars averaged (equal shards: the mean over the whole batch).  One
    shard's are the tick's."""
    if len(parts) == 1:
        return parts[0]

    def cat(xs):
        return np.concatenate(xs, axis=0)

    def mean(xs):
        return np.float32(np.mean(np.asarray(xs, np.float32)))

    npus = [p[0] for p in parts]
    rates = None
    if npus[0].layer_rates is not None:
        rates = {k: mean([n.layer_rates[k] for n in npus])
                 for k in npus[0].layer_rates}
    npu = NPUOutput(raw_pred=cat([n.raw_pred for n in npus]),
                    control=cat([n.control for n in npus]),
                    sparsity=mean([n.sparsity for n in npus]),
                    tile_skip=mean([n.tile_skip for n in npus]),
                    layer_rates=rates)
    stage_params = {s: {k: cat([p[2][s][k] for p in parts]) for k in ps}
                    for s, ps in parts[0][2].items()}
    return npu, cat([p[1] for p in parts]), stage_params
