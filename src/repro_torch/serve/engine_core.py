"""EngineCore: the device-side half of the cognitive serving tick, the
counterpart of ``repro.serve.engine_core`` on one device.

A tick is ``encode -> npu_forward -> control -> ISP`` run eagerly on the
engine's device, each stage on the backend its config names
(``EncodingConfig``, ``SNNConfig``, ``ISPConfig``): ONE host->device
copy of the staging bank (the bank is one contiguous, pinned buffer),
the tick's kernels on the current stream, and ONE device->host copy of
every output packed into a single flat tensor.  The engine snapshots the
launch table once at construction (``tune_table``) and runs every tick
pinned to it, so a later ``tune.set_table`` never reaches a built
engine.  One device, no mesh; CUDA graphs for the tick are later work.

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
"""
from __future__ import annotations

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
                 tune_table="active"):
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
        self.perm = None
        if control_order == "legacy":
            p = legacy_control_permutation(self.isp_cfg.stages)
            if cfg.control_dim <= max(p):
                raise ValueError(
                    f"NPU control_dim={cfg.control_dim} too narrow for "
                    f"the legacy slot layout (needs > {max(p)})")
            self.perm = torch.tensor(p, dtype=torch.int64,
                                     device=self.device)
        self.collect_sparsity = bool(collect_sparsity)
        self.params = params_to(npu_params, self.device)
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
        self.n_devices = 1

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
    def step(self, voxels, bayer, events, from_events):
        """The tick on device tensors -> (NPUOutput, rgb [B, H, W, 3],
        stage params {stage: {param: [B]}})."""
        with tune.pinned(self.tune_table):
            if self.cfg.in_channels == 2:
                with record_function("tick.encode"):
                    voxels = self._encode(events, voxels, from_events)
            with record_function("tick.npu"):
                out = npu_forward(self.params, voxels, self.cfg,
                                  collect_sparsity=self.collect_sparsity)
            ctrl = out.control[:, self.perm] if self.perm is not None \
                else out.control[:, :self.isp_cfg.control_dim]
            with record_function("tick.isp"):
                rgb = control_vector_pipeline_batch(bayer, ctrl,
                                                    self.isp_cfg)
                sp = control_to_stage_params(ctrl, self.isp_cfg.stages)
        return out, rgb, sp

    def upload(self, bank):
        """ONE host->device copy of the whole staging bank; returns the
        device views ``(voxels, bayer, events, from_events)``.  On a card
        the copy is non-blocking from the pinned bank, and the event
        recorded behind it on the bank keeps the bank from being
        re-packed before the copy lands."""
        with record_function("tick.upload"):
            dev = bank.buffer.to(self.device, non_blocking=True, copy=True)
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                bank.mark_copied(ev)
            return bank.device_views(dev)

    def dispatch(self, dev_views) -> Dispatched:
        """Launch the tick on uploaded device views and return at once:
        its outputs are packed into one flat float32 tensor and, on a
        card, copied without blocking into a pinned host buffer of this
        tick's own, an event recorded behind the copy."""
        out, rgb, sp = self.step(*dev_views)
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
            if self.device.type != "cuda":
                return Dispatched(flat, None, layout, stages,
                                  out.layer_rates is not None)
            host = torch.empty(flat.numel(), dtype=torch.float32,
                               pin_memory=True)
            host.copy_(flat, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        return Dispatched(host, event, layout, stages,
                          out.layer_rates is not None)

    def fetch(self, outputs: Dispatched):
        """The dispatched tick's outputs as numpy arrays of the step's
        structure: waits on the tick's own copy event alone."""
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
