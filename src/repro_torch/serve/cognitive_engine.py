"""Streaming engine for the cognitive perception loop, the counterpart of
``repro.serve.cognitive_engine``: a fixed pool of ``batch`` slots over
one :class:`EngineCore`.  Clients submit a finished DVS voxel window
(``submit``) or a raw event buffer (``submit_events``) plus one Bayer
frame; every ``tick`` voxelizes the event slots, runs the active batch
through the NPU and the ISP, hands back finished requests and recycles
their slots.  A submit is a host copy into the staging bank; the tick
makes one upload and one download.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.configs.base import EncodingConfig, ISPConfig, SNNConfig
from repro_torch.core.encoding import EventStream
from repro_torch.serve.engine_core import EngineCore
from repro_torch.serve.transport import (StagingBank, stage_request,
                                         validate_request)


class PerceptionResult(NamedTuple):
    rgb: np.ndarray             # [H, W, 3] corrected RGB
    control: np.ndarray         # [control_dim] raw NPU control vector
    raw_pred: np.ndarray        # detection head output for this frame
    stage_params: Dict[str, Dict[str, np.ndarray]]
    # per-layer spike rates of the tick batch (collect_sparsity=True)
    sparsity: Optional[Dict[str, float]] = None
    # the request's lifecycle (scheduler.RequestTelemetry), set by the
    # FleetEngine; None through the CognitiveEngine
    telemetry: Optional[Any] = None


@dataclasses.dataclass
class PerceptionRequest:
    rid: int
    voxels: Optional[Any] = None            # [T, Hd, Wd, 2] DVS voxel window
    bayer: Optional[Any] = None             # [H, W] RGGB mosaic in [0, 1]
    events: Optional[EventStream] = None    # raw [N]-leaf event buffer
    result: Optional[PerceptionResult] = None


class CognitiveEngine:
    """Slot-based streaming front-end over the cognitive loop.

    ``device`` defaults to "cuda" and raises when no card is present;
    the CPU runs the tick only when the caller passes ``device="cpu"``.
    """

    def __init__(self, npu_params, cfg: SNNConfig,
                 isp_cfg: Optional[ISPConfig] = None, batch: int = 4,
                 frame_hw: Optional[tuple] = None,
                 control_order: str = "pipeline",
                 enc_cfg: Optional[EncodingConfig] = None,
                 collect_sparsity: bool = False, device="cuda"):
        self.core = EngineCore(
            npu_params, cfg, isp_cfg, frame_hw=frame_hw,
            control_order=control_order, enc_cfg=enc_cfg,
            collect_sparsity=collect_sparsity, device=device)
        self.cfg = cfg
        self.isp_cfg = self.core.isp_cfg
        self.enc_cfg = self.core.enc_cfg
        self.batch = batch
        self.staging = StagingBank(cfg, batch, self.core.frame_hw,
                                   self.enc_cfg.event_capacity,
                                   pin_memory=self.core.device.type == "cuda")
        self.active: List[Optional[PerceptionRequest]] = [None] * batch
        self.ticks = 0
        self.last_tick_s = 0.0      # wall time of the latest tick()

    # ------------------------------------------------------------------
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.active):
            if r is None:
                return i
        return None

    def _stage(self, req: PerceptionRequest, kind: str) -> bool:
        slot = self._free_slot()
        if slot is None:
            return False
        stage_request(self.staging, slot, req, kind, self.enc_cfg)
        self.active[slot] = req
        return True

    def submit(self, req: PerceptionRequest) -> bool:
        """Stage a request into a free slot; False if the engine is full.
        Requests carrying raw events (and no voxels) stage as events."""
        return self._stage(req, validate_request(req, self.cfg.in_channels))

    def submit_events(self, req: PerceptionRequest) -> bool:
        """Stage a raw event buffer into a free slot; the voxelization
        happens in the next tick.  False if the engine is full."""
        return self._stage(req, validate_request(req, self.cfg.in_channels,
                                                 events_only=True))

    # ------------------------------------------------------------------
    def tick(self) -> List[PerceptionRequest]:
        """Run one batched perception step; returns the finished requests
        (every active one) and recycles their slots."""
        if not any(r is not None for r in self.active):
            return []
        t0 = time.perf_counter()
        out, rgb, sp = self.core.tick(self.staging)
        self.last_tick_s = time.perf_counter() - t0
        self.ticks += 1
        spars = None
        if out.layer_rates is not None:
            spars = {k: float(v) for k, v in out.layer_rates.items()}
        finished: List[PerceptionRequest] = []
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.result = PerceptionResult(
                rgb=rgb[i], control=out.control[i], raw_pred=out.raw_pred[i],
                stage_params={s: {k: v[i] for k, v in ps.items()}
                              for s, ps in sp.items()},
                sparsity=spars)
            finished.append(r)
            self.active[i] = None
        return finished

    def run_to_completion(self, requests: List[PerceptionRequest],
                          max_ticks: int = 10000) \
            -> List[PerceptionRequest]:
        done: List[PerceptionRequest] = []
        pending = collections.deque(requests)
        ticks = 0
        while (pending or any(r is not None for r in self.active)) \
                and ticks < max_ticks:
            while pending and self._free_slot() is not None:
                self.submit(pending.popleft())
            done.extend(self.tick())
            ticks += 1
        return done
