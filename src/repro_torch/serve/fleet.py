"""FleetEngine: continuously batched, self-healing serving of the
cognitive tick on one card, the counterpart of ``repro.serve.fleet``.

It composes:

* :class:`repro_torch.serve.engine_core.EngineCore`: the ``encode -> NPU
  -> control -> ISP`` tick, split into ``upload`` / ``dispatch`` /
  ``fetch`` so a tick is launched without waiting and harvested later;
* :class:`repro_torch.serve.transport.DoubleBuffer`: two pinned host
  staging banks, so tick N+1 is packed and uploaded while tick N runs;
* :class:`repro_torch.serve.scheduler.AdmissionQueue`: bounded
  admission, deadlines, shedding, retry backoff gates;
* :class:`repro_torch.serve.supervisor.FleetSupervisor` (with
  ``supervisor_cfg``): NaN/stall health checks, the circuit breaker and
  the fallback ladder;
* :class:`repro_torch.serve.faults.FaultInjector` (with ``fault_plan``):
  deterministic faults at the core boundary, one tick counter shared by
  every rung.

Every ``step()`` packs as many queued requests as there are free slots
into the next tick, dispatches it, and harvests the previous tick (two
deep with double buffering; ``double_buffer=False`` harvests the same
tick).  A malformed submit FAILS at the edge; a non-finite result is
quarantined (never delivered) when supervised; a
:class:`TransientTickError` fails the tick's requests, which retry behind
seeded exponential backoff; a request in flight past ``hedge_after_ms``
gets one hedged duplicate; consecutive failed ticks demote the engine
down the ladder, and half-open probes climb back.

The ladder, built when supervised and ``cfg.backend == "cuda"``
(:func:`fleet_ladder`): rung 0 ``"cuda_fused"`` (the active launch
table: fused conv->LIF and segment entries where it has them), rung 1
``"cuda"`` (an empty pinned table: the per-layer kernel route).  On a
card that is the whole ladder: its rungs are kernel routes only, so a
kernel that turns non-finite or slow is never replaced by the plain
layers, and a trip on rung 1 re-closes the breaker in place.  On the
CPU, where every rung runs the plain versions anyway, rung 2 ``"torch"``
(the SNN layers on their plain backend; the encode and the ISP stay on
their configs' backends) completes the reference's three-rung ladder.
Only ``TransientTickError``, the NaN quarantine and stall or straggler
ticks move it: any other error of a tick (a kernel that fails to build
or launch raises ``RuntimeError``) propagates out of ``step()``, so the
ladder never hides a broken kernel.

One card: ``mesh="auto"`` resolves to None, and an explicit mesh raises
(sharded serving comes with the port's ``distributed`` package).
Every delivered ``PerceptionResult`` carries a
``scheduler.RequestTelemetry``; ``stats()`` reduces them to p50/p99/
p99.9 latency and the availability envelope.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import (EncodingConfig, FleetConfig,
                                      ISPConfig, SNNConfig,
                                      SupervisorConfig)
from repro_torch.device import resolve_device
from repro_torch.kernels import tune
from repro_torch.serve.cognitive_engine import (PerceptionRequest,
                                                PerceptionResult)
from repro_torch.serve.engine_core import EngineCore
from repro_torch.serve.faults import (FaultInjector, FaultPlan,
                                      TransientTickError, _SharedTicker)
from repro_torch.serve.scheduler import (AdmissionQueue, RequestStatus,
                                         ServeRequest)
from repro_torch.serve.supervisor import FleetSupervisor
from repro_torch.serve.transport import (DoubleBuffer, StagingBank,
                                         stage_request, validate_request)


def fleet_ladder(cfg: SNNConfig, device_type: str, supervised: bool = True):
    """The supervised fleet's rungs as ``(name, SNNConfig, tune_table)``:
    slower rungs, the same function.  On a card (``device_type ==
    "cuda"``) only kernel routes; on the CPU the plain rung as well."""
    if not supervised or cfg.backend != "cuda":
        return [(cfg.backend, cfg, "active")]
    ladder = [("cuda_fused", cfg, "active"),
              ("cuda", cfg, tune.TuningTable())]
    if device_type != "cuda":
        ladder.append(("torch", dataclasses.replace(cfg, backend="torch"),
                       "active"))
    return ladder


class _Inflight:
    """One dispatched tick: its packed (slot, request) pairs, its
    not-yet-fetched outputs, and which core and rung ran it (the
    supervisor may switch rungs while it is in flight)."""

    def __init__(self, packed, outputs, core, rung: int, rung_name: str,
                 tick_no: int, t_dispatch: float):
        self.packed: List[Tuple[int, ServeRequest]] = packed
        self.outputs = outputs
        self.core = core
        self.rung = rung
        self.rung_name = rung_name
        self.tick_no = tick_no
        self.t_dispatch = t_dispatch


class FleetEngine:
    """Continuous-batching front-end over the cognitive tick on one
    device (``device``, default the card).  ``supervisor_cfg`` enables
    self-healing; ``fault_plan`` wraps every ladder rung in a
    :class:`FaultInjector` (testing and chaos runs); ``fault_advance``
    sets how an injected stall manifests (default: sleep; tests advance
    a fake clock)."""

    def __init__(self, npu_params, cfg: SNNConfig,
                 isp_cfg: Optional[ISPConfig] = None, *,
                 fleet_cfg: Optional[FleetConfig] = None,
                 mesh="auto",
                 enc_cfg: Optional[EncodingConfig] = None,
                 control_order: str = "pipeline",
                 collect_sparsity: bool = False,
                 frame_hw: Optional[tuple] = None,
                 supervisor_cfg: Optional[SupervisorConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 fault_advance: Optional[Callable[[float], None]] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device="cuda"):
        self.fleet_cfg = fleet_cfg if fleet_cfg is not None else FleetConfig()
        fc = self.fleet_cfg
        if mesh == "auto":
            mesh = None                 # one card
        if mesh is not None:
            raise NotImplementedError(
                "FleetEngine serves one device: sharded serving over a "
                "mesh waits for the port's distributed package (ROADMAP.md "
                "queue 1 item 4)")
        self.mesh = None

        def _core(core_cfg, tune_table):
            return EngineCore(
                npu_params, core_cfg, isp_cfg, frame_hw=frame_hw,
                control_order=control_order, enc_cfg=enc_cfg,
                collect_sparsity=collect_sparsity, device=device,
                tune_table=tune_table)

        ladder = fleet_ladder(cfg, resolve_device(device).type,
                              supervisor_cfg is not None)
        self.ladder_names = [name for name, _, _ in ladder]
        self.cores = [_core(c, t) for _, c, t in ladder]
        if fault_plan is not None:
            ticker = _SharedTicker()
            self.cores = [FaultInjector(c, fault_plan, ticker,
                                        advance=fault_advance)
                          for c in self.cores]
        self.core = self.cores[0]

        self.supervisor: Optional[FleetSupervisor] = None
        if supervisor_cfg is not None:
            self.supervisor = FleetSupervisor(supervisor_cfg,
                                              self.ladder_names, clock)

        self.cfg = cfg
        self.batch = fc.batch
        self.clock = clock
        self.buffers = DoubleBuffer(self._bank, enabled=fc.double_buffer)
        self.queue = AdmissionQueue(fc.max_queue)
        self._inflight: Optional[_Inflight] = None
        self.ticks = 0
        self.last_tick_s = 0.0
        self._latencies: List[float] = []   # delivered requests' latency_s
        self.n_delivered = 0
        self.n_deadline_missed = 0
        self.n_failed = 0                   # terminal FAILED requests
        self.n_malformed = 0                # FAILED at validation
        self.n_retries = 0                  # re-enqueues after failures
        self.n_hedges = 0                   # hedge duplicates launched
        self.n_hedge_wins = 0               # deliveries won by the hedge
        self.n_nan_delivered = 0            # non-finite results DELIVERED
        if supervisor_cfg is not None and supervisor_cfg.prewarm:
            self._prewarm()

    def _bank(self) -> StagingBank:
        return StagingBank(self.cfg, self.batch, self.core.frame_hw,
                           self.core.enc_cfg.event_capacity,
                           pin_memory=self.core.device.type == "cuda")

    # ------------------------------------------------------------------
    # client edge
    # ------------------------------------------------------------------
    def submit(self, req: PerceptionRequest, *,
               deadline_ms: Optional[float] = None) -> ServeRequest:
        """Admit a request (voxel- or event-carrying) into the bounded
        queue.  The returned ``ServeRequest`` is ``QUEUED``, ``REJECTED``
        (queue full; nothing copied) or ``FAILED`` with ``.error`` (a
        malformed payload).  ``deadline_ms`` counts from now; omitted, it
        is ``FleetConfig.default_deadline_ms``."""
        try:
            kind = validate_request(
                req, self.cfg.in_channels,
                time_steps=self.cfg.time_steps,
                voxel_hw=(self.cfg.height, self.cfg.width),
                frame_hw=self.core.frame_hw)
        except (ValueError, TypeError) as e:
            sreq = ServeRequest(request=req, status=RequestStatus.FAILED,
                                error=str(e))
            self.n_failed += 1
            self.n_malformed += 1
            return sreq
        now = self.clock()
        if deadline_ms is None:
            deadline_ms = self.fleet_cfg.default_deadline_ms
        sreq = ServeRequest(
            request=req, kind=kind,
            deadline=None if deadline_ms is None
            else now + deadline_ms / 1e3)
        self.queue.offer(sreq, now)
        return sreq

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    def step(self) -> List[ServeRequest]:
        """One scheduler round: shed expired queued work, hedge overdue
        in-flight work, pack free slots into the front staging bank,
        dispatch it on the supervisor's rung, then harvest the previous
        tick (health-checking every slot).  Returns every request that
        reached a terminal status this round (``DONE``, ``EXPIRED``,
        ``FAILED``)."""
        t0 = time.perf_counter()
        now = self.clock()
        terminal: List[ServeRequest] = []
        for sreq in self.queue.shed_expired(now):
            if sreq.is_hedge:               # the client never sees it
                self._settle_dead_hedge(sreq, terminal)
                continue
            terminal.append(sreq)
        self._maybe_hedge(now)

        # pack: continuous batching fills every slot the queue can
        bank = self.buffers.front
        bank.wait_copied()
        packed: List[Tuple[int, ServeRequest]] = []
        while len(packed) < self.batch and len(self.queue):
            sreq = self.queue.pop_ready(now)
            if sreq is None:
                break                       # the rest is backing off
            if sreq.expired(now):           # raced past its deadline
                sreq.status = RequestStatus.EXPIRED
                self.queue.n_expired += 1
                if sreq.is_hedge:
                    self._settle_dead_hedge(sreq, terminal)
                else:
                    terminal.append(sreq)
                continue
            if sreq.is_hedge and sreq.primary.status in (
                    RequestStatus.DONE, RequestStatus.FAILED,
                    RequestStatus.EXPIRED):
                continue                    # the race is settled
            slot = len(packed)
            try:
                stage_request(bank, slot, sreq.request, sreq.kind,
                              self.core.enc_cfg)
            except (ValueError, TypeError) as e:
                # a payload past the edge's validation: fail the
                # request, never the serving loop
                self.n_malformed += 1
                self._fail(sreq, f"staging: {e}", retryable=False,
                           now=now, terminal=terminal)
                continue
            sreq.telemetry.t_admit = now
            sreq.attempts += 1
            packed.append((slot, sreq))
        for slot in range(len(packed), self.batch):
            bank.from_events[slot] = False  # recycled slots stay inert

        # dispatch the new tick before harvesting the old one: its
        # upload and launches are queued behind the old tick's
        new_inflight = None
        if packed:
            rung = (self.supervisor.select_rung(self.ticks)
                    if self.supervisor is not None else 0)
            core = self.cores[rung]
            try:
                outputs = core.dispatch(core.upload(bank))
            except TransientTickError as e:
                t_fail = self.clock()
                if self.supervisor is not None:
                    self.supervisor.record_tick(self.ticks, rung, False,
                                                0.0, f"dispatch: {e}")
                for _, sreq in packed:
                    self._fail(sreq, str(e), retryable=True, now=t_fail,
                               terminal=terminal)
            else:
                t_disp = self.clock()
                for _, sreq in packed:
                    sreq.status = RequestStatus.IN_FLIGHT
                    sreq.telemetry.t_dispatch = t_disp
                new_inflight = _Inflight(
                    packed, outputs, core, rung,
                    self.ladder_names[rung], self.ticks, t_disp)
                self.buffers.flip()
                self.ticks += 1

        # harvest the previous tick (depth 2 with double buffering;
        # without it, this very tick)
        if self.fleet_cfg.double_buffer:
            harvest, self._inflight = self._inflight, new_inflight
        else:
            harvest, self._inflight = new_inflight, None
        if harvest is not None:
            self._harvest(harvest, terminal)
        self.last_tick_s = time.perf_counter() - t0
        return terminal

    # ------------------------------------------------------------------
    # failure handling and resilience
    # ------------------------------------------------------------------
    def _fail(self, sreq: ServeRequest, error: str, *, retryable: bool,
              now: float, terminal: List[ServeRequest]) -> None:
        """A request's tick went wrong.  Transient failures retry behind
        an exponential-backoff gate with seeded jitter while budget
        remains; otherwise the request ends FAILED.  Hedge copies never
        retry and never surface: the primary owns the outcome.  A
        primary that its hedge already delivered has no outcome left."""
        if sreq.status is RequestStatus.DONE:
            return
        if sreq.is_hedge:
            sreq.status = RequestStatus.FAILED
            primary = sreq.primary
            if primary.parked and primary.status is not RequestStatus.DONE:
                # the primary was only waiting on this hedge
                self._finalize_fail(primary, primary.error or error,
                                    terminal)
            return
        sup = self.supervisor
        if (retryable and sup is not None and sup.cfg.max_retries > 0
                and sreq.attempts <= sup.cfg.max_retries
                and not sreq.expired(now)):
            c = sup.cfg
            jitter_ms = float(np.random.default_rng(
                (c.retry_seed, sreq.rid & 0x7FFFFFFF, sreq.attempts)
            ).uniform(0.0, c.retry_jitter_ms)) if c.retry_jitter_ms else 0.0
            backoff_ms = c.retry_backoff_ms * (2 ** (sreq.attempts - 1)) \
                + jitter_ms
            sreq.not_before = now + backoff_ms / 1e3
            sreq.telemetry.n_retries += 1
            self.n_retries += 1
            if self.queue.offer(sreq, now, requeue=True):
                return
            # queue full: the retry loses to fresh admissions
        if (sreq.hedge is not None and sreq.hedge.status in
                (RequestStatus.QUEUED, RequestStatus.IN_FLIGHT)):
            # a live hedge still races: park, so the hedge's delivery or
            # failure settles this request (one terminal status)
            sreq.parked = True
            sreq.error = error
            return
        self._finalize_fail(sreq, error, terminal)

    def _settle_dead_hedge(self, hedge: ServeRequest,
                           terminal: List[ServeRequest]) -> None:
        """A hedge copy left the race without delivering: a primary
        parked on it fails now."""
        primary = hedge.primary
        if primary.parked and primary.status is not RequestStatus.DONE:
            self._finalize_fail(primary, primary.error or "hedge expired",
                                terminal)

    def _finalize_fail(self, sreq: ServeRequest, error: str,
                       terminal: List[ServeRequest]) -> None:
        sreq.status = RequestStatus.FAILED
        sreq.error = error
        self.n_failed += 1
        terminal.append(sreq)

    def _maybe_hedge(self, now: float) -> None:
        """A primary in flight past the latency SLO gets one duplicate
        enqueued to race it."""
        sup = self.supervisor
        if (sup is None or sup.cfg.hedge_after_ms is None
                or self._inflight is None):
            return
        slo_s = sup.cfg.hedge_after_ms / 1e3
        for _, sreq in self._inflight.packed:
            if (sreq.is_hedge or sreq.status is not RequestStatus.IN_FLIGHT
                    or sreq.telemetry.n_hedges > 0):
                continue
            if now - sreq.telemetry.t_enqueue <= slo_s:
                continue
            hedge = ServeRequest(request=sreq.request, kind=sreq.kind,
                                 deadline=sreq.deadline, primary=sreq)
            if self.queue.offer(hedge, now):
                sreq.hedge = hedge
                sreq.telemetry.n_hedges += 1
                self.n_hedges += 1

    # ------------------------------------------------------------------
    # harvest and health checks
    # ------------------------------------------------------------------
    def _harvest(self, inflight: _Inflight,
                 terminal: List[ServeRequest]) -> None:
        sup = self.supervisor
        try:
            out, rgb, sp = inflight.core.fetch(inflight.outputs)
        except TransientTickError as e:
            now = self.clock()
            if sup is not None:
                sup.record_tick(inflight.tick_no, inflight.rung, False,
                                now - inflight.t_dispatch,
                                f"transient: {e}")
            for _, sreq in inflight.packed:
                self._fail(sreq, str(e), retryable=True, now=now,
                           terminal=terminal)
            return
        now = self.clock()
        wall = now - inflight.t_dispatch
        spars = None
        if out.layer_rates is not None:
            spars = {k: float(v) for k, v in out.layer_rates.items()}
        ok, reason = True, ""
        guard = sup is not None and sup.cfg.nan_guard
        for slot, sreq in inflight.packed:
            finite = bool(np.isfinite(rgb[slot]).all()
                          and np.isfinite(out.control[slot]).all()
                          and np.isfinite(out.raw_pred[slot]).all())
            if guard and not finite:
                # quarantine: a non-finite result is never delivered
                ok, reason = False, "nan_output"
                sup.n_quarantined += 1
                sreq.telemetry.quarantined = True
                self._fail(sreq, "non-finite result quarantined",
                           retryable=True, now=now, terminal=terminal)
                continue
            if not finite:
                self.n_nan_delivered += 1   # unsupervised: count the leak
            self._deliver_one(sreq, slot, out, rgb, sp, spars, now,
                              inflight, terminal)
        if sup is not None:
            dl = sup.cfg.tick_deadline_ms
            if ok and dl is not None and wall * 1e3 > dl:
                ok, reason = False, "stall"
            sup.record_tick(inflight.tick_no, inflight.rung, ok, wall,
                            reason)

    def _deliver_one(self, sreq: ServeRequest, slot: int, out, rgb, sp,
                     spars, now: float, inflight: _Inflight,
                     terminal: List[ServeRequest]) -> None:
        primary = sreq.primary if sreq.is_hedge else sreq
        if primary.status is RequestStatus.DONE:
            sreq.status = RequestStatus.DONE    # lost the race: discard
            return
        tel = primary.telemetry
        tel.t_deliver = now
        tel.deadline_missed = primary.expired(now)
        tel.rung = inflight.rung_name
        if sreq.is_hedge:
            tel.hedge_won = True
            self.n_hedge_wins += 1
            sreq.status = RequestStatus.DONE
            # a retry of the primary still waiting is settled too: it
            # must not be packed and delivered a second time
            self.queue.discard(primary)
        primary.request.result = PerceptionResult(
            rgb=rgb[slot], control=out.control[slot],
            raw_pred=out.raw_pred[slot],
            stage_params={s: {k: v[slot] for k, v in ps.items()}
                          for s, ps in sp.items()},
            sparsity=spars, telemetry=tel)
        primary.status = RequestStatus.DONE
        self._latencies.append(tel.latency_s)
        self.n_delivered += 1
        self.n_deadline_missed += bool(tel.deadline_missed)
        terminal.append(primary)

    # ------------------------------------------------------------------
    def _prewarm(self) -> None:
        """Run every ladder rung's tick once up front, so a breaker's
        switch never pays a first call (kernel builds, plans) in the
        serving path."""
        bank = self._bank()
        for core in self.cores:
            real = getattr(core, "_core", core)  # past fault injection
            real.fetch(real.dispatch(real.upload(bank)))

    def drain(self, max_steps: int = 10000) -> List[ServeRequest]:
        """Step until the queue and the pipeline are empty; returns every
        request that reached a terminal status meanwhile.  With a fake
        clock, retried requests wait on ``not_before``: advance the clock
        between steps."""
        finished: List[ServeRequest] = []
        for _ in range(max_steps):
            if not len(self.queue) and self._inflight is None:
                break
            finished.extend(self.step())
        return finished

    def run_to_completion(self, requests: List[PerceptionRequest],
                          max_steps: int = 10000) -> List[ServeRequest]:
        """Submit, then drain (admission control applies: the list holds
        the REJECTED and malformed FAILED submits too)."""
        submitted = [self.submit(r) for r in requests]
        dead = [s for s in submitted
                if s.status in (RequestStatus.REJECTED,
                                RequestStatus.FAILED)]
        return dead + self.drain(max_steps)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """The serving envelope over every delivered request: p50/p99/
        p99.9 latency (seconds), availability, and the shed, rejected,
        failed, retried and hedged counts; the supervisor's state when
        supervised."""
        lat = sorted(self._latencies)
        n = len(lat)

        def pct(p):
            return lat[min(n - 1, int(p * n))] if n else float("nan")

        terminal = (self.n_delivered + self.n_failed
                    + self.queue.n_expired)
        out = {
            "delivered": self.n_delivered,
            "rejected": self.queue.n_rejected,
            "expired": self.queue.n_expired,
            "failed": self.n_failed,
            "malformed": self.n_malformed,
            "retries": self.n_retries,
            "hedges": self.n_hedges,
            "hedge_wins": self.n_hedge_wins,
            "nan_delivered": self.n_nan_delivered,
            "deadline_missed": self.n_deadline_missed,
            "availability": (self.n_delivered / terminal) if terminal
            else float("nan"),
            "ticks": self.ticks,
            "n_devices": self.core.n_devices,
            "latency_p50_s": pct(0.50),
            "latency_p99_s": pct(0.99),
            "latency_p999_s": pct(0.999),
        }
        if self.supervisor is not None:
            out["supervisor"] = self.supervisor.stats()
        return out
