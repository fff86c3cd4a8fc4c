"""FleetSupervisor: health checks, circuit breaking and graceful
degradation for the fleet (``repro_torch.serve.fleet``), the
counterpart of ``repro.serve.supervisor``.

* **Per-tick health.**  Every harvested tick reports (ok, wall time,
  reason).  Tick wall times feed a
  :class:`repro_torch.distributed.fault_tolerance.HeartbeatMonitor`, so
  a silently slowing engine (``straggler_factor`` x the running median
  for ``straggler_patience`` consecutive ticks) trips the breaker even
  when no tick crosses ``tick_deadline_ms``.
* **Circuit breaker.**  ``breaker_threshold`` consecutive failed ticks
  open the breaker: the engine is demoted one rung down the fallback
  ladder (``"cuda_fused"`` -> ``"cuda"`` -> ``"torch"``; slower rungs,
  the same function).  Demotions are telemetry events.
* **Recovery.**  After ``half_open_after`` ticks degraded, the next
  tick probes the rung above (half-open); ``recovery_threshold``
  consecutive clean probes promote, one failed probe re-opens.

::

    CLOSED --k consecutive failures--> OPEN (demote one rung)
    OPEN   --half_open_after ticks---> HALF_OPEN (probe rung above)
    HALF_OPEN --probe ok x recovery_threshold--> CLOSED (promote)
    HALF_OPEN --probe fail--> OPEN (stay degraded, timer restarts)

Every decision is host-side Python on the fleet's clock: a scripted
fault schedule and a fake clock drive every transition in tests.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional

from repro_torch.configs.base import SupervisorConfig
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor

_ENGINE = "engine"                  # the heartbeat worker id


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


@dataclasses.dataclass
class SupervisorEvent:
    """One telemetry transition: breaker open/close, rung demote/promote,
    probe outcomes."""
    tick: int
    event: str                      # "demote"|"probe"|"promote"|...
    rung_from: int
    rung_to: int
    reason: str = ""


class FleetSupervisor:
    """Breaker and degradation policy over a named fallback ladder.  It
    owns no engines: the fleet asks :meth:`select_rung` which rung serves
    the next tick and reports the outcome with :meth:`record_tick`."""

    def __init__(self, cfg: SupervisorConfig, ladder: List[str],
                 clock: Callable[[], float]):
        if not ladder:
            raise ValueError("supervisor needs at least one ladder rung")
        self.cfg = cfg
        self.ladder = list(ladder)
        self.clock = clock
        self.rung = 0
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.probe_successes = 0
        self._ticks_since_open = 0
        self.events: List[SupervisorEvent] = []
        self.n_tick_failures = 0
        self.n_quarantined = 0
        self.degraded_ticks = 0
        self.supervised_ticks = 0
        self.heartbeat = HeartbeatMonitor(
            [_ENGINE], timeout_s=cfg.heartbeat_timeout_s,
            straggler_factor=cfg.straggler_factor,
            patience=cfg.straggler_patience, clock=clock)

    @property
    def degraded(self) -> bool:
        return self.rung > 0

    def rung_name(self, rung: Optional[int] = None) -> str:
        return self.ladder[self.rung if rung is None else rung]

    def _log(self, tick: int, event: str, rung_from: int, rung_to: int,
             reason: str = "") -> None:
        self.events.append(SupervisorEvent(tick, event, rung_from,
                                           rung_to, reason))

    def select_rung(self, tick: int) -> int:
        """The rung that serves the tick about to be dispatched; once the
        degraded mode has absorbed ``half_open_after`` ticks, the ticks
        probe the rung above until an outcome lands."""
        if self.state is BreakerState.OPEN and self.rung > 0 \
                and self._ticks_since_open >= self.cfg.half_open_after:
            self.state = BreakerState.HALF_OPEN
            self._log(tick, "probe", self.rung, self.rung - 1,
                      "half-open probe")
        if self.state is BreakerState.HALF_OPEN and self.rung > 0:
            return self.rung - 1
        return self.rung

    def record_tick(self, tick: int, rung: int, ok: bool, wall_s: float,
                    reason: str = "") -> None:
        """The outcome of a harvested tick.  ``rung`` is what
        :meth:`select_rung` returned when the tick was dispatched: with
        two ticks in flight, a tick that ran above the current rung was a
        probe.  Also feeds the straggler monitor, whose flag counts as a
        failure."""
        self.supervised_ticks += 1
        probe = rung < self.rung
        if self.degraded and not probe:
            self.degraded_ticks += 1
        self.heartbeat.heartbeat(_ENGINE, step_time_s=wall_s)
        if ok and self.heartbeat.stragglers():
            ok, reason = False, "straggler"
            # one flag per trip: the breaker sees a fresh window after it
            self.heartbeat.workers[_ENGINE].step_times.clear()
        if not ok:
            self.n_tick_failures += 1

        if probe:
            if ok:
                self.probe_successes += 1
                if self.probe_successes >= self.cfg.recovery_threshold:
                    self._promote(tick)
            else:
                self.probe_successes = 0
                self.state = BreakerState.OPEN
                self._ticks_since_open = 0
                self._log(tick, "probe_failed", rung, self.rung, reason)
            return

        if self.state is BreakerState.OPEN:
            self._ticks_since_open += 1

        if ok:
            self.consecutive_failures = 0
            if self.state is BreakerState.OPEN and not self.degraded:
                # a trip on the floor rung (nowhere to demote): close
                # after the cooldown passes clean
                self.probe_successes += 1
                if (self._ticks_since_open >= self.cfg.half_open_after
                        and self.probe_successes
                        >= self.cfg.recovery_threshold):
                    self.probe_successes = 0
                    self.state = BreakerState.CLOSED
                    self._log(tick, "close", self.rung, self.rung,
                              "recovered")
            return
        self.consecutive_failures += 1
        if self.consecutive_failures >= self.cfg.breaker_threshold:
            self._open(tick, reason)

    def _open(self, tick: int, reason: str) -> None:
        self.consecutive_failures = 0
        self.probe_successes = 0
        self._ticks_since_open = 0
        self.state = BreakerState.OPEN
        if self.rung + 1 < len(self.ladder):
            self._log(tick, "demote", self.rung, self.rung + 1, reason)
            self.rung += 1
        else:
            # the floor rung: log the trip and keep serving
            self._log(tick, "breaker_floor", self.rung, self.rung, reason)

    def _promote(self, tick: int) -> None:
        self.probe_successes = 0
        self._ticks_since_open = 0
        self._log(tick, "promote", self.rung, self.rung - 1, "recovered")
        self.rung -= 1
        self.state = (BreakerState.CLOSED if self.rung == 0
                      else BreakerState.OPEN)

    def stats(self) -> dict:
        return {
            "breaker_state": self.state.value,
            "active_rung": self.rung,
            "active_backend": self.rung_name(),
            "tick_failures": self.n_tick_failures,
            "quarantined": self.n_quarantined,
            "degraded_ticks": self.degraded_ticks,
            "supervised_ticks": self.supervised_ticks,
            "transitions": [dataclasses.asdict(e) for e in self.events],
        }
