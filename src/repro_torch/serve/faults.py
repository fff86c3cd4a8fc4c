"""Deterministic fault injection for the fleet, the counterpart of
``repro.serve.faults``.  A :class:`FaultPlan` is an explicit per-(tick,
slot) event list expanded from a :class:`FaultConfig` seed; a
:class:`FaultInjector` applies it at the ``EngineCore`` boundary
(``upload`` / ``dispatch`` / ``fetch``), so the ``FleetEngine`` and
``FleetSupervisor`` under test are the real serving code.

* ``CORRUPT_INPUT``: NaN poison written into one staged voxel slot just
  before the host->device upload.
* ``NAN_OUTPUT``: NaN/Inf forced into one slot of the fetched NPU
  outputs; the supervisor's NaN guard must quarantine it.
* ``TRANSIENT_ERROR``: the tick raises :class:`TransientTickError` at
  harvest (retryable).
* ``STALL``: the harvest stalls ``stall_s`` past dispatch (a real clock
  sleeps; tests pass an ``advance`` hook that moves a fake clock).
* ``MALFORMED``: the client edge submits a structurally invalid request;
  not applied by the injector (a chaos run consults ``plan.malformed_at``
  and submits :func:`make_malformed_request`).

``FaultPlan.from_config(cfg, n_ticks, batch)`` depends only on its
arguments and draws exactly as the reference does, so a seed gives the
reference's schedule.  Only :class:`TransientTickError` is a fault the
fleet retries: any other error of a core (a kernel that fails to build
or launch) propagates.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, Iterable, List, Optional, Set

import numpy as np

from repro_torch.configs.base import FaultConfig


class FaultKind(str, enum.Enum):
    CORRUPT_INPUT = "corrupt_input"
    NAN_OUTPUT = "nan_output"
    TRANSIENT_ERROR = "transient_error"
    STALL = "stall"
    MALFORMED = "malformed"


class TransientTickError(RuntimeError):
    """A tick failure the supervisor may retry (launch failure, transfer
    error, preempted accelerator)."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``slot`` targets one staging slot for the
    slot-scoped kinds (None for whole-tick kinds); ``value`` is the
    poison (NaN or +-inf)."""
    tick: int
    kind: FaultKind
    slot: Optional[int] = None
    value: float = float("nan")
    stall_s: float = 0.0


class FaultPlan:
    """An explicit, immutable injection schedule keyed on tick."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self._by_tick: Dict[int, List[FaultEvent]] = {}
        for ev in events:
            self._by_tick.setdefault(ev.tick, []).append(ev)

    @classmethod
    def from_config(cls, cfg: FaultConfig, n_ticks: int,
                    batch: int) -> "FaultPlan":
        """The seeded config's event list: per tick, one draw per kind in
        a fixed kind order (a hit, a slot, a poison), so the schedule is
        a function of (seed, n_ticks, batch) and a longer horizon keeps
        the earlier ticks."""
        rng = np.random.default_rng(cfg.seed)
        events: List[FaultEvent] = []
        for tick in range(n_ticks):
            for kind, p in ((FaultKind.CORRUPT_INPUT, cfg.p_corrupt_input),
                            (FaultKind.NAN_OUTPUT, cfg.p_nan_output),
                            (FaultKind.TRANSIENT_ERROR, cfg.p_transient),
                            (FaultKind.STALL, cfg.p_stall),
                            (FaultKind.MALFORMED, cfg.p_malformed)):
                hit = rng.random() < p
                slot = int(rng.integers(0, max(batch, 1)))
                poison = (float("inf")
                          if rng.random() < cfg.inf_fraction
                          else float("nan"))
                if not hit:
                    continue            # the draws above keep the stream
                if kind in (FaultKind.CORRUPT_INPUT, FaultKind.NAN_OUTPUT):
                    events.append(FaultEvent(tick, kind, slot=slot,
                                             value=poison))
                elif kind is FaultKind.STALL:
                    events.append(FaultEvent(tick, kind,
                                             stall_s=cfg.stall_ms / 1e3))
                else:
                    events.append(FaultEvent(tick, kind))
        return cls(events)

    def events_at(self, tick: int) -> List[FaultEvent]:
        return self._by_tick.get(tick, [])

    def malformed_at(self, tick: int) -> bool:
        return any(ev.kind is FaultKind.MALFORMED
                   for ev in self.events_at(tick))

    def kinds(self) -> Set[FaultKind]:
        return {ev.kind for evs in self._by_tick.values() for ev in evs}

    def __len__(self) -> int:
        return sum(len(v) for v in self._by_tick.values())

    def __iter__(self):
        for tick in sorted(self._by_tick):
            yield from self._by_tick[tick]


class _SharedTicker:
    """One dispatch counter shared by every injector of a fleet, so the
    schedule stays tick-aligned across ladder rungs."""

    def __init__(self):
        self.tick = 0


class FaultInjector:
    """Wraps one ``EngineCore`` with the plan.  Every attribute the fleet
    reads delegates to the wrapped core; only ``upload`` / ``dispatch``
    / ``fetch`` are intercepted.  The rungs of a ladder share one
    :class:`_SharedTicker`, so the tick index is the fleet's."""

    def __init__(self, core, plan: FaultPlan,
                 ticker: Optional[_SharedTicker] = None,
                 advance: Optional[Callable[[float], None]] = None):
        self._core = core
        self._plan = plan
        self._ticker = ticker if ticker is not None else _SharedTicker()
        # how a STALL manifests: a real deployment blocks (sleep); tests
        # advance their fake serving clock instead
        self._advance = advance if advance is not None else time.sleep
        self.n_injected = 0

    def __getattr__(self, name):
        return getattr(self._core, name)

    def upload(self, bank):
        tick = self._ticker.tick
        for ev in self._plan.events_at(tick):
            if ev.kind is FaultKind.CORRUPT_INPUT:
                bank.fill_voxels(ev.slot % bank.batch, ev.value)
                self.n_injected += 1
        return self._core.upload(bank)

    def dispatch(self, dev_views):
        tick = self._ticker.tick
        self._ticker.tick += 1
        return (tick, self._core.dispatch(dev_views))

    def fetch(self, outputs):
        tick, real = outputs
        faults = self._plan.events_at(tick)
        for ev in faults:
            if ev.kind is FaultKind.TRANSIENT_ERROR:
                self.n_injected += 1
                raise TransientTickError(
                    f"injected transient failure at tick {tick}")
        out, rgb, sp = self._core.fetch(real)
        for ev in faults:
            if ev.kind is FaultKind.STALL:
                self.n_injected += 1
                self._advance(ev.stall_s)
            elif ev.kind is FaultKind.NAN_OUTPUT:
                self.n_injected += 1
                slot = ev.slot % out.raw_pred.shape[0]
                raw = np.array(out.raw_pred)
                ctl = np.array(out.control)
                raw[slot] = ev.value
                ctl[slot] = ev.value
                out = out._replace(raw_pred=raw, control=ctl)
        return out, rgb, sp


def make_malformed_request(rid: int, seed: int = 0):
    """A structurally invalid :class:`PerceptionRequest`: variants cycle
    on (rid, seed) -- no payload, voxels without a bayer frame, rank
    garbage, a wrong voxel grid -- each of which validation must catch
    before the serving loop stages it."""
    from repro_torch.serve.cognitive_engine import PerceptionRequest
    variant = (rid + seed) % 4
    if variant == 0:                       # neither voxels nor events
        return PerceptionRequest(rid=rid)
    if variant == 1:                       # voxels but no bayer frame
        return PerceptionRequest(
            rid=rid, voxels=np.zeros((1, 2, 2, 2), np.float32))
    if variant == 2:                       # rank garbage
        return PerceptionRequest(
            rid=rid, voxels=np.zeros((3,), np.float32),
            bayer=np.zeros((4, 4), np.float32))
    return PerceptionRequest(               # wrong voxel grid shape
        rid=rid, voxels=np.zeros((1, 1, 1, 7), np.float32),
        bayer=np.zeros((4, 4), np.float32))
