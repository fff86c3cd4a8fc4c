"""Request lifecycle for continuous-batching perception serving, the
counterpart of ``repro.serve.scheduler``: admission control,
per-request deadlines and telemetry.  Pure host-side Python.

* ``deadline_ms`` is measured from enqueue.  A queued request whose
  deadline passes before a slot frees up is shed (status ``EXPIRED``,
  ``result`` stays None) instead of occupying a slot.
* A request that made it into a tick always completes; if it lands
  after its deadline it is still delivered but flagged
  ``telemetry.deadline_missed``.
* Admission control is a bounded queue: a submit beyond ``max_queue``
  gets status ``REJECTED`` at once.

Telemetry records the four lifecycle timestamps (enqueue -> admit ->
dispatch -> deliver) on every request and rides back on
``PerceptionResult.telemetry``.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Deque, List, Optional


class RequestStatus(enum.Enum):
    QUEUED = "queued"          # admitted to the bounded queue
    REJECTED = "rejected"      # queue full at submit (admission control)
    IN_FLIGHT = "in_flight"    # packed into a dispatched tick
    DONE = "done"              # result delivered
    EXPIRED = "expired"        # deadline passed while queued: shed
    FAILED = "failed"          # malformed payload, quarantined output,
                               # or a tick failure with retries exhausted


@dataclasses.dataclass
class RequestTelemetry:
    """Lifecycle timestamps (seconds on the serving clock) and
    deadline/resilience accounting."""
    t_enqueue: float = 0.0
    t_admit: float = 0.0       # packed into a staging slot
    t_dispatch: float = 0.0    # tick launched (compute start)
    t_deliver: float = 0.0     # result fetched back to the host
    deadline_missed: bool = False
    n_retries: int = 0         # re-dispatches after transient failures
    n_hedges: int = 0          # hedged duplicates launched past the SLO
    hedge_won: bool = False    # the hedge copy delivered first
    quarantined: bool = False  # a non-finite result was caught en route
    rung: Optional[str] = None  # ladder rung that served the delivery

    @property
    def latency_s(self) -> float:
        """Submit-to-delivery wall time (the SLO axis)."""
        return self.t_deliver - self.t_enqueue

    @property
    def queue_s(self) -> float:
        return self.t_admit - self.t_enqueue

    @property
    def compute_s(self) -> float:
        return self.t_deliver - self.t_dispatch


@dataclasses.dataclass
class ServeRequest:
    """A ``PerceptionRequest`` wrapped with serving state.  ``deadline``
    is an absolute clock value (None: no deadline).  ``attempts`` counts
    dispatches (the retry budget compares against it), ``not_before`` is
    the absolute backoff gate a retried request waits behind, ``error``
    the terminal failure reason, and ``primary`` links a hedged duplicate
    back to the client-held request (the duplicate is never returned to
    the client; first delivery wins)."""
    request: "object"                       # PerceptionRequest
    deadline: Optional[float] = None
    kind: str = "voxels"                    # staging path: voxels|events
    status: RequestStatus = RequestStatus.QUEUED
    telemetry: RequestTelemetry = dataclasses.field(
        default_factory=RequestTelemetry)
    attempts: int = 0                       # dispatch count
    not_before: float = 0.0                 # retry backoff gate (abs clock)
    error: Optional[str] = None             # terminal failure reason
    primary: Optional["ServeRequest"] = None  # set on hedge copies only
    hedge: Optional["ServeRequest"] = None  # the live copy, on primaries
    parked: bool = False                    # retries exhausted; outcome
                                            # rides on the live hedge

    @property
    def rid(self):
        return self.request.rid

    @property
    def is_hedge(self) -> bool:
        return self.primary is not None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


class AdmissionQueue:
    """Bounded FIFO with deadline shedding, driven by the caller's
    ``now`` (a fake clock in tests)."""

    def __init__(self, max_depth: int):
        if max_depth < 1:
            raise ValueError(f"max_depth must be >= 1, got {max_depth}")
        self.max_depth = max_depth
        self._q: Deque[ServeRequest] = collections.deque()
        self.n_rejected = 0
        self.n_expired = 0

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, sreq: ServeRequest, now: float,
              requeue: bool = False) -> bool:
        """Admit or reject (bounded depth).  Stamps ``t_enqueue`` except
        on a retry's re-offer (``requeue=True``), which keeps the original
        enqueue time so latency charges the whole retry journey."""
        if not requeue:
            sreq.telemetry.t_enqueue = now
        if len(self._q) >= self.max_depth:
            sreq.status = RequestStatus.REJECTED
            self.n_rejected += 1
            return False
        sreq.status = RequestStatus.QUEUED
        self._q.append(sreq)
        return True

    def shed_expired(self, now: float) -> List[ServeRequest]:
        """Drop every queued request whose deadline has passed (from
        anywhere in the queue) and return them with status ``EXPIRED``."""
        shed = [r for r in self._q if r.expired(now)]
        if shed:
            self._q = collections.deque(
                r for r in self._q if not r.expired(now))
            for r in shed:
                r.status = RequestStatus.EXPIRED
            self.n_expired += len(shed)
        return shed

    def discard(self, sreq: ServeRequest) -> bool:
        """Take ``sreq`` out of the queue wherever it waits (a retry that
        was settled meanwhile); False when it is not queued."""
        try:
            self._q.remove(sreq)
        except ValueError:
            return False
        return True

    def pop_ready(self, now: float) -> Optional[ServeRequest]:
        """The next request whose retry gate has passed (``not_before <=
        now``), FIFO among the ready; requests still backing off keep
        their place.  None when nothing is ready."""
        for i, sreq in enumerate(self._q):
            if sreq.not_before <= now:
                del self._q[i]
                return sreq
        return None
