"""Heartbeat bookkeeping, straggler detection and the elastic restart
decision, the counterpart of ``repro.distributed.fault_tolerance``:
``WorkerState`` and ``HeartbeatMonitor`` (the serving supervisor's,
``repro_torch.serve.supervisor``), ``RestartPlan`` and ``plan_restart``.
Pure host-side Python on an injected clock, so a fake clock drives it
deterministically.

Straggler rule: a worker whose last ``patience`` step times all exceed
``straggler_factor`` x the median of every live worker's retained
window is flagged; a worker that stopped heartbeating for ``timeout_s``
is dead, and dead workers count on neither side.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass
class WorkerState:
    last_heartbeat: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)
    flagged: bool = False


class HeartbeatMonitor:
    def __init__(self, workers: List[str], timeout_s: float = 60.0,
                 straggler_factor: float = 2.0, patience: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.workers: Dict[str, WorkerState] = {
            w: WorkerState(last_heartbeat=clock()) for w in workers}
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.patience = patience
        self.clock = clock

    def heartbeat(self, worker: str, step_time_s: Optional[float] = None):
        st = self.workers[worker]
        st.last_heartbeat = self.clock()
        if step_time_s is not None:
            st.step_times.append(step_time_s)
            st.step_times = st.step_times[-16:]

    def dead_workers(self) -> Set[str]:
        now = self.clock()
        return {w for w, st in self.workers.items()
                if now - st.last_heartbeat > self.timeout_s}

    def stragglers(self) -> Set[str]:
        # the median over the full retained window of the live workers:
        # over only the last ``patience`` samples, a slowdown of a
        # single-worker monitor (the serving supervisor's) would move the
        # median to the very samples under test
        dead = self.dead_workers()
        alive = {w: st for w, st in self.workers.items() if w not in dead}
        all_times = [t for st in alive.values() for t in st.step_times]
        if not all_times:
            return set()
        med = sorted(all_times)[len(all_times) // 2]
        out = set()
        for w, st in alive.items():
            recent = st.step_times[-self.patience:]
            if len(recent) >= self.patience and \
                    all(t > self.straggler_factor * med for t in recent):
                out.add(w)
        return out

    def healthy_count(self) -> int:
        return len(self.workers) - len(self.dead_workers())


@dataclasses.dataclass
class RestartPlan:
    """What the runner does after failures are detected."""
    survivors: int
    new_mesh_shape: tuple
    restore_step: Optional[int]
    dropped_batches: int = 0   # deterministic data skipping on resume


def plan_restart(n_devices_alive: int, ckpt_latest: Optional[int],
                 model_parallel: int = 16,
                 steps_per_checkpoint: int = 100,
                 failed_step: Optional[int] = None) -> RestartPlan:
    """Elastic restart decision: the largest (data, model) mesh the
    survivors support, resuming from the newest checkpoint (data order
    stays deterministic: the loader is keyed on the step counter).

    ``failed_step`` (the step the run died at, when known) makes
    ``dropped_batches`` exact: ``failed_step - restore_step``.  Without
    it the plan takes the pessimistic bound ``restore_step %
    steps_per_checkpoint``, which is zero for a checkpoint-aligned
    restore step (so pass ``failed_step`` whenever it is known)."""
    if n_devices_alive <= 0:
        raise ValueError(
            f"cannot plan a restart with n_devices_alive="
            f"{n_devices_alive}; no surviving devices means a cold "
            f"restart, not an elastic reshard")
    mp = model_parallel
    while n_devices_alive % mp or mp < 1:
        mp //= 2
    mp = max(mp, 1)
    dp = n_devices_alive // mp
    restore = ckpt_latest
    if restore is None:
        dropped = 0
    elif failed_step is not None:
        if failed_step < restore:
            raise ValueError(
                f"failed_step={failed_step} precedes the restore "
                f"checkpoint at step {restore}")
        dropped = failed_step - restore
    else:
        dropped = restore % steps_per_checkpoint
    return RestartPlan(survivors=n_devices_alive,
                       new_mesh_shape=(dp, mp),
                       restore_step=restore,
                       dropped_batches=dropped)
