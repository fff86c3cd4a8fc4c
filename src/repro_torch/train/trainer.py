"""The training loop, the counterpart of ``repro.train.trainer``:
checkpoints, resume, heartbeats, data order keyed on the step counter.
Each step beats the trainer's own :class:`HeartbeatMonitor` (worker
``"worker0"``) with its host seconds, so ``trainer.monitor.stragglers()``
flags a run whose steps slow down.

Metrics stay on the device between log points: reading a value each step
would synchronise with the card every step.  They are drained to the
host, in one copy, only at log points and at the end.  Each step's record
holds its metrics, ``step``, ``dt_s`` (host seconds of the step, data
included) and ``data_s`` (host seconds of ``data_fn``); ``drain_s`` sums
the drains' host seconds, which include waiting for the card.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor

LOGGED = ("loss", "ce", "grad_norm", "recon")


class Trainer:
    def __init__(self, step_fn: Callable, state: Any,
                 data_fn: Callable[[int], Any],
                 ckpt: Optional[CheckpointManager] = None,
                 ckpt_every: int = 100,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print):
        self.step_fn = step_fn
        self.state = state
        self.data_fn = data_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.monitor = HeartbeatMonitor(["worker0"])
        self.log_every = log_every
        self.log = log_fn
        self.history: list = []
        self.drain_s = 0.0

    def maybe_resume(self) -> int:
        """Restore the newest checkpoint if one exists; the start step."""
        if self.ckpt is None:
            return 0
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        self.state = self.ckpt.restore(latest, like=self.state)
        self.log(f"[trainer] resumed from step {latest}")
        return latest

    def _drain(self, pending) -> None:
        """Move buffered on-device metrics into ``history``: every tensor
        of every pending step in one device-to-host copy."""
        t0 = time.monotonic()
        tensors = [v for *_, m in pending for v in m.values()
                   if isinstance(v, torch.Tensor)]
        values = iter(torch.stack([v.detach().float().reshape(())
                                   for v in tensors]).cpu().tolist()
                      if tensors else [])
        for step, dt, data_s, metrics in pending:
            rec = {k: next(values) if isinstance(v, torch.Tensor)
                   else float(v) for k, v in metrics.items()}
            rec.update(step=step, dt_s=dt, data_s=data_s)
            self.history.append(rec)
        pending.clear()
        self.drain_s += time.monotonic() - t0

    def run(self, num_steps: int, start_step: Optional[int] = None) -> Any:
        step0 = self.maybe_resume() if start_step is None else start_step
        pending: list = []
        for step in range(step0, num_steps):
            t0 = time.monotonic()
            batch = self.data_fn(step)      # deterministic in step
            t1 = time.monotonic()
            self.state, metrics = self.step_fn(self.state, batch)
            dt = time.monotonic() - t0
            self.monitor.heartbeat("worker0", step_time_s=dt)
            pending.append((step, dt, t1 - t0, metrics))
            if step % self.log_every == 0:
                self._drain(pending)
                rec = self.history[-1]
                msg = " ".join(f"{k}={v:.4f}" for k, v in rec.items()
                               if k in LOGGED)
                self.log(f"[trainer] step={step} {msg} ({dt:.2f}s)")
            if self.ckpt is not None and (step + 1) % self.ckpt_every == 0:
                self.ckpt.save(step + 1, self.state)
        self._drain(pending)
        if self.ckpt is not None:
            self.ckpt.save(num_steps, self.state, blocking=True)
        return self.state
