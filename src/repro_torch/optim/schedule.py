"""LR schedules as functions of the step counter, the counterpart of
``repro.optim.schedule``: float32 arithmetic on a step tensor."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup: int = 100, total: int = 10000,
                  min_ratio: float = 0.1):
    """Linear warmup over ``warmup`` steps, then a cosine from ``base_lr``
    down to ``min_ratio * base_lr`` at ``total``."""
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) *
                         0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return schedule
