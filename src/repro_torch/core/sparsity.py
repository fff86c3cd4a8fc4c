"""Spike-sparsity metrics, the counterpart of ``repro.core.sparsity``."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F


class SparsityTape:
    """Collects per-layer spike rates during a forward pass (device
    scalars, read back with the tick's outputs)."""

    def __init__(self):
        self.records: List[Tuple[str, torch.Tensor]] = []

    def record(self, name: str, spikes: torch.Tensor):
        self.records.append((name, spikes.mean()))

    def rates(self) -> Dict[str, torch.Tensor]:
        return dict(self.records)

    def network_sparsity(self) -> torch.Tensor:
        """1 - mean firing rate across recorded layers."""
        rs = [r for _, r in self.records]
        return 1.0 - sum(rs) / max(len(rs), 1)


def activity_sparsity(spike_tensors: List[torch.Tensor]) -> torch.Tensor:
    """1 - mean firing rate across all given layers."""
    rates = [s.mean() for s in spike_tensors]
    return 1.0 - sum(rates) / max(len(rates), 1)


def tile_skip_fraction(spikes: torch.Tensor, tile: int = 128) -> torch.Tensor:
    """Fraction of flattened length-``tile`` activation tiles that are
    all zero.  A ragged tail counts as one zero-padded partial tile (a
    silent tail is skippable, a live one is not)."""
    flat = spikes.reshape(-1)
    pad = (-flat.shape[0]) % tile
    if pad:
        flat = F.pad(flat, (0, pad))
    tiles = flat.reshape(-1, tile)
    return (tiles == 0).all(dim=-1).to(torch.float32).mean()
