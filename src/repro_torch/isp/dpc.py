"""Dynamic defective pixel correction (paper §V-B.1), the counterpart of
``repro.isp.dpc``: each mosaic pixel is compared with its 8 same-colour
neighbours (distance 2, cyclic); a pixel beyond ``threshold`` from all
of them with one sign is replaced by their trimmed mean."""
from __future__ import annotations

import torch

from repro_torch.isp._util import bcast, roll2

DPC_RADIUS = 2


def _same_color_neighbours(img: torch.Tensor) -> torch.Tensor:
    """img [B, H, W] -> [B, H, W, 8] distance-2 neighbours."""
    return torch.stack([roll2(img, dy, dx)
                        for dy in (-2, 0, 2) for dx in (-2, 0, 2)
                        if not (dy == 0 and dx == 0)], dim=-1)


def dpc_correct(raw: torch.Tensor, threshold=0.2):
    """raw [B, H, W] in [0, 1] -> (corrected, defective mask)."""
    nb = _same_color_neighbours(raw)
    diff = raw[..., None] - nb
    thr = bcast(threshold, diff)
    hot = (diff > thr).all(dim=-1)
    dead = (diff < -thr).all(dim=-1)
    defective = hot | dead
    # trimmed mean of the 8 neighbours (drop min and max)
    med = (nb.sum(dim=-1) - nb.amin(dim=-1) - nb.amax(dim=-1)) / 6.0
    return torch.where(defective, med, raw), defective
