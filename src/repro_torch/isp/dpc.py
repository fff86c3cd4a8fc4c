"""Dynamic defective pixel correction (paper §V-B.1), the counterpart of
``repro.isp.dpc``: each mosaic pixel is compared with its 8 same-colour
neighbours (distance 2, cyclic); a pixel beyond ``threshold`` from all
of them with one sign is replaced by their trimmed mean.

The full-image form and the windowed form of the fused path share
``_dpc_decide``, so both give the same bits; its neighbour sum is written
out left to right, an order the CUDA segment kernel replays."""
from __future__ import annotations

import functools
import operator

import torch

from repro_torch.isp._util import bcast, roll2

DPC_RADIUS = 2   # distance-2 same-colour neighbours -> 5x5 halo

# (dy, dx) of the 8 neighbours, in the reference's order
_OFFSETS = tuple((dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)
                 if not (dy == 0 and dx == 0))


def _dpc_decide(centre: torch.Tensor, nbs, threshold):
    """centre [B, h, w] and its 8 neighbours (a list of [B, h, w]) ->
    (corrected, defective mask)."""
    nb = torch.stack(nbs, dim=-1)
    diff = centre[..., None] - nb
    thr = bcast(threshold, diff)
    hot = (diff > thr).all(dim=-1)
    dead = (diff < -thr).all(dim=-1)
    defective = hot | dead
    # trimmed mean of the 8 neighbours (drop min and max)
    total = functools.reduce(operator.add, nbs)
    med = (total - nb.amin(dim=-1) - nb.amax(dim=-1)) / 6.0
    return torch.where(defective, med, centre), defective


def dpc_correct(raw: torch.Tensor, threshold=0.2):
    """raw [B, H, W] in [0, 1] -> (corrected, defective mask)."""
    return _dpc_decide(raw, [roll2(raw, dy, dx) for dy, dx in _OFFSETS],
                       threshold)


def dpc_window(win: torch.Tensor, p, *, bh: int, bw: int, **_):
    """Windowed form for the fused path: ``win`` [B, bh+4, bw+4], a
    wrap-padded window (the reference's cyclic roll) -> the corrected
    [B, bh, bw] tile."""
    r = DPC_RADIUS
    # roll(img, (dy, dx))[y, x] == img[y - dy, x - dx]
    nbs = [win[:, r - dy:r - dy + bh, r - dx:r - dx + bw]
           for dy, dx in _OFFSETS]
    return _dpc_decide(win[:, r:r + bh, r:r + bw], nbs, p["threshold"])[0]
