"""A batch of synthetic GEN1-like scenes, the counterpart of
``repro.data.synthetic.SceneBatch``: DVS events, the Bayer frame, the
detection ground truth and the clean image the cognitive loss compares
with.  Scenes come across from the reference's generator
(``repro_torch.convert.scene_from_numpy``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.encoding import EventStream


class SceneBatch(NamedTuple):
    events: EventStream      # leaves [B, N]
    bayer: torch.Tensor      # [B, H, W] RGGB mosaic (noisy, miscoloured)
    boxes: torch.Tensor      # [B, M, 5] (cls, cx, cy, w, h) normalised
    valid: torch.Tensor      # [B, M] bool
    clean_rgb: torch.Tensor  # [B, H, W, 3] ground-truth image (for PSNR)
