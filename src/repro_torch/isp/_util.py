"""Shared helpers of the batched ISP stages.

Every stage takes a batch of images — [B, H, W] Bayer mosaics or
[B, H, W, C] RGB — and parameters that are scalars or [B] vectors (one
value per image, as the reference gets by vmapping the per-image
pipeline).  Cyclic neighbourhoods are ``torch.roll`` over the image
dims (1, 2), the reference's ``jnp.roll`` over (0, 1).
"""
from __future__ import annotations

import torch


def bcast(v, x: torch.Tensor) -> torch.Tensor:
    """A scalar or [B] parameter shaped to broadcast against x [B, ...]."""
    v = torch.as_tensor(v, dtype=torch.float32, device=x.device)
    if v.dim() == 0:
        return v
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def roll2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``jnp.roll(img, (dy, dx), axis=(0, 1))`` for each image of x."""
    return torch.roll(x, (dy, dx), dims=(1, 2))
