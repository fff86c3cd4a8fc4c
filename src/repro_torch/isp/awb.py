"""Auto white balance (paper §V-B.2), the counterpart of
``repro.isp.awb``: grey-world gains from well-exposed pixels, softly
blended by the NPU's ``enable`` and biased by its r/b corrections."""
from __future__ import annotations

import torch

from repro_torch.isp._util import bcast


def awb_gains(rgb: torch.Tensor, lo: float = 0.05,
              hi: float = 0.95) -> torch.Tensor:
    """Grey-world gains per image. rgb [B, H, W, 3] -> [B, 3]."""
    lum = rgb.mean(dim=-1, keepdim=True)
    ok = ((lum > lo) & (lum < hi)).to(rgb.dtype)
    n = torch.clamp(ok.sum(dim=(1, 2, 3)), min=1.0)
    means = (rgb * ok).sum(dim=(1, 2)) / n[:, None]
    g = means[:, 1]
    return torch.stack([g / torch.clamp(means[:, 0], min=1e-6),
                        torch.ones_like(g),
                        g / torch.clamp(means[:, 2], min=1e-6)], dim=-1)


def awb_apply_stats(rgb: torch.Tensor, p, stats: torch.Tensor):
    """Apply grey-world gains ``stats`` [B, 3] with the enable blend and
    the r/b bias, in the reference's op order."""
    enable = bcast(p["enable"], stats)
    gains = enable * stats + (1.0 - enable) * torch.ones(3, device=rgb.device)
    bias_r = bcast(p["bias_r"], stats[:, 0])
    bias_b = bcast(p["bias_b"], stats[:, 0])
    bias = torch.stack(torch.broadcast_tensors(
        bias_r, torch.ones_like(bias_r), bias_b), dim=-1)
    gains = gains * bias
    return torch.clamp(rgb * gains[:, None, None, :], 0.0, 1.0)


# The fused path splits AWB into one global stats pass on the stage's
# materialised input and the pointwise awb_apply_stats inside a segment.
AWB_STATS_WIDTH = 3   # grey-world gains (r, g, b)


def awb_stats(rgb: torch.Tensor, p) -> torch.Tensor:
    """Global stats pass: [B, H, W, 3] -> the [B, 3] grey-world gains."""
    return awb_gains(rgb)
