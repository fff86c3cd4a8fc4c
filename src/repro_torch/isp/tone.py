"""Tone-mapping and colour-matrix stages, the counterpart of
``repro.isp.tone`` (registry extensions, not in the default ordering)."""
from __future__ import annotations

import torch

from repro_torch.isp._util import bcast
from repro_torch.isp.gamma import _RGB2YCBCR

_LUMA = _RGB2YCBCR[0]                                    # BT.601 luma row


def reinhard_tonemap(rgb: torch.Tensor, strength) -> torch.Tensor:
    """Global Reinhard ``y = x (1+k) / (x+k)``, knee k from strength."""
    k = bcast(1.0 / (1e-3 + 4.0 * torch.as_tensor(
        strength, dtype=torch.float32, device=rgb.device)), rgb)
    return torch.clamp(rgb * (1.0 + k) / (rgb + k), 0.0, 1.0)


def apply_saturation(rgb: torch.Tensor, saturation) -> torch.Tensor:
    """Luma-preserving saturation: 1 is identity, 0 greyscale."""
    lum = torch.einsum("...c,c->...", rgb, _LUMA.to(rgb.device))[..., None]
    return torch.clamp(lum + bcast(saturation, rgb) * (rgb - lum), 0.0, 1.0)
