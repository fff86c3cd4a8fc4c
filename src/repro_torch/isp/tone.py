"""Tone-mapping and colour-matrix stages, the counterpart of
``repro.isp.tone`` (registry extensions, not in the default ordering)."""
from __future__ import annotations

import functools

import torch

from repro_torch.isp._util import bcast
from repro_torch.isp.gamma import _RGB2YCBCR

_LUMA = _RGB2YCBCR[0]                                    # BT.601 luma row


@functools.lru_cache(maxsize=None)
def _luma_row(device=None) -> torch.Tensor:
    """The luma row on ``device``, copied there once per device."""
    return _LUMA.to(device)


def reinhard_tonemap(rgb: torch.Tensor, strength) -> torch.Tensor:
    """Global Reinhard ``y = x (1+k) / (x+k)``, knee k from strength."""
    k = bcast(1.0 / (1e-3 + 4.0 * torch.as_tensor(
        strength, dtype=torch.float32, device=rgb.device)), rgb)
    return torch.clamp(rgb * (1.0 + k) / (rgb + k), 0.0, 1.0)


def _luma(rgb: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """rgb [..., 3] . row [3] (on rgb's device) summed left to right,
    [..., 1] (an order the fused CUDA kernel replays; an einsum's GEMM
    sums in its own)."""
    return (rgb[..., 0] * row[0] + rgb[..., 1] * row[1]
            + rgb[..., 2] * row[2])[..., None]


def apply_saturation(rgb: torch.Tensor, saturation) -> torch.Tensor:
    """Luma-preserving saturation: 1 is identity, 0 greyscale."""
    lum = _luma(rgb, _luma_row(rgb.device))
    return torch.clamp(lum + bcast(saturation, rgb) * (rgb - lum), 0.0, 1.0)


# The fused form: the luma row is an array constant, passed to the fused
# segment as an input; same op order as apply_saturation.
CCM_CONSTS = (_LUMA,)


def apply_saturation_tile(rgb: torch.Tensor, p,
                          consts=CCM_CONSTS) -> torch.Tensor:
    lum = _luma(rgb, consts[0])
    return torch.clamp(lum + bcast(p["saturation"], rgb) * (rgb - lum),
                       0.0, 1.0)
