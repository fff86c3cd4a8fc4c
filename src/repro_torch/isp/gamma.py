"""Gamma LUT and YCbCr luma sharpening (paper §V-B.5), the counterpart
of ``repro.isp.gamma``."""
from __future__ import annotations

import torch

from repro_torch.isp._util import bcast

LUT_SIZE = 256

_RGB2YCBCR = torch.tensor([[0.299, 0.587, 0.114],
                           [-0.168736, -0.331264, 0.5],
                           [0.5, -0.418688, -0.081312]], dtype=torch.float32)
_YCC_OFFSET = torch.tensor([0.0, 0.5, 0.5], dtype=torch.float32)


def _lut_axis(device=None) -> torch.Tensor:
    """The reference's ``jnp.linspace(0, 1, 256)``: XLA evaluates it as
    ``i * float32(1/255)`` with the endpoint set to 1, which differs from
    ``torch.linspace`` in the last bit of some entries."""
    i = torch.arange(LUT_SIZE - 1, dtype=torch.float32, device=device)
    step = torch.tensor(1.0 / (LUT_SIZE - 1), dtype=torch.float32,
                        device=device)
    return torch.cat([i * step, torch.ones(1, device=device)])


def gamma_lut(gamma, device=None) -> torch.Tensor:
    """out = in^(1/gamma): gamma scalar -> [256], or [B] -> [B, 256]."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=device)
    inv = 1.0 / torch.clamp(g, min=1e-3)
    return _lut_axis(device) ** inv[..., None]


def apply_gamma(rgb: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Linear-interpolated LUT lookup; lut [256] or [B, 256] for rgb
    [B, ...]."""
    B = rgb.shape[0]
    lut = lut.expand(B, LUT_SIZE)
    scaled = rgb * (LUT_SIZE - 1)
    idx = torch.clamp(scaled.to(torch.int32), 0, LUT_SIZE - 1)
    frac = scaled - idx
    flat = idx.reshape(B, -1).to(torch.int64)
    lo = torch.gather(lut, 1, flat).reshape(rgb.shape)
    hi = torch.gather(lut, 1, torch.clamp(flat + 1, max=LUT_SIZE - 1))
    return lo + frac * (hi.reshape(rgb.shape) - lo)


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    m = _RGB2YCBCR.to(rgb.device)
    return torch.einsum("...c,dc->...d", rgb, m) + _YCC_OFFSET.to(rgb.device)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    ycc = ycc - _YCC_OFFSET.to(ycc.device)
    inv = torch.linalg.inv(_RGB2YCBCR).to(ycc.device)
    return torch.clamp(torch.einsum("...c,dc->...d", ycc, inv), 0.0, 1.0)


def sharpen_luma(rgb: torch.Tensor, amount) -> torch.Tensor:
    """Luminance sharpening in YCbCr, 5-point cyclic cross blur."""
    ycc = rgb_to_ycbcr(rgb)
    y = ycc[..., 0]
    blur = (y + torch.roll(y, 1, 1) + torch.roll(y, -1, 1)
            + torch.roll(y, 1, 2) + torch.roll(y, -1, 2)) / 5.0
    y2 = torch.clamp(y + bcast(amount, y) * (y - blur), 0.0, 1.0)
    ycc = torch.cat([y2[..., None], ycc[..., 1:]], dim=-1)
    return ycbcr_to_rgb(ycc)
