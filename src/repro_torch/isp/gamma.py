"""Gamma LUT and YCbCr luma sharpening (paper §V-B.5), the counterpart
of ``repro.isp.gamma``."""
from __future__ import annotations

import functools

import torch

from repro_torch.isp._util import bcast

LUT_SIZE = 256

_RGB2YCBCR = torch.tensor([[0.299, 0.587, 0.114],
                           [-0.168736, -0.331264, 0.5],
                           [0.5, -0.418688, -0.081312]], dtype=torch.float32)
_YCC_OFFSET = torch.tensor([0.0, 0.5, 0.5], dtype=torch.float32)
_YCBCR_INV = torch.linalg.inv(_RGB2YCBCR)


@functools.lru_cache(maxsize=None)
def _ycc_consts(device=None):
    """(the BT.601 matrix, its inverse, the chroma offset) on ``device``,
    copied there once per device (constants: callers do not modify
    them), so a tick copies nothing from the host for them.  The inverse
    is taken once, in float32 on the host."""
    return tuple(c.to(device) for c in (_RGB2YCBCR, _YCBCR_INV,
                                        _YCC_OFFSET))


@functools.lru_cache(maxsize=None)
def _lut_axis(device=None) -> torch.Tensor:
    """The reference's ``jnp.linspace(0, 1, 256)``: XLA evaluates it as
    ``i * float32(1/255)`` with the endpoint set to 1, which differs from
    ``torch.linspace`` in the last bit of some entries.  Built on the
    device once per device (a constant: callers do not modify it), so a
    tick copies nothing from the host for it."""
    i = torch.arange(LUT_SIZE - 1, dtype=torch.float32, device=device)
    step = torch.full((), 1.0 / (LUT_SIZE - 1), dtype=torch.float32,
                      device=device)
    return torch.cat([i * step, torch.ones(1, device=device)])


def gamma_lut(gamma, device=None) -> torch.Tensor:
    """out = in^(1/gamma): gamma scalar -> [256], or [B] -> [B, 256]."""
    g = torch.as_tensor(gamma, dtype=torch.float32, device=device)
    device = g.device
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
    m, _, off = _ycc_consts(rgb.device)
    return torch.einsum("...c,dc->...d", rgb, m) + off


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    _, inv, off = _ycc_consts(ycc.device)
    ycc = ycc - off
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


SHARPEN_RADIUS = 1   # 5-point cross blur on the luma plane

# The array constants of the windowed form, passed to the fused segment
# as inputs: the BT.601 matrix, the chroma offset and its inverse.
SHARPEN_CONSTS = (_RGB2YCBCR, _YCC_OFFSET, _YCBCR_INV)


def sharpen_window(win: torch.Tensor, p, *, bh: int, bw: int,
                   consts=SHARPEN_CONSTS, **_) -> torch.Tensor:
    """Windowed form for the fused path: ``win`` [B, bh+2, bw+2, 3], a
    wrap-padded window (the reference's cyclic roll) -> the sharpened
    [B, bh, bw, 3] tile, in :func:`sharpen_luma`'s op order."""
    mat, off, inv = (c.to(win.device) for c in consts)
    ycc = torch.einsum("...c,dc->...d", win, mat) + off
    y = ycc[..., 0]
    # roll(y, 1)[i] == y[i - 1]: the up/down/left/right fold order
    y_c = y[:, 1:-1, 1:-1]
    blur = (y_c + y[:, 0:-2, 1:-1] + y[:, 2:, 1:-1]
            + y[:, 1:-1, 0:-2] + y[:, 1:-1, 2:]) / 5.0
    y2 = torch.clamp(y_c + bcast(p["amount"], y_c) * (y_c - blur), 0.0, 1.0)
    ycc_c = torch.cat([y2[..., None], ycc[:, 1:-1, 1:-1, 1:]], dim=-1) - off
    return torch.clamp(torch.einsum("...c,dc->...d", ycc_c, inv), 0.0, 1.0)
