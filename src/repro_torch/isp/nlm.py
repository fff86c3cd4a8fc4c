"""Non-local means denoising, FPGA-adapted (paper §V-B.4), the
counterpart of ``repro.isp.nlm``: a 7x7 search window, 3x3 box-filtered
patch distances on luminance, cyclic boundaries, summed in the
reference's order.  The luminance is the channel mean summed left to
right, an order the CUDA kernels replay (torch's ``mean`` on a card sums
in its own)."""
from __future__ import annotations

import functools
import operator

import torch

from repro_torch.isp._util import bcast, roll2

NLM_RADIUS = 4   # 3 (search radius) + 1 (patch radius)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box filter of x [B, H, W] via two separable cyclic passes."""
    x = x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
    x = x + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)
    return x / 9.0


def luminance(img: torch.Tensor) -> torch.Tensor:
    """The channel mean of img [..., C]: ((c0 + c1) + c2) / C."""
    return functools.reduce(operator.add, img.unbind(-1)) / img.shape[-1]


def nlm_bandwidth(strength, device) -> torch.Tensor:
    """The filter bandwidth ``h = 1e-3 + 0.2 * strength`` (float32, the
    shape of ``strength``: a scalar or [B])."""
    return 1e-3 + 0.2 * torch.as_tensor(strength, dtype=torch.float32,
                                        device=device)


def nlm_denoise(img: torch.Tensor, strength=0.1,
                search: int = 7) -> torch.Tensor:
    """img [B, H, W] or [B, H, W, C] in [0, 1]; strength scalar or [B]."""
    single = img.dim() == 3
    if single:
        img = img[..., None]
    h = bcast(nlm_bandwidth(strength, img.device), img[..., 0])
    r = search // 2
    lum = luminance(img)
    wsum = acc = None
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = roll2(img, dy, dx)
            d2 = _box3((lum - roll2(lum, dy, dx)) ** 2)
            w = torch.exp(-d2 / (h * h))
            wsum = w if wsum is None else wsum + w
            term = w[..., None] * shifted
            acc = term if acc is None else acc + term
    out = acc / torch.clamp(wsum[..., None], min=1e-9)
    return out[..., 0] if single else out


def nlm_window(win: torch.Tensor, p, *, bh: int, bw: int, **_):
    """Windowed form for the fused path: ``win`` [B, bh+8, bw+8, C], a
    wrap-padded window (the reference's cyclic roll) -> the denoised
    [B, bh, bw, C] tile.  Every roll is a slice and the 3x3 box filter
    keeps :func:`_box3`'s summation order."""
    R = NLM_RADIUS
    h = bcast(nlm_bandwidth(p["strength"], win.device), win[..., 0])
    lum = luminance(win)

    def box3_interior(e):
        # e [B, bh+2, bw+2] -> [B, bh, bw]; x + roll(x, 1) + roll(x, -1)
        # along the rows, then along the columns
        s = e[:, 1:-1] + e[:, 0:-2] + e[:, 2:]
        s = s[:, :, 1:-1] + s[:, :, 0:-2] + s[:, :, 2:]
        return s / 9.0

    # centre luminance over the patch-extended region [bh+2, bw+2]
    lum_c = lum[:, R - 1:R + bh + 1, R - 1:R + bw + 1]
    wsum = acc = None
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            # roll(a, (dy, dx))[y, x] == a[y - dy, x - dx]
            lum_s = lum[:, R - 1 - dy:R - 1 - dy + bh + 2,
                        R - 1 - dx:R - 1 - dx + bw + 2]
            d2 = box3_interior((lum_c - lum_s) ** 2)
            w = torch.exp(-d2 / (h * h))
            shifted = win[:, R - dy:R - dy + bh, R - dx:R - dx + bw]
            wsum = w if wsum is None else wsum + w
            term = w[..., None] * shifted
            acc = term if acc is None else acc + term
    return acc / torch.clamp(wsum[..., None], min=1e-9)
