"""Non-local means denoising, FPGA-adapted (paper §V-B.4), the
counterpart of ``repro.isp.nlm``: a 7x7 search window, 3x3 box-filtered
patch distances on luminance, cyclic boundaries, summed in the
reference's order."""
from __future__ import annotations

import torch

from repro_torch.isp._util import bcast, roll2

NLM_RADIUS = 4   # 3 (search radius) + 1 (patch radius)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box filter of x [B, H, W] via two separable cyclic passes."""
    x = x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
    x = x + torch.roll(x, 1, 2) + torch.roll(x, -1, 2)
    return x / 9.0


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
    lum = img.mean(dim=-1)
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
