"""Malvar-He-Cutler linear demosaicing (paper §V-B.3), the counterpart of
``repro.isp.demosaic``: the exact 5x5 MHC filter bank on an RGGB mosaic,
each filter an explicit tap accumulation over the zero-padded mosaic
(zero taps skipped) in the reference's order, selected by Bayer phase.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# MHC filter bank (scaled by 1/8), copied from the reference.
# G at R/B locations:
_F_G = np.array([
    [0, 0, -1, 0, 0],
    [0, 0, 2, 0, 0],
    [-1, 2, 4, 2, -1],
    [0, 0, 2, 0, 0],
    [0, 0, -1, 0, 0]], np.float32) / 8.0

# R at G in R-row / B-column (and B at G in B-row):
_F_RB_ROW = np.array([
    [0, 0, 0.5, 0, 0],
    [0, -1, 0, -1, 0],
    [-1, 4, 5, 4, -1],
    [0, -1, 0, -1, 0],
    [0, 0, 0.5, 0, 0]], np.float32) / 8.0

# R at G in B-row / R-column:
_F_RB_COL = _F_RB_ROW.T.copy()

# R at B (and B at R):
_F_RB_DIAG = np.array([
    [0, 0, -1.5, 0, 0],
    [0, 2, 0, 2, 0],
    [-1.5, 0, 6, 0, -1.5],
    [0, 2, 0, 2, 0],
    [0, 0, -1.5, 0, 0]], np.float32) / 8.0

DEMOSAIC_RADIUS = 2


def _conv5_taps(padded: torch.Tensor, kernel: np.ndarray, h: int,
                w: int) -> torch.Tensor:
    """SAME 5x5 filter as a tap accumulation over padded [B, h+4, w+4]."""
    acc = torch.zeros((padded.shape[0], h, w), dtype=torch.float32,
                      device=padded.device)
    for dy in range(5):
        for dx in range(5):
            kv = float(kernel[dy, dx])
            if kv == 0.0:
                continue
            acc = acc + kv * padded[:, dy:dy + h, dx:dx + w]
    return acc


def bayer_phases(H: int, W: int, device=None, y0: int = 0, x0: int = 0):
    """RGGB phase masks (is_r, is_g1, is_g2, is_b), each [H, W] bool, of
    the H x W region whose top-left pixel sits at (y0, x0)."""
    yy, xx = torch.meshgrid(torch.arange(y0, y0 + H, device=device),
                            torch.arange(x0, x0 + W, device=device),
                            indexing="ij")
    ey, ex = (yy % 2 == 0), (xx % 2 == 0)
    return (ey & ex), (ey & ~ex), (~ey & ex), (~ey & ~ex)


def _mhc_filtered(padded: torch.Tensor, h: int, w: int, phases):
    """Filter bank and phase select on a zero-padded [B, h+4, w+4]
    mosaic: the one code path of :func:`demosaic_mhc` and
    :func:`demosaic_window`."""
    raw = padded[:, 2:2 + h, 2:2 + w]
    g_interp = _conv5_taps(padded, _F_G, h, w)
    rb_row = _conv5_taps(padded, _F_RB_ROW, h, w)
    rb_col = _conv5_taps(padded, _F_RB_COL, h, w)
    rb_diag = _conv5_taps(padded, _F_RB_DIAG, h, w)
    is_r, is_g1, is_g2, is_b = phases
    # green: native at G sites, interpolated at R/B
    g = torch.where(is_r | is_b, g_interp, raw)
    # red: native at R; row filter at G1, column filter at G2, diag at B
    r = torch.where(is_r, raw, torch.where(
        is_g1, rb_row, torch.where(is_g2, rb_col, rb_diag)))
    # blue: mirror of red
    b = torch.where(is_b, raw, torch.where(
        is_g2, rb_row, torch.where(is_g1, rb_col, rb_diag)))
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def demosaic_mhc(raw: torch.Tensor) -> torch.Tensor:
    """raw [B, H, W] RGGB mosaic in [0, 1] -> RGB [B, H, W, 3]."""
    _, H, W = raw.shape
    return _mhc_filtered(F.pad(raw, (2, 2, 2, 2)), H, W,
                         bayer_phases(H, W, raw.device))


def demosaic_window(win: torch.Tensor, p, *, y0: int, x0: int, bh: int,
                    bw: int, **_) -> torch.Tensor:
    """Windowed form for the fused path: ``win`` [B, bh+4, bw+4], a
    zero-padded window whose top-left interior pixel sits at mosaic
    coordinate (y0, x0) (the Bayer phase follows the absolute
    coordinates) -> the [B, bh, bw, 3] RGB tile, the same bits as the
    full-image form."""
    return _mhc_filtered(win, bh, bw,
                         bayer_phases(bh, bw, win.device, y0, x0))
