"""Dispatch of the spiking layers onto the kernels — the counterpart of
``repro.kernels.ops`` on the untuned launch defaults (per-layer
composition, ``gate="mask"`` for convs, in-kernel gate for the spike
matmul).  A shape-keyed launch table is later work.

Each op reshapes between the layers' [T, B, ...] layout and the flat
shapes a kernel takes; the kernel wrappers in ``spike_conv``,
``lif_scan`` and ``spike_matmul`` take their plain versions for CPU
tensors and launch the CUDA kernels for CUDA tensors.  Forward only:
the backward kernels come with training.
"""
from __future__ import annotations

import torch

from repro_torch.core.layers import spike_im2col, unfold
from repro_torch.kernels.lif_scan import lif_scan, norm_affine_lif
from repro_torch.kernels.max_pool import max_pool
from repro_torch.kernels.spike_conv import occupancy_mask, spike_conv
from repro_torch.kernels.spike_dwconv import spike_dwconv
from repro_torch.kernels.spike_matmul import spike_matmul


def spike_conv_op(xf: torch.Tensor, w: torch.Tensor, *,
                  stride: int = 1) -> torch.Tensor:
    """Activity-gated spiking conv.  xf [N, H, W, C] folded spikes, w
    HWIO [kh, kw, cin, cout] -> [N, Ho, Wo, cout], SAME padding.  The
    im2col and the occupancy mask are plain torch, as the reference
    leaves them to XLA; the gated GEMM is the kernel."""
    kh, kw = w.shape[:2]
    patches, (Ho, Wo) = spike_im2col(xf, kh, kw, stride)
    wmat = w.reshape(kh * kw * w.shape[2], w.shape[3]).contiguous()
    y = spike_conv(patches, wmat, occupancy_mask(patches))
    return y.reshape(xf.shape[0], Ho, Wo, -1)


def spike_dwconv_op(xf: torch.Tensor, w: torch.Tensor, *,
                    stride: int = 1) -> torch.Tensor:
    """Activity-gated depthwise conv.  xf [N, H, W, C] folded spikes, w
    [kh, kw, 1, C] -> [N, Ho, Wo, C], SAME padding; the kernel reads xf
    itself (no patch tensor)."""
    return spike_dwconv(xf.contiguous(), w.contiguous(), stride=stride)


def max_pool_op(xf: torch.Tensor, *, window: int = 2,
                gated: bool = True) -> torch.Tensor:
    """Gated max-pool of a folded [N, H, W, C] spike tensor ->
    [N, H//window, W//window, C], VALID, stride = window."""
    return max_pool(xf.contiguous(), window=window, gated=gated)


def norm_affine_lif_op(y: torch.Tensor, scale, bias, *, tau: float = 2.0,
                       v_th: float = 1.0, v_reset: float = 0.0):
    """y [T, B, ..., C] pre-norm conv output -> spikes, same shape."""
    T, B = y.shape[:2]
    y4 = y.reshape(T, B, -1, y.shape[-1]).contiguous()
    out = norm_affine_lif(y4, scale, bias, tau=tau, v_th=v_th,
                          v_reset=v_reset)
    return out.reshape(y.shape)


def lif_scan_op(currents: torch.Tensor, *, tau: float = 2.0,
                v_th: float = 1.0, v_reset: float = 0.0) -> torch.Tensor:
    """currents [T, ...] -> spikes, trailing dims folded for the kernel."""
    T = currents.shape[0]
    out = lif_scan(currents.reshape(T, -1).contiguous(), tau=tau, v_th=v_th,
                   v_reset=v_reset)
    return out.reshape(currents.shape)


def spike_matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] spikes (0/1), w [K, N] -> x @ w, all-zero tiles skipped."""
    return spike_matmul(x.contiguous(), w.contiguous())


def spike_conv_lif_op(xf, w, scale, bias, *, T: int, B: int,
                      stride: int = 1, tau: float = 2.0, v_th: float = 1.0,
                      v_reset: float = 0.0) -> torch.Tensor:
    """A whole firing conv layer: conv + instance norm + affine + T-step
    LIF.  xf [B*T, H, W, C] batch-major fold -> spikes [T, B, Ho, Wo,
    cout].  The per-op composition (two kernels) — the reference's
    untuned default; the fused conv->LIF kernel is later work."""
    y = unfold(spike_conv_op(xf, w, stride=stride), T, B)
    return norm_affine_lif_op(y, scale, bias, tau=tau, v_th=v_th,
                              v_reset=v_reset)
