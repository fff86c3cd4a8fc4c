"""Dispatch of the spiking layers onto the kernels — the counterpart of
``repro.kernels.ops``.

A whole firing conv layer (``spike_conv_lif_op``) resolves its launch
config through the shape-keyed launch table (``repro_torch.kernels.tune``,
op ``"conv_lif"``): the fused conv->LIF kernel (``spike_conv_lif``) or
the per-op pair (``spike_conv`` then ``norm_affine_lif``) under the
chosen gate.  An untuned shape takes the per-op pair under the
``"mask"`` gate; the other ops have one launch each (the spike matmul
gates in the kernel).

Each op reshapes between the layers' [T, B, ...] layout and the flat
shapes a kernel takes; the kernel wrappers take their plain versions for
CPU tensors and launch the CUDA kernels for CUDA tensors.  Forward
only: the backward kernels come with training.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.core.layers import _same_pads, spike_im2col, unfold
from repro_torch.kernels import tune
from repro_torch.kernels.blocks import DEFAULT_BK, DEFAULT_BM
from repro_torch.kernels.lif_scan import lif_scan, norm_affine_lif
from repro_torch.kernels.max_pool import max_pool
from repro_torch.kernels.spike_conv import occupancy_mask, spike_conv
from repro_torch.kernels.spike_conv_lif import slice_widths, spike_conv_lif
from repro_torch.kernels.spike_dwconv import spike_dwconv
from repro_torch.kernels.spike_matmul import spike_matmul


def _gate_mask(patches: torch.Tensor, gate: str):
    """The spike_conv kernel's occupancy argument under ``gate``."""
    if gate == "mask":
        return occupancy_mask(patches)
    if gate == "none":
        M, K = patches.shape
        return torch.ones((-(-M // DEFAULT_BM), -(-K // DEFAULT_BK)),
                          dtype=torch.int32, device=patches.device)
    if gate == "inline":
        return None
    raise ValueError(f"gate must be 'mask', 'inline' or 'none', got "
                     f"{gate!r}")


def spike_conv_op(xf: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  gate: str = "mask") -> torch.Tensor:
    """Activity-gated spiking conv.  xf [N, H, W, C] folded spikes, w
    HWIO [kh, kw, cin, cout] -> [N, Ho, Wo, cout], SAME padding.  The
    im2col and the occupancy mask are plain torch, as the reference
    leaves them to XLA; the gated GEMM is the kernel.  ``gate``:
    "mask" (the occupancy mask), "inline" (checked in the kernel) or
    "none" (an all-ones mask)."""
    kh, kw = w.shape[:2]
    patches, (Ho, Wo) = spike_im2col(xf, kh, kw, stride)
    wmat = w.reshape(kh * kw * w.shape[2], w.shape[3]).contiguous()
    y = spike_conv(patches, wmat, _gate_mask(patches, gate))
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


def conv_out_hw(xf: torch.Tensor, kh: int, kw: int, stride: int):
    """SAME output extent (Ho, Wo) of a conv on xf [N, H, W, C]."""
    return (_same_pads(xf.shape[1], kh, stride)[2],
            _same_pads(xf.shape[2], kw, stride)[2])


def _conv_lif_apply(cfg: tune.LaunchConfig, xf, w, scale, bias, *, T, B,
                    stride, lif):
    """One firing conv layer on the route ``cfg`` names -> spikes
    [T, B, Ho, Wo, cout]."""
    kh, kw = w.shape[:2]
    if cfg.fused:
        patches, (Ho, Wo) = spike_im2col(xf, kh, kw, stride)
        wmat = w.reshape(kh * kw * w.shape[2], w.shape[3]).contiguous()
        out = spike_conv_lif(patches, wmat, scale, bias, T=T, B=B,
                             HW=Ho * Wo, gate=cfg.gate, bn=cfg.bn, **lif)
        return out.reshape(T, B, Ho, Wo, -1)
    y = unfold(spike_conv_op(xf, w, stride=stride, gate=cfg.gate), T, B)
    return norm_affine_lif_op(y, scale, bias, **lif)


def spike_conv_lif_op(xf, w, scale, bias, *, T: int, B: int,
                      stride: int = 1, tau: float = 2.0, v_th: float = 1.0,
                      v_reset: float = 0.0) -> torch.Tensor:
    """A whole firing conv layer: conv + instance norm + affine + T-step
    LIF.  xf [B*T, H, W, C] batch-major fold -> spikes [T, B, Ho, Wo,
    cout].  The launch table decides the route per shape
    (``dims = T, B, HW, K, N`` as the reference keys it): the fused
    kernel or the per-op pair; both give the same spikes."""
    kh, kw = w.shape[:2]
    Ho, Wo = conv_out_hw(xf, kh, kw, stride)
    dims = dict(T=T, B=B, HW=Ho * Wo, K=kh * kw * w.shape[2], N=w.shape[3])
    lif = dict(tau=tau, v_th=v_th, v_reset=v_reset)

    def run(cfg):
        return _conv_lif_apply(cfg, xf, w, scale, bias, T=T, B=B,
                               stride=stride, lif=lif)
    runner, live = None, 1.0
    if tune.tuning_active():
        live = float((xf != 0).float().mean())
        runner = run
    return run(tune.dispatch("conv_lif", dims, runner, live=live))


def fused_conv_lif_table(keys: Iterable[str],
                         gate: str = "mask") -> tune.TuningTable:
    """A table that routes every ``conv_lif`` key of ``keys`` to the
    fused kernel under ``gate``, at the widest channel slice that fits
    (entries forced, not timed: their µs are NaN).  Other keys are
    left out."""
    table = tune.TuningTable()
    for key in keys:
        op, d = tune.parse_key(key)
        if op != "conv_lif":
            continue
        widths = slice_widths(d["T"] * d["HW"], d["N"])
        if not widths:
            raise ValueError(f"{key}: no channel slice fits a block")
        table.record(key, tune.LaunchConfig(bn=widths[0], gate=gate,
                                            fused=True),
                     float("nan"), float("nan"))
    return table
