"""Spiking layers (multi-step mode): conv and dense + LIF, the PyTorch
counterpart of ``repro.core.layers``.

Layout: activations are [T, B, H, W, C]; a conv runs on the batch-major
fold [B*T, H, W, C] (NHWC) with HWIO weights, exactly as the reference.
Each conv lowers to the spike-im2col patch matrix and a matmul that
accumulates K in 128-wide canonical blocks (``blocked_matmul``); the
instance norm is the population variance over (T, HW) per (b, c), under
``rsqrt(var + 1e-6)``.

Backend dispatch (``SNNConfig.backend``): ``"torch"`` computes the plain
formulation here; ``"cuda"`` routes a firing conv through
``repro_torch.kernels.ops.spike_conv_lif_op`` (gated spike-conv kernel +
fused norm/affine/LIF kernel), a non-firing conv through
``spike_conv_op``, dense firing through ``lif_scan_op`` and a
spike-input dense through ``spike_matmul_op``.  On CPU tensors those ops
take their kernels' plain versions, so both backends compute the same
function.  Depthwise convs and max-pool come with the mobilenet/vgg
slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SNNConfig
from repro_torch.core.lif import lif_scan
from repro_torch.kernels.blocks import CANONICAL_K_BLOCK

BACKENDS = ("torch", "cuda")
NORM_EPS = 1e-6


def _check_backend(cfg: SNNConfig) -> bool:
    """True when the kernel backend is selected; raises on typos."""
    if cfg.backend not in BACKENDS:
        raise ValueError(f"SNNConfig.backend must be one of {BACKENDS}, "
                         f"got {cfg.backend!r}")
    return cfg.backend == "cuda"


def _fire(y, cfg: SNNConfig):
    if _check_backend(cfg):
        from repro_torch.kernels.ops import lif_scan_op
        return lif_scan_op(y, tau=cfg.tau_mem, v_th=cfg.v_threshold,
                           v_reset=cfg.v_reset)
    return lif_scan(y, tau=cfg.tau_mem, v_th=cfg.v_threshold,
                    v_reset=cfg.v_reset)


# ---------------------------------------------------------------------------
# Initialisation (He-normal, the reference's scales)
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, shape) -> torch.Tensor:
    # shape: [kh, kw, cin, cout]
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5


def init_spiking_conv(gen: torch.Generator, cin: int, cout: int, *,
                      kernel: int = 3):
    return {"w": conv_init(gen, (kernel, kernel, cin, cout)),
            "scale": torch.ones(cout), "bias": torch.zeros(cout)}


def init_spiking_dense(gen: torch.Generator, cin: int, cout: int):
    return {"w": torch.randn((cin, cout), generator=gen) * (2.0 / cin) ** 0.5,
            "bias": torch.zeros(cout)}


# ---------------------------------------------------------------------------
# Spike-im2col lowering
# ---------------------------------------------------------------------------

def blocked_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] accumulated in ``CANONICAL_K_BLOCK`` K chunks, in
    order: each block's product is added to the running sum."""
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, a.shape[1], CANONICAL_K_BLOCK):
        acc = acc + a[:, k0:k0 + CANONICAL_K_BLOCK] \
            @ b[k0:k0 + CANONICAL_K_BLOCK]
    return acc


def _same_pads(size: int, k: int, stride: int):
    """XLA SAME padding: (lo, hi, out_size) along one spatial dim; the
    odd pixel of an odd total goes to the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2, out


def _patch_slices(xf: torch.Tensor, kh: int, kw: int, stride: int):
    """The kh*kw SAME-padded strided tap views of xf [N, H, W, C], in
    (kh, kw)-major order, each [N, Ho, Wo, C]."""
    _, H, W, _ = xf.shape
    plo_h, phi_h, Ho = _same_pads(H, kh, stride)
    plo_w, phi_w, Wo = _same_pads(W, kw, stride)
    xp = F.pad(xf, (0, 0, plo_w, phi_w, plo_h, phi_h))
    taps = [xp[:, i:i + (Ho - 1) * stride + 1:stride,
               j:j + (Wo - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]
    return taps, (Ho, Wo)


def spike_im2col(xf: torch.Tensor, kh: int, kw: int, stride: int = 1):
    """xf [N, H, W, C] -> patch matrix [N*Ho*Wo, kh*kw*C] (tap-major,
    channel-minor, matching ``w.reshape(kh*kw*cin, cout)``)."""
    taps, (Ho, Wo) = _patch_slices(xf, kh, kw, stride)
    N, _, _, C = xf.shape
    p = torch.stack(taps, dim=3)            # [N, Ho, Wo, taps, C]
    return p.reshape(N * Ho * Wo, kh * kw * C), (Ho, Wo)


def spike_conv(xf: torch.Tensor, w: torch.Tensor, *,
               stride: int = 1) -> torch.Tensor:
    """Plain conv in the kernel's formulation: xf [N, H, W, C], w HWIO
    [kh, kw, cin, cout] -> [N, Ho, Wo, cout], SAME padding."""
    kh, kw = w.shape[:2]
    patches, (Ho, Wo) = spike_im2col(xf, kh, kw, stride)
    wmat = w.reshape(kh * kw * w.shape[2], w.shape[3])
    return blocked_matmul(patches, wmat).reshape(xf.shape[0], Ho, Wo, -1)


def instance_norm_affine(y4: torch.Tensor, scale, bias,
                         eps: float = NORM_EPS) -> torch.Tensor:
    """y4 [T, B, HW, C]: per-(b, c) normalisation over axes (0, 2) with
    the two-pass population variance, then ``* scale + bias``."""
    mu = y4.mean(dim=(0, 2), keepdim=True)
    d = y4 - mu
    var = (d * d).mean(dim=(0, 2), keepdim=True)
    return d * torch.rsqrt(var + eps) * scale + bias


def fold(x: torch.Tensor) -> torch.Tensor:
    """[T, B, H, W, C] -> batch-major [B*T, H, W, C]."""
    T, B = x.shape[:2]
    return x.transpose(0, 1).reshape(B * T, *x.shape[2:])


def unfold(y: torch.Tensor, T: int, B: int) -> torch.Tensor:
    """[B*T, ...] -> [T, B, ...]."""
    return y.reshape(B, T, *y.shape[1:]).transpose(0, 1)


def apply_spiking_conv(p, x, cfg: SNNConfig, *, stride: int = 1,
                       fire: bool = True, tape=None,
                       tag: Optional[str] = None):
    """x: [T, B, H, W, C] -> conv, instance norm, affine, then spikes
    [T, B, H', W', C'] (or, with ``fire=False``, the normalised analog
    currents of a readout)."""
    T, B = x.shape[:2]
    use_kernels = _check_backend(cfg)
    xf = fold(x)
    if use_kernels and fire:
        from repro_torch.kernels.ops import spike_conv_lif_op
        out = spike_conv_lif_op(xf, p["w"], p["scale"], p["bias"], T=T,
                                B=B, stride=stride, tau=cfg.tau_mem,
                                v_th=cfg.v_threshold, v_reset=cfg.v_reset)
        if tape is not None:
            tape.record(tag or f"conv{len(tape.records)}", out)
        return out
    if use_kernels:
        from repro_torch.kernels.ops import spike_conv_op
        y = spike_conv_op(xf, p["w"], stride=stride)
    else:
        y = spike_conv(xf, p["w"], stride=stride)
    _, Ho, Wo, Co = y.shape
    y = unfold(y, T, B)
    y = instance_norm_affine(y.reshape(T, B, Ho * Wo, Co), p["scale"],
                             p["bias"]).reshape(y.shape)
    if not fire:
        return y
    out = _fire(y, cfg)
    if tape is not None:
        tape.record(tag or f"conv{len(tape.records)}", out)
    return out


def apply_spiking_dense(p, x, cfg: SNNConfig, *, fire: bool = True,
                        spike_input: bool = False, tape=None,
                        tag: Optional[str] = None):
    """x: [T, B, C].  ``spike_input`` marks x as a 0/1 spike tensor, so
    the kernel backend routes the matmul through the tile-skip
    ``spike_matmul_op``."""
    if spike_input and _check_backend(cfg):
        from repro_torch.kernels.ops import spike_matmul_op
        T, B, C = x.shape
        y = spike_matmul_op(x.reshape(T * B, C), p["w"])
        y = y.reshape(T, B, -1) + p["bias"]
    else:
        y = x @ p["w"] + p["bias"]
    if not fire:
        return y
    out = _fire(y, cfg)
    if tape is not None:
        tape.record(tag or f"dense{len(tape.records)}", out)
    return out
