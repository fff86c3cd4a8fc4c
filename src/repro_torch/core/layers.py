"""Spiking layers (multi-step mode): conv, depthwise conv and dense +
LIF, and max-pool, the PyTorch counterpart of ``repro.core.layers``.

Layout: activations are [T, B, H, W, C]; a conv runs on the batch-major
fold [B*T, H, W, C] (NHWC) with HWIO weights, exactly as the reference.
Each conv lowers to the spike-im2col patch matrix and a matmul that
accumulates K in 128-wide canonical blocks (``blocked_matmul``); the
instance norm is the population variance over (T, HW) per (b, c), under
``rsqrt(var + 1e-6)``.  A depthwise conv ([kh, kw, 1, C] weights)
accumulates its taps in order, ``acc + x_t * w[t]`` from +0.0, as the
reference's tap loop.

Backend dispatch (``SNNConfig.backend``): ``"torch"`` computes the plain
formulation here; ``"cuda"`` routes a firing conv through
``repro_torch.kernels.ops.spike_conv_lif_op`` (gated spike-conv kernel +
fused norm/affine/LIF kernel), a firing depthwise conv through
``spike_dwconv_op`` then ``norm_affine_lif_op``, a non-firing conv
through ``spike_conv_op``, dense firing through ``lif_scan_op``, a
spike-input dense through ``spike_matmul_op`` and a max-pool through
``max_pool_op``.  On CPU tensors those ops take their kernels' plain
versions, so both backends compute the same function.

Both backends are differentiable: the ``"torch"`` layers through
autograd and the surrogate ``spike`` of ``repro_torch.core.lif``, the
``"cuda"`` ops through their own backward (``kernels/ops.py``).  A
max-pool's gradient goes whole to the first element of its window, in
(row, column) order, that equals the window's max, as the reference's
``reduce_window`` VJP gives it; a chain of ``torch.maximum`` would split
ties, and spikes tie all the time.
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


def _fire(y, cfg: SNNConfig, bias=None):
    """Spikes of ``y + bias`` (bias None or [C]); on the kernel backend
    the add is part of the LIF launch."""
    if _check_backend(cfg):
        from repro_torch.kernels.ops import lif_scan_op
        return lif_scan_op(y, bias=bias, tau=cfg.tau_mem,
                           v_th=cfg.v_threshold, v_reset=cfg.v_reset,
                           beta=cfg.surrogate_beta)
    if bias is not None:
        y = y + bias
    return lif_scan(y, tau=cfg.tau_mem, v_th=cfg.v_threshold,
                    v_reset=cfg.v_reset, beta=cfg.surrogate_beta)


# ---------------------------------------------------------------------------
# Initialisation (He-normal, the reference's scales)
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, shape) -> torch.Tensor:
    # shape: [kh, kw, cin, cout]
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.randn(shape, generator=gen) * (2.0 / fan_in) ** 0.5


def init_spiking_conv(gen: torch.Generator, cin: int, cout: int, *,
                      kernel: int = 3, depthwise: bool = False):
    """HWIO weights [k, k, cin, cout] with per-channel scale/bias; a
    depthwise conv has [k, k, 1, cin] and ``cin`` channels out."""
    if depthwise:
        cout = cin
    shape = (kernel, kernel, 1 if depthwise else cin, cout)
    return {"w": conv_init(gen, shape),
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


def patches_grad(shape, kh: int, kw: int, stride: int,
                 tap_grad) -> torch.Tensor:
    """The adjoint of ``_patch_slices``: d xf [N, H, W, C] of an input of
    ``shape``, where ``tap_grad(t)`` is the gradient [N, Ho, Wo, C] of
    tap t's view; taps that overlap add up."""
    N, H, W, C = shape
    plo_h, phi_h, Ho = _same_pads(H, kh, stride)
    plo_w, phi_w, Wo = _same_pads(W, kw, stride)
    dxp = None
    for t in range(kh * kw):
        g = tap_grad(t)
        if dxp is None:
            dxp = g.new_zeros((N, H + plo_h + phi_h, W + plo_w + phi_w, C))
        i, j = divmod(t, kw)
        dxp[:, i:i + (Ho - 1) * stride + 1:stride,
            j:j + (Wo - 1) * stride + 1:stride, :] += g
    return dxp[:, plo_h:plo_h + H, plo_w:plo_w + W, :]


def spike_im2col(xf: torch.Tensor, kh: int, kw: int, stride: int = 1):
    """xf [N, H, W, C] -> patch matrix [N*Ho*Wo, kh*kw*C] (tap-major,
    channel-minor, matching ``w.reshape(kh*kw*cin, cout)``)."""
    taps, (Ho, Wo) = _patch_slices(xf, kh, kw, stride)
    N, _, _, C = xf.shape
    p = torch.stack(taps, dim=3)            # [N, Ho, Wo, taps, C]
    return p.reshape(N * Ho * Wo, kh * kw * C), (Ho, Wo)


def dw_patches(xf: torch.Tensor, kh: int, kw: int, stride: int = 1):
    """Depthwise form of the patches: [N*Ho*Wo, kh*kw, C] (channels stay
    per tap)."""
    taps, (Ho, Wo) = _patch_slices(xf, kh, kw, stride)
    N, _, _, C = xf.shape
    p = torch.stack(taps, dim=3)
    return p.reshape(N * Ho * Wo, kh * kw, C), (Ho, Wo)


def spike_conv(xf: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
               depthwise: bool = False) -> torch.Tensor:
    """Plain conv in the kernels' formulation: xf [N, H, W, C], w HWIO
    [kh, kw, cin, cout] (depthwise: [kh, kw, 1, C]) -> [N, Ho, Wo, cout],
    SAME padding.  Depthwise sums its taps in (kh, kw)-major order from
    +0.0, one multiply and one add per tap."""
    kh, kw = w.shape[:2]
    if depthwise:
        taps, (Ho, Wo) = _patch_slices(xf, kh, kw, stride)
        wf = w.reshape(kh * kw, -1)
        acc = torch.zeros((xf.shape[0], Ho, Wo, xf.shape[-1]),
                          dtype=torch.float32, device=xf.device)
        for t, xt in enumerate(taps):
            acc = acc + xt * wf[t]
        return acc
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
                       depthwise: bool = False, fire: bool = True,
                       tape=None, tag: Optional[str] = None):
    """x: [T, B, H, W, C] -> conv (depthwise with ``depthwise``),
    instance norm, affine, then spikes [T, B, H', W', C'] (or, with
    ``fire=False``, the normalised analog currents of a readout)."""
    T, B = x.shape[:2]
    use_kernels = _check_backend(cfg)
    xf = fold(x)
    if use_kernels and fire and not depthwise:
        from repro_torch.kernels.ops import spike_conv_lif_op
        out = spike_conv_lif_op(xf, p["w"], p["scale"], p["bias"], T=T,
                                B=B, stride=stride, tau=cfg.tau_mem,
                                v_th=cfg.v_threshold, v_reset=cfg.v_reset,
                                beta=cfg.surrogate_beta)
        return _record(tape, tag, out)
    if use_kernels:
        from repro_torch.kernels.ops import spike_conv_op, spike_dwconv_op
        op = spike_dwconv_op if depthwise else spike_conv_op
        y = unfold(op(xf, p["w"], stride=stride), T, B)
        if fire:
            # the depthwise epilogue: the fused norm+affine+LIF kernel
            from repro_torch.kernels.ops import norm_affine_lif_op
            out = norm_affine_lif_op(y, p["scale"], p["bias"],
                                     tau=cfg.tau_mem, v_th=cfg.v_threshold,
                                     v_reset=cfg.v_reset,
                                     beta=cfg.surrogate_beta)
            return _record(tape, tag, out)
    else:
        y = unfold(spike_conv(xf, p["w"], stride=stride,
                              depthwise=depthwise), T, B)
    _, _, Ho, Wo, Co = y.shape
    y = instance_norm_affine(y.reshape(T, B, Ho * Wo, Co), p["scale"],
                             p["bias"]).reshape(y.shape)
    if not fire:
        return y
    return _record(tape, tag, _fire(y, cfg))


def _record(tape, tag: Optional[str], out: torch.Tensor) -> torch.Tensor:
    if tape is not None:
        tape.record(tag or f"conv{len(tape.records)}", out)
    return out


def apply_spiking_dense(p, x, cfg: SNNConfig, *, fire: bool = True,
                        spike_input: bool = False, tape=None,
                        tag: Optional[str] = None):
    """x: [T, B, C].  ``spike_input`` marks x as a 0/1 spike tensor, so
    the kernel backend routes the matmul through the tile-skip
    ``spike_matmul_op``; a firing layer on the kernel backend adds its
    bias in the LIF launch (the same float32 add)."""
    if spike_input and _check_backend(cfg):
        from repro_torch.kernels.ops import spike_matmul_op
        T, B, C = x.shape
        y = spike_matmul_op(x.reshape(T * B, C), p["w"]).reshape(T, B, -1)
    else:
        y = x @ p["w"]
    if not fire:
        return y + p["bias"]
    out = _fire(y, cfg, bias=p["bias"])
    if tape is not None:
        tape.record(tag or f"dense{len(tape.records)}", out)
    return out


def _max_of_slices(xf: torch.Tensor, window: int) -> torch.Tensor:
    _, H, W, _ = xf.shape
    ho, wo = H // window, W // window
    out = None
    for di in range(window):
        for dj in range(window):
            s = xf[:, di:ho * window:window, dj:wo * window:window, :]
            out = s if out is None else torch.maximum(out, s)
    return out


def pool_grad(xf: torch.Tensor, g: torch.Tensor, window: int) -> torch.Tensor:
    """The max-pool's VJP: xf [N, H, W, C] the pooled input, g [N, H//window,
    W//window, C] -> d xf, each window's gradient on the first element,
    in (row, column) order, that equals its max (a ragged tail gets 0)."""
    _, H, W, _ = xf.shape
    ho, wo = H // window, W // window
    m = _max_of_slices(xf, window)
    d = torch.zeros_like(xf)
    taken = torch.zeros(m.shape, dtype=torch.bool, device=xf.device)
    for di in range(window):
        for dj in range(window):
            at = (slice(None), slice(di, ho * window, window),
                  slice(dj, wo * window, window))
            hit = (xf[at] == m) & ~taken
            d[at] = torch.where(hit, g, 0.0)
            taken |= hit
    return d


class _Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xf, window):
        ctx.save_for_backward(xf)
        ctx.window = window
        return _max_of_slices(xf, window)

    @staticmethod
    def backward(ctx, g):
        xf, = ctx.saved_tensors
        return pool_grad(xf, g, ctx.window), None


def pool_slices(xf: torch.Tensor, window: int) -> torch.Tensor:
    """Plain max-pool of xf [N, H, W, C] -> [N, H//window, W//window, C]:
    the elementwise max of the window's strided slices, taken in
    (row, column) order (VALID, stride = window; a ragged tail is
    dropped).  Its gradient is ``pool_grad``'s first-maximum rule."""
    return _Pool.apply(xf, window)


def max_pool(x: torch.Tensor, window: int = 2,
             cfg: Optional[SNNConfig] = None) -> torch.Tensor:
    """x: [T, B, H, W, C] -> [T, B, H//window, W//window, C], the view
    of a batch-major result (so the next layer's ``fold`` is a view).
    Under a ``"cuda"`` cfg the gated pooling kernel (``max_pool_op``)
    reads x where it lies, with no fold copy before it."""
    if cfg is not None and _check_backend(cfg):
        from repro_torch.kernels.ops import max_pool_op
        return max_pool_op(x, window=window)
    T, B = x.shape[:2]
    return unfold(pool_slices(fold(x), window), T, B)
