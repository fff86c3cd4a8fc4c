"""Dispatch of the spiking layers onto the kernels, and their gradients
-- the counterpart of ``repro.kernels.ops``.

A whole firing conv layer (``spike_conv_lif_op``) resolves its launch
config through the shape-keyed launch table (``repro_torch.kernels.tune``,
op ``"conv_lif"``): the fused conv->LIF kernel (``spike_conv_lif``) or
the per-op pair (``spike_conv`` then ``norm_affine_lif``) under the
chosen gate.  An untuned shape takes the per-op pair under the
``"mask"`` gate.  A planned backbone segment (``backbone_segment_op``,
op ``"backbone_seg"``) runs as one ``backbone_segment`` launch or on
the per-layer route, each layer through its own dispatch; untuned, the
per-layer route.  The other ops have one launch each (the spike matmul
gates in the kernel).

Each op reshapes between the layers' [T, B, ...] layout and the flat
shapes a kernel takes; the kernel wrappers take their plain versions for
CPU tensors and launch the CUDA kernels for CUDA tensors.

Every op is a ``torch.autograd.Function`` whose forward is the kernel and
whose backward ports the reference's custom VJP in plain PyTorch (the
reference's backwards are jnp replays and plain matmuls, no Pallas
kernel): the LIF ops replay the recurrence and run the surrogate BPTT
(``_lif_replay``, ``_lif_bwd_scan``), the convs and the spike matmul
take plain matmul adjoints, the pool gives each window's gradient to its
first maximum, and the fused segment recomputes itself on the per-layer
route and differentiates that.  A replay takes the forward's own spikes
for the resets: the kernels' statistics follow their own contract
(float64 class sums, ``csrc/lif_common.cuh``), so spikes re-derived from
the plain statistics could flip one near threshold and the backward
would then not be that of the forward it differentiates.  Inputs and
spikes are the residuals; the membrane trajectory and the norm
statistics are recomputed in the backward.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from repro_torch.core.layers import (NORM_EPS, _patch_slices, _same_pads,
                                     fold, patches_grad, pool_grad,
                                     spike_im2col, unfold)
from repro_torch.core.lif import f32_decay, surrogate_grad
from repro_torch.kernels import tune
from repro_torch.kernels.backbone_fuse import (segment_activation_elems,
                                               segment_edge_elems,
                                               segment_macs,
                                               segment_unfused_launches)
from repro_torch.kernels.backbone_segment import (backbone_segment,
                                                  segment_operands,
                                                  segment_plan)
from repro_torch.kernels.lif_scan import lif_scan, norm_affine_lif
from repro_torch.kernels.max_pool import max_pool
from repro_torch.kernels.spike_conv import spike_conv
from repro_torch.kernels.spike_conv_lif import conv_lif_plan, spike_conv_lif
from repro_torch.kernels.spike_dwconv import spike_dwconv
from repro_torch.kernels.spike_matmul import spike_matmul


# ---------------------------------------------------------------------------
# Surrogate-gradient BPTT, shared by the LIF-carrying ops
# ---------------------------------------------------------------------------

def _lif_replay(z, *, tau: float, v_th: float, v_reset: float,
                spikes=None):
    """Re-run the LIF recurrence on currents z [T, ...] -> the
    pre-threshold distances x_t = u_t - v_th [T, ...] and the spikes.
    With ``spikes`` (the forward's) the resets take those, not spikes
    re-derived from x."""
    decay = f32_decay(tau)
    u = torch.full_like(z[0], v_reset)
    xs, ss = [], []
    for t in range(z.shape[0]):
        u = decay * (u - v_reset) + v_reset + z[t]
        x = u - v_th
        s = (x >= 0).to(z.dtype) if spikes is None else spikes[t]
        u = u * (1.0 - s) + v_reset * s
        xs.append(x)
        ss.append(s)
    return torch.stack(xs), torch.stack(ss) if spikes is None else spikes


def _lif_bwd_scan(g, xs, ss, *, tau: float, v_th: float, v_reset: float,
                  beta: float):
    """Reverse-time BPTT through the LIF recurrence.  g: dL/d(spikes)
    [T, ...] -> dL/d(currents) [T, ...].  The spike enters the output
    and the hard reset u+ = u (1 - s) + v_reset s, so
      du_t = du+ (1 - s_t) + (g_t + du+ (v_reset - u_t)) H'(x_t),
    what autograd derives through the surrogate ``spike``."""
    decay = f32_decay(tau)
    du = torch.zeros_like(g[0])
    dz = [None] * g.shape[0]
    for t in reversed(range(g.shape[0])):
        u_t = xs[t] + v_th
        ds = g[t] + du * (v_reset - u_t)
        dut = du * (1.0 - ss[t]) + ds * surrogate_grad(xs[t], beta)
        dz[t] = dut
        du = dut * decay
    return torch.stack(dz)


def _lif_grad(z, spikes, g, lif, beta):
    """dL/dz of the LIF over currents z [T, ...] that fired ``spikes``."""
    xs, ss = _lif_replay(z, spikes=spikes, **lif)
    return _lif_bwd_scan(g, xs, ss, beta=beta, **lif)


def _norm_lif_grad(y4, scale, bias, spikes, g, lif, beta):
    """The backward of instance norm + affine + LIF on y4 [T, B, HW, C]
    that fired ``spikes``: (dy4, dscale, dbias).  The norm is
    rematerialised in the plain formula (1/N variance):
      dy = r (dyhat - mean(dyhat) - yhat mean(dyhat yhat))."""
    mu = y4.mean(dim=(0, 2), keepdim=True)
    d = y4 - mu
    r = torch.rsqrt((d * d).mean(dim=(0, 2), keepdim=True) + NORM_EPS)
    yhat = d * r
    dz = _lif_grad(yhat * scale + bias, spikes, g.reshape(y4.shape), lif,
                   beta)
    dyhat = dz * scale
    dscale = (dz * yhat).sum(dim=(0, 1, 2))
    dbias = dz.sum(dim=(0, 1, 2))
    m1 = dyhat.mean(dim=(0, 2), keepdim=True)
    m2 = (dyhat * yhat).mean(dim=(0, 2), keepdim=True)
    return r * (dyhat - m1 - yhat * m2), dscale, dbias


def _conv_grad(xf, w, g, stride, needs):
    """Plain adjoints of the SAME conv of xf [N, H, W, C] with HWIO w,
    given g [N, Ho, Wo, cout]: (dxf, dw), each None where ``needs`` says
    so.  dxf is g @ wmat^T put back through the tap gather's adjoint, dw
    the patch matrix^T @ g."""
    kh, kw, cin, cout = w.shape
    g2 = g.reshape(-1, cout)
    dxf = dw = None
    if needs[0]:
        dp = (g2 @ w.reshape(kh * kw * cin, cout).t()).reshape(
            *g.shape[:3], kh * kw, cin)
        dxf = patches_grad(xf.shape, kh, kw, stride, lambda t: dp[..., t, :])
    if needs[1]:
        patches, _ = spike_im2col(xf, kh, kw, stride)
        dw = (patches.t() @ g2).reshape(w.shape)
    return dxf, dw


def _dwconv_grad(xf, w, g, stride, needs):
    """Plain adjoints of the SAME depthwise conv (w [kh, kw, 1, C])."""
    kh, kw = w.shape[:2]
    wf = w.reshape(kh * kw, -1)
    dxf = dw = None
    if needs[0]:
        dxf = patches_grad(xf.shape, kh, kw, stride, lambda t: g * wf[t])
    if needs[1]:
        taps, _ = _patch_slices(xf, kh, kw, stride)
        dw = torch.stack([(x_t * g).sum(dim=(0, 1, 2))
                          for x_t in taps]).reshape(w.shape)
    return dxf, dw


# ---------------------------------------------------------------------------
# The ops: kernel forward, plain backward
# ---------------------------------------------------------------------------

class _SpikeConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xf, w, stride, gate):
        ctx.save_for_backward(xf, w)
        ctx.stride = stride
        return spike_conv(xf, w, stride=stride, gate=gate)

    @staticmethod
    def backward(ctx, g):
        xf, w = ctx.saved_tensors
        return (*_conv_grad(xf, w, g, ctx.stride, ctx.needs_input_grad),
                None, None)


def spike_conv_op(xf: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  gate: str = "mask") -> torch.Tensor:
    """Activity-gated spiking conv.  xf [N, H, W, C] folded spikes, w
    HWIO [kh, kw, cin, cout] -> [N, Ho, Wo, cout], SAME padding.  The
    kernel reads xf itself (no patch matrix, no occupancy mask in
    torch).  ``gate``: "mask" (each K block checked in xf before its
    copies), "inline" (each staged slice checked) or "none"."""
    return _SpikeConv.apply(xf.contiguous(), w.contiguous(), stride, gate)


class _SpikeDwconv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xf, w, stride):
        ctx.save_for_backward(xf, w)
        ctx.stride = stride
        return spike_dwconv(xf, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        xf, w = ctx.saved_tensors
        return (*_dwconv_grad(xf, w, g, ctx.stride, ctx.needs_input_grad),
                None)


def spike_dwconv_op(xf: torch.Tensor, w: torch.Tensor, *,
                    stride: int = 1) -> torch.Tensor:
    """Activity-gated depthwise conv.  xf [N, H, W, C] folded spikes, w
    [kh, kw, 1, C] -> [N, Ho, Wo, C], SAME padding; the kernel reads xf
    itself (no patch tensor)."""
    return _SpikeDwconv.apply(xf.contiguous(), w.contiguous(), stride)


class _MaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window, gated):
        ctx.save_for_backward(x)
        ctx.window = window
        return max_pool(x, window=window, gated=gated)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        if x.dim() == 4:
            return pool_grad(x, g, ctx.window), None, None
        T, B = x.shape[:2]
        return unfold(pool_grad(fold(x), g, ctx.window), T, B), None, None


def max_pool_op(x: torch.Tensor, *, window: int = 2,
                gated: bool = True) -> torch.Tensor:
    """Gated max-pool, VALID, stride = window.  x [T, B, H, W, C] spikes
    as they lie (no fold copy; a layout the kernel does not take
    raises) -> [T, B, H//window, W//window, C], the ``unfold`` view of
    the kernel's batch-major output; a folded [N, H, W, C] (contiguous)
    -> [N, H//window, W//window, C].  Each window's gradient goes to its
    first maximum in (row, column) order (``layers.pool_grad``)."""
    out = _MaxPool.apply(x, window, gated)
    return unfold(out, *x.shape[:2]) if x.dim() == 5 else out


class _NormAffineLif(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y4, scale, bias, lif, beta):
        out = norm_affine_lif(y4, scale, bias, **lif)
        ctx.save_for_backward(y4, scale, bias, out)
        ctx.lif, ctx.beta = lif, beta
        return out

    @staticmethod
    def backward(ctx, g):
        y4, scale, bias, s = ctx.saved_tensors
        return (*_norm_lif_grad(y4, scale, bias, s, g, ctx.lif, ctx.beta),
                None, None)


def norm_affine_lif_op(y: torch.Tensor, scale, bias, *, tau: float = 2.0,
                       v_th: float = 1.0, v_reset: float = 0.0,
                       beta: float = 4.0):
    """y [T, B, ..., C] pre-norm conv output -> spikes, same shape."""
    T, B = y.shape[:2]
    y4 = y.reshape(T, B, -1, y.shape[-1]).contiguous()
    out = _NormAffineLif.apply(y4, scale, bias,
                               dict(tau=tau, v_th=v_th, v_reset=v_reset),
                               beta)
    return out.reshape(y.shape)


class _LifScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, currents, bias, lif, beta):
        out = lif_scan(currents, bias=bias, **lif)
        ctx.save_for_backward(currents, bias, out)
        ctx.lif, ctx.beta = lif, beta
        return out

    @staticmethod
    def backward(ctx, g):
        currents, bias, s = ctx.saved_tensors
        T = currents.shape[0]
        z = currents if bias is None else (
            currents.reshape(T, -1, bias.shape[0]) + bias).reshape(T, -1)
        dz = _lif_grad(z, s, g, ctx.lif, ctx.beta)
        dbias = None
        if bias is not None and ctx.needs_input_grad[1]:
            dbias = dz.reshape(-1, bias.shape[0]).sum(dim=0)
        return dz, dbias, None, None


def lif_scan_op(currents: torch.Tensor, *, bias=None, tau: float = 2.0,
                v_th: float = 1.0, v_reset: float = 0.0,
                beta: float = 4.0) -> torch.Tensor:
    """currents [T, ..., C] -> spikes of ``currents + bias`` (bias None or
    [C]), trailing dims folded for the kernel, the add in its launch."""
    if bias is not None and tuple(bias.shape) != tuple(currents.shape[-1:]):
        raise ValueError(f"lif_scan_op: bias {tuple(bias.shape)} for "
                         f"currents {tuple(currents.shape)}")
    T = currents.shape[0]
    out = _LifScan.apply(currents.reshape(T, -1).contiguous(), bias,
                         dict(tau=tau, v_th=v_th, v_reset=v_reset), beta)
    return out.reshape(currents.shape)


class _SpikeMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return spike_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        # the sparsity lives in x, not in the adjoints: two plain matmuls
        x, w = ctx.saved_tensors
        return (g @ w.t() if ctx.needs_input_grad[0] else None,
                x.t() @ g if ctx.needs_input_grad[1] else None)


def spike_matmul_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] spikes (0/1), w [K, N] -> x @ w, all-zero tiles skipped."""
    return _SpikeMatmul.apply(x.contiguous(), w.contiguous())


def conv_out_hw(xf: torch.Tensor, kh: int, kw: int, stride: int):
    """SAME output extent (Ho, Wo) of a conv on xf [N, H, W, C]."""
    return (_same_pads(xf.shape[1], kh, stride)[2],
            _same_pads(xf.shape[2], kw, stride)[2])


class _ConvLif(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xf, w, scale, bias, T, B, stride, gate, cluster, lif,
                beta):
        out = spike_conv_lif(xf, w, scale, bias, T=T, B=B, stride=stride,
                             gate=gate, cluster=cluster, **lif)
        ctx.save_for_backward(xf, w, scale, bias, out)
        ctx.dims, ctx.lif, ctx.beta = (T, B, stride), lif, beta
        return out

    @staticmethod
    def backward(ctx, g):
        xf, w, scale, bias, s = ctx.saved_tensors
        T, B, stride = ctx.dims
        # the conv output again: spike_conv gives the fused kernel's bits
        y = spike_conv(xf, w, stride=stride)
        y4 = unfold(y, T, B).reshape(s.shape).contiguous()
        dy4, dscale, dbias = _norm_lif_grad(y4, scale, bias, s, g, ctx.lif,
                                            ctx.beta)
        dy = fold(dy4.reshape(T, B, *y.shape[1:]))
        dxf, dw = _conv_grad(xf, w, dy, stride, ctx.needs_input_grad)
        return (dxf, dw, dscale, dbias) + (None,) * 7


def _conv_lif_apply(cfg: tune.LaunchConfig, xf, w, scale, bias, *, T, B,
                    stride, lif, beta):
    """One firing conv layer on the route ``cfg`` names -> spikes
    [T, B, Ho, Wo, cout].  The fused kernel, like the per-op conv, reads
    xf itself (no patch matrix, no occupancy mask in torch)."""
    if cfg.fused:
        Ho, Wo = conv_out_hw(xf, w.shape[0], w.shape[1], stride)
        out = _ConvLif.apply(xf.contiguous(), w.contiguous(), scale, bias,
                             T, B, stride, cfg.gate, cfg.bm, lif, beta)
        return out.reshape(T, B, Ho, Wo, -1)
    y = unfold(spike_conv_op(xf, w, stride=stride, gate=cfg.gate), T, B)
    return norm_affine_lif_op(y, scale, bias, beta=beta, **lif)


def spike_conv_lif_op(xf, w, scale, bias, *, T: int, B: int,
                      stride: int = 1, tau: float = 2.0, v_th: float = 1.0,
                      v_reset: float = 0.0, beta: float = 4.0
                      ) -> torch.Tensor:
    """A whole firing conv layer: conv + instance norm + affine + T-step
    LIF.  xf [B*T, H, W, C] batch-major fold -> spikes [T, B, Ho, Wo,
    cout].  The launch table decides the route per shape
    (``dims = T, B, HW, K, N`` as the reference keys it): the fused
    kernel or the per-op pair; both give the same spikes, and the same
    gradients (the fused route's backward is the pair's)."""
    kh, kw = w.shape[:2]
    Ho, Wo = conv_out_hw(xf, kh, kw, stride)
    dims = dict(T=T, B=B, HW=Ho * Wo, K=kh * kw * w.shape[2], N=w.shape[3])
    lif = dict(tau=tau, v_th=v_th, v_reset=v_reset)

    def run(cfg):
        return _conv_lif_apply(cfg, xf, w, scale, bias, T=T, B=B,
                               stride=stride, lif=lif, beta=beta)
    runner, live = None, 1.0
    if tune.tuning_active():
        live = float((xf != 0).float().mean())
        runner = run
    return run(tune.dispatch("conv_lif", dims, runner, live=live,
                             taps=kh * kw))


def fused_conv_lif_table(keys: Iterable[str],
                         gate: str = "mask") -> tune.TuningTable:
    """A table that routes every ``conv_lif`` key of ``keys`` to the
    fused kernel under ``gate``, at its plan's default cluster size
    (entries forced, not timed: their µs are NaN).  Other keys are left
    out."""
    table = tune.TuningTable()
    for key in keys:
        op, d = tune.parse_key(key)
        if op != "conv_lif":
            continue
        p = conv_lif_plan(d["T"], d["B"], d["HW"], d["N"], d["K"])
        table.record(key, tune.LaunchConfig(bm=p.cluster, gate=gate,
                                            fused=True),
                     float("nan"), float("nan"))
    return table


# ---------------------------------------------------------------------------
# backbone_segment_op: a planned segment as one launch or per layer
# ---------------------------------------------------------------------------

def segment_dims(specs, *, T: int, B: int, H: int, W: int):
    """The launch-table dims of a segment of anonymous ``specs`` on a
    [T, B, H, W, C] input: the extent, each layer's ``dim_token``
    (``L0``, ``L1``, ...) and the aggregate terms of the estimate: MACs
    ``F``, conv-output elements ``A``, edge elements ``E`` (input,
    weights, output) and the per-layer route's device operations ``U``."""
    dims = dict(T=T, B=B, H=H, W=W)
    for i, s in enumerate(specs):
        dims[f"L{i}"] = s.dim_token
    kw = dict(H=H, W=W, T=T, B=B)
    dims.update(F=segment_macs(specs, **kw),
                A=segment_activation_elems(specs, **kw),
                E=segment_edge_elems(specs, **kw),
                U=segment_unfused_launches(specs))
    return dims


def _seg_unfused(x, params, specs, lif, beta: float = 4.0):
    """The per-layer route of a segment, as ``_run_per_layer`` runs it on
    the "cuda" backend: each firing conv through its own ``conv_lif``
    dispatch, a depthwise layer through ``spike_dwconv`` and
    ``norm_affine_lif``, a pool through ``max_pool``."""
    for (w, scale, bias), s in zip(params, specs):
        T, B = x.shape[:2]
        if s.depthwise:
            y = unfold(spike_dwconv_op(fold(x), w, stride=s.stride), T, B)
            x = norm_affine_lif_op(y, scale, bias, beta=beta, **lif)
        else:
            x = spike_conv_lif_op(fold(x), w, scale, bias, T=T, B=B,
                                  stride=s.stride, beta=beta, **lif)
        if s.pool:
            x = max_pool_op(x, window=s.pool)
    return x


class _Segment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, specs, gate, cluster, lif, beta, *flat):
        params = [flat[i:i + 3] for i in range(0, len(flat), 3)]
        out = backbone_segment(x.contiguous(),
                               segment_operands(params, specs), specs=specs,
                               gate=gate, cluster=cluster, **lif)
        ctx.save_for_backward(x, *flat)
        ctx.specs, ctx.lif, ctx.beta = specs, lif, beta
        return out

    @staticmethod
    def backward(ctx, g):
        # recompute the segment on the per-layer route, the kernel's
        # bit-equal twin, and differentiate it: its replays see the
        # forward's spikes, and its grads are the per-layer route's
        x, *flat = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, *flat)]
            ps = [leaves[i:i + 3] for i in range(1, len(leaves), 3)]
            out = _seg_unfused(leaves[0], ps, ctx.specs, ctx.lif, ctx.beta)
            grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
        grads = [torch.zeros_like(t) if d is None else d
                 for t, d in zip(leaves, grads)]
        return (grads[0], None, None, None, None, None, *grads[1:])


def backbone_segment_op(x: torch.Tensor, params, *, specs,
                        tau: float = 2.0, v_th: float = 1.0,
                        v_reset: float = 0.0,
                        beta: float = 4.0) -> torch.Tensor:
    """One planned backbone segment (``backbone_fuse.plan_segments``)
    through one dispatch point.  x [T, B, H, W, C] spikes; params the
    (w, scale, bias) of each layer; specs its anonymous ``LayerSpec``s
    (same-shaped segments share one table entry) -> spikes after the
    last layer, pooling absorbed.  The launch table decides per shape:
    the ``backbone_segment`` kernel under its gate and cluster size
    (``LaunchConfig.gate``/``bm``; one device op, the weights read in
    place) or the per-layer route (the default); both give the same
    spikes and the same gradients."""
    T, B, H, W, _ = x.shape
    specs = tuple(specs)
    dims = segment_dims(specs, T=T, B=B, H=H, W=W)
    lif = dict(tau=tau, v_th=v_th, v_reset=v_reset)

    def run(cfg):
        if cfg.fused:
            return _Segment.apply(x, specs, cfg.gate, cfg.bm, lif, beta,
                                  *(t for layer in params for t in layer))
        return _seg_unfused(x, params, specs, lif, beta)
    runner, live = None, 1.0
    if tune.tuning_active():
        live = float((x != 0).float().mean())
        runner = run
    return run(tune.dispatch("backbone_seg", dims, runner, live=live))


def fused_segment_table(keys: Iterable[str], gate: str = "none",
                        cluster: Optional[int] = None) -> tune.TuningTable:
    """A table that routes every ``backbone_seg`` key of ``keys`` to the
    ``backbone_segment`` kernel under ``gate`` with ``cluster`` blocks
    per batch element (default: the key's ``segment_plan``'s; entries
    forced, not timed: their µs are NaN).  Other keys, and segments the
    plan refuses at that cluster size, are left out.  The default gate
    is "none": a segment's row tiles span whole images, so a 32-deep
    slice of them is almost never all zero, and "inline"'s check cost
    2-13% on the H100 at the served shapes (chip_smoke.py
    --segment-phase)."""
    table = tune.TuningTable()
    for key in keys:
        op, d = tune.parse_key(key)
        if op != "backbone_seg":
            continue
        try:
            p = segment_plan(tune.segment_specs(d), d["T"], d["B"], d["H"],
                             d["W"], cluster=cluster)
        except ValueError:
            continue
        table.record(key, tune.LaunchConfig(bm=p.cluster, gate=gate,
                                            fused=True),
                     float("nan"), float("nan"))
    return table
