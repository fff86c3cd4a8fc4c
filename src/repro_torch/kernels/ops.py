"""Dispatch of the spiking layers onto the kernels — the counterpart of
``repro.kernels.ops``.

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
CPU tensors and launch the CUDA kernels for CUDA tensors.  Forward
only: the backward kernels come with training.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from repro_torch.core.layers import _same_pads, fold, unfold
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


def spike_conv_op(xf: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                  gate: str = "mask") -> torch.Tensor:
    """Activity-gated spiking conv.  xf [N, H, W, C] folded spikes, w
    HWIO [kh, kw, cin, cout] -> [N, Ho, Wo, cout], SAME padding.  The
    kernel reads xf itself (no patch matrix, no occupancy mask in
    torch).  ``gate``: "mask" (each K block checked in xf before its
    copies), "inline" (each staged slice checked) or "none"."""
    return spike_conv(xf.contiguous(), w.contiguous(), stride=stride,
                      gate=gate)


def spike_dwconv_op(xf: torch.Tensor, w: torch.Tensor, *,
                    stride: int = 1) -> torch.Tensor:
    """Activity-gated depthwise conv.  xf [N, H, W, C] folded spikes, w
    [kh, kw, 1, C] -> [N, Ho, Wo, C], SAME padding; the kernel reads xf
    itself (no patch tensor)."""
    return spike_dwconv(xf.contiguous(), w.contiguous(), stride=stride)


def max_pool_op(x: torch.Tensor, *, window: int = 2,
                gated: bool = True) -> torch.Tensor:
    """Gated max-pool, VALID, stride = window.  x [T, B, H, W, C] spikes
    as they lie (no fold copy; a layout the kernel does not take
    raises) -> [T, B, H//window, W//window, C], the ``unfold`` view of
    the kernel's batch-major output; a folded [N, H, W, C] (contiguous)
    -> [N, H//window, W//window, C]."""
    if x.dim() == 5:
        T, B = x.shape[:2]
        return unfold(max_pool(x, window=window, gated=gated), T, B)
    return max_pool(x, window=window, gated=gated)


def norm_affine_lif_op(y: torch.Tensor, scale, bias, *, tau: float = 2.0,
                       v_th: float = 1.0, v_reset: float = 0.0):
    """y [T, B, ..., C] pre-norm conv output -> spikes, same shape."""
    T, B = y.shape[:2]
    y4 = y.reshape(T, B, -1, y.shape[-1]).contiguous()
    out = norm_affine_lif(y4, scale, bias, tau=tau, v_th=v_th,
                          v_reset=v_reset)
    return out.reshape(y.shape)


def lif_scan_op(currents: torch.Tensor, *, bias=None, tau: float = 2.0,
                v_th: float = 1.0, v_reset: float = 0.0) -> torch.Tensor:
    """currents [T, ..., C] -> spikes of ``currents + bias`` (bias None or
    [C]), trailing dims folded for the kernel, the add in its launch."""
    if bias is not None and tuple(bias.shape) != tuple(currents.shape[-1:]):
        raise ValueError(f"lif_scan_op: bias {tuple(bias.shape)} for "
                         f"currents {tuple(currents.shape)}")
    T = currents.shape[0]
    out = lif_scan(currents.reshape(T, -1).contiguous(), bias=bias, tau=tau,
                   v_th=v_th, v_reset=v_reset)
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
    [T, B, Ho, Wo, cout].  The fused kernel, like the per-op conv, reads
    xf itself (no patch matrix, no occupancy mask in torch)."""
    if cfg.fused:
        Ho, Wo = conv_out_hw(xf, w.shape[0], w.shape[1], stride)
        out = spike_conv_lif(xf.contiguous(), w.contiguous(), scale, bias,
                             T=T, B=B, stride=stride, gate=cfg.gate,
                             cluster=cfg.bm, **lif)
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


def _seg_unfused(x, params, specs, lif):
    """The per-layer route of a segment, as ``_run_per_layer`` runs it on
    the "cuda" backend: each firing conv through its own ``conv_lif``
    dispatch, a depthwise layer through ``spike_dwconv`` and
    ``norm_affine_lif``, a pool through ``max_pool``."""
    for (w, scale, bias), s in zip(params, specs):
        T, B = x.shape[:2]
        if s.depthwise:
            y = unfold(spike_dwconv_op(fold(x), w, stride=s.stride), T, B)
            x = norm_affine_lif_op(y, scale, bias, **lif)
        else:
            x = spike_conv_lif_op(fold(x), w, scale, bias, T=T, B=B,
                                  stride=s.stride, **lif)
        if s.pool:
            x = max_pool_op(x, window=s.pool)
    return x


def backbone_segment_op(x: torch.Tensor, params, *, specs,
                        tau: float = 2.0, v_th: float = 1.0,
                        v_reset: float = 0.0) -> torch.Tensor:
    """One planned backbone segment (``backbone_fuse.plan_segments``)
    through one dispatch point.  x [T, B, H, W, C] spikes; params the
    (w, scale, bias) of each layer; specs its anonymous ``LayerSpec``s
    (same-shaped segments share one table entry) -> spikes after the
    last layer, pooling absorbed.  The launch table decides per shape:
    the ``backbone_segment`` kernel under its gate and cluster size
    (``LaunchConfig.gate``/``bm``; one device op, the weights read in
    place) or the per-layer route (the default); both give the same
    spikes."""
    T, B, H, W, _ = x.shape
    specs = tuple(specs)
    dims = segment_dims(specs, T=T, B=B, H=H, W=W)
    lif = dict(tau=tau, v_th=v_th, v_reset=v_reset)

    def run(cfg):
        if cfg.fused:
            return backbone_segment(x.contiguous(),
                                    segment_operands(params, specs),
                                    specs=specs, gate=cfg.gate,
                                    cluster=cfg.bm, **lif)
        return _seg_unfused(x, params, specs, lif)
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
