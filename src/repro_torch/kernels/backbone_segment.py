"""A planned backbone segment in one launch: the wrapper of its CUDA
kernel (``csrc/backbone_segment.cu``) and its plain version.

The kernel runs one thread-block cluster per batch element (``cluster``
blocks, each taking a share of a layer's rows) and chains the segment's
layers in a per-element scratch that the planner's budget keeps in L2:
per layer the conv (implicit im2col, canonical K blocks; or the
depthwise tap loop), the instance-norm statistics, normalise + affine +
LIF and the optional pool, a cluster barrier between the phases.  Its
conv sums as ``spike_conv``/``spike_conv_lif``/``spike_dwconv`` sum and
its statistics as ``norm_affine_lif``'s, so its spikes equal the
per-layer kernel route's bit for bit under either gate.

The plain version is the counterpart of the reference's ``_segment_ref``
in the per-layer route's own plain arithmetic (``blocked_matmul`` on the
patch matrix or the tap loop, ``norm_affine_lif_plain``,
``pool_slices``), so on the CPU a segment equals the per-layer route
exactly.  The wrapper takes it for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from repro_torch.core.layers import (NORM_EPS, _same_pads, blocked_matmul,
                                     fold, pool_slices, spike_conv,
                                     spike_im2col, unfold)
from repro_torch.core.lif import f32_decay
from repro_torch.kernels.backbone_fuse import (MAX_FUSED_STRIDE, LayerSpec,
                                               conv_out_hw, layer_out_hw,
                                               out_channels)
from repro_torch.kernels.blocks import CANONICAL_K_BLOCK
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)
from repro_torch.kernels.lif_scan import norm_affine_lif_plain

_SIG = ("backbone_segment_launch",
        [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4
        + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 4 + [ctypes.c_int64]
        + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_int, ctypes.c_void_p])

GATES = ("inline", "none")
_GATE_CODES = {"inline": 1, "none": 2}     # GateMode of gated_gemm.cuh
CLUSTER_SIZES = (16, 8, 4, 2, 1)           # blocks per batch element
DEFAULT_CLUSTER = 8      # portable: any sm_90 card schedules it
MAX_LAYERS = 16
MAX_POOL = 4
_ROW_CLASSES = 32
_UNSCHEDULABLE = -1


def weight_rows(spec: LayerSpec) -> int:
    """Rows of a layer's weight operand: K canonical-padded to 128 for a
    normal conv, the taps for a depthwise one."""
    taps = spec.kernel * spec.kernel
    if spec.depthwise:
        return taps
    k = taps * spec.cin
    return k + (-k) % CANONICAL_K_BLOCK


def segment_operands(params, specs: Sequence[LayerSpec]) -> Tuple:
    """Per-layer (w HWIO, scale, bias) -> the kernel's flat operands: a
    normal layer's canonical-padded [Kp, N] weight matrix (zero rows past
    K), a depthwise layer's [taps, C] tap matrix, then scale and bias."""
    flat = []
    for (w, scale, bias), s in zip(params, specs):
        if s.depthwise:
            flat.append(w.reshape(s.kernel * s.kernel, -1).contiguous())
        else:
            wmat = w.reshape(-1, w.shape[-1])
            pk = weight_rows(s) - wmat.shape[0]
            if pk:
                wmat = torch.cat([wmat, wmat.new_zeros((pk, wmat.shape[1]))])
            flat.append(wmat.contiguous())
        flat += [scale.contiguous(), bias.contiguous()]
    return tuple(flat)


def segment_layer_plain(x, w, spec: LayerSpec):
    """One layer's conv on x [T, B, H, W, C] with the kernel's weight
    operand -> the pre-norm conv output [T, B, Ho*Wo, n], contiguous:
    the per-layer route's plain conv (``blocked_matmul`` of the patch
    matrix over the first K weight rows, or the tap loop)."""
    T, B = x.shape[:2]
    xf = fold(x)
    if spec.depthwise:
        y = spike_conv(xf, w.reshape(spec.kernel, spec.kernel, 1, -1),
                       stride=spec.stride, depthwise=True)
    else:
        patches, (ho, wo) = spike_im2col(xf, spec.kernel, spec.kernel,
                                         spec.stride)
        k = spec.kernel * spec.kernel * spec.cin
        y = blocked_matmul(patches, w[:k]).reshape(xf.shape[0], ho, wo, -1)
    y = unfold(y, T, B)
    return y.reshape(T, B, -1, y.shape[-1]).contiguous(), y.shape[2:4]


def backbone_segment_plain(x, flat, *, specs, tau: float = 2.0,
                           v_th: float = 1.0, v_reset: float = 0.0,
                           eps: float = NORM_EPS) -> torch.Tensor:
    """The segment layer by layer: conv, ``norm_affine_lif_plain``, then
    ``pool_slices`` where the layer pools."""
    cur = x
    for i, s in enumerate(specs):
        w, scale, bias = flat[3 * i:3 * i + 3]
        y4, (ho, wo) = segment_layer_plain(cur, w, s)
        T, B, _, n = y4.shape
        cur = norm_affine_lif_plain(y4, scale, bias, tau=tau, v_th=v_th,
                                    v_reset=v_reset, eps=eps).reshape(
            T, B, ho, wo, n)
        if s.pool:
            cur = unfold(pool_slices(fold(cur), s.pool), T, B)
    return cur


def _check(x, flat, specs, gate, cluster):
    if gate not in GATES:
        raise ValueError(f"backbone_segment: gate must be one of {GATES}, "
                         f"got {gate!r}")
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"backbone_segment: cluster must be one of "
                         f"{CLUSTER_SIZES}, got {cluster!r}")
    if not specs or len(specs) > MAX_LAYERS:
        raise ValueError(f"backbone_segment: 1 to {MAX_LAYERS} layers, got "
                         f"{len(specs)}")
    if len(flat) != 3 * len(specs):
        raise ValueError("backbone_segment: flat must hold (w, scale, bias) "
                         "per layer")
    if x.dim() != 5 or x.shape[-1] != specs[0].cin:
        raise ValueError(f"backbone_segment: x must be [T, B, H, W, "
                         f"{specs[0].cin}], got {tuple(x.shape)}")
    cin = specs[0].cin
    for i, s in enumerate(specs):
        if s.stride > MAX_FUSED_STRIDE or s.stride < 1:
            raise ValueError(f"backbone_segment: layer {i} stride "
                             f"{s.stride} is not chained (1 to "
                             f"{MAX_FUSED_STRIDE})")
        if not 0 <= s.pool <= MAX_POOL:
            raise ValueError(f"backbone_segment: layer {i} pool {s.pool} not "
                             f"in [0, {MAX_POOL}]")
        if s.cin != cin or (s.depthwise and s.cout != s.cin):
            raise ValueError(f"backbone_segment: layer {i} ({s}) does not "
                             f"chain from {cin} channels")
        w, scale, bias = flat[3 * i:3 * i + 3]
        n = out_channels(s)
        want = (weight_rows(s), n)
        if tuple(w.shape) != want or scale.shape != (n,) \
                or bias.shape != (n,):
            raise ValueError(f"backbone_segment: layer {i} operands "
                             f"{tuple(w.shape)}, {tuple(scale.shape)}, "
                             f"{tuple(bias.shape)}; want {want}, ({n},)")
        cin = n


def backbone_segment(x: torch.Tensor, flat, *, specs, gate: str = "inline",
                     cluster: int = DEFAULT_CLUSTER, tau: float = 2.0,
                     v_th: float = 1.0, v_reset: float = 0.0,
                     eps: float = NORM_EPS) -> torch.Tensor:
    """x [T, B, H, W, C] spikes; ``flat`` the per-layer (w, scale, bias)
    of ``segment_operands``; ``specs`` the segment's ``LayerSpec``s ->
    spikes [T, B, Hf, Wf, Cf] after the last layer, pooling absorbed.
    ``gate``: "inline" (zero activations skipped) or "none"; ``cluster``:
    blocks per batch element."""
    specs = tuple(specs)
    _check(x, flat, specs, gate, cluster)
    dev = check_f32("backbone_segment", x, *flat)
    lif = dict(tau=tau, v_th=v_th, v_reset=v_reset, eps=eps)
    if dev.type == "cpu":
        return backbone_segment_plain(x, flat, specs=specs, **lif)
    T, B, H, W, _ = x.shape
    dims, ptrs = [], []
    act_elems = acc_elems = max_n = 1
    h, w = H, W
    for i, s in enumerate(specs):
        ho, wo = conv_out_hw(s, h, w)
        n = out_channels(s)
        pad_h = _same_pads(h, s.kernel, s.stride)[0]
        pad_w = _same_pads(w, s.kernel, s.stride)[0]
        dims += [h, w, s.cin, ho, wo, n, s.kernel, s.stride, pad_h, pad_w,
                 int(s.depthwise), s.pool]
        ptrs += [t.data_ptr() for t in flat[3 * i:3 * i + 3]]
        acc_elems = max(acc_elems, T * ho * wo * n)
        max_n = max(max_n, n)
        h, w = layer_out_hw(s, h, w)
        if i + 1 < len(specs):
            act_elems = max(act_elems, T * h * w * n)
    out = torch.empty((T, B, h, w, out_channels(specs[-1])),
                      dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    act = torch.empty((2, B, act_elems), dtype=torch.float32, device=dev)
    acc = torch.empty((B, acc_elems), dtype=torch.float32, device=dev)
    red = torch.empty((B, 2 * _ROW_CLASSES * max_n), dtype=torch.float64,
                      device=dev)
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    lib = load("backbone_segment", _SIG)
    with torch.cuda.device(dev):
        err = lib.backbone_segment_launch(
            c_dims, c_ptrs, len(specs), T, B, _GATE_CODES[gate],
            f32_decay(tau), v_th, v_reset, eps, x.data_ptr(), out.data_ptr(),
            act[0].data_ptr(), act[1].data_ptr(), act_elems, acc.data_ptr(),
            acc_elems, red.data_ptr(), max_n, cluster, stream_of(dev))
    if err == _UNSCHEDULABLE:
        raise RuntimeError(f"backbone_segment: the card cannot schedule a "
                           f"cluster of {cluster} blocks")
    check_launch("backbone_segment", err)
    return out
