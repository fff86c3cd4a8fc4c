"""The CUDA kernels against their plain PyTorch versions on the
card.  Every test needs an NVIDIA GPU and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: the GEMMs sum in another order than cuBLAS (allclose
atol=1e-4, rtol=1e-5, TF32 off); the LIF scan replays the plain
recurrence op for op (equal; with a dense layer's bias added in its
launch, equal to the plain scan of currents + bias); the norm kernel's
statistics round differently, so its spikes may flip only where the
plain membrane lies within 1e-4 of threshold.  The event voxelization
and the demosaic are bit-exact (equal; the demosaic also to the stencil
segment's demosaic instance, the same tile); NLM is held at atol 1e-6,
its exp and the plain version's may differ in the last bit.  The fused ISP segments replay
their plain versions op for op (equal for [exposure+dpc], [demosaic] and
[awb*+gamma]); sharpen's colour matrices are einsums on the plain side,
summed in another order, and NLM has its exp (atol 1e-6); every tile a
stencil op has an instance of gives its plan's bits.  The
depthwise conv replays the plain tap loop's roundings (equal, on spikes
and on real values, under any tiles) and the
max-pool has no rounding (equal, both gate modes, also read from [T, B]
spikes where they lie: contiguous, a batch-major view, a base pointer
off 16 bytes).  The spike matmul's
small path (the control head's) sums the tiled path's canonical chain
(equal to it).  The spike conv kernel reads the folded spikes (implicit im2col)
and gives the gated GEMM's bits on the materialised patches under every
gate (equal to spike_matmul on spike_im2col's patches).  The fused
conv->LIF kernel reads the folded spikes too, sums its conv as
spike_conv and its statistics as norm_affine_lif do, so its spikes equal
the per-op kernel pair's (equal, every gate, every served shape of the
four backbones, also with silent frames, and under other cluster sizes)
and are held to its plain version by the near-threshold rule (1e-4).
The backbone segment kernel sums its convs and statistics as the
per-layer kernels do, so its spikes
equal the per-layer kernel route's (equal, both gates, every cluster
size its plan accepts), and each of its layers is held to the plain layer on the route's
own input by the near-threshold rule (1e-4).  The norm kernel keeps the
statistics contract of csrc/lif_common.cuh, so its spikes equal the
contract's CPU replay (testing.norm_affine_lif_contract) under every
launch plan.  The kernels that once held the batch on gridDim.y or .z
(flash_attention's "mma_sync" and "f32" designs among them) run at batch
65537 (chip_smoke.batch_cap_run), equal on the checked batch elements to
a run on those elements alone.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.encoding import (OOB_POLICIES, VOXEL_MODES,
                                       EventStream, encode_batch,
                                       events_to_voxel_batch)
from repro_torch.configs.base import FleetConfig
from repro_torch.configs.registry import (ENCODING_CONFIGS, ISP_CONFIGS,
                                          reduced_snn)
from repro_torch.core.npu import init_npu
from repro_torch.core.layers import (blocked_matmul, fold,
                                     instance_norm_affine, pool_slices,
                                     unfold,
                                     spike_conv as conv_plain, spike_im2col)
from repro_torch.isp.demosaic import demosaic_mhc
from repro_torch.isp.fuse import compile_plan, segment_call
from repro_torch.isp.nlm import nlm_denoise
from repro_torch.isp.stages import control_to_stage_params
from repro_torch.kernels import build, ops, tune
from repro_torch.kernels.backbone_fuse import LayerSpec
from repro_torch.kernels.backbone_segment import (CLUSTER_SIZES,
                                                  backbone_segment,
                                                  plan_clusters,
                                                  segment_layer_plain,
                                                  segment_operands,
                                                  segment_plan)
from repro_torch.kernels.demosaic import demosaic
from repro_torch.kernels.event_voxel import event_voxel
from repro_torch.kernels import lif_scan as klif
from repro_torch.kernels.lif_scan import lif_scan, norm_affine_lif
from repro_torch.kernels import isp_fused as isp_mod
from repro_torch.kernels.max_pool import max_pool
from repro_torch.kernels.nlm import nlm
from repro_torch.kernels.spike_conv import GATES as CONV_GATES
from repro_torch.kernels.spike_conv import conv_tiles, spike_conv
from repro_torch.kernels.spike_conv_lif import (GATES, conv_lif_plan,
                                                spike_conv_lif)
from repro_torch.kernels import spike_dwconv as dw_mod
from repro_torch.kernels import spike_matmul as mm_mod
from repro_torch.kernels.spike_dwconv import spike_dwconv
from repro_torch.kernels.spike_matmul import spike_matmul
from repro_torch.serve.cognitive_engine import PerceptionRequest
from repro_torch.serve.fleet import FleetEngine
from repro_torch.serve.transport import stage_request, validate_request
from repro_torch.testing import norm_affine_lif_contract, spike_mismatch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the served norm shapes and the batch-cap runs, shared with the card run
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    """Decided inside the test, never at collection time, so every
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _spikes(rng, shape, density, silent_rows=0):
    x = (rng.random(shape) < density).astype(np.float32)
    x[:silent_rows] = 0.0
    return torch.tensor(x)


@pytest.mark.parametrize("T,N", [(5, 512), (3, 1025), (5, 40960)])
def test_lif_scan_bitexact(dev, T, N):
    rng = np.random.default_rng(N)
    cur = torch.tensor(rng.normal(0.6, 1.0, (T, N)).astype(np.float32))
    got = lif_scan(cur.to(dev))
    torch.testing.assert_close(got, lif_scan(cur).to(dev), rtol=0, atol=0)


@pytest.mark.parametrize("T,B,HW,C", [(5, 2, 256, 64), (3, 3, 100, 40),
                                      (5, 8, 1024, 32)])
def test_norm_affine_lif_matches_plain(dev, T, B, HW, C):
    rng = np.random.default_rng(HW + C)
    y = torch.tensor(rng.normal(0.3, 1.0, (T, B, HW, C)).astype(np.float32),
                     device=dev)
    scale = torch.tensor(rng.normal(1, 0.2, (C,)).astype(np.float32),
                         device=dev)
    bias = torch.tensor(rng.normal(0, 0.1, (C,)).astype(np.float32),
                        device=dev)
    got = norm_affine_lif(y, scale, bias)
    res = spike_mismatch(instance_norm_affine(y, scale, bias), got, tol=1e-4)
    assert res["far"] == 0, res


def _norm_case(shape, seed, case="normal"):
    """y [T, B, HW, C], scale, bias on the CPU.  "silent": an all-zero
    slab (no variance: z is the bias); "on_threshold": every other
    channel has scale 0 and bias v_th, so its normalised current is
    exactly 1.0 and u - v_th is exactly 0 at t = 0."""
    rng = np.random.default_rng(seed)
    T, B, HW, C = shape
    y = rng.normal(0.3, 1.0, shape).astype(np.float32)
    scale = rng.normal(1, 0.2, (C,)).astype(np.float32)
    bias = rng.normal(0, 0.3, (C,)).astype(np.float32)
    if case == "silent":
        y[:] = 0.0
        bias[::2] = 1.0
    elif case == "on_threshold":
        scale[::2] = 0.0
        bias[::2] = 1.0
    return tuple(torch.tensor(a) for a in (y, scale, bias))


def _norm_equals_contract(dev, y, scale, bias, plan=None):
    args = (y.to(dev), scale.to(dev), bias.to(dev))
    if plan is None:
        got = norm_affine_lif(*args)
    else:
        got = klif._norm_launch(*args, plan, tau=2.0, v_th=1.0,
                                v_reset=0.0, eps=klif.NORM_EPS)
    torch.cuda.synchronize()
    want = norm_affine_lif_contract(y, scale, bias)
    assert torch.equal(got.cpu(), want), int((got.cpu() != want).sum())
    return got


@pytest.mark.parametrize("shape", chip_smoke.NORM_SERVED_SHAPES)
def test_norm_affine_lif_served_shapes_equal_contract(dev, shape):
    """Every served shape of the four backbones' ticks: the kernel's
    spikes equal the contract's replay bit for bit."""
    _norm_equals_contract(dev, *_norm_case(shape, sum(shape)))


@pytest.mark.parametrize("T", [1, 3, 5])
@pytest.mark.parametrize("HW", [1, 16, 100, 33])
@pytest.mark.parametrize("C", [1, 24, 33, 66])
def test_norm_affine_lif_ragged_equal_contract(dev, T, HW, C):
    _norm_equals_contract(dev, *_norm_case((T, 3, HW, C), T * HW + C))


@pytest.mark.parametrize("case", ["silent", "on_threshold"])
@pytest.mark.parametrize("shape", [(5, 2, 256, 24), (3, 2, 33, 66)])
def test_norm_affine_lif_edge_values_equal_contract(dev, case, shape):
    got = _norm_equals_contract(dev, *_norm_case(shape, 7, case))
    if case == "on_threshold":
        assert bool((got[0, :, :, ::2] == 1.0).all())


def _plans(shape):
    """The default plan and others: every cluster size, narrow and wide
    tiles, 4-byte copies, the slab streamed from L2."""
    T, B, HW, C = shape
    base = klif.norm_lif_plan(*shape)
    out = [base, dataclasses.replace(base, staged=False),
           dataclasses.replace(base, vec=1)]
    for cluster in (1, 2, 4, 8, 16):
        for ct in sorted({1, min(C, 8), min(C, 32), base.ct}):
            classes = 32 // cluster
            p = dataclasses.replace(
                base, ct=ct, cluster=cluster, vec=1,
                threads=max(256, -(-classes * ct // 32) * 32))
            if p.smem_bytes > klif.MAX_SMEM:
                p = dataclasses.replace(p, staged=False)
            out.append(p)
    return out


@pytest.mark.parametrize("shape", [(5, 2, 1024, 32), (5, 3, 100, 33),
                                   (3, 2, 33, 66), (2, 2, 16, 24)])
def test_norm_affine_lif_under_other_plans(dev, shape):
    """The contract fixes the bits, not the plan: every plan gives the
    replay's spikes."""
    y, scale, bias = _norm_case(shape, 3)
    for plan in _plans(shape):
        _norm_equals_contract(dev, y, scale, bias, plan)


def test_norm_affine_lif_refuses_a_bad_plan(dev):
    y, scale, bias = (t.to(dev) for t in _norm_case((2, 1, 4, 6), 0))
    bad = dataclasses.replace(klif.norm_lif_plan(2, 1, 4, 6), vec=4)
    with pytest.raises(RuntimeError, match="failed to launch"):
        klif._norm_launch(y, scale, bias, bad, tau=2.0, v_th=1.0,
                          v_reset=0.0, eps=klif.NORM_EPS)


@pytest.mark.parametrize("kernel", chip_smoke.BATCH_CAP_KERNELS)
def test_batch_past_the_old_grid_cap(dev, kernel):
    """Batch 65537 (65537 time steps for event_voxel_steps) on a tiny
    spatial shape: the last batch elements equal a run on them alone
    (the steps: the plain version)."""
    got, want = chip_smoke.batch_cap_run(kernel, dev)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


# (N, H, W, cin, cout, k, stride, density, silent frames)
CONV_CASES = {
    "strided_ragged": (4, 17, 15, 2, 19, 3, 2, 0.3, 0),
    "wide_k": (2, 8, 8, 40, 24, 3, 1, 0.2, 0),
    "pointwise": (3, 8, 8, 256, 14, 1, 1, 0.4, 0),
    "partly_silent": (6, 16, 16, 32, 64, 3, 1, 0.3, 4),
    "all_silent": (2, 8, 8, 4, 8, 3, 2, 0.0, 0),
    # split-K: M = 640, K = 2304, N = 256 (YOLO's f3 and head conv)
    "split_k": (40, 4, 4, 256, 256, 3, 1, 0.2, 0),
    # 2 channels (8-byte chunks), stride 2 on an even 64-wide input
    "c2_stride2_even": (40, 64, 64, 2, 32, 3, 2, 0.05, 0),
    # DenseNet's first dense layer: cout 24 in a 32-wide tile, K = 216
    "densenet_c24": (40, 32, 32, 24, 24, 3, 1, 0.2, 0),
    "pointwise_c66": (20, 8, 8, 66, 14, 1, 1, 0.3, 0),  # 8-byte chunks
    "odd_c15": (4, 12, 12, 15, 19, 3, 1, 0.3, 0),       # 4-byte chunks
}


def _conv_inputs(dev, case, seed, silent_half=False):
    n, h, w_, cin, cout, k, stride, dens, silent = CONV_CASES[case]
    rng = np.random.default_rng(seed)
    xf = _spikes(rng, (n, h, w_, cin), dens, silent)
    if silent_half:
        xf[: n // 2] = 0.0
    w = torch.tensor(rng.normal(0, 1, (k, k, cin, cout)).astype(np.float32))
    return xf.to(dev), w.to(dev), k, stride


def _oracle(xf, w, k, stride):
    """Today's gated GEMM (spike_matmul) on the materialised patches."""
    patches, (Ho, Wo) = spike_im2col(xf, k, k, stride)
    y = spike_matmul(patches, w.reshape(-1, w.shape[-1]).contiguous())
    return y.reshape(xf.shape[0], Ho, Wo, -1)


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_spike_conv_matches_plain(dev, case):
    """Every gate bit-equal to spike_matmul on the patches, and within
    1e-4 of the plain version."""
    xf, w, k, stride = _conv_inputs(dev, case, len(case))
    want = _oracle(xf, w, k, stride)
    plain = spike_conv(xf.cpu(), w.cpu(), stride=stride)
    for gate in CONV_GATES:
        got = spike_conv(xf, w, stride=stride, gate=gate)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (gate, float((got - want).abs().max()))
        torch.testing.assert_close(got.cpu(), plain, atol=1e-4, rtol=1e-5)
    if case == "split_k":
        M, K, N = xf.shape[0] * 16, w.shape[0] ** 2 * w.shape[2], w.shape[3]
        assert conv_tiles(M, K, N).split


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_spike_conv_inline_gate_matches_plain(dev, case):
    """Half the frames silent, so the gates skip: "inline" (and "mask",
    "none") bit-equal to spike_matmul on the patches, within 1e-4 of
    the plain version."""
    xf, w, k, stride = _conv_inputs(dev, case, 5, silent_half=True)
    want = _oracle(xf, w, k, stride)
    got = spike_conv(xf, w, stride=stride, gate="inline")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for gate in ("mask", "none"):
        assert torch.equal(spike_conv(xf, w, stride=stride, gate=gate), got)
    torch.testing.assert_close(got.cpu(), spike_conv(
        xf.cpu(), w.cpu(), stride=stride), atol=1e-4, rtol=1e-5)


# (T, B, H, W, cin, cout, stride, density, silent frames)
CONV_LIF_CASES = {
    "yolo_d0": (5, 8, 64, 64, 2, 32, 2, 0.1, 0),
    "ragged_rows_k": (3, 3, 13, 11, 20, 24, 2, 0.3, 0),
    "wide_channels": (5, 2, 8, 8, 64, 256, 1, 0.2, 0),
    "partly_silent": (5, 4, 16, 16, 32, 64, 1, 0.3, 10),
    "all_silent": (3, 2, 8, 8, 4, 8, 1, 0.0, 0),
}


def _conv_lif_pair(xf, w, scale, bias, T, B, stride, gate="mask"):
    """The per-op kernel pair on the same spikes: (spikes [T, B, HW, N],
    the pair's normalised currents)."""
    y = spike_conv(xf, w, stride=stride, gate=gate)
    y4 = y.reshape(B, T, -1, w.shape[3]).transpose(0, 1).contiguous()
    return norm_affine_lif(y4, scale, bias), instance_norm_affine(
        y4, scale, bias)


def _conv_lif_params(rng, cin, cout, k, dev):
    w = torch.tensor(rng.normal(0, 1, (k, k, cin, cout)).astype(np.float32),
                     device=dev)
    scale = torch.tensor(rng.normal(1, 0.2, cout).astype(np.float32),
                         device=dev)
    bias = torch.tensor(rng.normal(0, 0.2, cout).astype(np.float32),
                        device=dev)
    return w, scale, bias


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("case", sorted(CONV_LIF_CASES))
def test_spike_conv_lif_matches_per_op_pair_and_plain(dev, case, gate):
    """Equal to the per-op kernel pair at the plan's cluster size and at
    the others that hold the slab; the plain version by the rule."""
    T, B, h, w_, cin, cout, stride, dens, silent = CONV_LIF_CASES[case]
    rng = np.random.default_rng(len(case) + cout)
    xf = _spikes(rng, (B * T, h, w_, cin), dens, silent).to(dev)
    w, scale, bias = _conv_lif_params(rng, cin, cout, 3, dev)
    pair, z = _conv_lif_pair(xf, w, scale, bias, T, B, stride)
    HW = pair.shape[2]
    for cluster in (1, 2, 4, 8, 16):
        try:
            conv_lif_plan(T, B, HW, cout, 9 * cin, cluster=cluster)
        except ValueError:
            continue
        got = spike_conv_lif(xf, w, scale, bias, T=T, B=B, stride=stride,
                             gate=gate, cluster=cluster)
        torch.cuda.synchronize()
        assert torch.equal(got, pair), (cluster, int((got != pair).sum()))
    plain = spike_conv_lif(xf.cpu(), w.cpu(), scale.cpu(), bias.cpu(), T=T,
                           B=B, stride=stride)
    assert spike_mismatch(z.cpu(), plain, tol=1e-4)["far"] == 0
    assert spike_mismatch(z.cpu(), got, tol=1e-4)["far"] == 0


@pytest.mark.parametrize("shape", chip_smoke.CONV_LIF_SERVED_SHAPES)
def test_spike_conv_lif_served_shapes_equal_per_op_pair(dev, shape):
    """Every served (T, B, HW, K, N) of the four backbones (a 3x3 conv
    where 9 divides K, else 1x1; stride 1 on a square frame), under each
    gate, on 15% spikes and again with the first half of the batch
    silent (the "mask" and "inline" gates skip tiles): torch.equal to the
    per-op kernel pair."""
    T, B, HW, K, N = shape
    k = 3 if K % 9 == 0 else 1
    side = int(round(HW ** 0.5))
    rng = np.random.default_rng(HW + K + N)
    xf = _spikes(rng, (B * T, side, side, K // (k * k)), 0.15).to(dev)
    w, scale, bias = _conv_lif_params(rng, K // (k * k), N, k, dev)
    silent = xf.clone()
    silent[: B * T // 2] = 0.0
    for x in (xf, silent):
        pair, _ = _conv_lif_pair(x, w, scale, bias, T, B, 1)
        for gate in GATES:
            got = spike_conv_lif(x, w, scale, bias, T=T, B=B, gate=gate)
            torch.cuda.synchronize()
            assert torch.equal(got, pair), (gate, int((got != pair).sum()))


# (N, H, W, C, stride, density, silent frames)
DW_CASES = {
    # MobileNet's four depthwise layers at batch 8 (T = 5)
    "mobilenet_dw0": (40, 64, 64, 32, 2, 0.2, 0),
    "mobilenet_dw1": (40, 32, 32, 32, 2, 0.2, 0),
    "mobilenet_dw2": (40, 16, 16, 64, 2, 0.2, 0),
    "mobilenet_dw3": (40, 8, 8, 128, 2, 0.2, 0),
    "mobilenet_dw0_half_silent": (40, 64, 64, 32, 2, 0.2, 20),
    # more frames than gridDim.y or z could hold
    "frames_65537": (65537, 8, 8, 8, 2, 0.2, 0),
    # wide frames at stride 1, and on 4-byte lanes (C % 4 != 0)
    "wide_stride1": (40, 32, 32, 32, 1, 0.2, 0),
    "wide_c33": (40, 64, 64, 33, 2, 0.2, 0),
    "wide_c33_stride1": (40, 32, 32, 33, 1, 0.2, 0),
    "odd_ragged": (3, 17, 15, 33, 2, 0.3, 0),
    "stride1_wide": (4, 9, 10, 256, 1, 0.1, 0),
    "partly_silent": (6, 16, 16, 24, 2, 0.3, 4),
    "all_silent": (2, 8, 8, 8, 1, 0.0, 0),
}


def _other_dw_tiles(t):
    """Taller and narrower tiles than ``dw_tiles`` picks, 8 channels a
    block where C allows it: several commit groups a block, several
    column bands and channel groups."""
    cg = 8 if t.C % 8 == 0 else t.cg
    t = dataclasses.replace(t, cg=cg, bw=max(1, t.Wo // 3),
                            bh=min(dw_mod.MAX_BAND, t.Ho), col_threads=3)
    while t.smem_bytes > dw_mod.MAX_SMEM:
        t = dataclasses.replace(t, bh=t.bh - 1)
    return t


@pytest.mark.parametrize("case", sorted(DW_CASES))
def test_spike_dwconv_bitexact(dev, case):
    """Equal to the plain tap loop on spikes and on real values, with
    dw_tiles' tiles and with others."""
    n, h, w_, c, stride, dens, silent = DW_CASES[case]
    rng = np.random.default_rng(len(case) + c)
    w = torch.tensor(rng.normal(0, 0.5, (3, 3, 1, c)).astype(np.float32),
                     device=dev)
    spikes = _spikes(rng, (n, h, w_, c), dens, silent).to(dev)
    real = torch.tensor(rng.normal(0, 1, (n, h, w_, c)).astype(np.float32),
                        device=dev)
    for x in (spikes, real):
        got = spike_dwconv(x, w, stride=stride)
        want = conv_plain(x, w, stride=stride, depthwise=True)
        assert torch.equal(got, want)
        t = dw_mod.dw_tiles(n, h, w_, c, 3, 3, stride)
        assert torch.equal(dw_mod._launch(x, w, stride, _other_dw_tiles(t)),
                           want)
        if n <= 64:
            assert torch.equal(got.cpu(), conv_plain(x.cpu(), w.cpu(),
                                                     stride=stride,
                                                     depthwise=True))


@pytest.mark.parametrize("k,offset", [(1, 0), (5, 0), (3, 1), (5, 1),
                                      (15, 0), (57, 1)])
def test_spike_dwconv_other_kernels_and_unaligned(dev, k, offset):
    """Kernel sizes other than 3x3 (the runtime-size instance; 15 and 57
    with narrower tiles and fewer channels a block), and an input 4 bytes
    off a 16-byte boundary (the 4-byte lane path at C % 4 == 0): equal to
    the plain tap loop."""
    n, h, w_, c = 6, 13, 11, 16
    rng = np.random.default_rng(10 * k + offset)
    w = torch.tensor(rng.normal(0, 0.5, (k, k, 1, c)).astype(np.float32),
                     device=dev)
    flat = torch.zeros(n * h * w_ * c + offset, device=dev)
    x = flat[offset:].view(n, h, w_, c)
    x.copy_(_spikes(rng, (n, h, w_, c), 0.3).to(dev))
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    for stride in (1, 2):
        got = spike_dwconv(x, w, stride=stride)
        assert torch.equal(got, conv_plain(x, w, stride=stride,
                                           depthwise=True))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("shape,density", [((40, 32, 32, 64), 0.2),
                                           ((3, 9, 7, 33), 0.3),
                                           ((5, 16, 16, 66), 0.0),
                                           ((4, 8, 8, 24), 1.0)])
def test_max_pool_matches_plain(dev, shape, density, gated):
    rng = np.random.default_rng(shape[3])
    x = _spikes(rng, shape, density, silent_rows=1).to(dev)
    assert torch.equal(max_pool(x, window=2, gated=gated), pool_slices(x, 2))
    real = torch.tensor(rng.normal(0, 1, shape).astype(np.float32),
                        device=dev)
    assert torch.equal(max_pool(real, window=2, gated=gated),
                       pool_slices(real, 2))
    assert torch.equal(max_pool(real, window=3, gated=gated),
                       pool_slices(real, 3))


# (T, B, H, W, C, window): VGG's first pool, DenseNet's last (C = 66, the
# 4-byte lanes), a window-3 pool with a ragged tail, a row of 8 lanes
TB_POOLS = [(5, 8, 64, 64, 32, 2), (5, 8, 16, 16, 66, 2),
            (3, 2, 11, 13, 8, 3), (2, 3, 8, 8, 4, 2)]


def _offset(t, floats=1):
    """t's values in a tensor whose base pointer is ``floats`` floats past
    a 16-byte boundary (the kernel takes its 4-byte lanes there)."""
    buf = torch.zeros(t.numel() + floats, device=t.device)
    out = buf[floats:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("layout", ["tb", "batch_major", "misaligned"])
@pytest.mark.parametrize("case", TB_POOLS)
def test_max_pool_on_tb_spikes_matches_plain(dev, case, layout, gated):
    """The [T, B] entry on the layer's spikes where they lie (contiguous
    in [T, B] order, the unfold view of a batch-major tensor, or a base
    pointer off a 16-byte boundary), one frame silent: bit-equal to
    pool_slices(fold(x))."""
    T, B, H, W, C, window = case
    rng = np.random.default_rng(C + window)
    x = _spikes(rng, (T, B, H, W, C), 0.2).to(dev)
    x[0, 0] = 0.0                               # a silent frame
    if layout == "batch_major":
        x = fold(x).contiguous().reshape(B, T, H, W, C).transpose(0, 1)
    elif layout == "misaligned":
        x = _offset(x)
    want = pool_slices(fold(x), window)
    got = max_pool(x, window=window, gated=gated)
    assert got.shape == (B * T, H // window, W // window, C)
    assert torch.equal(got, want)
    assert torch.equal(ops.max_pool_op(x, window=window, gated=gated),
                       want.reshape(B, T, *want.shape[1:]).transpose(0, 1))


@pytest.mark.parametrize("M,K,N,density", [(40, 64, 8, 0.3), (40, 64, 8, 0.0),
                                           (300, 200, 33, 0.1)])
def test_spike_matmul_matches_plain(dev, M, K, N, density):
    rng = np.random.default_rng(M + K)
    x = _spikes(rng, (M, K), density)
    w = torch.tensor(rng.normal(0, 1, (K, N)).astype(np.float32))
    got = spike_matmul(x.to(dev), w.to(dev))
    torch.testing.assert_close(got.cpu(), spike_matmul(x, w), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("M,K,N,density", [
    (40, 64, 8, 0.3),           # the control head at batch 8
    (5, 64, 8, 0.3),            # ... at batch 1
    (80, 64, 8, 0.3),           # ... at batch 16: two blocks
    (40, 64, 8, 0.0),
    (37, 200, 13, 0.2),         # two K blocks, the second ragged
    (1, 200, 33, 0.5),
    (300, 130, 1, 0.2),
    (64, 127, 64, 0.1),         # K % 4 != 0: 4-byte loads of x
])
def test_spike_matmul_small_path_equals_tiled(dev, M, K, N, density):
    """The small path gives the tiled path's bits, and both lie within
    1e-4 of blocked_matmul."""
    assert mm_mod.matmul_path(M, N) == "small"
    rng = np.random.default_rng(M * K + N)
    x = _spikes(rng, (M, K), density, silent_rows=M // 3).to(dev)
    w = torch.tensor(rng.normal(0, 1, (K, N)).astype(np.float32),
                     device=dev)
    got = spike_matmul(x, w)
    assert torch.equal(got, mm_mod._launch(x, w, "tiled"))
    torch.testing.assert_close(got, blocked_matmul(x, w), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("kernel", ["spike_conv", "spike_matmul"])
def test_gemm_past_the_old_row_tile_cap(dev, kernel):
    """More than 65535 * 64 rows: more 64-row tiles than gridDim.y holds
    (the row tiles sit on gridDim.x), against the plain version.
    spike_conv on a VGG-first-layer-like xf [1025, 64, 64, 2] (M =
    1025 * 4096 rows), also bit-equal to spike_matmul on its patches;
    spike_matmul on M = 65535 * 64 + 64 rows."""
    g = torch.Generator(device=dev).manual_seed(0)
    if kernel == "spike_conv":
        xf = (torch.rand(1025, 64, 64, 2, device=dev, generator=g)
              < 0.1).float()
        xf[-1] = 1.0            # the last row tiles live
        w = torch.randn(3, 3, 2, 32, device=dev, generator=g)
        patches, _ = spike_im2col(xf, 3, 3, 1)
        assert patches.shape[0] > 65535 * 64
        wmat = w.reshape(-1, 32)
        got = spike_conv(xf, w).reshape(-1, 32)
        assert torch.equal(got, spike_matmul(patches, wmat))
        want = spike_matmul(patches.cpu(), wmat.cpu())
    else:
        M, K, N = 65535 * 64 + 64, 18, 32
        x = (torch.rand(M, K, device=dev, generator=g) < 0.1).float()
        x[-64:] = 1.0           # the last row tile live
        w = torch.randn(K, N, device=dev, generator=g)
        got = spike_matmul(x, w)
        want = spike_matmul(x.cpu(), w.cpu())
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-5)


def _events(rng, B, N, T, H, W, *, live=0.8, hot=False):
    """[B, N] events with out-of-range coordinates, polarities and
    timestamps (boundary ``t == window`` included); ``hot`` piles every
    event onto four cells."""
    t = rng.uniform(-0.3, 1.3, (B, N)).astype(np.float32)
    t[:, :3] = 1.0
    if hot:
        x = rng.integers(0, 2, (B, N))
        y = rng.integers(0, 2, (B, N))
    else:
        x = rng.integers(-2, W + 2, (B, N))
        y = rng.integers(-2, H + 2, (B, N))
    p = rng.integers(-1, 3, (B, N))
    return EventStream(torch.tensor(t), *(torch.tensor(a.astype(np.int32))
                                          for a in (x, y, p)),
                       torch.tensor(rng.random((B, N)) < live))


# (B, N, T, H, W): the tick's windows, none live, every event on four
# cells, a frame that is no whole number of 16-byte groups, a DAVIS346
# frame and a 720p one (several clusters a window), and a buffer of an
# odd length (4-byte event loads)
VOXEL_CASES = {"path": (8, 2048, 5, 64, 64), "empty": (2, 512, 5, 16, 16),
               "overfull": (2, 8192, 3, 16, 12), "odd": (3, 300, 7, 37, 53),
               "davis346": (2, 4096, 5, 260, 346),
               "hd720": (2, 4096, 5, 720, 1280),
               "odd_buffer": (3, 301, 5, 16, 12)}


@pytest.mark.parametrize("case", list(VOXEL_CASES))
def test_event_voxel_bitexact(dev, case):
    B, N, T, H, W = VOXEL_CASES[case]
    rng = np.random.default_rng(len(case))
    evs = _events(rng, B, N, T, H, W, live=0.0 if case == "empty" else 0.8,
                  hot=case == "overfull")
    on_dev = EventStream(*(a.to(dev) for a in evs))
    for mode in VOXEL_MODES:
        for oob in OOB_POLICIES:
            kw = dict(time_steps=T, height=H, width=W, mode=mode, oob=oob)
            got = event_voxel(on_dev, **kw)
            want = events_to_voxel_batch(on_dev, **kw)
            assert torch.equal(got, want), (mode, oob)
            assert torch.equal(got.cpu(), events_to_voxel_batch(evs, **kw))


@pytest.mark.parametrize("case", ["path", "odd", "davis346", "hd720",
                                  "odd_buffer"])
def test_encode_batch_matches_plain(dev, case):
    """The tick's encode on "cuda" (one launch: the grid of each window
    from events, the staged voxels of the others, the [T, B] view of a
    batch-major grid, so the next fold is a view) equal to its plain
    form, in every mode x oob policy, with a mask that mixes windows."""
    B, N, T, H, W = VOXEL_CASES[case]
    rng = np.random.default_rng(N)
    evs = EventStream(*(a.to(dev) for a in _events(rng, B, N, T, H, W)))
    vox = torch.tensor(rng.uniform(-1, 2, (T, B, H, W, 2)).astype(np.float32),
                       device=dev)
    for mask in (np.arange(B) % 2 == 0, np.ones(B, bool), np.zeros(B, bool)):
        fe = torch.tensor(mask, device=dev)
        for mode in VOXEL_MODES:
            for oob in OOB_POLICIES:
                kw = dict(time_steps=T, height=H, width=W, mode=mode,
                          oob=oob)
                build.reset_launches()
                got = encode_batch(evs, vox, fe, backend="cuda", **kw)
                assert build.LAUNCHES == {"event_voxel": 1}
                assert got.shape == vox.shape
                assert fold(got).data_ptr() == got.data_ptr()
                assert got.transpose(0, 1).is_contiguous()
                want = encode_batch(evs, vox, fe, backend="torch", **kw)
                assert torch.equal(got, want), (mask, mode, oob)


@pytest.mark.parametrize("B,H,W", [(8, 64, 64), (2, 37, 53)])
def test_demosaic_bitexact(dev, B, H, W):
    raw = torch.tensor(np.random.default_rng(H).uniform(
        -0.1, 1.1, (B, H, W)).astype(np.float32), device=dev)
    assert torch.equal(demosaic(raw), demosaic_mhc(raw))


@pytest.mark.parametrize("B,H,W", [(3, 5, 7), (1, 1, 1), (2, 9, 33),
                                   (1, 10, 34), (2, 17, 63), (1, 2, 2),
                                   (4, 480, 640)])
def test_demosaic_every_phase_at_a_ragged_edge(dev, B, H, W):
    """Odd, tiny and VGA frames: the last tile row and column are cut at
    either parity, so all four Bayer phases meet the ragged edge; values
    outside [0, 1] reach the clip.  Bit-exact to the plain version and to
    the stencil segment's demosaic instance (the same demosaic tile), in
    one launch a call."""
    from repro_torch.isp.demosaic import demosaic_window
    raw = torch.tensor(np.random.default_rng(H * W).uniform(
        -0.1, 1.1, (B, H, W)).astype(np.float32), device=dev)
    build.reset_launches()
    got = demosaic(raw)
    assert build.LAUNCHES == {"demosaic": 1}
    assert torch.equal(got, demosaic_mhc(raw))
    wstep = isp_mod.ChainStep(fn=demosaic_window, names=(), offset=0,
                              op="demosaic")
    none = torch.zeros(B, 1, device=dev)
    seg = isp_mod.stencil_segment(
        raw, none, none, prologue=(), window_fn=demosaic_window,
        wstep=wstep, radius=2, pad="zero", out_tail=(3,))
    assert torch.equal(got, seg)


@pytest.mark.parametrize("T,B,C", [(5, 8, 64), (3, 2, 33), (12, 4, 40),
                                   (1, 1, 1)])
def test_lif_scan_bias_bitexact(dev, T, B, C):
    """The dense layer's bias added in the launch: equal to the plain
    scan of currents + bias and to the kernel without a bias on them,
    through the wrapper and the op, with C dividing N at 1 to 64
    channels and T 1 to 12."""
    rng = np.random.default_rng(T * B * C)
    y = torch.tensor(rng.normal(0.5, 1.0, (T, B, C)).astype(np.float32),
                     device=dev)
    bias = torch.tensor(rng.normal(0.0, 0.5, C).astype(np.float32),
                        device=dev)
    want = lif_scan((y + bias).reshape(T, -1).cpu()).to(dev)
    build.reset_launches()
    got = lif_scan(y.reshape(T, -1), bias=bias)
    assert build.LAUNCHES == {"lif_scan": 1}
    assert torch.equal(got, want)
    assert torch.equal(lif_scan((y + bias).reshape(T, -1)), want)
    assert torch.equal(ops.lif_scan_op(y, bias=bias).reshape(T, -1), want)


@pytest.mark.parametrize("B,H,W,C", [(8, 64, 64, 3), (2, 128, 96, 3),
                                     (2, 20, 17, 1), (2, 33, 40, 2),
                                     (3, 24, 31, 4), (1, 5, 7, 3)])
def test_nlm_matches_plain(dev, B, H, W, C):
    rng = np.random.default_rng(H + C)
    img = torch.tensor(rng.uniform(0, 1, (B, H, W, C)).astype(np.float32),
                       device=dev)
    strength = torch.tensor(rng.uniform(0, 1, B).astype(np.float32),
                            device=dev)
    got = nlm(img, strength)
    torch.testing.assert_close(got, nlm_denoise(img, strength), atol=1e-6,
                               rtol=0)
    # a scalar strength is the same as a tensor of it
    same = torch.full((B,), float(strength[0]), device=dev)
    assert torch.equal(nlm(img, float(strength[0])), nlm(img, same))


@pytest.mark.parametrize("B,H,W,C", [(8, 64, 64, 3), (2, 37, 53, 1),
                                     (1, 5, 7, 3), (2, 40, 48, 1)])
def test_nlm_equals_stencil_nlm(dev, B, H, W, C):
    """nlm and the stencil segment with an empty prologue and the nlm
    window op run the same NLM tile: equal bits."""
    from repro_torch.isp.nlm import nlm_window
    rng = np.random.default_rng(W + C)
    img = torch.tensor(rng.uniform(0, 1, (B, H, W, C)).astype(np.float32),
                       device=dev)
    x = img[..., 0] if C == 1 else img
    strength = torch.tensor(rng.uniform(0, 1, B).astype(np.float32),
                            device=dev)
    wstep = isp_mod.ChainStep(fn=nlm_window, names=("strength",), offset=0,
                              op="nlm")
    seg = isp_mod.stencil_segment(
        x, strength[:, None].contiguous(), torch.zeros(B, 1, device=dev),
        prologue=(), window_fn=nlm_window, wstep=wstep, radius=4,
        pad="wrap", out_tail=() if C == 1 else (C,))
    assert torch.equal(nlm(x, strength), seg)


# plan segments that give the plain version's bits
EXACT_SEGMENTS = ("[exposure+dpc]", "[demosaic]", "[awb*+gamma]")


@pytest.mark.parametrize("name", ["fused", "hdr_fused", "fast_preview"])
@pytest.mark.parametrize("B,H,W", [(8, 64, 64), (2, 37, 53), (4, 480, 640),
                                   (1, 5, 7), (4, 128, 128)])
def test_isp_fused_segments_match_plain(dev, name, B, H, W):
    """Every segment of the ordering's plan, its kernel against its plain
    version on the same inputs, per-frame control vectors."""
    rng = np.random.default_rng(H + len(name))
    stages = ISP_CONFIGS[name].stages
    raw = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    raw[rng.random((B, H, W)) < 0.02] = 1.0
    ctrl = torch.tensor(rng.uniform(0, 1, (B, ISP_CONFIGS[name].control_dim))
                        .astype(np.float32), device=dev)
    sp = control_to_stage_params(ctrl, stages)
    x = torch.tensor(raw, device=dev)
    for ex in compile_plan(stages):
        assert ex.launches_kernel
        kernel, plain, args, kw = segment_call(ex, x, sp)
        got, want = kernel(*args, **kw), plain(*args, **kw)
        label = ex.segment.describe()
        if label in EXACT_SEGMENTS:
            assert torch.equal(got, want), label
        else:
            torch.testing.assert_close(got, want, atol=1e-6, rtol=0,
                                       msg=label)
        x = want.contiguous()


@pytest.mark.parametrize("label", list(chip_smoke.POINTWISE_CASES))
@pytest.mark.parametrize("shape", [(8, 64, 64), (2, 37, 53), (3, 5, 7),
                                   (1, 1, 1), (5, 3, 1), (2, 17, 33),
                                   (3, 32, 35)])
def test_pointwise_segment_bitexact(dev, label, shape):
    """Row 12's cases (a C = 3 chain with gamma, a Bayer chain, a chain
    with no gamma) on frames ragged, smaller than a tile and one pixel:
    the kernel gives its plain version's bits (the no-gamma chain's
    tonemap and CCM within 1e-6)."""
    g = torch.Generator(dev).manual_seed(sum(shape) + len(label))
    kernel, plain, args, kw = chip_smoke.pointwise_call(label, shape, dev, g)
    got, want = kernel(*args, **kw), plain(*args, **kw)
    if label in chip_smoke.POINTWISE_EXACT:
        assert torch.equal(got, want), label
    else:
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0, msg=label)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("label", ["[awb*+gamma]", "[exposure]"])
def test_pointwise_segment_off_16_bytes(dev, offset, label):
    """x 4, 8 or 12 bytes past a 16-byte boundary (its output aligned):
    the spans' 16-byte parts move and the store takes 4-byte lanes; the
    bits do not change."""
    g = torch.Generator(dev).manual_seed(offset)
    kernel, plain, args, kw = chip_smoke.pointwise_call(label, (2, 37, 53),
                                                        dev, g)
    x = args[0]
    buf = torch.zeros(x.numel() + offset, device=dev)
    xo = buf[offset:].view(x.shape)
    xo.copy_(x)
    assert xo.data_ptr() % 16 == 4 * offset
    want = plain(*args, **kw)
    assert torch.equal(kernel(xo, *args[1:], **kw), want)
    assert torch.equal(kernel(*args, **kw), want)


def _fleet_on_card(dev, batch=2):
    """A reduced spiking-YOLO fleet on the all-kernel configs, and four
    numpy-made voxel requests."""
    cfg = reduced_snn("spiking_yolo", backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device=dev)
    fleet = FleetEngine(params, cfg, ISP_CONFIGS["cuda"],
                        enc_cfg=ENCODING_CONFIGS["cuda"],
                        fleet_cfg=FleetConfig(batch=batch), device=dev)
    rng = np.random.default_rng(0)
    reqs = [PerceptionRequest(
        rid=i, voxels=(rng.random((cfg.time_steps, cfg.height, cfg.width,
                                   2)) < 0.15).astype(np.float32),
        bayer=rng.uniform(0.05, 0.95, (cfg.height, cfg.width)).astype(
            np.float32)) for i in range(2 * batch)]
    return fleet, reqs


def _stage(fleet, bank, reqs):
    for i, r in enumerate(reqs):
        stage_request(bank, i, r, validate_request(r, 2), fleet.core.enc_cfg)


def test_harvest_waits_for_its_own_tick_only(dev):
    """Ticks A and B in flight, a spin kernel behind B: fetch(A) returns
    while an event behind the spin is pending, with A's own outputs."""
    fleet, reqs = _fleet_on_card(dev)
    banks = fleet.buffers.banks
    assert all(b.buffer.is_pinned() for b in banks)
    _stage(fleet, banks[0], reqs[:2])
    _stage(fleet, banks[1], reqs[2:])
    pending, _, (out_a, rgb_a, _), (out_b, _, _) = \
        chip_smoke.harvest_check(fleet.core, banks[0], banks[1])
    assert pending
    alone, rgb_alone, _ = fleet.core.tick(banks[0])
    assert np.array_equal(out_a.raw_pred, alone.raw_pred)
    assert np.array_equal(rgb_a, rgb_alone)
    assert not np.array_equal(out_a.raw_pred, out_b.raw_pred)


def test_bank_is_not_repacked_before_its_copy_event(dev):
    """A bank uploaded behind a spin kernel: staging into it waits for
    the copy's event, so the device copy holds the bank as uploaded."""
    fleet, reqs = _fleet_on_card(dev)
    bank = fleet.buffers.front
    _stage(fleet, bank, reqs[:2])
    pending, done, intact = chip_smoke.bank_event_check(
        fleet.core, bank, reqs[3], fleet.core.enc_cfg)
    assert pending and done and intact


def test_fleet_serves_on_the_card(dev):
    """A supervised fleet on the card serves every request on rung 0;
    its ladder is the two kernel routes, bit-equal, and rung 0 is within
    1e-4 of a core on the plain SNN layers."""
    from repro_torch.configs.base import SupervisorConfig
    from repro_torch.serve.engine_core import EngineCore
    fleet, reqs = _fleet_on_card(dev)
    sup = FleetEngine(fleet.cores[0].params, fleet.cfg, ISP_CONFIGS["cuda"],
                      enc_cfg=ENCODING_CONFIGS["cuda"],
                      fleet_cfg=FleetConfig(batch=2),
                      supervisor_cfg=SupervisorConfig(), device=dev)
    assert sup.ladder_names == ["cuda_fused", "cuda"]
    done = sup.run_to_completion(reqs)
    assert sorted(s.rid for s in done) == [0, 1, 2, 3]
    assert {s.request.result.telemetry.rung for s in done} == {"cuda_fused"}
    bank = sup.buffers.front
    _stage(sup, bank, reqs[:2])
    ref = sup.cores[0].tick(bank)
    out, rgb, _ = sup.cores[1].tick(bank)
    assert np.array_equal(out.raw_pred, ref[0].raw_pred)
    assert np.array_equal(rgb, ref[1])
    plain = EngineCore(fleet.cores[0].params,
                       dataclasses.replace(fleet.cfg, backend="torch"),
                       ISP_CONFIGS["cuda"], enc_cfg=ENCODING_CONFIGS["cuda"],
                       device=dev)
    out, rgb, _ = plain.tick(bank)
    np.testing.assert_allclose(out.raw_pred, ref[0].raw_pred, atol=1e-4)
    np.testing.assert_allclose(rgb, ref[1], atol=1e-4)


@pytest.mark.parametrize("B,H,W", [(2, 37, 53), (1, 5, 7)])
def test_isp_stencil_every_tile_equal(dev, B, H, W, monkeypatch):
    """Every stencil segment of the hdr ordering under each tile its op
    has an instance of gives the bits of its plan's tile; a plan whose
    threads or shared bytes are not the instance's is refused."""
    rng = np.random.default_rng(W)
    stages = ISP_CONFIGS["hdr_fused"].stages
    x = torch.tensor(rng.uniform(0, 1, (B, H, W)).astype(np.float32),
                     device=dev)
    ctrl = torch.tensor(rng.uniform(
        0, 1, (B, ISP_CONFIGS["hdr_fused"].control_dim)).astype(np.float32),
        device=dev)
    sp = control_to_stage_params(ctrl, stages)
    for ex in compile_plan(stages):
        kernel, plain, args, kw = segment_call(ex, x, sp)
        if ex.segment.stencil is not None:
            op, c_in = ex.wstep.op, x.shape[3] if x.dim() == 4 else 1
            want = kernel(*args, **kw)
            for th, tw in isp_mod.op_tiles(op):
                plan = isp_mod.tile_plan(op, B, H, W, c_in, th, tw)
                monkeypatch.setattr(isp_mod, "stencil_plan",
                                    lambda *_, p=plan: p)
                assert torch.equal(kernel(*args, **kw), want)
            bad = plan._replace(smem=plan.smem + 4)
            monkeypatch.setattr(isp_mod, "stencil_plan", lambda *_: bad)
            with pytest.raises(RuntimeError, match="failed to launch"):
                kernel(*args, **kw)
            monkeypatch.undo()
        x = plain(*args, **kw).contiguous()


# (T, B, H, density, silent batch elements, specs)
SEG_CASES = {
    "canonical_pair_pool": (3, 2, 12, 0.15, 0, (
        LayerSpec("", cin=2, cout=8), LayerSpec("", cin=8, cout=8, pool=2),
        LayerSpec("", kernel=1, cin=8, cout=16))),
    "stride2_chain": (5, 3, 16, 0.2, 0, (
        LayerSpec("", stride=2, cin=16, cout=32),
        LayerSpec("", cin=32, cout=32),
        LayerSpec("", stride=2, cin=32, cout=64))),
    "depthwise_inside": (3, 2, 17, 0.2, 0, (
        LayerSpec("", stride=2, depthwise=True, cin=24, cout=24),
        LayerSpec("", kernel=1, cin=24, cout=48),
        LayerSpec("", stride=2, depthwise=True, cin=48, cout=48),
        LayerSpec("", kernel=1, cin=48, cout=256))),
    "single_layer_pool": (5, 2, 16, 0.3, 0, (
        LayerSpec("", kernel=1, cin=132, cout=66, pool=2),)),
    "partly_silent": (5, 4, 16, 0.2, 2, (
        LayerSpec("", cin=64, cout=64),
        LayerSpec("", stride=2, cin=64, cout=128))),
}


def _segment_case(name, dev):
    T, B, H, dens, silent, specs = SEG_CASES[name]
    rng = np.random.default_rng(len(name) + H)
    x = (rng.random((T, B, H, H, specs[0].cin)) < dens).astype(np.float32)
    x[:, :silent] = 0.0
    params = []
    for s in specs:
        n = s.cin if s.depthwise else s.cout
        w = rng.normal(0, 0.5, (s.kernel, s.kernel, 1 if s.depthwise
                                else s.cin, n))
        params.append(tuple(torch.tensor(a.astype(np.float32), device=dev)
                            for a in (w, rng.normal(1, 0.2, n),
                                      rng.normal(0, 0.2, n))))
    return torch.tensor(x, device=dev), tuple(params), specs


def _per_layer_route(x, params, specs):
    """The per-layer kernel route, layer by layer: each layer's input,
    then the output."""
    ins = []
    with tune.off():
        for p, s in zip(params, specs):
            ins.append(x.contiguous())
            x = ops._seg_unfused(x, (p,), (s,), LIF)
    return ins, x


LIF = dict(tau=2.0, v_th=1.0, v_reset=0.0)


@pytest.mark.parametrize("gate", ["inline", "none"])
@pytest.mark.parametrize("case", sorted(SEG_CASES))
def test_backbone_segment_equals_per_layer_route(dev, case, gate):
    x, params, specs = _segment_case(case, dev)
    ins, want = _per_layer_route(x, params, specs)
    flat = segment_operands(params, specs)
    T, B, H, W, _ = x.shape
    clusters = []
    for cluster in CLUSTER_SIZES:           # every cluster the plan takes
        try:
            segment_plan(specs, T, B, H, W, cluster=cluster)
        except ValueError:
            continue
        clusters.append(cluster)
    assert set(plan_clusters(specs, T, B, H, W)) <= set(clusters)
    for cluster in clusters:
        got = backbone_segment(x, flat, specs=specs, gate=gate,
                               cluster=cluster, **LIF)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (cluster, float((got != want)
                                                       .float().mean()))
    # each layer alone, on the route's own input, held to the plain layer
    for i, (s, xin) in enumerate(zip(specs, ins)):
        s0 = dataclasses.replace(s, pool=0)
        w, sc, bi = flat[3 * i:3 * i + 3]
        got = backbone_segment(xin, (w, sc, bi), specs=(s0,), gate=gate,
                               **LIF)
        y4, _ = segment_layer_plain(xin.cpu(), w.cpu(), s0)
        z = instance_norm_affine(y4, sc.cpu(), bi.cpu())
        res = spike_mismatch(z, got.reshape(z.shape), tol=1e-4)
        assert res["far"] == 0, (i, res)


def test_backbone_segment_raises_on_what_it_does_not_take(dev):
    x, params, specs = _segment_case("stride2_chain", dev)
    flat = segment_operands(params, specs)
    with pytest.raises(ValueError, match="gate"):
        backbone_segment(x, flat, specs=specs, gate="mask")
    with pytest.raises(ValueError, match="cluster"):
        backbone_segment(x, flat, specs=specs, cluster=3)
    with pytest.raises(ValueError, match="stride"):
        backbone_segment(x, flat, specs=(dataclasses.replace(
            specs[0], stride=3),) + specs[1:])
    with pytest.raises(TypeError, match="float32"):
        backbone_segment(x.double(), flat, specs=specs)
    with pytest.raises(ValueError, match="operands"):
        backbone_segment(x, flat[3:] + flat[:3], specs=specs)


def test_launch_counters(dev):
    build.reset_launches()
    x = torch.ones(5, 64, device=dev)
    lif_scan(x)
    lif_scan(x, bias=torch.ones(64, device=dev))        # the add in it
    spike_matmul(x, torch.ones(64, 8, device=dev))
    lif_scan(x.cpu())                       # the plain version: no launch
    lif_scan(x.cpu(), bias=torch.ones(64))  # plain
    for gate in CONV_GATES:                 # one launch a call, any gate
        spike_conv(torch.ones(2, 8, 8, 4, device=dev),
                   torch.ones(3, 3, 4, 8, device=dev), gate=gate)
    spike_conv(torch.ones(2, 8, 8, 4), torch.ones(3, 3, 4, 8))  # plain
    evs = _events(np.random.default_rng(0), 2, 64, 3, 8, 8)
    event_voxel(EventStream(*(a.to(dev) for a in evs)), time_steps=3,
                height=8, width=8)
    event_voxel(evs, time_steps=3, height=8, width=8)      # plain
    rgb = demosaic(torch.rand(2, 8, 8, device=dev))
    nlm(rgb, 0.3)
    nlm(rgb.cpu(), 0.3)                                     # plain
    stages = ISP_CONFIGS["fast_preview"].stages
    raw = torch.rand(2, 8, 8, device=dev)
    for ex in compile_plan(stages):         # 2 stencil + 1 pointwise
        kernel, plain, args, kw = segment_call(ex, raw, None)
        raw = kernel(*args, **kw)
        plain(*args, **kw)                  # plain: no launch
    kernel, plain, args, kw = chip_smoke.pointwise_call(    # one a call
        "[exposure]", (2, 8, 8), dev, torch.Generator(dev).manual_seed(0))
    kernel(*args, **kw)
    plain(*args, **kw)                      # plain: no launch
    xf = torch.ones(2, 8, 8, 4, device=dev)
    spike_dwconv(xf, torch.ones(3, 3, 1, 4, device=dev), stride=2)
    spike_dwconv(xf.cpu(), torch.ones(3, 3, 1, 4), stride=2)   # plain
    max_pool(xf, gated=True)
    max_pool(xf, gated=False)
    max_pool(xf.cpu())                                      # plain
    max_pool(xf.reshape(2, 1, 8, 8, 4))                  # [T, B] entry
    max_pool(xf.reshape(2, 1, 8, 8, 4).cpu())            # plain
    one = torch.ones(4, device=dev)
    w4 = torch.ones(3, 3, 4, 4, device=dev)
    spike_conv_lif(xf, w4, one, one, T=1, B=2)
    spike_conv_lif(xf.cpu(), w4.cpu(), one.cpu(), one.cpu(), T=1,
                   B=2)                                     # plain
    seg = (LayerSpec("", cin=4, cout=4, pool=2),)
    flat = (torch.ones(36, 4, device=dev), one, one)
    x5 = xf.reshape(2, 1, 8, 8, 4)
    backbone_segment(x5, flat, specs=seg)
    backbone_segment(x5.cpu(), tuple(t.cpu() for t in flat),
                     specs=seg)                             # plain
    torch.cuda.synchronize()
    assert build.LAUNCHES == {"lif_scan": 2, "spike_matmul": 1,
                              "spike_conv": len(CONV_GATES),
                              "spike_conv_lif": 1, "backbone_segment": 1,
                              "event_voxel": 1, "demosaic": 1, "nlm": 1,
                              "isp_stencil_segment": 2,
                              "isp_pointwise_segment": 2,
                              "spike_dwconv": 1, "max_pool": 3}


# ---------------------------------------------------------------------------
# the ops' backwards on the card (plain PyTorch behind each kernel forward)
# ---------------------------------------------------------------------------

class _Cfg:
    tau_mem, v_threshold, v_reset, surrogate_beta = 2.0, 1.0, 0.0, 4.0


def _bwd_gap(op_fn, plain_fn, inputs, seed=0):
    """(op output, the worst relative gap of its input gradients from
    plain autograd's, given the op's output) for one seeded output
    gradient."""
    ks = [t.detach().requires_grad_() for t in inputs]
    ps = [t.detach().requires_grad_() for t in inputs]
    out = op_fn(*ks)
    want = plain_fn(*ps, out.detach())
    g = torch.randn(out.shape, generator=torch.Generator(
        out.device).manual_seed(seed), device=out.device)
    gk = torch.autograd.grad(out, ks, g)
    gp = torch.autograd.grad(want, ps, g)
    for a in gk:
        assert torch.isfinite(a).all()
    return out.detach(), max(float((a - b).abs().max()
                                   / (b.abs().max() + 1e-30))
                             for a, b in zip(gk, gp))


def _forced_norm(y4, s, b, spikes):
    return chip_smoke.forced_lif(instance_norm_affine(y4, s, b), spikes,
                                 _Cfg)


@pytest.mark.parametrize("k,stride,depthwise", [(3, 1, False), (3, 2, False),
                                                (1, 1, False), (3, 1, True),
                                                (3, 2, True)])
def test_conv_backward_matches_plain_autograd(dev, k, stride, depthwise):
    """spike_conv_op / spike_dwconv_op: the kernel forward and its plain
    adjoints within 1e-5 of autograd through the plain conv."""
    rng = np.random.default_rng(k * 10 + stride)
    xf = _spikes(rng, (10, 17, 15, 24), 0.2).to(dev)
    w = torch.tensor(rng.normal(0, 0.5, (k, k, 1 if depthwise else 24,
                                         24 if depthwise else 40))
                     .astype(np.float32), device=dev)
    op = ops.spike_dwconv_op if depthwise else ops.spike_conv_op
    _, gap = _bwd_gap(lambda x, w: op(x, w, stride=stride),
                      lambda x, w, _: conv_plain(x, w, stride=stride,
                                                 depthwise=depthwise),
                      (xf, w))
    assert gap <= 1e-5


@pytest.mark.parametrize("T,B,HW,C", [(5, 2, 256, 24), (3, 3, 100, 33)])
def test_norm_affine_lif_backward_matches_plain_autograd(dev, T, B, HW, C):
    """On the kernel's own spikes (forced into the plain LIF): the
    statistics contract's flips near threshold do not enter."""
    rng = np.random.default_rng(T + C)
    y = torch.tensor(rng.normal(0.3, 1.0, (T, B, HW, C)).astype(np.float32),
                     device=dev)
    s = torch.tensor(rng.normal(1, 0.2, C).astype(np.float32), device=dev)
    b = torch.tensor(rng.normal(0, 0.2, C).astype(np.float32), device=dev)
    _, gap = _bwd_gap(lambda y, s, b: ops.norm_affine_lif_op(y, s, b, **LIF),
                      _forced_norm, (y, s, b))
    assert gap <= 1e-5


@pytest.mark.parametrize("stride", [1, 2])
def test_spike_conv_lif_backward_matches_plain_autograd(dev, stride):
    T, B, H, cin, cout = 3, 2, 13, 12, 20
    rng = np.random.default_rng(stride)
    xf = _spikes(rng, (B * T, H, H, cin), 0.2).to(dev)
    w = torch.tensor(rng.normal(0, 0.5, (3, 3, cin, cout)).astype(np.float32),
                     device=dev)
    s = torch.tensor(rng.normal(1, 0.2, cout).astype(np.float32), device=dev)
    b = torch.tensor(rng.normal(0, 0.2, cout).astype(np.float32), device=dev)
    Ho = -(-H // stride)
    plan = conv_lif_plan(T, B, Ho * Ho, cout, 9 * cin)
    fused = tune.LaunchConfig(bm=plan.cluster, gate="mask", fused=True)

    def op(x, w, s, b):
        return ops._conv_lif_apply(fused, x, w, s, b, T=T, B=B,
                                   stride=stride, lif=LIF, beta=4.0)

    def plain(x, w, s, b, spikes):
        y = conv_plain(x, w, stride=stride)
        y4 = y.reshape(B, T, Ho * Ho, cout).transpose(0, 1)
        return _forced_norm(y4, s, b, spikes.reshape(y4.shape)).reshape(
            spikes.shape)
    build.reset_launches()
    _, gap = _bwd_gap(op, plain, (xf, w, s, b))
    assert gap <= 1e-5
    # the forward and its rematerialised conv
    assert build.LAUNCHES["spike_conv_lif"] == 1
    assert build.LAUNCHES["spike_conv"] == 1


def test_lif_scan_and_spike_matmul_backward_match_plain_autograd(dev):
    rng = np.random.default_rng(0)
    cur = torch.tensor(rng.normal(0.8, 0.5, (5, 8, 64)).astype(np.float32),
                       device=dev)
    bias = torch.tensor(rng.normal(0, 0.3, 64).astype(np.float32),
                        device=dev)
    spikes, gap = _bwd_gap(
        lambda c, b: ops.lif_scan_op(c, bias=b, **LIF),
        lambda c, b, _: klif.lif_scan_plain(c + b, **LIF), (cur, bias))
    assert gap <= 1e-5
    w = torch.tensor(rng.normal(0, 1, (64, 8)).astype(np.float32), device=dev)
    _, gap = _bwd_gap(ops.spike_matmul_op,
                      lambda x, w, _: blocked_matmul(x, w),
                      (spikes.reshape(40, 64), w))
    assert gap <= 1e-5


@pytest.mark.parametrize("shape", [(5, 8, 64, 64, 32), (3, 2, 9, 7, 5)])
def test_max_pool_backward_first_maximum(dev, shape):
    """[T, B] spikes where they lie: the gradient equal to the plain
    pool's (each window's on its first maximum)."""
    rng = np.random.default_rng(shape[2])
    x = _spikes(rng, shape, 0.3).to(dev)
    T, B = shape[:2]
    _, gap = _bwd_gap(lambda x: ops.max_pool_op(x, window=2),
                      lambda x, _: unfold(pool_slices(fold(x), 2), T, B),
                      (x,))
    assert gap == 0.0


@pytest.mark.parametrize("case", ["stride2_chain", "single_layer_pool",
                                  "depthwise_inside"])
def test_backbone_segment_backward_equals_per_layer_route(dev, case):
    """The segment kernel's backward (recomputed on the per-layer kernel
    route) against the per-layer route's own: the same spikes, so the
    same gradients."""
    x, params, specs = _segment_case(case, dev)
    flat = [t for p in params for t in p]
    T, B, H, W, _ = x.shape
    key = tune.shape_key("backbone_seg", **ops.segment_dims(
        specs, T=T, B=B, H=H, W=W))
    table = ops.fused_segment_table([key])

    def run(x, *flat):
        return ops.backbone_segment_op(
            x, [flat[i:i + 3] for i in range(0, len(flat), 3)], specs=specs,
            **LIF)

    def fused(x, *flat):
        with tune.pinned(table):
            return run(x, *flat)

    def per_layer(x, *rest):
        with tune.off():
            return run(x, *rest[:-1])
    build.reset_launches()
    _, gap = _bwd_gap(fused, per_layer, (x, *flat))
    assert gap <= 1e-5
    assert build.LAUNCHES["backbone_segment"] == 1


def test_kernels_without_a_backward_refuse_grad(dev):
    """No wrapper drops a graph silently: a kernel called outside its
    op's Function, or one with no backward (ISP, event), raises on an
    input that requires grad while grad mode is on; under no_grad it
    runs."""
    raw = torch.rand(2, 16, 16, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        demosaic(raw)
    rgb = torch.rand(2, 16, 16, 3, device=dev)
    with pytest.raises(RuntimeError, match="requires grad"):
        nlm(rgb, torch.full((2,), 0.3, device=dev, requires_grad=True))
    with pytest.raises(RuntimeError, match="requires grad"):
        spike_conv(torch.ones(2, 8, 8, 4, device=dev, requires_grad=True),
                   torch.ones(3, 3, 4, 8, device=dev))
    with pytest.raises(RuntimeError, match="requires grad"):
        max_pool(torch.ones(1, 2, 4, 4, 3, device=dev, requires_grad=True))
    evs = _events(np.random.default_rng(0), 2, 64, 3, 8, 8)
    evs = EventStream(*(a.to(dev) for a in evs))
    with pytest.raises(RuntimeError, match="requires grad"):
        event_voxel(evs._replace(t=evs.t.clone().requires_grad_()),
                    time_steps=3, height=8, width=8)
    with torch.no_grad():
        demosaic(raw)
    # through the op's Function the same kernel takes a graph
    x = torch.ones(2, 8, 8, 4, device=dev, requires_grad=True)
    ops.spike_conv_op(x, torch.ones(3, 3, 4, 8, device=dev)).sum().backward()
    assert x.grad is not None
