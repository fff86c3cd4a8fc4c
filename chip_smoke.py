#!/usr/bin/env python3
"""Drive the PyTorch port's cognitive serving tick on one NVIDIA GPU, on
the paper's four spiking backbones, and its LM serving path on
full-width qwen2-7b, arctic-480b and deepseek-v3-671b (the last two cut
in depth), and hold each hand-written CUDA kernel against its plain
PyTorch version.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. device  — require CUDA; print the card's name and power limit;
2. build   — compile the kernels from ``src/repro_torch/kernels/csrc``
             (one nvcc per source, in parallel); print the build time and
             each kernel's register report;
3. parity  — walk full-width spiking-YOLO (64x64, T=5, 32 base channels,
             4 stages) at batch 8 layer by layer, calling each NPU kernel
             on the main path's own inputs and comparing it with its plain
             version on the same inputs (TF32 off): spike_conv (read from
             the folded spikes) under each gate ("mask", "inline",
             "none") bit-equal to spike_matmul on the layer's patches
             (the gated GEMM's bits), spike_conv and spike_matmul allclose
             atol=1e-4 rtol=1e-5 to their plain versions, spike_matmul's
             "small" path (the control head's) bit-equal to its "tiled"
             path on the head's input and on 30% spikes, lif_scan with
             the control head's bias added in its launch equal to the
             plain scan of currents + bias (the layer's bias and a
             seeded random one) and to the parent's path, the add then
             the earlier kernel (where build/earlier/lif_scan.cu holds a
             copy of its source: `git show aef84b2:src/repro_torch/
             kernels/csrc/lif_scan.cu`), one device op a call,
             norm_affine_lif spikes equal to the CPU replay of its
             statistics contract (testing.norm_affine_lif_contract) and
             to its earlier design's (where build/earlier holds its
             source), and to its plain version except where the plain
             membrane lies within 1e-4 of v_th; spike_conv also on a partly silent
             input so the gates skip; on every firing conv
             the fused spike_conv_lif under each gate ("mask", "inline",
             "none") on the layer's own folded spikes and on a copy whose
             first half of the batch is silent, its spikes equal to the
             per-op kernel pair's (torch.equal) and its plain version's
             except where the per-op membrane lies within 1e-4 of v_th
             (flips and the band's size printed).  Then the all-kernel
             tick's own encode and ISP inputs: event_voxel equal to its
             plain version in every mode x oob policy on the 8 event
             windows of the request set, and again with NaN, +-inf and
             +-1e10 timestamps; the tick's encode (encode_batch on
             "cuda": one launch, each window binned from its events or
             copied from the staged voxel windows) equal to its plain
             form and to the parent's kernel + torch.where (where
             build/earlier/event_voxel.cu holds a copy of its source:
             `git show 2f15604:src/repro_torch/kernels/csrc/
             event_voxel.cu`), with every window from events and with
             half of them staged, one device op a call (torch.profiler);
             and the ISP walked stage by
             stage with the stage params of the kernel NPU's control
             vector: demosaic equal to its plain version, to the earlier
             design (where build/earlier/demosaic.cu holds a copy of its
             source, with aef84b2's isp_common.cuh beside it) and to
             the [demosaic] stencil segment, one device op a call (and
             so on ragged [2, 37, 53], [3, 5, 7], [8, 512, 512] and VGA
             [4, 480, 640] frames), nlm within 1e-6 (max |err| printed),
             bit-equal to its earlier design (where build/earlier/nlm.cu
             holds a copy of its source: `git show 2f15604:src/
             repro_torch/kernels/csrc/nlm.cu`), a scalar strength equal
             to a tensor of it, one device op a call for either.
             Then the fused ISP backend ("cuda_fused") on the same frames,
             for the default (ISP_CONFIGS["fused"]), hdr and fast_preview
             orderings, segment by segment: each segment's kernel
             (isp_stencil_segment, isp_pointwise_segment) against its
             plain version on the same inputs, equal for [exposure+dpc],
             [demosaic] and [awb*+gamma], within 1e-6 otherwise, each
             stencil segment bit-equal to the earlier design (where
             build/earlier/isp_fused.cu holds a copy of its source), and
             the whole fused output against the per-stage "torch" path
             within 1e-6; again on ragged [2, 37, 53] frames, on an
             [8, 512, 512] and a VGA [4, 480, 640] batch with control
             vectors drawn in [0, 1); and the fast_preview ordering fused
             through control_vector_pipeline_batch, with its launches
             counted.
             Then the same layer walk (spike_conv_lif included) for
             full-width spiking MobileNet, VGG and DenseNet (the paper's
             other backbones; same voxels):
             spike_dwconv equal to its plain tap loop on each depthwise
             layer's input and on a partly silent copy (the earlier
             grid-stride design too, where build/earlier holds its
             source), max_pool on each pool's [T, B] spikes as the layer
             gives them (no fold copy) equal to its plain version on the
             fold in both gate modes, also with an all-silent frame, and
             its [N, H, W, C] entry and the earlier design (where
             build/earlier/max_pool.cu holds a copy of its source) on the
             fold equal too.  Each arch's segment
             plan at the default budget is printed, and every
             fused-route segment (YOLO 2, MobileNet 2, VGG 1, DenseNet 1)
             runs through backbone_segment on the walk's own input to it
             (its plan printed: cluster, blocks an SM, ring, shared
             memory, each layer's tile), under "inline" and "none" at
             every cluster size a launch table may choose (the plan's,
             twice and half it), and again with half the batch silent:
             bit-equal to the per-layer kernel route each time (and to
             the PR 17 design, where build/earlier holds its source),
             and each layer of the
             route held to the plain layer on its own input by the
             near-threshold rule (flips and band printed).  Last, VGG's
             first layer at batch 205 (more 64-row tiles than gridDim.y
             holds) through spike_conv and spike_matmul on its patches,
             bit-equal to each other and allclose to the plain GEMM; and
             the kernels that once held the batch on gridDim.y or .z
             (norm_affine_lif, event_voxel -- also at 65537 time steps --,
             encode_batch, spike_conv_lif, backbone_segment, isp_stencil_segment,
             max_pool's [T, B] entry, and
             flash_attention's "mma_sync" and "f32" designs at Sq = 1, one
             head, d = 64, also within the bar of the plain scan) at batch
             65537 on a tiny shape, the last 4 batch elements bit-equal to
             a run on them alone;
4. timings — per kernel, device-time medians (CUDA events behind a spin
             kernel, so host launch overhead is not counted) over 30 runs
             of every launch of a tick (kernel, plain version, one
             PyTorch call where it computes the same function:
             cuDNN's conv on the pre-padded channels-last input for
             spike_conv (torch.matmul on its patches beside it, and the
             kernel under each gate), torch.matmul for spike_matmul
             (its "tiled" path beside it), cuDNN's grouped conv on the
             pre-padded channels-last input for spike_dwconv (the
             earlier grid-stride design beside it where
             build/earlier/spike_dwconv.cu holds a copy of its source:
             `git show <commit>:src/repro_torch/kernels/csrc/
             spike_dwconv.cu`; null otherwise),
             F.max_pool2d for max_pool (beside it the fold copy and the
             parent's path, the fold copy then the earlier kernel, where
             build/earlier/max_pool.cu holds a copy of its source: `git
             show 2798f1c:src/repro_torch/kernels/csrc/max_pool.cu`);
             none for norm_affine_lif (its
             earlier design beside it where build/earlier/
             norm_affine_lif.cu holds a copy of its source); none for
             spike_conv_lif (its plan's tile, cluster, row tile and ring
             printed, and the earlier design's time where
             build/earlier/spike_conv_lif.cu holds a copy of its source:
             `git show 572391d:src/repro_torch/kernels/csrc/
             spike_conv_lif.cu`, on the torch-built patches and mask it
             read) and backbone_segment, printed beside the per-op kernel
             pair's and the per-layer kernel route's time instead), and
             the least time the card could take for the same work (bytes
             at 3.35 TB/s, fp32 operations at 67 TFLOP/s, this run's
             data), per backbone;
             isp_stencil_segment over the fused default plan's four
             segments, isp_pointwise_segment on fast_preview's
             [awb*+gamma] (row 12 in "tick_rows" too, beside the PR 13
             design on a prebuilt LUT and the parent's path, the LUT by
             torch ops then that kernel; and one "pointwise_rows" line:
             [awb*+gamma], an [exposure] chain on Bayer frames and the
             no-gamma [awb*+tonemap+ccm] at the tick's, ragged, tiny,
             VGA and [8, 512, 512] shapes, bit-equal to the plain
             version and the PR 13 design, one device op a call); every
             stencil segment of the three orderings
             on the tick's frames and on a VGA batch, printed as one
             "isp_segments" line per shape beside the earlier design's
             time (build/earlier/isp_fused.cu: `git show
             2798f1c:src/repro_torch/kernels/csrc/isp_fused.cu`, timed
             with the parent wrapper's torch ops), the plain version's
             and the bound; plus demosaic, nlm and the fused segments on
             an [8, 512, 512] batch (nlm beside its earlier design and
             bit-equal to it); demosaic beside its earlier design and the
             [demosaic] segment at every shape above (one
             "demosaic_shapes" line); rows 3, 9, 10 and 11 (lif_scan with
             the bias beside the parent's add + kernel, event_voxel as
             the tick's encode_batch, demosaic, nlm) beside their earlier
             designs timed with the parent's wrapper ops (its add; its
             torch.where select; its torch-built luminance and
             bandwidth), printed as one "tick_rows" line with each call's
             device ops.  The kernels
             line takes the NPU rows
             from spiking-YOLO's tick (spike_conv_lif at every firing conv,
             as its forced-fused tick runs it), spike_dwconv from
             MobileNet's, max_pool from VGG's plus DenseNet's and
             backbone_segment from the four archs' fused-route segments
             (its plan's default, gate "inline"; the PR 17 design's time
             beside it where build/earlier holds its source; its
             operations bound from the MACs this input needs);
5. serve   — first the launch table: per arch one eager npu_forward at
             batch 8 under tune.tuning with the "smoke" sweep policy,
             every conv_lif and backbone_seg key printed with its
             winner, its us and the
             default's, and the host time of one eager launch.  Then
             CognitiveEngines (batch 8, seeded random weights) answer the
             same 16 requests, 8 voxel windows and 8 raw event buffers.
             Full spiking_yolo through four: the all-kernel engine
             (encoding, SNN and ISP on their kernels), the fused-ISP
             engine (the same with ISP_CONFIGS["fused"]), the SNN-kernel
             engine (torch encoding and ISP) and the plain engine; then
             full spiking_mobilenet, spiking_vgg and spiking_densenet,
             each through an all-kernel and a plain engine; and per arch
             an all-kernel engine built under a forced-fused table (every
             firing non-depthwise conv on spike_conv_lif: 9 YOLO, 9 VGG,
             6 MobileNet, 14 DenseNet launches a tick), one under the
             swept table and one under a forced-segment table (every
             fused-route segment on backbone_segment, its layers
             launching nothing else).  Each runs
             with the launch counters set to 0 just before it and read
             just after, against npu_launches_per_tick per backbone:
             the all-kernel engines must show every per-stage kernel's
             launches per tick (MobileNet's spike_dwconv, VGG's and
             DenseNet's max_pool), the fused-ISP engine the NPU kernels,
             event_voxel and exactly 4 isp_stencil_segment (no demosaic,
             nlm or isp_pointwise_segment), the SNN-kernel engine only the
             NPU kernels, the plain engines none at all, and no
             spiking-YOLO engine spike_dwconv or max_pool.  Every result
             is checked, each backbone's layers are held to their plain
             versions on the same inputs, and each all-kernel engine's
             results to its plain engine's (raw_pred and control 1e-4,
             rgb 1e-4, printed); then the cognitive loop
             (cognitive_forward on the "cuda" and "fused" ISP configs,
             cognitive_step(use_cuda=True)) against its plain run at the
             same bars; then the tick latency (p50, p90) of spiking-YOLO's
             four engines and every other all-kernel engine (untuned,
             forced-fused, swept, forced-segment), in turns, and each of
             those engines' device ops a tick (torch.profiler, printed);
             then the serving fleet (fleet_phase): FleetEngine on
             spiking-YOLO, batch 8, all-kernel configs, rung 0 on the
             swept table: a harvest of tick A that returns while a spin
             behind tick B is pending, the pinned-bank rule, the two
             kernel rungs of the card's ladder on one bank, bit-equal,
             and a core on the plain SNN layers within 1e-4 of rung 0
             (launches counted per core), a clean supervised run of
             64 requests (launches counted after the prewarm, every
             request DONE on "cuda_fused" within 1e-4 of a
             CognitiveEngine, step and request latency printed beside
             the card) and a seeded "chaos" run (no non-finite result
             delivered, every request terminal, a demotion and a
             promotion in the telemetry), one "fleet" line;
5b. train  — full-width spiking-YOLO (64x64, T 5, batch 8, seeded
             random weights) trained through the kernels on a scene
             batch of the port's generator (data/synthetic.py,
             seeded 11), the reference's
             "detector" recipe (AdamW lr 4e-3, weight decay 1e-4, clip
             1.0, warmup_cosine with a warmup of 100): one timed step
             (forward, backward, optimizer, each ended by a synchronise,
             again warm after 2 more through make_snn_train_step) in
             "detect" and
             "cognitive" mode, on the per-op route (rows 1-4), a
             forced-fused table (row 5) and a forced-segment table (row
             7); each step's launches counted (each route's kernels must
             launch), its loss and every gradient leaf finite and not
             all zero, held to the plain backend's step on the card (loss
             within 1e-4 relative, the gradients' relative L2 gap within
             1e-2: room for the forward's near-threshold flips, counted
             by the layer walk of the scene); the three routes' losses
             equal and their gradients within 1e-5; device ops and busy
             time of a step (torch.profiler) and its peak memory.  Then
             rows 1-8's backwards (plain PyTorch) at each arch's
             full-width layer shapes on the kernel route's own inputs:
             each op's gradients within 1e-5 of plain autograd on the
             same forward (the kernel's spikes forced into the plain
             LIF), both backwards timed; the phase's seconds printed;
5c. detector loop — train/detector.py end to end on the kernels: the
             train-smoke gate on TRAIN_CONFIGS["detector_smoke_cuda"]
             (reduced, batch 8, 300 steps, checkpoints every 100 in a
             temporary directory): the mean loss of the last 10 steps
             at most half the first 10's, held-out AP@0.5 at most 0.05
             before and at least 0.15 (and above it) after, a resume
             from step 100 bit-equal leaf by leaf to the uninterrupted
             state; then TRAIN_CONFIGS["detector"] at full width on
             "cuda" over a 300-step horizon: the loss of the last 10
             steps under 0.8x the first 10's, steady ms a step split
             into data, step and metric drain, AP before and after,
             sparsity, a step's kernel launches equal to
             npu_launches_per_tick (the forward's; the backward is plain
             PyTorch) and its device ops and busy time, a full-width
             checkpoint saved (its synchronous stall timed) and
             restored onto the card's state and onto a CPU copy, each
             bit-equal; then the classification head (detect off) at
             full width on the four archs, the kernel backend's logits
             within 1e-4 of the plain backend's, its launches counted;
             one "detector" line;
5d. data parallelism — the fleet (full-width spiking-YOLO, batch 8,
             "cuda" encoding, ISP "cuda" and "fused", untuned route) on
             an explicit two-entry mesh [cuda:0, cuda:0]: one tick's
             launches twice the one-device fleet's, 128 requests through
             it and the one-device fleet in turns, each within 1e-5 of
             the one-device fleet's, step p50/p99 of both; then 2 ranks
             spawned on the card (torch.multiprocessing, gloo with CUDA
             tensors: NCCL refuses two ranks on one device):
             TRAIN_CONFIGS["detector"] on "cuda" at batch 8, the
             data-parallel step's loss within 1e-5 and its gradients'
             relative L2 within 1e-2 of the one-process step's, two
             steps' losses within 1e-5, every rank's state bit-equal,
             host ms a step beside one process's; the manual
             data-parallel step (int8 over "pod") finite, its first
             step within 1e-5 of a one-process replay, ranks bit-equal;
             the pipeline ring within 1e-5 (or why gloo did not run it);
             with 2+ cards the same on NCCL ranks and the fleet on
             mesh="auto", on one card a line saying they did not run;
             each figure a line with the card's name and power limit;
             one "dist" line;
6. LM      — after the SNN engines' memory is released: full-width
             qwen2-7b (28 layers, bf16, random weights from a CUDA
             generator seeded 0; parameter count and bytes resident
             printed); serve_prefill of 2 numpy-seeded prompts of 4096
             tokens (cache 4112) with exactly 28 flash_attention
             launches, every one on the "wgmma" design (wgmma on a
             TMA-fed K/V ring, warp-specialised, persistent; counted per
             design as build.LAUNCHES["flash_attention:wgmma"]); the
             kernel against its plain scan on layer 0's
             and the last layer's own q/k/v, bf16 (the rounding bound
             2^-8 (A + |got| + |plain|) + 1e-5, A the attention over |v|:
             P is rounded to bf16 for the P.V product and both outputs
             to bf16; capped at 2e-2 + 1e-2 |plain|; the median |plain|
             printed beside it) and float32 copies (1e-5); the same
             prefill on the plain scan, its last logits' max relative
             difference below 0.05 and the argmax equal wherever the
             plain top-2 margin exceeds twice the largest logit
             difference; 16 greedy serve_decode steps from the
             prefill cache with no flash_attention launch; at 2 layers in
             float32 the decode of token 4096 after a 4095-token prefill
             against the 4096-token prefill (rel < 1e-4); the decode's
             f32 wo product (bf16 parts, one GEMM) against a float32
             copy of wo (rel < 1e-5); ServeEngine at
             full width (batch 4, max_len 128, 6 requests of 4-7 tokens,
             8 new tokens each) answering every request with in-range
             tokens, and on the 2-layer float32 model each request's
             tokens equal to its serve_prefill + serve_decode
             continuation; then flash_attention's time per prefill (28
             launches, each on its layer's own inputs), the earlier
             "mma_sync" design's on the same inputs, its plain scan's,
             SDPA's (library) and its bound (visible pairs at the 989
             TFLOP/s bf16 peak, or bytes), prefill tokens/s, the decode
             step and the engine tick p50/p90, and one prefill and five
             decode steps under torch.profiler (device ops, busy time,
             idle share, the costliest device ops);
6b. MoE and MLA — the bf16 qwen2-7b freed, arctic-480b then
             deepseek-v3-671b at their published widths, only the depth
             cut (MOE_DEPTH: arctic 2 MoE layers of 128 experts top-2,
             ~55 GB; deepseek a dense MLA layer, an MLA + MoE layer of
             256 experts top-8 with a shared expert, and the mtp
             subtree's MLA + MoE block, ~50 GB; every cut printed), each
             freed before the next: bf16 weights from a CUDA generator
             seeded 0 (parameters and bytes printed); serve_prefill of 2
             x 4096 tokens with flash_attention counted by design (arctic
             2 "wgmma" at (128, 128), deepseek 2 "mma_sync" at (d, dv) =
             (192, 128)); the kernel against its plain scan on layer 0's
             own q/k/v (bf16 within the rounding bound, float32 copies
             within 1e-5); each MoE layer's routing (expert loads, the
             capacity, the pairs dropped); the last logits against the
             plain-scan prefill's (< 0.05); 8 greedy decode steps (no
             flash launch); ServeEngine at full width (batch 4, 4
             requests, 4 tokens each); the prefill (ms, tokens/s; one
             under torch.profiler: device ops, busy, idle share, the
             costliest ops), the decode step, layer 0's kernel, its
             plain scan, SDPA (or why none of its backends takes dv !=
             d) and the bound (2 d + 2 dv operations a visible pair at
             989 TFLOP/s); peak
             memory; the (192, 128) instances' ptxas report; then in
             float32 at one layer of each kind with no mtp
             (MOE_CHECK_DEPTH) the decode of a prompt's last token
             against the whole prompt's prefill at MOE_CHECK_SEQ tokens
             (rel < 1e-4; no pair can drop there) and at 4096 (held
             where the forward kept the last tokens' pairs, else
             reported), and the engine's tokens equal to prefill +
             decode; one "moe" JSON line, and row 14 of the kernels line
             carries the (192, 128) instance;
7. report  — one JSON line of per-kernel numbers, the card line, and
             the result line ``{"ok": true, "device": {...}}`` last.

Run alone (without ``src/``) or without a card, it fails before any
result is printed.

    python3 chip_smoke.py --kernel-phase spiking_yolo spiking_densenet

runs only phase 3-4's layer walk (every NPU kernel against its plain
version, and its times) for the named archs at batch 8 and prints each
arch's per-kernel numbers as one JSON line; it prints no result line.

    python3 chip_smoke.py --norm-phase

builds only norm_affine_lif and runs it alone at every served shape of
the four backbones (numpy-seeded conv outputs, batch 8): bit-equal to
the contract replay, to the earlier design (where build/earlier holds
its source) and under other launch plans; per arch the kernel, earlier
design, plain and bound times summed over a tick's launches, and each
plan's, as one JSON line; it prints no result line.

    python3 chip_smoke.py --conv-lif-phase

builds only spike_conv_lif, spike_conv and norm_affine_lif and runs the
fused kernel alone at every firing conv of the four backbones (each
layer's input shape, kernel and stride; numpy-seeded 15% spikes, batch
8): equal to the per-op kernel pair under each gate; per arch the
kernel at its plan and at every other cluster size that holds the slab,
the per-op pair, the plain version, the earlier design (where
build/earlier holds its source) and the bound, as one JSON line; it
prints no result line.

    python3 chip_smoke.py --segment-phase

builds only backbone_segment and the per-layer route's kernels and runs
every fused-route segment of the four backbones alone, on the input the
per-layer kernel route gives it from the tick's voxels (batch 8): equal
to the route under both gates at every cluster size a launch table may
choose and to the PR 17 design (where build/earlier holds its source);
the kernel, the PR 17 design, the per-layer route, the plain version,
the bound and every (cluster, row tile, ring) plan timed; per arch as
one JSON line; it prints no result line.

    python3 chip_smoke.py --isp-pool-phase

builds only isp_fused and max_pool and runs PERF.md's rows 13, 12 and 8
alone: the "pointwise_rows" line; every stencil segment of the fused
orderings at [8, 64, 64],
[2, 37, 53] and [4, 480, 640] on random frames and controls, bit-equal
to and timed beside the earlier design (with the wrapper's device ops
by name under torch.profiler at the first and last shape), and every
max_pool of VGG and DenseNet on numpy-seeded spikes in [T, B] order,
beside the fold copy and the parent's path; one JSON line, no result
line.

    python3 chip_smoke.py --train-phase

builds only the NPU kernels and runs phase 5b alone; one JSON line, no
result line.

    python3 chip_smoke.py --detector-phase

builds only the NPU kernels and runs phase 5c alone; one JSON line, no
result line.

    python3 chip_smoke.py --dist-phase

builds only the NPU, encoding and ISP kernels and runs phase 5d alone;
one JSON line, no result line.

    python3 chip_smoke.py --moe-phase

builds only flash_attention and runs phase 6b alone; it prints the
"moe" JSON line, the card line and the result line.

    python3 chip_smoke.py --flash-phase

builds only flash_attention and runs it alone at one qwen2-7b prefill
layer (numpy-seeded bf16 q [2, 4096, 28, 128], k and v [2, 4096, 4,
128], causal; no model): the "wgmma" kernel against the plain scan
within the rounding bound and the float32 kernel on float32 copies
within 1e-5, then the "wgmma" kernel, the "mma_sync" design, SDPA and
the float32 kernel timed in turns, printed with the bound, TFLOP/s and
the card as one JSON line; it prints no result line.
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

BATCH = 8
REQUESTS = 16
EVENT_CAPACITY = 2048
TIMING_REPS = 30
LATENCY_TICKS = 120
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
FP32_FLOPS = 67e12              # H100 SXM fp32 outside the tensor cores
NEAR_TOL = 1e-4
E2E_TOL = 1e-4                  # end-to-end raw_pred, control and rgb
NLM_TOL = 1e-6
LARGE_HW = 512                  # the extra demosaic/nlm timing line
VGA = (4, 480, 640)             # a VGA batch: the work, not the launch, sets
#                                 the stencil segments' time
RAGGED = (2, 37, 53)            # frames that are no whole number of tiles
TINY = (3, 5, 7)                # frames smaller than a stencil tile
POOL_DENSITY = 0.15             # the seeded spikes of --isp-pool-phase
SPIN_CYCLES_PER_S = 2e9         # ~ the H100's SM clock, for the spin kernel
# the grid-cap check: VGG's first layer at this batch has more 64-row
# tiles (5 * 205 * 64 * 64 rows) than gridDim.y holds (65535)
GRID_CAP_BATCH = 205
# the batch-cap check: these kernels once held B on gridDim.y or .z
# (at most 65535); each runs at this batch on a tiny spatial shape, its
# last BATCH_CAP_TAIL batch elements held to a run on them alone
# (flash_attention's "mma_sync" and "f32" designs at Sq = 1, one head,
# d = 64, also to the plain scan)
BIG_BATCH = 65537
BATCH_CAP_TAIL = 4
BATCH_CAP_KERNELS = ("norm_affine_lif", "event_voxel", "event_voxel_steps",
                     "encode_batch", "spike_conv_lif", "backbone_segment",
                     "stencil_segment", "pointwise_segment", "demosaic",
                     "max_pool", "flash_mma_sync", "flash_f32")
# [T, B, HW, C] of every norm_affine_lif launch of the four backbones'
# untuned ticks at batch 8 (norm_shapes; tests/test_torch_norm_lif.py
# holds this list to it)
NORM_SERVED_SHAPES = (
    (5, 8, 16, 128), (5, 8, 16, 256), (5, 8, 64, 64), (5, 8, 64, 66),
    (5, 8, 64, 128), (5, 8, 64, 256), (5, 8, 256, 24), (5, 8, 256, 32),
    (5, 8, 256, 64), (5, 8, 256, 66), (5, 8, 256, 128), (5, 8, 1024, 24),
    (5, 8, 1024, 32), (5, 8, 1024, 60), (5, 8, 1024, 64), (5, 8, 4096, 24),
    (5, 8, 4096, 32), (5, 8, 4096, 48))
# (T, B, HW, K, N) of every conv_lif dispatch (a firing non-depthwise
# conv) of the four backbones' ticks at batch 8 (conv_lif_dims;
# tests/test_torch_conv_lif.py holds this list to it)
CONV_LIF_SERVED_SHAPES = (
    (5, 8, 16, 128, 256), (5, 8, 16, 1152, 256), (5, 8, 16, 2304, 256),
    (5, 8, 64, 64, 128), (5, 8, 64, 576, 128), (5, 8, 64, 594, 66),
    (5, 8, 64, 1152, 128), (5, 8, 64, 1152, 256), (5, 8, 64, 2304, 256),
    (5, 8, 256, 32, 64), (5, 8, 256, 132, 66), (5, 8, 256, 288, 64),
    (5, 8, 256, 540, 24), (5, 8, 256, 576, 64), (5, 8, 256, 576, 128),
    (5, 8, 256, 756, 24), (5, 8, 256, 972, 24), (5, 8, 256, 1152, 128),
    (5, 8, 1024, 18, 32), (5, 8, 1024, 32, 32), (5, 8, 1024, 120, 60),
    (5, 8, 1024, 288, 32), (5, 8, 1024, 288, 64), (5, 8, 1024, 432, 24),
    (5, 8, 1024, 576, 64), (5, 8, 1024, 648, 24), (5, 8, 1024, 864, 24),
    (5, 8, 4096, 18, 24), (5, 8, 4096, 18, 32), (5, 8, 4096, 96, 48),
    (5, 8, 4096, 216, 24), (5, 8, 4096, 288, 32), (5, 8, 4096, 432, 24),
    (5, 8, 4096, 648, 24))
# LM serving: full-width qwen2-7b, 2 prompts of train_4k's 4096 tokens
LM_ARCH = "qwen2-7b"
LM_BATCH = 2
LM_SEQ = 4096
LM_DECODE = 16                  # greedy decode steps after the prefill
LM_CHECK_LAYERS = 2             # depth of the float32 decode-vs-prefill check
LM_ENGINE = dict(batch=4, max_len=128, requests=6, max_new=8)
LM_PLAIN_REPS = 5               # the plain scan's timing runs per layer
# the MoE/MLA phase: arctic-480b, then deepseek-v3-671b, at their
# published widths with only the depth cut (so that the bf16 weights fit
# the card's 80 GB: ~55 and ~50 GB)
MOE_ARCHS = ("arctic-480b", "deepseek-v3-671b")
MOE_DEPTH = {"arctic-480b": dict(num_layers=2),
             "deepseek-v3-671b": dict(num_layers=2, first_dense_layers=1)}
# the float32 decode-vs-forward check: one layer of each kind, no MTP
MOE_CHECK_DEPTH = {"arctic-480b": dict(num_layers=1),
                   "deepseek-v3-671b": dict(mtp_depth=0)}
MOE_DECODE = 8                  # greedy decode steps after the prefill
# the float32 decode-vs-forward check's prompts: LM_BATCH x 4 = 8 tokens,
# within the reference's least capacity (8 slots an expert), so that no
# (token, expert) pair can be dropped; at LM_SEQ the forward drops pairs
# (capacity factor 2 against random weights' skewed routing), and a
# dropped last token's MoE output is 0 in the forward and not in the
# decode, as in the reference
MOE_CHECK_SEQ = 4
MOE_ENGINE = dict(batch=4, max_len=64, requests=4, max_new=4)
F32_TOL = 1e-5                  # flash kernel vs plain, float32
# flash kernel vs plain, bfloat16: the rounding bound of
# kernels.flash_attention.bf16_error_bound, never past this fixed bar
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2
# the prefill's last logits on the kernel vs on the plain scan, max
# |diff| over max |logit|: 28 bf16 layers carry the kernel's rounding of
# P forward (0.020 measured on an H100, 700 W)
LOGITS_REL_TOL = 0.05

# name -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "spike_conv": ("src/repro_torch/kernels/csrc/spike_conv.cu",
                   "src/repro/kernels/spike_conv.py:126"),
    "spike_conv_lif": ("src/repro_torch/kernels/csrc/spike_conv_lif.cu",
                       "src/repro/kernels/spike_conv.py:260"),
    "norm_affine_lif": ("src/repro_torch/kernels/csrc/norm_affine_lif.cu",
                        "src/repro/kernels/lif_scan.py:142"),
    "lif_scan": ("src/repro_torch/kernels/csrc/lif_scan.cu",
                 "src/repro/kernels/lif_scan.py:71"),
    "spike_matmul": ("src/repro_torch/kernels/csrc/spike_matmul.cu",
                     "src/repro/kernels/spike_matmul.py:53"),
    "event_voxel": ("src/repro_torch/kernels/csrc/event_voxel.cu",
                    "src/repro/kernels/event_voxel.py:81"),
    "demosaic": ("src/repro_torch/kernels/csrc/demosaic.cu",
                 "src/repro/kernels/demosaic.py:67"),
    "nlm": ("src/repro_torch/kernels/csrc/nlm.cu",
            "src/repro/kernels/nlm.py:55"),
    "isp_pointwise_segment": ("src/repro_torch/kernels/csrc/isp_fused.cu",
                              "src/repro/kernels/isp_fused.py:109"),
    "isp_stencil_segment": ("src/repro_torch/kernels/csrc/isp_fused.cu",
                            "src/repro/kernels/isp_fused.py:145"),
    "spike_dwconv": ("src/repro_torch/kernels/csrc/spike_dwconv.cu",
                     "src/repro/kernels/spike_conv.py:172"),
    "max_pool": ("src/repro_torch/kernels/csrc/max_pool.cu",
                 "src/repro/kernels/backbone_fuse.py:509"),
    "backbone_segment": ("src/repro_torch/kernels/csrc/backbone_segment.cu",
                         "src/repro/kernels/backbone_fuse.py:423"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:57"),
}
NPU_KERNELS = ("spike_conv", "spike_conv_lif", "norm_affine_lif", "lif_scan",
               "spike_matmul", "spike_dwconv", "max_pool", "backbone_segment")
# fused-route segments per forward at the planner's default budget
SEGMENTS_PER_TICK = {"spiking_yolo": 2, "spiking_mobilenet": 2,
                     "spiking_vgg": 1, "spiking_densenet": 1}
# timestamps the reference bins by XLA's saturating float -> int32 cast
NONFINITE_T = (float("nan"), float("inf"), float("-inf"), 1e10, -1e10)
# the fleet phase: spiking-YOLO's requests (make_requests x 4), and the
# chaos run's horizon in ticks
FLEET_REQUESTS = 64
CHAOS_TICKS = 48
HARVEST_SLEEP_S = 0.2           # the spin that a harvest must not wait for
# the train phase: the reference's "detector" recipe (configs/base.py:
# 355-391, configs/registry.py:277-278), steps per (mode, route) after
# the timed one, the kernels each route's step must launch
TRAIN_RECIPE = dict(lr=4e-3, weight_decay=1e-4, grad_clip=1.0)
TRAIN_SCHEDULE = dict(warmup=100, total=2000, min_ratio=0.3)
TRAIN_STEPS = 2
TRAIN_ROUTE_KERNELS = {
    "per_op": ("spike_conv", "norm_affine_lif", "lif_scan", "spike_matmul"),
    "fused": ("spike_conv_lif", "spike_conv", "lif_scan", "spike_matmul"),
    "segment": ("backbone_segment", "spike_conv", "norm_affine_lif",
                "lif_scan", "spike_matmul")}
# the detector loop (phase 5c): the train-smoke gate of the reference's
# examples/train_detector.py:56-83 on the reduced config, the step it
# resumes from, the full-width run's horizon and loss bar, the
# classification head's bar (kernel vs plain backend, full width)
# phase 5d (data parallelism): rounds of REQUESTS requests through the
# mesh fleet and the one-device fleet in turns; the training checks' steps
# and bars (the fleet's as E2E_TOL's; a replay of the same kernels on the
# same rows within 1e-5; the detector's DP step against the one-process
# step: the loss, the gradients' relative L2 and every state leaf after
# DIST_STEPS steps within 1e-5, the bars of tests/_torch_distributed_main.py)
DIST_ROUNDS = 8
DIST_STEPS = 2
E2E_DIST_TOL = 1e-5
DIST_LOSS_RTOL = 1e-5
DIST_GRAD_RTOL = 1e-5
DIST_STATE_TOL = 1e-5
DIST_REPLAY_TOL = 1e-5
# gloo's TCP transport breaking the connection when its point-to-point
# calls are handed CUDA tensors: the sender's writev of device memory
# fails, its peer sees the connection close
GLOO_CUDA_P2P_ERRORS = ("Bad address", "Connection closed by peer")
GATE_LOSS_RATIO = 0.5
GATE_AP_BEFORE_MAX = 0.05
GATE_AP_AFTER_MIN = 0.15
GATE_RESUME_AT = 100
FULL_STEPS = 300
FULL_LOSS_RATIO = 0.8
CLASSIFY_TOL = 1e-4
# a kernel route's step against the plain backend's on the card: a
# near-threshold flip of the forward (counted by the layer walk) would
# move the loss and the gradients, so the bars leave room for a few (the
# H100 run with 0 flips: loss equal, gradients 5.5e-7 apart)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-2
# an op's backward against plain autograd on the same forward (its spikes
# forced): rounding only, the bar of tests/test_lif_backend.py
BWD_RTOL = 1e-5
BWD_REPS = 5
# the paper's other three backbones, served beside spiking-YOLO
NEW_ARCHS = ("spiking_mobilenet", "spiking_vgg", "spiking_densenet")
TICK_KERNELS = ("event_voxel", "demosaic", "nlm")
FUSED_KERNELS = ("isp_pointwise_segment", "isp_stencil_segment")
# the fused ISP orderings checked: name -> (stages, its ISP config name)
FUSED_ORDERINGS = ("fused", "hdr_fused", "fast_preview")
# plan segments whose kernel gives its plain version's bits
EXACT_SEGMENTS = ("[exposure+dpc]", "[demosaic]", "[awb*+gamma]")
# row 12's cases: the pointwise segment (label) of an ordering's plan, and
# its frames' channels: fast_preview's, an exposure chain on Bayer frames,
# a chain with no gamma
POINTWISE_CASES = {
    "[awb*+gamma]": (("exposure", "dpc", "demosaic", "awb", "gamma"), 3),
    "[exposure]": (("exposure",), 1),
    "[awb*+tonemap+ccm]": (("demosaic", "awb", "tonemap", "ccm"), 3)}
POINTWISE_EXACT = ("[awb*+gamma]", "[exposure]")
POINTWISE_SHAPES = ((BATCH, 64, 64), RAGGED, TINY, VGA,
                    (BATCH, LARGE_HW, LARGE_HW))
# fp32 operations per pixel of each device op of the fused segments,
# counted from csrc/isp_fused.cu (C = 3 channels where it applies);
# nlm's from nlm_ops
SEGMENT_OPS = {"exposure": 9, "awb": 24, "gamma": 21, "tonemap": 17,
               "ccm": 20, "dpc": 48, "demosaic": 44, "sharpen": 46}


def npu_launches_per_tick(cfg, fused=0, segments=()):
    """Kernel launches of one ``npu_forward`` on the "cuda" backend, with
    the backbone ``segments`` (``Segment``s) on the backbone_segment
    kernel, one launch each, and ``fused`` of the firing non-depthwise
    convs outside them on the fused conv->LIF kernel, the rest on the
    per-op pair (tests/test_torch_backbones.py,
    tests/test_torch_conv_lif.py and tests/test_torch_backbone_fuse.py
    hold this to the code).  The detection head adds a firing conv and
    a readout conv; the classification head (``cfg.detect`` off) is a
    plain product and launches nothing."""
    S = cfg.num_stages
    # the backbone's (convs, firing convs, depthwise convs, pools)
    conv, fire, dw, pool = {
        "yolo": (2 * S, 2 * S, 0, 0),
        "vgg": (2 * S, 2 * S, 0, S),
        "mobilenet": (S + 1, 2 * S + 1, S, 0),
        "densenet": (4 * S + 1, 4 * S + 1, 0, S)}[cfg.backbone]
    # the detection head: head_conv fires, head_pred reads out
    head = 1 if cfg.detect else 0
    out = {"spike_conv": conv + 2 * head - fused,
           "norm_affine_lif": fire + head - fused,
           "spike_dwconv": dw, "max_pool": pool, "lif_scan": 1,
           "spike_matmul": 1}
    if fused:
        out["spike_conv_lif"] = fused
    for seg in segments:
        # the segment's layers launch nothing but the segment kernel
        out["backbone_segment"] = out.get("backbone_segment", 0) + 1
        for s in seg.layers:
            out["spike_dwconv" if s.depthwise else "spike_conv"] -= 1
            out["norm_affine_lif"] -= 1
            out["max_pool"] -= bool(s.pool)
    return out


def conv_lif_layers(params, cfg, batch, skip=()):
    """(name, T, B, H, W, C, kh, stride, N) of every firing
    non-depthwise conv of one forward, in order (the backbone's, then
    head_conv): its input [T, B, H, W, C], its kh x kh kernel, stride and
    output channels; the layers named in ``skip`` left out."""
    layers = []

    def conv(name, p, x, stride, depthwise):
        T, B, H, W, _ = x
        kh, kw, cin, cout = p["w"].shape
        if not depthwise and name not in skip:
            layers.append((name, T, B, H, W, cin, kh, stride, cout))
        return (T, B, -(-H // stride), -(-W // stride),
                x[4] if depthwise else cout)

    def pool(name, x, window):
        return x[:2] + (x[2] // window, x[3] // window, x[4])

    x = backbone_walk(cfg, params["backbone"],
                      (cfg.time_steps, batch, cfg.height, cfg.width,
                       cfg.in_channels), conv, pool,
                      lambda fs: fs[0][:4] + (sum(f[4] for f in fs),))
    conv("head_conv", params["head"]["conv"], x, 1, False)
    return layers


def conv_lif_dims(params, cfg, batch, skip=()):
    """The launch-table dims (T, B, HW, K, N) of every firing
    non-depthwise conv of one forward, in order (the backbone's, then
    head_conv): each one ``conv_lif`` dispatch; the layers named in
    ``skip`` left out."""
    return [dict(T=T, B=B, HW=-(-H // s) * -(-W // s), K=k * k * C, N=N)
            for _, T, B, H, W, C, k, s, N in conv_lif_layers(
                params, cfg, batch, skip)]


def norm_shapes(params, cfg, batch):
    """[T, B, HW, C] of every norm_affine_lif launch of one untuned
    forward on the per-layer route, in order: each firing conv's (the
    backbone's, depthwise included, then head_conv)."""
    shapes = []

    def conv(name, p, x, stride, depthwise):
        T, B, H, W, _ = x
        cout = x[4] if depthwise else p["w"].shape[-1]
        Ho, Wo = -(-H // stride), -(-W // stride)
        shapes.append((T, B, Ho * Wo, cout))
        return (T, B, Ho, Wo, cout)

    def pool(name, x, window):
        return x[:2] + (x[2] // window, x[3] // window, x[4])

    x = backbone_walk(cfg, params["backbone"],
                      (cfg.time_steps, batch, cfg.height, cfg.width,
                       cfg.in_channels), conv, pool,
                      lambda fs: fs[0][:4] + (sum(f[4] for f in fs),))
    conv("head_conv", params["head"]["conv"], x, 1, False)
    return shapes


def fused_segments(cfg, batch, table):
    """The fused-route backbone segments of one forward that ``table``
    routes to the backbone_segment kernel."""
    from repro_torch.core.backbones import fused_route_segments
    out = []
    for seg, _, key in fused_route_segments(cfg, batch):
        c = table.config_for(key)
        if c is not None and c.fused:
            out.append(seg)
    return out


def fused_layers(params, cfg, batch, table):
    """How many firing non-depthwise convs of one forward ``table``
    routes to the fused conv->LIF kernel (outside the segments it routes
    to the segment kernel)."""
    from repro_torch.kernels import tune
    inside = {s.name for seg in fused_segments(cfg, batch, table)
              for s in seg.layers}
    return sum(bool(c and c.fused) for c in (
        table.config_for(tune.shape_key("conv_lif", **d))
        for d in conv_lif_dims(params, cfg, batch, skip=inside)))


def backbone_walk(cfg, bb, x, conv, pool, cat):
    """The backbone's layers in the order its apply runs them (the
    per-layer route): ``conv(name, p, x, stride, depthwise)`` per conv,
    ``pool(name, x, window)`` per max-pool, DenseNet's concats through
    ``cat`` (tests/test_torch_backbones.py holds this to the backbones'
    own apply)."""
    from repro_torch.core import backbones as BB
    if cfg.backbone == "densenet":
        x = conv("stem", bb["stem"], x, 1, False)
        for s in range(cfg.num_stages):
            feats = [x]
            for i in range(BB.DENSE_LAYERS_PER_BLOCK):
                name = f"b{s}_l{i}"
                feats.append(conv(name, bb[name], cat(feats), 1, False))
            x = pool(f"t{s}", conv(f"t{s}", bb[f"t{s}"], cat(feats), 1,
                                   False), 2)
        return x
    specs = {"vgg": BB.vgg_specs, "mobilenet": BB.mobilenet_specs,
             "yolo": BB.yolo_specs}[cfg.backbone](cfg)
    for s in specs:
        x = conv(s.name, bb[s.name], x, s.stride, s.depthwise)
        if s.pool:
            x = pool(s.name, x, s.pool)
    return x


def pool_shapes(params, cfg, batch):
    """(name, [T, B, H, W, C], window) of every max_pool of one forward,
    in order."""
    shapes = []

    def conv(name, p, x, stride, depthwise):
        T, B, H, W, _ = x
        return (T, B, -(-H // stride), -(-W // stride),
                x[4] if depthwise else p["w"].shape[-1])

    def pool(name, x, window):
        shapes.append((name, x, window))
        return x[:2] + (x[2] // window, x[3] // window, x[4])

    backbone_walk(cfg, params["backbone"],
                  (cfg.time_steps, batch, cfg.height, cfg.width,
                   cfg.in_channels), conv, pool,
                  lambda fs: fs[0][:4] + (sum(f[4] for f in fs),))
    return shapes


def pool_check(name, x, window, st):
    """max_pool on a layer's spikes x [T, B, H, W, C] as the main path
    gives them (contiguous in [T, B] order), read where they lie: both
    gate modes bit-equal to the plain version on the batch-major fold,
    also with an all-silent frame, and the [N, H, W, C] entry on the
    fold (and the earlier design, where build/earlier holds its source)
    equal too.  Timed beside the plain
    version, F.max_pool2d on the fold (library), the fold copy alone and
    the parent's path: the fold copy, then the earlier kernel.  Returns
    the batch-major output."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import layers as L
    from repro_torch.kernels.max_pool import max_pool
    check(x.is_contiguous(), f"max_pool {name}: the spikes are not "
          f"contiguous in [T, B] order")
    earlier = earlier_max_pool()
    silent = x.clone()
    silent[0, 0] = 0
    for label, inp in (("main path", x), ("silent frame", silent)):
        xf = L.fold(inp).contiguous()
        want = L.pool_slices(xf, window)
        for gated in (True, False):
            got = max_pool(inp, window=window, gated=gated)
            flat = max_pool(xf, window=window, gated=gated)
            torch.cuda.synchronize()
            check(torch.equal(got, want) and torch.equal(flat, want),
                  f"max_pool {name} ({label}, gated={gated}) differs from "
                  f"its plain version")
        if earlier:
            check(torch.equal(earlier(xf, window), want), f"max_pool "
                  f"{name} ({label}): the earlier design differs")
    y = max_pool(x, window=window)
    T, B, H, W, C = x.shape
    ho, wo = H // window, W // window
    xf = L.fold(x).contiguous()
    xn = xf.permute(0, 3, 1, 2)                 # channels-last NCHW
    ms = time_ms(lambda: max_pool(x, window=window))
    fold_ms = time_ms(lambda: L.fold(x).contiguous())
    old_ms = time_ms(lambda: earlier(xf, window)) if earlier else None
    parent_ms = time_ms(lambda: earlier(L.fold(x).contiguous(), window)) \
        if earlier else None
    st.add((T, B, H, W, C), ms,
           time_ms(lambda: L.pool_slices(L.fold(x), window)),
           (T * B * ho * wo * window * window * C + y.numel()) * 4,
           (window * window - 1) * int((y != 0).sum()), 0.0,
           library_ms=time_ms(lambda: F.max_pool2d(xn, window)),
           extra={"fold_ms": fold_ms, "earlier_design_ms": old_ms,
                  "parent_path_ms": parent_ms})
    print(f"  max_pool {name:11s} [T,B,H,W,C]={(T, B, H, W, C)} window "
          f"{window}: read in [T, B] order, equal in both gate modes, "
          f"silent frame included; ms {ms:.5f}, parent's path (fold copy "
          f"{fold_ms:.5f} + earlier kernel) "
          + (f"{parent_ms:.5f}" if earlier else "not built"))
    return y


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps=TIMING_REPS, warmup=3):
    """Median device time of one call of ``fn``.  A spin kernel keeps the
    card busy while the host enqueues ``fn``, so the two events bracket
    fn's device work, not the host's launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(max(2 * host_s, 1e-4) * SPIN_CYCLES_PER_S)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


EARLIER = ROOT / "build" / "earlier"  # earlier designs' sources, to time
_EARLIER_LIBS = {}


def _earlier(name, argtypes, symbol=None):
    """The launch function (``symbol``, default ``<name>_launch``) of
    kernel ``name``'s earlier design, built with the kernels' nvcc flags
    from a copy of its source at build/earlier/<source>; None where there
    is no copy.  Headers are looked up in build/earlier first, then in
    csrc: copies of the earlier headers there (``isp_common.cuh`` from
    aef84b2 for the earlier demosaic and stencil designs, which call its
    runtime-tap ``mhc_rgb``) take precedence over today's."""
    import ctypes
    from repro_torch.kernels import build
    src = EARLIER / build.SOURCES[name]
    if not src.exists():
        return None
    if name not in _EARLIER_LIBS:
        lib_path = EARLIER / f"lib{name}.so"
        done = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(EARLIER), "-I",
             str(build.CSRC), "-o", str(lib_path), str(src)],
            capture_output=True, text=True,
            timeout=300)
        check(done.returncode == 0, f"the earlier {name} does not "
              f"build:\n{done.stdout}{done.stderr}")
        _EARLIER_LIBS[name] = ctypes.CDLL(str(lib_path))
    fn = getattr(_EARLIER_LIBS[name], symbol or f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def earlier_max_pool():
    """max_pool's earlier design (a thread an output, a 64-bit index
    decode, on the batch-major fold that the parent's path copied first),
    built from a copy of its source at build/earlier/max_pool.cu (`git
    show 2798f1c:src/repro_torch/kernels/csrc/max_pool.cu >
    build/earlier/max_pool.cu`), as a function (xf, window) -> out, gated;
    None where there is no copy."""
    import ctypes
    import torch
    fn = _earlier("max_pool", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p])
    if fn is None:
        return None

    def run(xf, window):
        N, H, W, C = xf.shape
        out = torch.empty((N, H // window, W // window, C),
                          device=xf.device)
        err = fn(xf.data_ptr(), out.data_ptr(), N, H, W, C, window, 1,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the earlier max_pool failed to launch: "
              f"cudaError {err}")
        return out
    return run


def earlier_stencil():
    """The stencil segment's earlier design (a 16x16 output tile and one
    thread a pixel a block, the window op and its side chosen at run
    time, NLM's 49 weights serial in one thread), built from a copy of
    its source at build/earlier/isp_fused.cu (`git show
    2798f1c:src/repro_torch/kernels/csrc/isp_fused.cu >
    build/earlier/isp_fused.cu`), as a function taking the wrapper's
    arguments and doing what the parent's wrapper did around the launch
    (the gamma LUT and the flattened constants built by torch ops on
    every call); None where there is no copy."""
    import ctypes
    import torch
    from repro_torch.isp.gamma import gamma_lut
    from repro_torch.kernels import isp_fused as IF
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _earlier("isp_fused", [P] * 6 + [I] * 8 + [P] * 3 + [I] * 5 + [P],
                  symbol="isp_stencil_launch")
    if fn is None:
        return None

    def run(x, pvec, stats, consts=(), *, prologue, wstep, radius, pad,
            out_tail, **_):
        (n, ops, poffs, coffs), starts = IF._descriptor(prologue, consts)
        g = IF.gamma_offset(prologue)
        lut = gamma_lut(pvec[:, g], device=x.device) if g >= 0 else None
        B, H, W = x.shape[:3]
        out = torch.empty((B, H, W) + tuple(out_tail), device=x.device)
        # the parent's wrapper flattened the constants on every call
        flat = (torch.cat([c.reshape(-1) for c in consts]) if consts
                else torch.zeros(1, device=x.device))
        err = fn(x.data_ptr(), out.data_ptr(), pvec.data_ptr(),
                 stats.data_ptr(), flat.data_ptr(),
                 0 if lut is None else lut.data_ptr(), B, H, W,
                 x.shape[3] if x.dim() == 4 else 1,
                 out_tail[0] if out_tail else 1, pvec.shape[1],
                 stats.shape[1], n, ops, poffs, coffs,
                 IF.DEVICE_OPS.index(wstep.op) + 1, wstep.offset,
                 starts[wstep.c_offset], radius, int(pad == "zero"),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the earlier stencil segment failed to launch: "
              f"cudaError {err}")
        return out
    return run


def earlier_pointwise():
    """The pointwise segment's PR 13 design (a thread a pixel, a 64-bit
    index decode, the [B, 256] LUT read from global memory), from the
    copy of isp_fused.cu at build/earlier/isp_fused.cu (2798f1c's, whose
    pointwise kernel and launcher are PR 13's, unchanged up to 28ac6d7),
    as a namespace: ``kernel(lut, x, pvec, stats, consts, chain)``
    launches it on a prebuilt LUT (or None), ``lut_of(pvec, chain)``
    builds that LUT by torch ops, and ``parent(x, pvec, stats, consts,
    chain=...)`` does what the parent's wrapper did (the LUT, then the
    launch); None where there is no copy."""
    import ctypes
    import types
    import torch
    from repro_torch.isp.gamma import gamma_lut
    from repro_torch.kernels import isp_fused as IF
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _earlier("isp_fused", [P] * 6 + [I] * 7 + [P] * 4,
                  symbol="isp_pointwise_launch")
    if fn is None:
        return None

    def kernel(lut, x, pvec, stats, consts, chain):
        (n, ops, poffs, coffs), _ = IF._descriptor(chain, consts)
        out = torch.empty_like(x)
        flat = IF._flat_consts(consts, x.device)
        B, H, W = x.shape[:3]
        err = fn(x.data_ptr(), out.data_ptr(), pvec.data_ptr(),
                 stats.data_ptr(), flat.data_ptr(),
                 0 if lut is None else lut.data_ptr(), B, H, W,
                 x.shape[3] if x.dim() == 4 else 1, pvec.shape[1],
                 stats.shape[1], n, ops, poffs, coffs,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the earlier pointwise segment failed to launch: "
              f"cudaError {err}")
        return out

    def lut_of(pvec, chain):
        g = IF.gamma_offset(chain)
        return (gamma_lut(pvec[:, g], device=pvec.device).contiguous()
                if g >= 0 else None)

    def parent(x, pvec, stats, consts=(), *, chain, **_):
        return kernel(lut_of(pvec, chain), x, pvec, stats, consts, chain)
    return types.SimpleNamespace(kernel=kernel, lut_of=lut_of, parent=parent)


def earlier_dwconv():
    """spike_dwconv's earlier design (a thread an output in a
    grid-stride loop), from a copy of its source at
    build/earlier/spike_dwconv.cu, as a function (xf, w, stride) -> out
    on CUDA tensors; None where there is no copy."""
    import ctypes
    import torch
    from repro_torch.core.layers import _same_pads
    fn = _earlier("spike_dwconv", [ctypes.c_void_p] * 3
                  + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    if fn is None:
        return None

    def run(xf, w, stride):
        N, H, W, C = xf.shape
        kh, kw = w.shape[:2]
        pad_h, _, Ho = _same_pads(H, kh, stride)
        pad_w, _, Wo = _same_pads(W, kw, stride)
        out = torch.empty((N, Ho, Wo, C), device=xf.device)
        err = fn(xf.data_ptr(), w.data_ptr(), out.data_ptr(), N, H, W, C,
                 Ho, Wo, kh, kw, stride, pad_h, pad_w,
                 torch.cuda.current_stream(xf.device).cuda_stream)
        check(err == 0, f"the earlier spike_dwconv failed to launch: "
              f"cudaError {err}")
        return out
    return run


def earlier_norm():
    """norm_affine_lif's earlier design (one block of 32 channels x 32
    row classes per (b, channel group), three passes over L2), from a
    copy of its source at build/earlier/norm_affine_lif.cu (`git show
    97a1ee0:src/repro_torch/kernels/csrc/norm_affine_lif.cu`), as a
    function (y, scale, bias, lif_kw) -> spikes on CUDA tensors; None
    where there is no copy."""
    import ctypes
    import torch
    from repro_torch.core.layers import NORM_EPS
    from repro_torch.core.lif import f32_decay
    fn = _earlier("norm_affine_lif", [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                  + [ctypes.c_void_p])
    if fn is None:
        return None

    def run(y, scale, bias, lif_kw):
        T, B, HW, C = y.shape
        out = torch.empty_like(y)
        err = fn(y.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), T, B, HW, C, f32_decay(lif_kw["tau"]),
                 lif_kw["v_th"], lif_kw["v_reset"], NORM_EPS,
                 torch.cuda.current_stream(y.device).cuda_stream)
        check(err == 0, f"the earlier norm_affine_lif failed to launch: "
              f"cudaError {err}")
        return out
    return run


def earlier_conv_lif():
    """spike_conv_lif's earlier design (one block per (batch element,
    channel slice) holding the slice's slab, reading a torch-built patch
    matrix and, under "mask", a torch-built occupancy mask), from a copy
    of its source at build/earlier/spike_conv_lif.cu (`git show
    572391d:src/repro_torch/kernels/csrc/spike_conv_lif.cu`), as a
    function (patches, wmat, occ, scale, bias, T, B, HW, lif_kw) ->
    spikes on CUDA tensors, gate "mask", at the widest slice whose slab
    fits a block (that design's own rule); None where there is no copy."""
    import ctypes
    import torch
    from repro_torch.core.layers import NORM_EPS
    from repro_torch.core.lif import f32_decay
    fn = _earlier("spike_conv_lif", [ctypes.c_void_p] * 6
                  + [ctypes.c_int] * 7 + [ctypes.c_float] * 4
                  + [ctypes.c_void_p])
    if fn is None:
        return None

    def smem(rows, nc):
        return 8 * 32 * nc + 4 * (2 * nc + 64 * (max(64, 256 // nc) + 4)
                                  + 64 * nc + rows * nc)

    def run(patches, wmat, occ, scale, bias, T, B, HW, lif_kw):
        K, N = wmat.shape
        nc = next(w for w in (64, 32, 16, 8, 4, 2, 1)
                  if w < 2 * N and smem(T * HW, w) <= 232448)
        out = torch.empty((T, B, HW, N), device=patches.device)
        err = fn(patches.data_ptr(), wmat.data_ptr(), occ.data_ptr(),
                 scale.data_ptr(), bias.data_ptr(), out.data_ptr(), T, B, HW,
                 K, N, nc, 0, f32_decay(lif_kw["tau"]), lif_kw["v_th"],
                 lif_kw["v_reset"], NORM_EPS,
                 torch.cuda.current_stream(patches.device).cuda_stream)
        check(err == 0, f"the earlier spike_conv_lif failed to launch: "
              f"cudaError {err}")
        return out
    return run


def earlier_segment():
    """backbone_segment's earlier design (one cluster per batch element
    sharing an L2 scratch: 64x64 register-staged conv tiles dealt round
    the cluster, the conv output, the statistics' class sums and the
    spikes in global memory, four fenced barriers a layer), from a copy
    of its source at build/earlier/backbone_segment.cu (`git show
    5b9eb78:src/repro_torch/kernels/csrc/backbone_segment.cu`), as a
    function (x, params, specs, gate, cluster, lif_kw) -> spikes on CUDA
    tensors; it takes the canonical-padded weight matrices and the
    scratch it always took.  None where there is no copy."""
    import ctypes
    import torch
    from repro_torch.core.layers import NORM_EPS, _same_pads
    from repro_torch.core.lif import f32_decay
    from repro_torch.kernels.backbone_fuse import (conv_out_hw, layer_out_hw,
                                                   out_channels)
    fn = _earlier("backbone_segment", [ctypes.c_void_p, ctypes.c_void_p]
                  + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                  + [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_void_p,
                                             ctypes.c_int64, ctypes.c_void_p]
                  + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    if fn is None:
        return None

    def operands(params, specs):
        flat = []
        for (w, scale, bias), s in zip(params, specs):
            wmat = w.reshape(-1, w.shape[-1])
            if not s.depthwise:
                pad = -wmat.shape[0] % 128
                wmat = torch.cat([wmat, wmat.new_zeros((pad, wmat.shape[1]))])
            flat += [wmat.contiguous(), scale, bias]
        return flat

    def run(x, params, specs, gate, cluster, lif_kw, flat=None):
        flat = flat if flat is not None else operands(params, specs)
        T, B, H, W, _ = x.shape
        dims, ptrs = [], []
        act_elems = acc_elems = max_n = 1
        h, w = H, W
        for i, s in enumerate(specs):
            ho, wo = conv_out_hw(s, h, w)
            n = out_channels(s)
            dims += [h, w, s.cin, ho, wo, n, s.kernel, s.stride,
                     _same_pads(h, s.kernel, s.stride)[0],
                     _same_pads(w, s.kernel, s.stride)[0], int(s.depthwise),
                     s.pool]
            ptrs += [t.data_ptr() for t in flat[3 * i:3 * i + 3]]
            acc_elems = max(acc_elems, T * ho * wo * n)
            max_n = max(max_n, n)
            h, w = layer_out_hw(s, h, w)
            if i + 1 < len(specs):
                act_elems = max(act_elems, T * h * w * n)
        out = torch.empty((T, B, h, w, out_channels(specs[-1])),
                          device=x.device)
        act = torch.empty((2, B, act_elems), device=x.device)
        acc = torch.empty((B, acc_elems), device=x.device)
        red = torch.empty((B, 64 * max_n), dtype=torch.float64,
                          device=x.device)
        err = fn((ctypes.c_int * len(dims))(*dims),
                 (ctypes.c_void_p * len(ptrs))(*ptrs), len(specs), T, B,
                 {"inline": 1, "none": 2}[gate], f32_decay(lif_kw["tau"]),
                 lif_kw["v_th"], lif_kw["v_reset"], NORM_EPS, x.data_ptr(),
                 out.data_ptr(), act[0].data_ptr(), act[1].data_ptr(),
                 act_elems, acc.data_ptr(), acc_elems, red.data_ptr(),
                 max_n, cluster,
                 torch.cuda.current_stream(x.device).cuda_stream)
        check(err == 0, f"the earlier backbone_segment failed to launch: "
              f"cudaError {err}")
        return out
    run.operands = operands
    return run


def earlier_nlm():
    """nlm's earlier design (one thread a pixel running the serial
    nlm_pixel, 49 weights with a divide and an exp each), built from a
    copy of its source at build/earlier/nlm.cu (`git show
    2f15604:src/repro_torch/kernels/csrc/nlm.cu > build/earlier/nlm.cu`),
    as a function (img, strength) -> out doing what the parent's wrapper
    did around the launch (the bandwidth h and the luminance plane by
    torch ops on every call); None where there is no copy."""
    import ctypes
    import torch
    from repro_torch.isp.nlm import luminance, nlm_bandwidth
    fn = _earlier("nlm", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])
    if fn is None:
        return None

    def run(img, strength):
        chans = img[..., None] if img.dim() == 3 else img
        B, H, W, C = chans.shape
        h = nlm_bandwidth(strength, img.device)
        h = (h.expand(B) if h.dim() == 0 else h).contiguous()
        lum = luminance(chans)
        out = torch.empty_like(chans)
        err = fn(chans.data_ptr(), lum.data_ptr(), h.data_ptr(),
                 out.data_ptr(), B, H, W, C,
                 torch.cuda.current_stream(img.device).cuda_stream)
        check(err == 0, f"the earlier nlm failed to launch: cudaError {err}")
        return out.reshape(img.shape)
    return run


def earlier_demosaic():
    """demosaic's earlier design (one thread a pixel over the whole
    [B, H, W], a 64-bit index decode, runtime taps from constant memory,
    the four Bayer phases in every warp), built from a copy of its source
    at build/earlier/demosaic.cu (`git show
    aef84b2:src/repro_torch/kernels/csrc/demosaic.cu`, with that commit's
    isp_common.cuh beside it), as a function raw -> rgb; None where there
    is no copy."""
    import ctypes
    import torch
    fn = _earlier("demosaic", [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
    if fn is None:
        return None

    def run(raw):
        B, H, W = raw.shape
        out = torch.empty((B, H, W, 3), device=raw.device)
        err = fn(raw.data_ptr(), out.data_ptr(), B, H, W,
                 torch.cuda.current_stream(raw.device).cuda_stream)
        check(err == 0, f"the earlier demosaic failed to launch: "
              f"cudaError {err}")
        return out
    return run


def earlier_lif_scan():
    """lif_scan's earlier design (no bias: the dense layer's add was a
    torch op before it), built from a copy of its source at
    build/earlier/lif_scan.cu (`git show
    aef84b2:src/repro_torch/kernels/csrc/lif_scan.cu`), as a function
    (currents [T, N], **lif_kw) -> spikes; None where there is no
    copy."""
    import ctypes
    import torch
    from repro_torch.core.lif import f32_decay
    fn = _earlier("lif_scan", [ctypes.c_void_p] * 2
                  + [ctypes.c_int, ctypes.c_int64] + [ctypes.c_float] * 3
                  + [ctypes.c_void_p])
    if fn is None:
        return None

    def run(cur, *, tau, v_th, v_reset):
        T, N = cur.shape
        out = torch.empty_like(cur)
        err = fn(cur.data_ptr(), out.data_ptr(), T, N, f32_decay(tau), v_th,
                 v_reset, torch.cuda.current_stream(cur.device).cuda_stream)
        check(err == 0, f"the earlier lif_scan failed to launch: "
              f"cudaError {err}")
        return out
    return run


def earlier_event_voxel():
    """event_voxel's earlier design (a block per (window, time bin, 8192
    cells), each walking all of its window's events), built from a copy
    of its source at build/earlier/event_voxel.cu (`git show
    2f15604:src/repro_torch/kernels/csrc/event_voxel.cu >
    build/earlier/event_voxel.cu`), as a function (evs, **kw) -> [B, T,
    H, W, 2]; the parent's tick selected from it with a torch.where on
    its [T, B] view.  None where there is no copy."""
    import ctypes
    import torch
    fn = _earlier("event_voxel", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p])
    if fn is None:
        return None
    modes = {"binary": 0, "count": 1, "signed": 2}

    def run(evs, *, time_steps, height, width, window=1.0, mode="binary",
            oob="clip"):
        B, N = evs.t.shape
        out = torch.empty((B, time_steps, height, width, 2),
                          device=evs.t.device)
        err = fn(*(a.data_ptr() for a in evs), out.data_ptr(), B, N,
                 time_steps, height, width, window, modes[mode],
                 int(oob == "drop"),
                 torch.cuda.current_stream(evs.t.device).cuda_stream)
        check(err == 0, f"the earlier event_voxel failed to launch: "
              f"cudaError {err}")
        return out
    return run


def ms_or_none(fn):
    """time_ms(fn), or None where there is no fn (an earlier design not
    built)."""
    return None if fn is None else time_ms(fn)


def _sum_or_none(a, b):
    return None if a is None or b is None else a + b


class KernelStats:
    """Per-kernel sums over one tick's launches."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.bytes_s = self.ops_s = 0.0
        self.library_ms = None
        self.per_op_ms = None       # spike_conv_lif: the per-op kernel pair
        self.max_abs_err = 0.0
        self.shapes = []
        self.extra = {}             # other named times, summed (ms);
        #                             None where one was not timed

    def add(self, shape, ms, plain_ms, nbytes, nops, err, library_ms=None,
            per_op_ms=None, peak_flops=FP32_FLOPS, extra=None):
        self.shapes.append(shape)
        for k, v in (extra or {}).items():
            self.extra[k] = _sum_or_none(self.extra.get(k, 0.0), v)
        if per_op_ms is not None:
            self.per_op_ms = (self.per_op_ms or 0.0) + per_op_ms
        self.ms += ms
        self.plain_ms += plain_ms
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / peak_flops * 1e3
        self.bound_ms += max(tb, to)
        self.bytes_s += tb
        self.ops_s += to
        self.max_abs_err = max(self.max_abs_err, float(err))
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + library_ms

    def merge(self, other):
        """Add ``other``'s launches to these."""
        self.shapes += other.shapes
        self.ms += other.ms
        self.plain_ms += other.plain_ms
        self.bound_ms += other.bound_ms
        self.bytes_s += other.bytes_s
        self.ops_s += other.ops_s
        self.max_abs_err = max(self.max_abs_err, other.max_abs_err)
        if other.library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + other.library_ms
        if other.per_op_ms is not None:
            self.per_op_ms = (self.per_op_ms or 0.0) + other.per_op_ms
        for k, v in other.extra.items():
            self.extra[k] = _sum_or_none(self.extra.get(k, 0.0), v)
        return self

    def summary(self):
        out = {"launches": len(self.shapes), "ms": self.ms,
               "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
               "library_ms": self.library_ms,
               "max_abs_err": self.max_abs_err}
        if self.per_op_ms is not None:
            out["per_op_ms"] = self.per_op_ms
        out.update(self.extra)
        return out

    def row(self, name, launches):
        src, replaces = KERNELS[name]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": self.max_abs_err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "bytes" if self.bytes_s >= self.ops_s
                else "operations",
                "library_ms": self.library_ms,
                "profile_windows": PROFILE_WINDOWS.get(name)}


def live_tile_elems(occ, M, K, bm=128, bk=128):
    """Patch elements inside tiles whose occupancy bit is set."""
    import torch
    rows = torch.full((occ.shape[0],), bm, dtype=torch.float64)
    rows[-1] = M - bm * (occ.shape[0] - 1)
    cols = torch.full((occ.shape[1],), bk, dtype=torch.float64)
    cols[-1] = K - bk * (occ.shape[1] - 1)
    return float((occ.double().cpu() * rows[:, None] * cols[None, :]).sum())


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

def make_requests(cfg, rng):
    """8 voxel windows then 8 raw event buffers (ragged, some overfull)
    with Bayer frames, all from one numpy generator."""
    import numpy as np
    import torch
    from repro_torch.core.encoding import EventStream, events_to_voxel
    from repro_torch.serve.cognitive_engine import PerceptionRequest

    def events(n):
        return EventStream(
            t=rng.random(n).astype(np.float32),
            x=rng.integers(0, cfg.width, n).astype(np.int32),
            y=rng.integers(0, cfg.height, n).astype(np.int32),
            p=rng.integers(0, 2, n).astype(np.int32),
            valid=rng.random(n) < 0.97)

    def bayer():
        b = rng.uniform(0.05, 0.95, (cfg.height, cfg.width)).astype(
            np.float32)
        hot = rng.random(b.shape) < 0.01
        b[hot] = rng.choice([0.0, 1.0], int(hot.sum()))
        return b

    reqs = []
    for i in range(REQUESTS // 2):
        ev = events(EVENT_CAPACITY)
        vox = events_to_voxel(EventStream(*(torch.as_tensor(a) for a in ev)),
                              time_steps=cfg.time_steps, height=cfg.height,
                              width=cfg.width)
        reqs.append(PerceptionRequest(rid=i, voxels=vox.numpy(),
                                      bayer=bayer()))
    for i in range(REQUESTS // 2, REQUESTS):
        n = int(rng.integers(EVENT_CAPACITY // 2, EVENT_CAPACITY * 5 // 4))
        reqs.append(PerceptionRequest(rid=i, events=events(n), bayer=bayer()))
    return reqs


# ---------------------------------------------------------------------------
# phase 3 + 4: per-kernel parity and timings on the main path's inputs
# ---------------------------------------------------------------------------

def kernel_phase(params, cfg, vox):
    """Every NPU kernel of ``cfg``'s forward on the main path's own
    inputs, layer by layer: held to its plain version and timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import layers as L
    from repro_torch.kernels.spike_conv import GATES as CONV_GATES
    from repro_torch.kernels.spike_conv import (conv_tiles, occupancy_mask,
                                                spike_conv)
    from repro_torch.kernels import spike_dwconv as dw_mod
    from repro_torch.kernels import spike_matmul as mm_mod
    from repro_torch.kernels.spike_dwconv import (spike_dwconv,
                                                  tap_occupancy_mask)
    from repro_torch.kernels.spike_matmul import spike_matmul

    from repro_torch.core.backbones import fused_route_segments

    st = {k: KernelStats() for k in NPU_KERNELS}
    lif_kw = dict(tau=cfg.tau_mem, v_th=cfg.v_threshold, v_reset=cfg.v_reset)
    T, B = vox.shape[:2]
    gemm_inputs = []
    last = {}                   # the latest conv's patches, wmat and output
    routes = fused_route_segments(cfg, B)
    seg_inputs = {seg.layers[0].name: None for seg, _, _ in routes}

    def gemm(p, x, stride, name):
        """spike_conv on x's folded spikes, under every gate bit-equal to
        the gated GEMM (spike_matmul) on its materialised patches -> the
        conv output [T, B, ...]."""
        w = p["w"]
        kh = w.shape[0]
        xf = L.fold(x).contiguous()
        patches, (Ho, Wo) = L.spike_im2col(xf, kh, kh, stride)
        wmat = w.reshape(-1, w.shape[-1]).contiguous()
        M, K = patches.shape
        N = wmat.shape[1]
        y = spike_conv(xf, w, stride=stride)        # the main path's gate
        oracle = spike_matmul(patches, wmat).reshape(y.shape)
        y_ref = L.spike_conv(xf, w, stride=stride)
        for gate in CONV_GATES:
            got = spike_conv(xf, w, stride=stride, gate=gate)
            torch.cuda.synchronize()
            check(torch.equal(got, oracle), f"spike_conv {name} (gate "
                  f"{gate}): {int((got != oracle).sum())} values differ "
                  f"from spike_matmul on its patches")
        check(torch.allclose(y, y_ref, atol=1e-4, rtol=1e-5),
              f"spike_conv {name} disagrees with its plain version")
        occ = occupancy_mask(patches)
        live = live_tile_elems(occ, M, K)
        # the yardstick: cuDNN on the pre-padded input, channels-last
        # (TF32 off); torch.matmul on the patches beside it
        H, W = xf.shape[1:3]
        plo_h, phi_h, _ = L._same_pads(H, kh, stride)
        plo_w, phi_w, _ = L._same_pads(W, kh, stride)
        xp = F.pad(xf, (0, 0, plo_w, phi_w, plo_h, phi_h)).permute(0, 3, 1, 2)
        wt = w.permute(3, 2, 0, 1).contiguous()

        def library():
            return F.conv2d(xp, wt, stride=stride)
        lib_err = float((library().permute(0, 2, 3, 1) - y_ref).abs().max())
        check(lib_err <= 1e-4, f"spike_conv {name}: the library conv is "
              f"{lib_err:.3g} away")
        gate_ms = {g: time_ms(lambda g=g: spike_conv(xf, w, stride=stride,
                                                     gate=g))
                   for g in CONV_GATES}
        t = conv_tiles(M, K, N)
        st["spike_conv"].add(
            (M, K, N), gate_ms["mask"],
            time_ms(lambda: L.spike_conv(xf, w, stride=stride)),
            (xf.numel() + K * N + M * N) * 4, 2.0 * N * live,
            (y - y_ref).abs().max(), library_ms=time_ms(library),
            extra={"matmul_ms": time_ms(lambda: torch.matmul(patches, wmat)),
                   "inline_ms": gate_ms["inline"],
                   "none_ms": gate_ms["none"]})
        print(f"  spike_conv {name:9s} M={M} K={K} N={N} tile "
              f"128x{t.bn}{' split-K' if t.split else ''} live tiles "
              f"{int(occ.sum())}/{occ.numel()}: bit-equal to spike_matmul "
              f"under {'/'.join(CONV_GATES)}; max|err| "
              f"{float((y - y_ref).abs().max()):.3g}; ms by gate "
              + " ".join(f"{g} {v:.4f}" for g, v in gate_ms.items()))
        if len(gemm_inputs) < 2:
            gemm_inputs.append((xf, w, stride))
        last.update(patches=patches, wmat=wmat, y=y.reshape(M, N), xf=xf,
                    w=w, stride=stride)
        return L.unfold(y, T, B)

    def dwconv(p, x, stride, name):
        """spike_dwconv on x, bit-equal to the plain tap loop -> the conv
        output [T, B, ...]."""
        w = p["w"]
        kh, kw = w.shape[:2]
        xf = L.fold(x).contiguous()
        y = spike_dwconv(xf, w, stride=stride)
        y_ref = L.spike_conv(xf, w, stride=stride, depthwise=True)
        # partly silent: the first half of the frames carry no spike
        silent = xf.clone()
        silent[: xf.shape[0] // 2] = 0
        got_s = spike_dwconv(silent, w, stride=stride)
        want_s = L.spike_conv(silent, w, stride=stride, depthwise=True)
        # the earlier design, timed beside the kernel where its source is
        earlier = earlier_dwconv()
        old = earlier(xf, w, stride) if earlier else y_ref
        torch.cuda.synchronize()
        check(torch.equal(y, y_ref), f"spike_dwconv {name} is not bit-exact")
        check(torch.equal(got_s, want_s),
              f"spike_dwconv {name} is not bit-exact on a partly silent "
              f"input")
        check(torch.equal(old, y_ref), f"spike_dwconv {name}: the earlier "
              f"design is not bit-exact")
        N, H, W, C = xf.shape
        taps, _ = L._patch_slices(xf, kh, kw, stride)
        live = sum(int((t != 0).sum()) for t in taps)
        occ = tap_occupancy_mask(L.dw_patches(xf, kh, kw, stride)[0])
        occ_s = tap_occupancy_mask(L.dw_patches(silent, kh, kw, stride)[0])
        # the yardstick: cuDNN's grouped conv on the pre-padded input,
        # channels-last (TF32 off)
        plo_h, phi_h, _ = L._same_pads(H, kh, stride)
        plo_w, phi_w, _ = L._same_pads(W, kw, stride)
        xp = F.pad(xf, (0, 0, plo_w, phi_w, plo_h, phi_h)).permute(0, 3, 1, 2)
        wt = w.permute(3, 2, 0, 1).contiguous()

        def library():
            return F.conv2d(xp, wt, stride=stride, groups=C)
        lib_err = float((library().permute(0, 2, 3, 1) - y_ref).abs().max())
        check(lib_err <= 1e-4, f"spike_dwconv {name}: the library conv is "
              f"{lib_err:.3g} away")
        ms = time_ms(lambda: spike_dwconv(xf, w, stride=stride))
        lib_ms = time_ms(library)
        old_ms = time_ms(lambda: earlier(xf, w, stride)) if earlier else None
        st["spike_dwconv"].add(
            (N, H, W, C, stride), ms,
            time_ms(lambda: L.spike_conv(xf, w, stride=stride,
                                         depthwise=True)),
            (xf.numel() + y.numel() + w.numel()) * 4, 2.0 * live, 0.0,
            library_ms=lib_ms, extra={"earlier_design_ms": old_ms})
        t = dw_mod.dw_tiles(N, H, W, C, kh, kw, stride)
        print(f"  spike_dwconv {name:7s} [N,H,W,C]={(N, H, W, C)} stride "
              f"{stride}, {t.blocks} blocks of {t.bh}x{t.bw} outputs x "
              f"{t.cg} channels, {t.threads} threads, {t.smem_bytes} B "
              f"shared: bit-exact"
              f"{' (the earlier design too)' if earlier else ''}; "
              f"live taps {live}/{kh * kw * y.numel()}, "
              f"silent tap slabs {int((occ == 0).sum())}/{occ.numel()} "
              f"(partly silent input: {int((occ_s == 0).sum())}, "
              f"bit-exact); ms {ms:.5f}, cuDNN {lib_ms:.5f}, earlier design "
              + (f"{old_ms:.5f}" if earlier else "not built"))
        return L.unfold(y, T, B)

    def conv(name, p, x, stride, depthwise):
        if name in seg_inputs:
            seg_inputs[name] = x.contiguous()
        y5 = (dwconv if depthwise else gemm)(p, x, stride, name)
        s5 = fire(p, y5, name, st, lif_kw)
        if not depthwise:
            fused_check(p, last, s5, name, st, lif_kw)
        return s5

    def pool(name, x, window):
        """max_pool on the layer's spikes as they lie (pool_check)."""
        return L.unfold(pool_check(name, x, window, st["max_pool"]),
                        *x.shape[:2])

    feats = backbone_walk(cfg, params["backbone"], vox, conv, pool,
                          lambda fs: torch.cat(fs, dim=-1))
    h = conv("head_conv", params["head"]["conv"], feats, 1, False)
    gemm(params["head"]["pred"], h, 1, "head_pred")

    # partly silent input: the first half of the frames carry no spike
    xf, w, stride = gemm_inputs[-1]
    silent = xf.clone()
    silent[: silent.shape[0] // 2] = 0
    patches, _ = L.spike_im2col(silent, w.shape[0], w.shape[1], stride)
    wmat = w.reshape(-1, w.shape[-1])
    occ = occupancy_mask(patches)
    check(int((occ == 0).sum()) > 0, "no silent tile in the skip check")
    want = spike_matmul(patches, wmat)
    plain = L.blocked_matmul(patches, wmat)
    for gate in CONV_GATES:
        got = spike_conv(silent, w, stride=stride,
                         gate=gate).reshape(want.shape)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"spike_conv (gate {gate}) differs "
              f"from spike_matmul on a partly silent input")
        check(torch.allclose(got, plain, atol=1e-4, rtol=1e-5),
              f"spike_conv (gate {gate}) disagrees with its plain version "
              f"on a partly silent input")
    print(f"  spike_conv partly silent: {int((occ == 0).sum())}/"
          f"{occ.numel()} tiles silent, bit-equal to spike_matmul under "
          f"{'/'.join(CONV_GATES)}, max|err| "
          f"{float((got - plain).abs().max()):.3g}")

    # control head: ctrl_hidden fires through lif_scan with the dense
    # layer's bias in its launch, ctrl_out is the spike-input matmul
    ph, po = params["ctrl_hidden"], params["ctrl_out"]
    s_k = control_fire_check(feats.mean(dim=(2, 3)) @ ph["w"], ph["bias"],
                             st["lif_scan"], lif_kw)

    hx = s_k.reshape(T * B, -1).contiguous()
    rnd = (torch.rand(hx.shape, device=hx.device,
                      generator=torch.Generator(hx.device).manual_seed(1))
           < 0.3).float()
    errs = []
    M, K = hx.shape
    N = po["w"].shape[1]
    path = mm_mod.matmul_path(M, N)
    check(path == "small", f"spike_matmul: the head's [{M}, {K}] @ [{K}, "
          f"{N}] takes the {path} path")
    for xin, label in ((hx, "main path"), (rnd, "30% spikes")):
        got = spike_matmul(xin, po["w"])
        tiled = mm_mod._launch(xin, po["w"], "tiled")
        want = L.blocked_matmul(xin, po["w"])
        torch.cuda.synchronize()
        check(torch.equal(got, tiled), f"spike_matmul: the small path "
              f"differs from the tiled one ({label})")
        check(torch.allclose(got, want, atol=1e-4, rtol=1e-5),
              f"spike_matmul disagrees ({label})")
        errs.append(float((got - want).abs().max()))
        print(f"  spike_matmul {label} {tuple(xin.shape)}@"
              f"{tuple(po['w'].shape)} spikes {float(xin.mean()):.3f}: "
              f"{path} path bit-equal to the tiled one, max|err| "
              f"{errs[-1]:.3g}")
    live = live_tile_elems(occupancy_mask(hx), M, K)
    st["spike_matmul"].add(
        (M, K, N), time_ms(lambda: spike_matmul(hx, po["w"])),
        time_ms(lambda: L.blocked_matmul(hx, po["w"])),
        (M * K + K * N + M * N) * 4, 2.0 * N * live, max(errs),
        library_ms=time_ms(lambda: torch.matmul(hx, po["w"])),
        extra={"tiled_ms": time_ms(
            lambda: mm_mod._launch(hx, po["w"], "tiled"))})
    for seg, _, _ in routes:
        segment_check(params["backbone"], cfg, seg,
                      seg_inputs[seg.layers[0].name], st, lif_kw)
    return st


def control_fire_check(y, bias, st, lif_kw):
    """The control head's firing on its own currents y = pooled @ w
    [T, B, C] and the layer's bias [C]: lif_scan with the bias in its
    launch equal to the plain scan of y + bias (also with a seeded
    random bias: the served one is zero at init) and to the parent's
    path, the add then the earlier kernel (where build/earlier holds its
    source); one device op a call against the parent's two; timed
    beside them into ``st``.  Returns the spikes [T, B * C]."""
    import numpy as np
    import torch
    from repro_torch.core.lif import lif_scan as lif_plain
    from repro_torch.kernels.lif_scan import lif_scan
    T, C = y.shape[0], y.shape[-1]
    flat = y.reshape(T, -1).contiguous()
    old = earlier_lif_scan()
    rnd = torch.tensor(np.random.default_rng(7).normal(0.0, 0.5, C)
                       .astype(np.float32), device=y.device)
    for b, label in ((bias, "the layer's bias"), (rnd, "a random bias")):
        got = lif_scan(flat, bias=b, **lif_kw)
        cur = (y + b).reshape(T, -1)
        want = lif_plain(cur, **lif_kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"lif_scan with {label} is not the "
              f"plain scan of currents + bias")
        check(old is None or torch.equal(got, old(cur, **lif_kw)),
              f"lif_scan with {label} differs from the earlier kernel on "
              f"currents + bias")
        check(torch.equal(lif_scan(cur.contiguous(), **lif_kw), want),
              f"lif_scan without a bias is not bit-exact ({label})")
        if b is bias:
            s_k = got
    def parent():
        cur = (y + bias).reshape(T, -1)
        return old(cur, **lif_kw) if old else lif_scan(cur, **lif_kw)
    (k_ops, _), (p_ops, _) = ops_a_call(
        lambda: lif_scan(flat, bias=bias, **lif_kw)), ops_a_call(parent)
    ops = {"device_ops": k_ops, "parent_device_ops": p_ops}
    check(k_ops == 1, f"lif_scan with a bias: device ops a "
          f"call {ops}, want 1")
    n = flat.numel()
    st.add(tuple(flat.shape), time_ms(lambda: lif_scan(flat, bias=bias,
                                                       **lif_kw)),
           time_ms(lambda: lif_plain(y + bias, **lif_kw)),
           (2 * n + C) * 4, 9 * n, 0.0,
           extra={"parent_ms": time_ms(parent),
                  "earlier_kernel_ms": ms_or_none(old and (
                      lambda: old(flat, **lif_kw))),
                  "no_bias_ms": time_ms(lambda: lif_scan(flat, **lif_kw)),
                  **ops})
    print(f"  lif_scan [T,N]={tuple(flat.shape)} + bias [{C}]: spikes "
          f"{float(s_k.mean()):.3f}, bit-exact to the plain scan of "
          f"currents + bias (the layer's and a random bias)"
          + (", and to the earlier kernel" if old else
             "; the earlier design not built") + f"; {ops}")
    return s_k


def segment_check(bb, cfg, seg, x, st, lif_kw, rings=False):
    """One fused-route segment on the layer walk's own input x: the
    backbone_segment kernel under both gates at every cluster size a
    launch table may choose (``plan_clusters``), bit-equal to the
    per-layer kernel route, also with half the batch silent, and to the
    PR 17 design (where build/earlier holds its source); each layer of
    the route held to the plain layer on the route's own input by the
    near-threshold rule; then timed beside the PR 17 design, its plain
    version and the per-layer route.  ``rings``: also time every (row
    tile cap, ring depth) that fits at each cluster size."""
    import torch
    from repro_torch.core.layers import (NORM_EPS, _patch_slices, fold,
                                         instance_norm_affine)
    from repro_torch.kernels import ops, tune
    from repro_torch.kernels.backbone_fuse import (segment_edge_elems,
                                                   segment_macs)
    from repro_torch.kernels import backbone_segment as BS
    from repro_torch.kernels.backbone_segment import (
        GATES, OCCUPANCIES, backbone_segment, backbone_segment_plain,
        plan_clusters, segment_layer_plain, segment_operands, segment_plan)
    from repro_torch.testing import spike_mismatch
    specs = tuple(s.anon() for s in seg.layers)
    params = tuple((bb[s.name]["w"], bb[s.name]["scale"], bb[s.name]["bias"])
                   for s in seg.layers)
    flat = segment_operands(params, specs)
    check(all(f.data_ptr() == p[0].data_ptr()
              for f, p in zip(flat[::3], params)),
          f"{seg.describe()}: segment_operands copied a weight")
    T, B, H, W, _ = x.shape
    plan = segment_plan(specs, T, B, H, W)
    clusters = plan_clusters(specs, T, B, H, W)
    silent = x.clone()
    silent[:, : B // 2] = 0
    check(bool((silent != 0).any()), f"{seg.describe()}: the partly silent "
          f"input has no spike")
    earlier = earlier_segment()
    old_flat = earlier.operands(params, specs) if earlier else None

    def route(inp):
        with tune.off():
            return ops._seg_unfused(inp, params, specs, lif_kw)

    runs = 0
    for label, inp in (("walk", x), ("partly silent", silent)):
        want = route(inp)
        for gate in GATES:
            for cs in clusters:
                got = backbone_segment(inp, flat, specs=specs, gate=gate,
                                       cluster=cs, **lif_kw)
                torch.cuda.synchronize()
                check(torch.equal(got, want), f"backbone_segment "
                      f"{seg.describe()} ({label}, gate {gate}, cluster "
                      f"{cs}): {int((got != want).sum())} spikes differ from "
                      f"the per-layer kernel route")
                runs += 1
            if earlier:
                old = earlier(inp, params, specs, gate, 8, lif_kw, old_flat)
                torch.cuda.synchronize()
                check(torch.equal(old, want), f"backbone_segment "
                      f"{seg.describe()} ({label}, gate {gate}): the PR 17 "
                      f"design differs from the per-layer kernel route")
    # each layer of the route on its own input against the plain layer;
    # the live MACs of this input (zero activations skipped) for the bound
    cur, near, flips, live_macs = x, [], [], 0
    with tune.off():
        for i, (p, s) in enumerate(zip(params, specs)):
            s0 = dataclasses.replace(s, pool=0)
            pre = ops._seg_unfused(cur, (p,), (s0,), lif_kw)
            y4, _ = segment_layer_plain(cur.contiguous(), flat[3 * i], s0)
            z = instance_norm_affine(y4, p[1], p[2])
            res = spike_mismatch(z, pre.reshape(z.shape), tol=NEAR_TOL,
                                 **lif_kw)
            check(res["far"] == 0, f"{seg.describe()} layer {i}: "
                  f"{res['far']} spikes differ from the plain layer away "
                  f"from threshold")
            near.append(res["near"])
            flips.append(res["flipped"])
            taps, _ = _patch_slices(fold(cur), s.kernel, s.kernel, s.stride)
            nz = sum(int((t != 0).sum()) for t in taps)
            live_macs += nz if s.depthwise else nz * s.cout
            cur = ops._seg_unfused(cur, (p,), (s,), lif_kw)
    kernel = backbone_segment(x, flat, specs=specs, **lif_kw)
    plain = backbone_segment_plain(x, flat, specs=specs, **lif_kw)
    torch.cuda.synchronize()
    err = float((kernel - plain).abs().max())
    differ = int((kernel != plain).sum())
    kw = dict(H=H, W=W, T=T, B=B)
    ms = time_ms(lambda: backbone_segment(x, flat, specs=specs, **lif_kw))
    ms_c = {f"{g}/{cs}": time_ms(lambda g=g, cs=cs: backbone_segment(
        x, flat, specs=specs, gate=g, cluster=cs, **lif_kw))
        for g in GATES for cs in clusters}
    plain_ms = time_ms(lambda: backbone_segment_plain(x, flat, specs=specs,
                                                      **lif_kw))
    route_ms = time_ms(lambda: route(x))
    old_ms = time_ms(lambda: earlier(x, params, specs, "inline", 8, lif_kw,
                                     old_flat)) if earlier else None
    # the other plans at each cluster: blocks an SM, row tile cap, ring
    ring_ms, seen = {}, {plan}
    shapes = BS._segment_shapes(specs, T, H, W)
    want = route(x)
    for cs, occ, ring in ((c, o, r) for c in clusters for o in OCCUPANCIES
                          for r in BS._RINGS) if rings else ():
        q = BS._fit(specs, shapes, T, B, cs, occ, (ring,))
        if q is None or q in seen:
            continue
        seen.add(q)

        def run(q=q):
            return BS.segment_launch(x, flat, q, gate="inline",
                                     eps=NORM_EPS, **lif_kw)
        check(torch.equal(run(), want), f"backbone_segment "
              f"{seg.describe()} under {q.describe()}: differs from the "
              f"per-layer kernel route")
        ring_ms[f"{cs}/{occ}/{ring[0]}/{ring[1]}"] = time_ms(run)
    nbytes = 4 * segment_edge_elems(specs, **kw)
    bound = max(nbytes / HBM_BYTES_PER_S, 2.0 * live_macs / FP32_FLOPS) * 1e3
    st["backbone_segment"].add(
        (seg.describe(),) + tuple(x.shape), ms, plain_ms, nbytes,
        2.0 * live_macs, err, per_op_ms=route_ms,
        extra={"earlier_design_ms": old_ms})
    print(f"  backbone_segment {seg.describe()} in {tuple(x.shape)} -> "
          f"{tuple(kernel.shape)}: plan {plan.describe()}; bit-equal to the "
          f"per-layer kernel route in {runs} input/gate/cluster runs"
          f"{' and the PR 17 design too' if earlier else ''}; "
          f"layer-by-layer vs plain flips {flips}, near-threshold band "
          f"{near}; whole-chain plain differs at {differ} of "
          f"{kernel.numel()}; MACs dense {segment_macs(specs, **kw)} live "
          f"{live_macs}; ms kernel {ms:.5f}, by gate/cluster {ms_c}, PR 17 "
          f"design " + (f"{old_ms:.5f}" if earlier else "not built")
          + f", plain {plain_ms:.4f}, per-layer route {route_ms:.5f}, "
          f"bound {bound:.5f}"
          + (f"; by cluster/blocks an SM/row tile cap/ring {ring_ms}"
             if rings else ""))


def segment_phase(params_by_arch, vox):
    """Every fused-route segment of the four backbones alone, on the
    input the per-layer kernel route gives it from the tick's voxels:
    ``segment_check`` with every (cluster, row tile, ring) plan timed.
    Returns per arch the segment kernel's numbers."""
    import torch
    from repro_torch.core.backbones import fused_route_segments
    from repro_torch.kernels import ops, tune
    from repro_torch.kernels.backbone_fuse import LayerSpec
    out = {}
    for arch, (params, cfg) in params_by_arch.items():
        lif_kw = dict(tau=cfg.tau_mem, v_th=cfg.v_threshold,
                      v_reset=cfg.v_reset)
        starts = {seg.layers[0].name: seg
                  for seg, _, _ in fused_route_segments(cfg, BATCH)}
        st = {"backbone_segment": KernelStats()}
        bb = params["backbone"]

        def conv(name, p, x, stride, depthwise):
            if name in starts:
                segment_check(bb, cfg, starts.pop(name), x.contiguous(), st,
                              lif_kw, rings=True)
            w = p["w"]
            spec = LayerSpec("", kernel=w.shape[0], stride=stride,
                             depthwise=depthwise, cin=x.shape[-1],
                             cout=w.shape[-1])
            with tune.off():
                return ops._seg_unfused(x, ((w, p["scale"], p["bias"]),),
                                        (spec,), lif_kw)

        def pool(name, x, window):
            return ops.max_pool_op(x, window=window)
        print(f"  --- {arch}: fused-route segments alone")
        backbone_walk(cfg, bb, vox, conv, pool,
                      lambda feats: torch.cat(feats, dim=-1))
        check(not starts, f"{arch}: segments {list(starts)} never reached")
        out[arch] = st["backbone_segment"].summary()
    return out


def fire(p, y5, name, st, lif_kw):
    """norm_affine_lif on a conv output: bit-equal to the replay of its
    statistics contract (and to the earlier design where its source is
    copied), held to its plain version by the near-threshold rule; then
    timed beside the plain version and the earlier design."""
    import torch
    from repro_torch.core.layers import instance_norm_affine
    from repro_torch.kernels.lif_scan import norm_affine_lif as kernel
    from repro_torch.kernels.lif_scan import norm_affine_lif_plain as plain
    from repro_torch.kernels.lif_scan import norm_lif_plan
    from repro_torch.testing import norm_affine_lif_contract, spike_mismatch
    T, B, Ho, Wo, C = y5.shape
    y4 = y5.reshape(T, B, Ho * Wo, C).contiguous()
    sc, bi = p["scale"], p["bias"]
    s_k = kernel(y4, sc, bi, **lif_kw)
    z = instance_norm_affine(y4, sc, bi)
    s_p = plain(y4, sc, bi, **lif_kw)
    earlier = earlier_norm()
    old = earlier(y4, sc, bi, lif_kw) if earlier else None
    torch.cuda.synchronize()
    check(torch.equal(s_k.cpu(), norm_affine_lif_contract(y4, sc, bi,
                                                          **lif_kw)),
          f"norm_affine_lif {name}: the kernel's spikes differ from the "
          f"replay of its statistics contract")
    check(old is None or torch.equal(s_k, old), f"norm_affine_lif {name}: "
          f"the kernel's spikes differ from the earlier design's")
    res = spike_mismatch(z, s_k, tol=NEAR_TOL, **lif_kw)
    check(res["far"] == 0, f"norm_affine_lif {name}: {res['far']} spikes "
          f"differ away from threshold")
    n = y4.numel()
    ms = time_ms(lambda: kernel(y4, sc, bi, **lif_kw))
    old_ms = time_ms(lambda: earlier(y4, sc, bi, lif_kw)) if earlier \
        else None
    st["norm_affine_lif"].add(
        (T, B, Ho * Wo, C), ms, time_ms(lambda: plain(y4, sc, bi, **lif_kw)),
        2 * n * 4 + 2 * C * 4, 14 * n, (s_k - s_p).abs().max(),
        extra={"earlier_design_ms": old_ms})
    pl = norm_lif_plan(T, B, Ho * Wo, C)
    print(f"  norm_affine_lif {name:9s} [T,B,HW,C]={(T, B, Ho * Wo, C)} "
          f"rate {float(s_k.mean()):.3f} flipped {res['flipped']} "
          f"(near threshold {res['near']}); bit-equal to the contract "
          f"replay{' and the earlier design' if earlier else ''}; plan "
          f"cluster {pl.cluster} x tile {pl.ct} ({pl.blocks} blocks, "
          f"{pl.smem_bytes} B shared, staged {pl.staged}); ms {ms:.5f}, "
          f"earlier design " + (f"{old_ms:.5f}" if earlier else "not built"))
    return s_k.reshape(T, B, Ho, Wo, C)


def fused_check(p, last, s_pair, name, st, lif_kw):
    """spike_conv_lif on the layer's own folded spikes, under every gate,
    and again with the first half of the batch silent: equal to the
    per-op kernel pair (s_pair: spike_conv, then norm_affine_lif) and
    held to its plain version by the near-threshold rule; then timed
    (gate "mask") beside its plain version, the per-op pair and the PR
    16 design (where build/earlier holds its source)."""
    import torch
    from repro_torch.core.layers import instance_norm_affine
    from repro_torch.core.layers import spike_im2col
    from repro_torch.kernels.lif_scan import norm_affine_lif
    from repro_torch.kernels.spike_conv import spike_conv
    from repro_torch.kernels.spike_conv_lif import (GATES, conv_lif_plan,
                                                    spike_conv_lif,
                                                    spike_conv_lif_plain)
    from repro_torch.testing import slab_occupancy_mask, spike_mismatch
    patches, wmat, y = last["patches"], last["wmat"], last["y"]
    xf, w, stride = last["xf"], last["w"], last["stride"]
    T, B, Ho, Wo, N = s_pair.shape
    HW, (M, K) = Ho * Wo, patches.shape
    sc, bi = p["scale"], p["bias"]
    kw = dict(T=T, B=B, stride=stride, **lif_kw)
    plan = conv_lif_plan(T, B, HW, N, K)

    def pair(x):
        """The per-op kernel pair on folded spikes x: (spikes, currents)."""
        y4 = spike_conv(x, w, stride=stride).reshape(
            B, T, HW, N).transpose(0, 1).contiguous()
        return norm_affine_lif(y4, sc, bi, **lif_kw), \
            instance_norm_affine(y4, sc, bi)

    # the first half of the batch silent (batch-major fold: the first
    # M // 2 patch rows)
    silent_x = xf.clone()
    silent_x[: xf.shape[0] // 2] = 0
    silent = spike_im2col(silent_x, w.shape[0], w.shape[1], stride)[0]
    occ_s = slab_occupancy_mask(silent.reshape(B, T * HW, K))
    check(int((occ_s == 0).sum()) > 0, f"spike_conv_lif {name}: no silent "
          f"tile in the partly silent check")
    y4 = y.reshape(B, T, HW, N).transpose(0, 1).contiguous()
    runs = {"main path": (xf, s_pair.reshape(T, B, HW, N),
                          instance_norm_affine(y4, sc, bi)),
            "partly silent": (silent_x, *pair(silent_x))}
    flips, band, err = {}, {}, 0.0
    for label, (x, s_ref, z) in runs.items():
        plain = spike_conv_lif_plain(x, w, sc, bi, **kw)
        res_p = spike_mismatch(z, plain, tol=NEAR_TOL, **lif_kw)
        check(res_p["far"] == 0, f"spike_conv_lif {name} ({label}): its "
              f"plain version differs away from threshold: {res_p}")
        for gate in GATES:
            got = spike_conv_lif(x, w, sc, bi, gate=gate, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, s_ref), f"spike_conv_lif {name} "
                  f"({label}, gate {gate}): {int((got != s_ref).sum())} "
                  f"spikes differ from the per-op kernel pair's")
            flips[label] = int((plain != s_ref).any(dim=0).sum())
            band[label] = spike_mismatch(z, got, tol=NEAR_TOL,
                                         **lif_kw)["near"]
            err = max(err, float((got - plain).abs().max()))
    occ = slab_occupancy_mask(patches.reshape(B, T * HW, K))
    live = sum(live_tile_elems(occ[b], T * HW, K) for b in range(B))
    ms = time_ms(lambda: spike_conv_lif(xf, w, sc, bi, **kw))
    plain_ms = time_ms(lambda: spike_conv_lif_plain(xf, w, sc, bi, **kw))
    pair_ms = time_ms(lambda: norm_affine_lif(
        spike_conv(xf, w, stride=stride).reshape(B, T, HW, N)
        .transpose(0, 1).contiguous(), sc, bi, **lif_kw))
    earlier = earlier_conv_lif()
    old_ms, old_equal = None, None
    if earlier:
        def old():
            return earlier(patches, wmat, occ, sc, bi, T, B, HW, lif_kw)
        old_equal = bool(torch.equal(old(), runs["main path"][1]))
        old_ms = time_ms(old)
    st["spike_conv_lif"].add(
        (T, B, HW, K, N, plan.ct, plan.cluster), ms, plain_ms,
        (xf.numel() + K * N + M * N + 2 * N) * 4, 2.0 * N * live, err,
        per_op_ms=pair_ms, extra={"earlier_design_ms": old_ms})
    print(f"  spike_conv_lif {name:9s} [T,B,HW,K,N]={(T, B, HW, K, N)} plan "
          f"tile {plan.ct} cluster {plan.cluster} bm {plan.bm} stages "
          f"{plan.stages} ({plan.blocks} blocks, {plan.smem_bytes} B "
          f"shared): equal to the per-op pair under "
          f"{'/'.join(GATES)}, also partly silent; plain flips {flips}; "
          f"near-threshold band {band}; ms kernel {ms:.5f} plain "
          f"{plain_ms:.4f} per-op pair {pair_ms:.5f} earlier design "
          + (f"{old_ms:.5f} (equal to the pair: {old_equal})" if earlier
             else "not built"))


def event_windows(reqs, dev):
    """The raw event buffers of the request set, fitted to the FIFO as
    the engine stages them: an EventStream of [8, EVENT_CAPACITY]."""
    import torch
    from repro_torch.core.encoding import EventStream, as_stream, fit_stream
    ev = [fit_stream(as_stream(r.events), EVENT_CAPACITY)
          for r in reqs if r.events is not None]
    return EventStream(*(torch.stack(ls).to(dev) for ls in zip(*ev)))


def nlm_ops(B, H, W, C):
    """fp32 operations of NLM: per pixel the luminance and the final
    divide (2C), and per shift a difference, a square, four box adds, a
    scale, a negation, a divide, an exp, the weight sum and 2C
    weighted-sum ops."""
    return B * H * W * (2 * C + 49 * (11 + 2 * C))


def segment_work(ex, x, out):
    """(bytes, fp32 operations) a fused segment must move and do: its
    input read once, its output written once, and each op of its chain
    and window once per pixel."""
    B, H, W = x.shape[:3]
    ops = 0
    for step in ex.chain + ((ex.wstep,) if ex.wstep is not None else ()):
        if step.op == "nlm":
            ops += nlm_ops(1, 1, 1, out.shape[3] if out.dim() == 4 else 1)
        else:
            ops += SEGMENT_OPS[step.op]
    return (x.numel() + out.numel()) * 4, ops * B * H * W


def fused_orderings():
    """name -> the ISP config of each fused ordering checked."""
    import dataclasses as dc
    from repro_torch.configs.registry import ISP_CONFIGS
    return {n: (ISP_CONFIGS[n] if ISP_CONFIGS[n].backend == "cuda_fused"
                else dc.replace(ISP_CONFIGS[n], name=n + "_fused",
                                backend="cuda_fused"))
            for n in FUSED_ORDERINGS}


def fused_isp_check(x, ctrls, label, st=None, seg_rows=None,
                    profile=False):
    """Each fused ordering on frames x [B, H, W] with control vectors
    ctrls[name] [B, dim]: every segment's kernel against its plain
    version on the same inputs (and a stencil segment's against the
    earlier design's bits, where build/earlier holds its source), and
    the whole fused output against the per-stage "torch" path.  With
    ``st``, the default ordering's stencil segments and fast_preview's
    pointwise one are timed into it; with ``seg_rows``, every stencil
    segment of every ordering gets a row: the kernel's ms, the earlier
    design's, the plain version's, the bound and the stencil plan (with
    ``profile``, also the wrapper's device ops by name under
    torch.profiler: the kernel and the gamma LUT's torch ops).  Returns
    the printed max |err| per segment."""
    import torch
    from repro_torch.isp.fuse import compile_plan, segment_call
    from repro_torch.isp.stages import control_to_stage_params, run_stages
    from repro_torch.kernels.isp_fused import stencil_plan
    earlier = earlier_stencil()
    earlier_pw = earlier_pointwise()
    errs = {}
    for name, icfg in fused_orderings().items():
        sp = control_to_stage_params(ctrls[name], icfg.stages)
        y = x
        for ex in compile_plan(icfg.stages):
            check(ex.launches_kernel, f"{name}: segment "
                  f"{ex.segment.describe()} launches no kernel")
            kernel, plain, args, kw = segment_call(ex, y, sp)
            got, want = kernel(*args, **kw), plain(*args, **kw)
            stencil = ex.segment.stencil is not None
            old = (earlier(*args, **kw) if earlier and stencil else
                   earlier_pw.parent(*args, **kw) if earlier_pw
                   and not stencil
                   else None)
            torch.cuda.synchronize()
            seg = ex.segment.describe()
            err = float((got - want).abs().max())
            if seg in EXACT_SEGMENTS:
                check(torch.equal(got, want), f"{label} {name} {seg}: not "
                      f"bit-exact (max|err| {err:.3g})")
            check(err <= NLM_TOL, f"{label} {name} {seg}: max|err| "
                  f"{err:.3g} > {NLM_TOL}")
            check(old is None or torch.equal(got, old), f"{label} {name} "
                  f"{seg}: the kernel's bits differ from the earlier "
                  f"design's")
            errs[f"{name} {seg}"] = err
            timed = ((name == "fused" and stencil)
                     or (name == "fast_preview" and not stencil))
            ms = plain_ms = None
            if (st is not None and timed) or (seg_rows is not None
                                              and stencil):
                ms = time_ms(lambda: kernel(*args, **kw))
                plain_ms = time_ms(lambda: plain(*args, **kw))
                nbytes, nops = segment_work(ex, y, got)
            if st is not None and timed:
                k = "isp_stencil_segment" if stencil else \
                    "isp_pointwise_segment"
                st[k].add((seg,) + tuple(y.shape), ms, plain_ms, nbytes,
                          nops, err)
            if seg_rows is not None and stencil:
                one = KernelStats()
                one.add(tuple(y.shape), ms, plain_ms, nbytes, nops, err)
                B, H, W = y.shape[:3]
                pl = stencil_plan(ex.wstep.op, B, H, W,
                                  y.shape[3] if y.dim() == 4 else 1)
                seg_rows[f"{name} {seg}"] = {
                    "ms": ms,
                    "earlier_design_ms": time_ms(
                        lambda: earlier(*args, **kw)) if earlier else None,
                    "plain_ms": plain_ms, "bound_ms": one.bound_ms,
                    "bound_by": one.row("isp_stencil_segment",
                                        1)["bound_by"],
                    "max_abs_err": err, "tile": [pl.th, pl.tw],
                    "threads": pl.threads, "blocks": pl.blocks,
                    "smem": pl.smem}
                if profile:
                    _, busy, n_ops, by_name = profile_window(
                        lambda: kernel(*args, **kw), 20)
                    seg_rows[f"{name} {seg}"]["profile"] = {
                        "device_ms": busy, "device_ops": n_ops,
                        "by_name": {k[:60]: v for k, v in by_name.items()}}
            y = want.contiguous()
        whole = run_stages(x, sp, icfg.stages, backend="cuda_fused")
        ref = run_stages(x, sp, icfg.stages, backend="torch")
        torch.cuda.synchronize()
        err = float((whole - ref).abs().max())
        check(err <= NLM_TOL, f"{label} {name}: fused vs per-stage max|err| "
              f"{err:.3g} > {NLM_TOL}")
        errs[f"{name} whole vs per-stage"] = err
    print(f"  fused ISP {label} max|err|"
          + (" (bit-equal to the earlier designs)" if earlier else "") + ": "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def random_isp_inputs(shape, dev, g):
    """Frames in [0, 1) of ``shape`` and, per fused ordering, control
    vectors in [0, 1)."""
    import torch
    raw = torch.rand(shape, device=dev, generator=g)
    return raw, {name: torch.rand((shape[0], icfg.control_dim), device=dev,
                                  generator=g)
                 for name, icfg in fused_orderings().items()}


def isp_segment_line(x, ctrls, label, card, st=None, profile=False):
    """fused_isp_check with every stencil segment's row, printed as one
    line and returned."""
    rows = {}
    fused_isp_check(x, ctrls, label, st, seg_rows=rows, profile=profile)
    print("  isp_segments " + json.dumps({"shape": list(x.shape),
                                          "card": card, **rows}))
    return rows


def tick_pointwise_call(x, ctrl):
    """(kernel, plain, args, kw) of fast_preview's pointwise segment
    ([awb*+gamma]) on frames x with control ctrl, its input the plain
    output of the stencil segments before it."""
    from repro_torch.isp.fuse import compile_plan, segment_call
    from repro_torch.isp.stages import control_to_stage_params
    icfg = fused_orderings()["fast_preview"]
    sp = control_to_stage_params(ctrl, icfg.stages)
    y = x
    for ex in compile_plan(icfg.stages):
        call = segment_call(ex, y, sp)
        if ex.segment.stencil is None:
            return call
        kernel, plain, args, kw = call
        y = plain(*args, **kw).contiguous()
    raise ValueError("fast_preview has no pointwise segment")


def fused_isp_phase(params, cfg, reqs, dev, card, rows):
    """The fused ISP backend on the tick's own frames and control (the
    kernel NPU's on the event windows; an ordering wider than the NPU's
    head draws the rest in [0, 1)), every stencil segment timed beside
    the earlier design; row 12 on fast_preview's [awb*+gamma] at the
    tick beside the PR 13 design and the parent's path, added to
    ``rows`` (rows 3, 9, 10 and 11 from tick_kernel_phase) and printed as
    the "tick_rows" line; parity on ragged frames; then fast_preview
    fused through the pipeline entry point with its launches counted."""
    import torch
    from repro_torch.core.encoding import voxel_batch
    from repro_torch.core.npu import npu_forward
    from repro_torch.isp.pipeline import control_vector_pipeline_batch
    from repro_torch.kernels import build
    st = {k: KernelStats() for k in FUSED_KERNELS}
    vox = voxel_batch(event_windows(reqs, dev), backend="cuda",
                      time_steps=cfg.time_steps, height=cfg.height,
                      width=cfg.width).contiguous()
    ctrl = npu_forward(params, vox, cfg).control
    x = torch.stack([torch.as_tensor(r.bayer) for r in reqs
                     if r.events is not None]).to(dev)
    g = torch.Generator(dev).manual_seed(3)
    ctrls = {}
    for name, icfg in fused_orderings().items():
        extra = max(icfg.control_dim - ctrl.shape[1], 0)
        ctrls[name] = torch.cat([ctrl, torch.rand(
            (ctrl.shape[0], extra), device=dev, generator=g)],
            dim=1)[:, :icfg.control_dim].contiguous()
    isp_segment_line(x, ctrls, "tick [8, 64, 64]", card, st)
    rows["isp_pointwise_segment"] = pointwise_row(
        tick_pointwise_call(x, ctrls["fast_preview"]), "[awb*+gamma]")
    print("  tick_rows " + json.dumps(rows))
    # frames that are no whole number of tiles: parity only
    fused_isp_check(*random_isp_inputs(RAGGED, dev, g), str(list(RAGGED)))

    # the pointwise kernel's main path: fast_preview fused, entry point
    icfg = fused_orderings()["fast_preview"]
    build.reset_launches()
    rgb = control_vector_pipeline_batch(x, ctrls["fast_preview"], icfg)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    want = {"isp_stencil_segment": 2, "isp_pointwise_segment": 1}
    check(counts == want, f"fast_preview fused: launches {counts}, want "
          f"{want}")
    check(bool(torch.isfinite(rgb).all()) and rgb.shape == x.shape + (3,),
          "fast_preview fused: bad rgb")
    print(f"  fast_preview fused through control_vector_pipeline_batch: "
          f"launches {counts}")
    return st, counts


def isp_pool_phase(archs, dev, card):
    """Rows 8, 12 and 13 alone: every stencil segment of the fused
    orderings on random frames and controls at [8, 64, 64], RAGGED and
    VGA, beside the earlier design (isp_segment_line); the pointwise
    segment's cases and shapes (pointwise_shapes_line); every max_pool
    of VGG and DenseNet on numpy-seeded spikes (POOL_DENSITY) in [T, B]
    order, beside the parent's path (pool_check).  Returns the rows per
    shape and the pool's sums per arch."""
    import numpy as np
    import torch
    g = torch.Generator(dev).manual_seed(5)
    out = {"card": card, "isp": {}, "max_pool": {}}
    for shape in ((BATCH, 64, 64), RAGGED, VGA):
        out["isp"][str(list(shape))] = isp_segment_line(
            *random_isp_inputs(shape, dev, g), str(list(shape)), card,
            profile=shape != RAGGED)
    out["pointwise"] = pointwise_shapes_line(dev, card)
    rng = np.random.default_rng(0)
    for arch in ("spiking_vgg", "spiking_densenet"):
        params, cfg = archs[arch]
        st = KernelStats()
        print(f"  --- {arch}: every max_pool on seeded spikes")
        for name, shape, window in pool_shapes(params, cfg, BATCH):
            x = torch.tensor((rng.random(shape) < POOL_DENSITY)
                             .astype(np.float32), device=dev)
            pool_check(name, x, window, st)
        out["max_pool"][arch] = st.summary()
    return out


def pointwise_call(label, shape, dev, g):
    """(kernel, plain, args, kw) of row 12's case ``label``
    (POINTWISE_CASES) on frames of ``shape`` [B, H, W] (with its
    channels) in [0, 1) and control vectors in [0, 1)."""
    import torch
    from repro_torch.configs.base import ISPConfig
    from repro_torch.isp.fuse import compile_plan, segment_call
    from repro_torch.isp.stages import control_to_stage_params
    stages, C = POINTWISE_CASES[label]
    ex = next(e for e in compile_plan(stages)
              if e.segment.describe() == label)
    x = torch.rand(tuple(shape) + ((C,) if C == 3 else ()), device=dev,
                   generator=g)
    ctrl = torch.rand((shape[0], ISPConfig(stages=stages).control_dim),
                      device=dev, generator=g)
    return segment_call(ex, x, control_to_stage_params(ctrl, stages))


def pointwise_row(call, label):
    """Row 12 on one call (kernel, plain, args, kw): the kernel against
    its plain version (equal in POINTWISE_EXACT, else within NLM_TOL) and
    bit-equal to the PR 13 design (where build/earlier holds its source),
    one device op a call; its time beside the PR 13 kernel on a prebuilt
    LUT, the parent's path (the LUT by torch ops, then that kernel), the
    plain version and the bound (its bytes: x read, out written)."""
    import torch
    kernel, plain, args, kw = call
    x = args[0]
    old = earlier_pointwise()
    got, want = kernel(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    shape = list(x.shape)
    if label in POINTWISE_EXACT:
        check(torch.equal(got, want), f"pointwise {label} {shape}: not "
              f"bit-exact (max|err| {err:.3g})")
    check(err <= NLM_TOL, f"pointwise {label} {shape}: max|err| {err:.3g}")
    check(old is None or torch.equal(got, old.parent(*args, **kw)),
          f"pointwise {label} {shape}: not bit-equal to the PR 13 design")
    ops, windows = ops_a_call(lambda: kernel(*args, **kw))
    check(ops == 1, f"pointwise {label} {shape}: {ops} device ops a call "
          f"in {windows} profile windows")
    lut = old and old.lut_of(args[1], kw["chain"])
    nbytes = 2 * x.numel() * 4
    nops = x.numel() // (x.shape[3] if x.dim() == 4 else 1) * sum(
        SEGMENT_OPS[s.op] for s in kw["chain"])
    return {"shape": shape, "ms": time_ms(lambda: kernel(*args, **kw)),
            "earlier_kernel_ms": ms_or_none(old and (
                lambda: old.kernel(lut, *args, kw["chain"]))),
            "earlier_ms": ms_or_none(old and (
                lambda: old.parent(*args, **kw))),
            "plain_ms": time_ms(lambda: plain(*args, **kw)),
            "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                            nops / FP32_FLOPS) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= nops / FP32_FLOPS else "operations"),
            "device_ops": ops, "profile_windows": windows,
            "earlier_device_ops": old and ops_a_call(
                lambda: old.parent(*args, **kw))[0],
            "max_abs_err": err}


def pointwise_shapes_line(dev, card):
    """Row 12 at every case and shape (POINTWISE_CASES x
    POINTWISE_SHAPES; the no-gamma and Bayer chains at the tick, ragged
    and VGA shapes), printed as one "pointwise_rows" line."""
    import torch
    g = torch.Generator(dev).manual_seed(12)
    rows = {}
    for label in POINTWISE_CASES:
        shapes = POINTWISE_SHAPES if label == "[awb*+gamma]" else \
            ((BATCH, 64, 64), RAGGED, VGA)
        for shape in shapes:
            rows[f"{label} {list(shape)}"] = pointwise_row(
                pointwise_call(label, shape, dev, g), label)
    print("  pointwise_rows " + json.dumps({"card": card, **rows}))
    print(f"  pointwise_segment: bit-equal to its plain version "
          f"({', '.join(POINTWISE_EXACT)}; else within {NLM_TOL})"
          + (" and to the PR 13 design" if earlier_pointwise() else
             "; the PR 13 design not built")
          + f", one device op a call, at {len(rows)} cases x shapes")
    return rows


def demosaic_segment(raw):
    """The fused ISP's [demosaic] stencil segment (the default fused
    ordering's) on mosaics raw [B, H, W], as a function () -> rgb: one
    launch of the stencil kernel's demosaic instance."""
    import torch
    from repro_torch.isp.fuse import compile_plan, segment_call
    from repro_torch.isp.stages import control_to_stage_params
    icfg = fused_orderings()["fused"]
    ex = next(e for e in compile_plan(icfg.stages)
              if e.segment.describe() == "[demosaic]")
    sp = control_to_stage_params(
        torch.zeros((raw.shape[0], icfg.control_dim), device=raw.device),
        icfg.stages)
    kernel, _, args, kw = segment_call(ex, raw, sp)
    return lambda: kernel(*args, **kw)


def demosaic_check(raw, label, st=None):
    """demosaic on mosaics raw [B, H, W]: bit-equal to its plain version
    (demosaic_mhc), to the earlier design (where build/earlier holds its
    source) and to the fused [demosaic] stencil segment, one device op a
    call, timed beside them (and added to ``st``, where given).  Returns
    (rgb, its row)."""
    import torch
    from repro_torch.isp.demosaic import demosaic_mhc
    from repro_torch.kernels.demosaic import demosaic
    old = earlier_demosaic()
    seg = demosaic_segment(raw)
    got, want = demosaic(raw), demosaic_mhc(raw)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"demosaic {label}: not bit-exact")
    check(old is None or torch.equal(got, old(raw)),
          f"demosaic {label}: not bit-equal to the earlier design")
    check(torch.equal(got, seg()), f"demosaic {label}: not bit-equal to "
          f"the [demosaic] stencil segment")
    ops, windows = ops_a_call(lambda: demosaic(raw))
    check(ops == 1, f"demosaic {label}: {ops} device ops a call in "
          f"{windows} profile windows, want 1")
    B, H, W = raw.shape
    n = B * H * W
    row = {"shape": [B, H, W], "ms": time_ms(lambda: demosaic(raw)),
           "earlier_ms": ms_or_none(old and (lambda: old(raw))),
           "segment_ms": time_ms(seg),
           "plain_ms": time_ms(lambda: demosaic_mhc(raw)),
           "device_ops": ops, "profile_windows": windows}
    one = KernelStats()
    work = ((B, H, W), row["ms"], row["plain_ms"], n * 16,
            SEGMENT_OPS["demosaic"] * n, 0.0)
    one.add(*work)
    row["bound_ms"] = one.bound_ms
    if st is not None:
        st.add(*work)
    print(f"  demosaic {label} [B,H,W]=({B},{H},{W}): bit-exact, equal to "
          f"the [demosaic] segment"
          + (" and the earlier design" if old else
             "; the earlier design not built") + f", {ops} device op a call")
    return got, row


def tick_kernel_phase(params, cfg, reqs, dev, lif=None):
    """event_voxel (as the tick's encode, encode_batch: one launch),
    demosaic and nlm on the all-kernel tick's own inputs, each held to
    its plain version and timed; rows 9, 10 and 11 beside their earlier
    designs (with the parent's wrapper ops: its torch.where select, its
    torch-built luminance and bandwidth), with the device ops of a call,
    and row 3 (``lif``, the control head's firing from kernel_phase).
    Returns the stats and those rows (fused_isp_phase prints them with
    row 12 as the "tick_rows" line)."""
    import torch
    from repro_torch.configs.registry import ISP_CONFIGS
    from repro_torch.core.encoding import (OOB_POLICIES, VOXEL_MODES,
                                           encode_batch,
                                           events_to_voxel_batch,
                                           voxel_batch)
    from repro_torch.core.npu import npu_forward
    from repro_torch.isp.nlm import nlm_denoise
    from repro_torch.isp.stages import (control_to_stage_params, get_stage,
                                        resolve_stage_params)
    from repro_torch.kernels.event_voxel import event_voxel
    from repro_torch.kernels.nlm import nlm

    st = {k: KernelStats() for k in TICK_KERNELS}
    rows = {}
    evs = event_windows(reqs, dev)
    kw = dict(time_steps=cfg.time_steps, height=cfg.height, width=cfg.width)
    B, N = evs.t.shape
    # the staged voxel windows of the request set, [T, B] as the bank
    # holds them; the event tick takes every window from its events, a
    # mixed one half of them from the staged grid
    staged = torch.stack([torch.as_tensor(r.voxels) for r in reqs
                          if r.voxels is not None][:B], dim=1).to(dev)
    every = torch.ones(B, dtype=torch.bool, device=dev)
    mixed = torch.arange(B, device=dev) % 2 == 0
    old_ev = earlier_event_voxel()

    def parent_encode(e, fe, **k):
        """the parent's tick encode: its kernel, then the select"""
        return torch.where(fe[None, :, None, None, None],
                           old_ev(e, **k).transpose(0, 1), staged)

    def encode_cases(e, label):
        for mode in VOXEL_MODES:
            for oob in OOB_POLICIES:
                k = dict(kw, mode=mode, oob=oob)
                got = event_voxel(e, **k)
                want = events_to_voxel_batch(e, **k)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"event_voxel {mode}/{oob} is not bit-exact{label}")
                for fe in (every, mixed):
                    got = encode_batch(e, staged, fe, backend="cuda", **k)
                    want = encode_batch(e, staged, fe, backend="torch", **k)
                    torch.cuda.synchronize()
                    # the kernel writes the batch-major grid, so the
                    # first layer's fold of its [T, B] view is a view
                    check(torch.equal(got, want) and (
                        got.transpose(0, 1).is_contiguous()
                        or got.device.type == "cpu"),
                          f"encode_batch {mode}/{oob} is not its plain "
                          f"form{label}")
                    if old_ev is not None:
                        check(torch.equal(got, parent_encode(e, fe, **k)),
                              f"encode_batch {mode}/{oob} is not the "
                              f"parent's encode{label}")

    encode_cases(evs, "")
    grid = B * cfg.time_steps * cfg.height * cfg.width * 2
    live = int(evs.valid.sum())
    enc_ops, enc_windows = ops_a_call(
        lambda: encode_batch(evs, staged, every, backend="cuda", **kw))
    check(enc_ops == 1, f"encode_batch: {enc_ops} device ops a call, want 1")
    row9 = {"ms": time_ms(lambda: encode_batch(evs, staged, every,
                                               backend="cuda", **kw)),
            "event_voxel_ms": time_ms(lambda: event_voxel(evs, **kw)),
            "earlier_ms": ms_or_none(old_ev and (
                lambda: parent_encode(evs, every, **kw))),
            "earlier_kernel_ms": ms_or_none(old_ev and (
                lambda: old_ev(evs, **kw))),
            "plain_ms": time_ms(lambda: encode_batch(
                evs, staged, every, backend="torch", **kw)),
            "device_ops": enc_ops, "profile_windows": enc_windows,
            "earlier_device_ops": old_ev and ops_a_call(
                lambda: parent_encode(evs, every, **kw))[0]}
    st["event_voxel"].add(
        (B, N), row9["ms"], row9["plain_ms"], B * N * 17 + B + grid * 4,
        10 * B * N + grid, 0.0)
    row9["bound_ms"] = st["event_voxel"].bound_ms
    rows["event_voxel"] = row9
    print(f"  event_voxel [B,N]=({B},{N}) {live} live events: event_voxel "
          f"and encode_batch (every window from events, and half from the "
          f"staged grid) bit-exact in "
          f"{len(VOXEL_MODES) * len(OOB_POLICIES)} mode x oob cases"
          + ("" if old_ev else "; the earlier design not built"))
    # non-finite and huge timestamps: the kernel saturates as the plain
    # version does (NaN -> bin 0; +inf -> past the last bin; -inf -> before
    # the first), each of them on 4 events of every window
    t = evs.t.clone()
    for i, v in enumerate(NONFINITE_T):
        t[:, 4 * i:4 * i + 4] = v
    encode_cases(evs._replace(t=t, valid=torch.ones_like(evs.valid)),
                 " with non-finite timestamps")
    print(f"  event_voxel, encode_batch with timestamps {NONFINITE_T}: "
          f"bit-exact in every mode x oob case")

    # the ISP stage by stage, with the kernel NPU's control on these windows
    isp_cfg = ISP_CONFIGS["cuda"]
    vox = voxel_batch(evs, backend="cuda", **kw).contiguous()
    ctrl = npu_forward(params, vox, cfg).control[:, :isp_cfg.control_dim]
    sp = control_to_stage_params(ctrl, isp_cfg.stages)
    x = torch.stack([torch.as_tensor(r.bayer) for r in reqs
                     if r.events is not None]).to(dev)
    for name in isp_cfg.stages:
        p = resolve_stage_params(name, sp)
        if name == "demosaic":
            x, rows["demosaic"] = demosaic_check(x, "tick", st["demosaic"])
        elif name == "nlm":
            s = p["strength"]
            got, want = nlm(x, s), nlm_denoise(x, s)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(err <= NLM_TOL, f"nlm max|err| {err:.3g} > {NLM_TOL}")
            old = earlier_nlm()
            if old is not None:
                check(torch.equal(got, old(x, s)),
                      "nlm is not bit-equal to its earlier design")
            s0 = float(s[0])
            check(torch.equal(nlm(x, s0), nlm(x, torch.full_like(s, s0))),
                  "nlm: a scalar strength differs from a tensor of it")
            calls = {"tensor": ops_a_call(lambda: nlm(x, s)),
                     "scalar": ops_a_call(lambda: nlm(x, s0))}
            ops = {k: v[0] for k, v in calls.items()}
            check(ops == {"tensor": 1, "scalar": 1},
                  f"nlm: device ops a call {ops}, want 1")
            Bx, H, W, C = x.shape
            row11 = {"ms": time_ms(lambda: nlm(x, s)),
                     "earlier_ms": ms_or_none(old and (lambda: old(x, s))),
                     "plain_ms": time_ms(lambda: nlm_denoise(x, s)),
                     "device_ops": ops,
                     "profile_windows": {k: v[1] for k, v in calls.items()},
                     "earlier_device_ops": old and ops_a_call(
                         lambda: old(x, s))[0],
                     "max_abs_err": err}
            st["nlm"].add((Bx, H, W, C), row11["ms"], row11["plain_ms"],
                          2 * x.numel() * 4 + Bx * 4, nlm_ops(Bx, H, W, C),
                          err)
            row11["bound_ms"] = st["nlm"].bound_ms
            rows["nlm"] = row11
            print(f"  nlm [B,H,W,C]=({Bx},{H},{W},{C}) strengths "
                  f"{[round(float(v), 3) for v in s]} max|err| {err:.3g}"
                  + (", bit-equal to the earlier design" if old
                     else "; the earlier design not built"))
            x = got
        else:
            x = get_stage(name).impl_for("torch")(x, p)
    if lif is not None:
        rows["lif_scan"] = lif.summary()
    return st, rows


def large_isp_line(dev):
    """demosaic (beside its earlier design and the [demosaic] stencil
    segment, also on ragged frames, frames smaller than a tile and a VGA
    batch), nlm (beside its earlier design) and the fused segments on an
    [8, 512, 512] batch: printed lines."""
    import torch
    from repro_torch.isp.nlm import nlm_denoise
    from repro_torch.kernels.nlm import nlm
    g = torch.Generator(dev).manual_seed(2)
    raw = torch.rand((BATCH, LARGE_HW, LARGE_HW), device=dev, generator=g)
    strength = torch.rand((BATCH,), device=dev, generator=g)
    rgb, dem_row = demosaic_check(raw, "[8, 512, 512]")
    dem_rows = {str(list(shape)): demosaic_check(
        torch.rand(shape, device=dev, generator=g), str(list(shape)))[1]
        for shape in (RAGGED, TINY, VGA)}
    print("  demosaic_shapes " + json.dumps(dem_rows))
    got, want = nlm(rgb, strength), nlm_denoise(rgb, strength)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(err <= NLM_TOL, f"nlm max|err| {err:.3g} at 512x512")
    old = earlier_nlm()
    check(old is None or torch.equal(got, old(rgb, strength)),
          "nlm is not bit-equal to its earlier design at 512x512")
    n = BATCH * LARGE_HW * LARGE_HW
    row = {"shape": [BATCH, LARGE_HW, LARGE_HW],
           "demosaic": dem_row,
           "nlm": {"ms": time_ms(lambda: nlm(rgb, strength)),
                   "earlier_ms": ms_or_none(old and (
                       lambda: old(rgb, strength))),
                   "plain_ms": time_ms(lambda: nlm_denoise(rgb, strength)),
                   "bound_ms": max(nlm_ops(BATCH, LARGE_HW, LARGE_HW, 3)
                                   / FP32_FLOPS, n * 24 / HBM_BYTES_PER_S)
                   * 1e3, "max_abs_err": err}}
    print("  large " + json.dumps(row))

    # the fused segments at this size, control vectors in [0, 1)
    ctrls = {name: torch.rand((BATCH, icfg.control_dim), device=dev,
                              generator=g)
             for name, icfg in fused_orderings().items()}
    st = {k: KernelStats() for k in FUSED_KERNELS}
    fused_isp_check(raw, ctrls, "[8, 512, 512]", st)
    print("  large " + json.dumps({"shape": [BATCH, LARGE_HW, LARGE_HW], **{
        k: {"ms": s.ms, "plain_ms": s.plain_ms, "bound_ms": s.bound_ms,
            "launches": len(s.shapes), "max_abs_err": s.max_abs_err}
        for k, s in st.items()}}))


# ---------------------------------------------------------------------------
# phase 5: the launch table swept on the card, then the engines
# ---------------------------------------------------------------------------

def sweep_phase(all_archs, vox):
    """Per arch, one eager ``npu_forward`` at batch 8 on the request
    set's voxels under ``tune.tuning`` with the smoke sweep policy: each
    firing non-depthwise conv's shape and each fused-route backbone
    segment's is timed on its own inputs.  Prints every key with its
    winner, its µs and the default's, and the host cost of one eager
    launch (the roofline's LAUNCH_S).  Returns arch -> (swept table, the
    forced-fused table over its conv_lif keys, the forced-segment table
    over its backbone_seg keys)."""
    import torch
    from repro_torch.configs.registry import get_tune_config
    from repro_torch.core.backbones import fused_route_segments
    from repro_torch.core.npu import npu_forward
    from repro_torch.kernels import ops, tune
    from repro_torch.kernels.lif_scan import lif_scan
    tables = {}
    for arch, (p, c) in all_archs.items():
        with tune.tuning(tune.TuningTable(), get_tune_config("smoke")) as t:
            npu_forward(p, vox, c)
        torch.cuda.synchronize()
        keys = [tune.shape_key("conv_lif", **d)
                for d in conv_lif_dims(p, c, vox.shape[1])]
        seg_keys = [k for _, _, k in fused_route_segments(c, vox.shape[1])]
        check(set(t.entries) == set(keys) | set(seg_keys), f"{arch}: swept "
              f"keys {sorted(t.entries)} != the forward's "
              f"{sorted(set(keys) | set(seg_keys))}")
        fused = [k for k, e in t.entries.items() if e["fused"]]
        print(f"  {arch}: swept {len(keys)} conv_lif and {len(seg_keys)} "
              f"backbone_seg shapes; fused at {len(fused)}: {fused}")
        for k, e in t.entries.items():
            route = ("per-layer" if k in seg_keys else "per-op") \
                if not e["fused"] else "fused"
            print(f"    {k}: {route} gate {e['gate']} bm {e['bm']} bn "
                  f"{e['bn']}: {e['us']} us (default {e['default_us']} us)")
        tables[arch] = (t, ops.fused_conv_lif_table(keys),
                        ops.fused_segment_table(seg_keys))
    x = torch.ones((1, 32), device=vox.device)
    for _ in range(10):
        lif_scan(x)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        lif_scan(x)
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    print(f"  launch overhead: {host_us:.2f} us of host time per eager "
          f"lif_scan launch ({n} in a row)")
    return tables


def layer_walk(params, cfg, plain_cfg, vox):
    """Every layer of the kernel path on the kernel path's own input,
    held to the plain layer's currents on the same input (a pool to the
    plain pool, equal).  Returns the flipped and near-threshold neurons
    summed over the layers."""
    import torch
    from repro_torch.core import layers as L
    from repro_torch.testing import spike_mismatch

    totals = {"flipped": 0, "near": 0}

    def held(name, got, z):
        res = spike_mismatch(z, got, tol=NEAR_TOL, tau=cfg.tau_mem,
                             v_th=cfg.v_threshold, v_reset=cfg.v_reset)
        check(res["far"] == 0, f"layer {name}: {res['far']} spikes differ "
              f"away from threshold")
        print(f"  layer {name:11s} flipped {res['flipped']} "
              f"(near threshold {res['near']})")
        totals["flipped"] += res["flipped"]
        totals["near"] += res["near"]

    def conv(name, p, x, stride, depthwise):
        kw = dict(stride=stride, depthwise=depthwise)
        out = L.apply_spiking_conv(p, x, cfg, **kw)
        held(name, out, L.apply_spiking_conv(p, x, plain_cfg, fire=False,
                                             **kw))
        return out

    def pool(name, x, window):
        out = L.max_pool(x, window, cfg)
        check(torch.equal(out, L.max_pool(x, window, plain_cfg)),
              f"pool after {name} differs from the plain pool")
        return out

    x = backbone_walk(cfg, params["backbone"], vox, conv, pool,
                      lambda fs: torch.cat(fs, dim=-1))
    ph = params["head"]["conv"]
    h = L.apply_spiking_conv(ph, x, cfg)
    held("head_conv", h, L.apply_spiking_conv(ph, x, plain_cfg, fire=False))
    pred = L.apply_spiking_conv(params["head"]["pred"], h, cfg, fire=False)
    pred_p = L.apply_spiking_conv(params["head"]["pred"], h, plain_cfg,
                                  fire=False)
    check(torch.allclose(pred, pred_p, atol=1e-4, rtol=1e-5),
          "head readout disagrees with the plain layer")
    pooled = x.mean(dim=(2, 3))
    c = params["ctrl_hidden"]
    hc = L.apply_spiking_dense(c, pooled, cfg)
    held("ctrl_hidden", hc, L.apply_spiking_dense(c, pooled, plain_cfg,
                                                  fire=False))
    o = params["ctrl_out"]
    got = L.apply_spiking_dense(o, hc, cfg, fire=False, spike_input=True)
    want = L.apply_spiking_dense(o, hc, plain_cfg, fire=False)
    check(torch.allclose(got, want, atol=1e-4, rtol=1e-5),
          "ctrl_out disagrees with the plain layer")
    return totals


def check_results(done, cfg, isp_cfg):
    import numpy as np
    check(sorted(r.rid for r in done) == list(range(REQUESTS)),
          "not every request was answered")
    h = cfg.height // 2 ** cfg.num_stages
    for r in done:
        res = r.result
        check(res.rgb.shape == (cfg.height, cfg.width, 3), "rgb shape")
        check(res.control.shape == (cfg.control_dim,), "control shape")
        check(res.raw_pred.shape == (h, h, cfg.num_anchors,
                                     5 + cfg.num_classes), "raw_pred shape")
        for a in (res.rgb, res.control, res.raw_pred):
            check(np.isfinite(a).all(), f"non-finite output (rid {r.rid})")
        check(res.rgb.min() >= 0.0 and res.rgb.max() <= 1.0,
              "rgb outside [0, 1]")
        check(((res.control >= 0) & (res.control <= 1)).all(),
              "control outside [0, 1]")
        check(set(res.stage_params) == set(isp_cfg.stages), "stage params")


def max_diff(a, b, field):
    import numpy as np
    return max(float(np.abs(getattr(a[k], field) - getattr(b[k], field))
                     .max()) for k in a)


def serve_phase(params, cfg, reqs, dev, archs, tables):
    """The engines answer the same requests: spiking-YOLO's four, then an
    all-kernel and a plain engine per arch of ``archs`` (name -> (params,
    cfg)), and per arch (spiking-YOLO's engines named "all_kernels_*")
    an all-kernel engine built under its forced-fused table, one under
    its swept table and one under its forced-segment table (``tables``;
    every fused-route segment on backbone_segment).  Launch counts per
    engine, results
    checked and held to the plain engines, each layer held to its plain
    version; then the tick latency of every all-kernel engine and
    spiking-YOLO's others, in turns."""
    import torch
    from repro_torch.configs.registry import ENCODING_CONFIGS, ISP_CONFIGS
    from repro_torch.core.encoding import voxel_batch
    from repro_torch.kernels import build, tune
    from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                    PerceptionRequest)

    def clone(rs):
        return [PerceptionRequest(rid=r.rid, voxels=r.voxels, bayer=r.bayer,
                                  events=r.events) for r in rs]

    def plain(c):
        return dataclasses.replace(c, backend="torch")

    def all_kernels(p, c, isp="cuda"):
        return CognitiveEngine(p, c, isp_cfg=ISP_CONFIGS[isp],
                               enc_cfg=ENCODING_CONFIGS["cuda"], batch=BATCH,
                               device=dev)

    tick_kernels = dict(event_voxel=1, demosaic=1, nlm=1)
    npu = npu_launches_per_tick(cfg)
    # name -> (engine, its kernel launches per tick)
    engines = {
        "all_kernels": (all_kernels(params, cfg), dict(npu, **tick_kernels)),
        "fused_isp": (all_kernels(params, cfg, isp="fused"),
                      dict(npu, event_voxel=1, isp_stencil_segment=4)),
        "snn_kernels": (CognitiveEngine(params, cfg, batch=BATCH,
                                        device=dev), npu),
        "plain": (CognitiveEngine(params, plain(cfg), batch=BATCH,
                                  device=dev), {}),
    }
    for arch, (p, c) in archs.items():
        engines[arch] = (all_kernels(p, c),
                         dict(npu_launches_per_tick(c), **tick_kernels))
        engines[arch + "_plain"] = (
            CognitiveEngine(p, plain(c), batch=BATCH, device=dev), {})
    # the launch table's engines: each snapshots the table active at
    # construction
    tabled = []
    for arch, (p, c) in {"spiking_yolo": (params, cfg), **archs}.items():
        base = "all_kernels" if arch == "spiking_yolo" else arch
        swept, forced, segment = tables[arch]
        n_seg = len(fused_segments(c, BATCH, segment))
        check(n_seg == SEGMENTS_PER_TICK[arch], f"{arch}: the forced-segment "
              f"table routes {n_seg} segments, want "
              f"{SEGMENTS_PER_TICK[arch]}")
        for kind, table in (("fused", forced), ("swept", swept),
                            ("segment", segment)):
            with tune.pinned(table):
                eng = all_kernels(p, c)
            per_tick = npu_launches_per_tick(
                c, fused=fused_layers(p, c, BATCH, table),
                segments=fused_segments(c, BATCH, table))
            engines[f"{base}_{kind}"] = (eng, dict(per_tick, **tick_kernels))
            tabled.append(f"{base}_{kind}")
    for eng, _ in engines.values():
        eng.run_to_completion(clone(reqs[BATCH:]))        # warm-up

    results, launches = {}, {}
    for name, (eng, per_tick) in engines.items():
        ticks0 = eng.ticks
        build.reset_launches()                      # counts to 0 ...
        done = eng.run_to_completion(clone(reqs))
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)               # ... read just after
        ticks = eng.ticks - ticks0
        print(f"  {name}: served {len(done)} requests in {ticks} ticks; "
              f"launches {counts}")
        check_results(done, eng.cfg, eng.isp_cfg)
        want = {k: n * ticks for k, n in per_tick.items() if n}
        check({k: v for k, v in counts.items() if v} == want,
              f"{name}: launches {counts}, want {want} ({ticks} ticks)")
        results[name] = {r.rid: r.result for r in done}
        launches[name] = counts
    yolo_new = {(n, k): launches[n].get(k, 0) for n in
                ("all_kernels", "fused_isp", "snn_kernels", "plain")
                for k in ("spike_dwconv", "max_pool")}
    check(not any(yolo_new.values()), "a spiking-YOLO engine launched "
          f"spike_dwconv or max_pool: {yolo_new}")

    # each layer held to its plain version on the event-derived batch
    vox = voxel_batch(event_windows(reqs, dev), backend="cuda",
                      time_steps=cfg.time_steps, height=cfg.height,
                      width=cfg.width).contiguous()
    for arch, (p, c) in {"spiking_yolo": (params, cfg), **archs}.items():
        print(f"  {arch}: every layer on the kernel path's own input")
        layer_walk(p, c, plain(c), vox)

    # end to end against the plain engines
    plain_of = {"all_kernels": "plain", **{a: a + "_plain" for a in archs}}
    pairs = {"all_kernels": "plain", "fused_isp": "plain",
             "snn_kernels": "plain", **{a: a + "_plain" for a in archs},
             **{n: plain_of[n.rsplit("_", 1)[0]] for n in tabled}}
    for f in ("raw_pred", "control", "rgb"):
        d = {name: max_diff(results[name], results[ref], f)
             for name, ref in pairs.items()}
        print(f"  end-to-end max|kernel - plain| {f}: "
              + ", ".join(f"{k} {v:.3g}" for k, v in d.items()))
        for name in ("all_kernels", "fused_isp", *archs, *tabled):
            check(d[name] <= E2E_TOL, f"{name} {f} differs from plain by "
                  f"{d[name]:.3g}")

    # tick latency, the engines in turns on the same batches
    timed = ("all_kernels", "fused_isp", "snn_kernels", "plain", *archs,
             *tabled)
    lat = {name: [] for name in timed}
    order = [(name, engines[name][0]) for name in timed]
    for i in range(LATENCY_TICKS):
        batch = reqs[(i % 2) * BATCH:(i % 2 + 1) * BATCH]
        k = i % len(order)
        for name, e in order[k:] + order[:k]:
            for r in clone(batch):
                check(e.submit(r), "engine full")
            e.tick()
            lat[name].append(e.last_tick_s * 1e3)
    summary = {name: {"p50_ms": statistics.median(v),
                      "p90_ms": statistics.quantiles(v, n=10)[8],
                      "ticks": len(v)} for name, v in lat.items()}
    print(f"  tick latency (batch {BATCH}, {LATENCY_TICKS} ticks each, "
          f"host clock to results on the host): {summary}")

    # device ops a tick per engine (torch.profiler; printed, as
    # profile_tick reports them)
    def one_tick(e):
        for r in clone(reqs[:BATCH]):
            check(e.submit(r), "engine full")
        e.tick()
    ops = {name: profile_window(lambda e=engines[name][0]: one_tick(e),
                                5)[2] for name in timed}
    print(f"  device ops a tick (batch {BATCH}): {ops}")
    return launches, summary


def harvest_check(core, bank_a, bank_b):
    """Two ticks in flight on one stream: dispatch A, dispatch B, then a
    spin kernel of HARVEST_SLEEP_S and an event behind it.  fetch(A)
    waits on A's own copy event, so it returns while that event is still
    pending.  Returns (pending when fetch(A) returned, fetch(A)'s
    seconds, A's fetched outputs, B's)."""
    import torch
    a = core.dispatch(core.upload(bank_a))
    b = core.dispatch(core.upload(bank_b))
    torch.cuda._sleep(int(HARVEST_SLEEP_S * SPIN_CYCLES_PER_S))
    late = torch.cuda.Event()
    late.record()
    t0 = time.perf_counter()
    got_a = core.fetch(a)
    dt = time.perf_counter() - t0
    pending = not late.query()
    got_b = core.fetch(b)
    late.synchronize()
    return pending, dt, got_a, got_b


def bank_event_check(core, bank, req, enc_cfg):
    """The pinned-bank rule: a bank uploaded behind a spin kernel (its
    copy not run yet) is re-packed only once the copy's event completes,
    so the device copy holds what was staged before.  Returns (the copy
    pending after upload, its event complete once staging returned, the
    device copy equal to the bank as uploaded)."""
    import numpy as np
    import torch
    from repro_torch.serve.transport import stage_request, validate_request
    bank.wait_copied()
    torch.cuda._sleep(int(HARVEST_SLEEP_S * SPIN_CYCLES_PER_S))
    sub, = bank.shards                  # one device: one shard
    before = sub.buffer.numpy().copy()
    (voxels, *_), = core.upload(bank)
    ev = sub._copied
    pending = not ev.query()
    stage_request(bank, 0, req, validate_request(req, 2), enc_cfg)
    done = ev.query()
    torch.cuda.synchronize()
    copied = torch.empty(0, dtype=torch.uint8, device=voxels.device).set_(
        voxels.untyped_storage()).cpu().numpy()[:before.size]
    return pending, done, bool(np.array_equal(copied, before))


def fleet_requests(cfg):
    """FLEET_REQUESTS mixed requests: make_requests (8 voxel windows, 8
    raw event buffers) from seeds 10, 11, ..., rids 0..63."""
    import numpy as np
    out = []
    for k in range(FLEET_REQUESTS // REQUESTS):
        for r in make_requests(cfg, np.random.default_rng(10 + k)):
            r.rid += k * REQUESTS
            out.append(r)
    return out


def fleet_phase(params, cfg, dev, card, table):
    """The serving fleet (``repro_torch.serve.fleet.FleetEngine``) on
    full-width spiking-YOLO at batch 8 on one card (``mesh=None``: phase
    5d runs the sharded fleet) with the all-kernel configs
    (ENCODING_CONFIGS["cuda"], ISP_CONFIGS["cuda"]), rung 0 on the swept
    launch table ``table``: the one-tick-only harvest and the pinned-bank
    rule on rung 0's core; the ladder's two kernel rungs on one staged
    bank, bit-equal, and a core on the plain SNN layers (no rung on a
    card) within E2E_TOL of rung 0; each core's launches against
    npu_launches_per_tick, the plain core's the encode's and ISP's
    alone; a clean supervised
    run (SUPERVISOR_CONFIGS["supervisor"], prewarmed: the counts set to 0
    after the prewarm, read after the run) of FLEET_REQUESTS requests,
    every one DONE on "cuda_fused" within E2E_TOL of an all-kernel
    CognitiveEngine's result on the same table, its step latency and
    stats(); then a chaos run (FAULT_CONFIGS["chaos"] over CHAOS_TICKS,
    SUPERVISOR_CONFIGS["soak"], the plan's malformed submits included):
    no non-finite result delivered, every request terminal and delivered
    at most once, a demotion and a promotion in the telemetry.  Returns
    the report (printed as one "fleet" line)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import FleetConfig
    from repro_torch.configs.registry import (ENCODING_CONFIGS,
                                              FAULT_CONFIGS, ISP_CONFIGS,
                                              SUPERVISOR_CONFIGS)
    from repro_torch.kernels import build, tune
    from repro_torch.serve.cognitive_engine import (CognitiveEngine,
                                                    PerceptionRequest)
    from repro_torch.serve.engine_core import EngineCore
    from repro_torch.serve.faults import FaultPlan, make_malformed_request
    from repro_torch.serve.fleet import FleetEngine
    from repro_torch.serve.scheduler import RequestStatus
    from repro_torch.serve.transport import stage_request, validate_request

    def clone(r, rid=None):
        return PerceptionRequest(rid=r.rid if rid is None else rid,
                                 voxels=r.voxels, bayer=r.bayer,
                                 events=r.events)

    reqs = fleet_requests(cfg)
    kw = dict(isp_cfg=ISP_CONFIGS["cuda"], enc_cfg=ENCODING_CONFIGS["cuda"],
              device=dev)
    sup = dataclasses.replace(SUPERVISOR_CONFIGS["supervisor"], prewarm=True)
    with tune.pinned(table):
        fleet = FleetEngine(params, cfg, fleet_cfg=FleetConfig(batch=BATCH),
                            mesh=None, supervisor_cfg=sup, **kw)
        ref = CognitiveEngine(params, cfg, batch=BATCH, **kw)
    plain = EngineCore(params, dataclasses.replace(cfg, backend="torch"),
                       **kw)
    check(fleet.ladder_names == ["cuda_fused", "cuda"],
          f"fleet ladder {fleet.ladder_names}: a card's rungs are kernel "
          f"routes only")
    check(all(s.buffer.is_pinned() for b in fleet.buffers.banks
              for s in b.shards),
          "fleet: the staging banks are not pinned")
    tick_kernels = dict(event_voxel=1, demosaic=1, nlm=1)
    per_tick = [dict(npu_launches_per_tick(
        cfg, fused=fused_layers(params, cfg, BATCH, table),
        segments=fused_segments(cfg, BATCH, table)), **tick_kernels),
        dict(npu_launches_per_tick(cfg), **tick_kernels), tick_kernels]
    report = {"card": card}
    core = fleet.cores[0]
    enc = core.enc_cfg

    def staged(bank, rs):
        for i, r in enumerate(rs):
            stage_request(bank, i, r, validate_request(r, 2), enc)
        return bank

    # two ticks in flight: the harvest of the first waits for it alone
    banks = fleet.buffers.banks
    staged(banks[0], reqs[:BATCH])
    staged(banks[1], reqs[BATCH:2 * BATCH])
    pending, dt, (out_a, rgb_a, _), (out_b, _, _) = harvest_check(
        core, banks[0], banks[1])
    alone, rgb_alone, _ = core.tick(banks[0])
    d_a = max(float(np.abs(out_a.raw_pred - alone.raw_pred).max()),
              float(np.abs(rgb_a - rgb_alone).max()))
    check(pending, f"fleet: fetch of tick A waited for the stream past "
          f"tick B ({dt * 1e3:.1f} ms)")
    check(d_a <= E2E_TOL, f"fleet: tick A's harvest differs from A alone "
          f"by {d_a:.3g}")
    check(not np.array_equal(out_a.raw_pred, out_b.raw_pred),
          "fleet: ticks A and B fetched the same outputs")
    report["harvest"] = {"fetch_ms": dt * 1e3, "spin_ms":
                         HARVEST_SLEEP_S * 1e3, "pending": pending,
                         "equal_to_alone": bool(
                             np.array_equal(out_a.raw_pred, alone.raw_pred)
                             and np.array_equal(rgb_a, rgb_alone))}
    pend, done, equal = bank_event_check(core, banks[1], clone(reqs[0]),
                                         enc)
    check(pend and done and equal, f"fleet: pinned-bank rule (copy pending "
          f"{pend}, done once staged {done}, device copy intact {equal})")
    report["bank_rule"] = {"pending_after_upload": pend,
                           "done_after_staging": done, "intact": equal}
    print(f"  fleet: fetch of tick A returned in {dt * 1e3:.2f} ms with a "
          f"{HARVEST_SLEEP_S * 1e3:.0f} ms spin behind tick B pending; a "
          f"bank is re-packed only after its copy's event")

    # the ladder's rungs and the plain core on one staged bank
    bank = staged(banks[0], reqs[2 * BATCH:3 * BATCH])
    names = fleet.ladder_names[:2] + ["plain"]
    outs, rung_counts = [], []
    for i, c in enumerate(fleet.cores[:2] + [plain]):
        build.reset_launches()                      # counts to 0 ...
        outs.append(c.tick(bank))
        torch.cuda.synchronize()
        counts = {k: v for k, v in build.LAUNCHES.items() if v}
        rung_counts.append(counts)                  # ... read just after
        want = {k: v for k, v in per_tick[i].items() if v}
        check(counts == want, f"fleet core {names[i]}: "
              f"launches {counts}, want {want}")
    diffs = [{f: float(np.abs(np.asarray(a) - np.asarray(b)).max())
              for f, a, b in (("raw_pred", o[0].raw_pred, outs[0][0].raw_pred),
                              ("control", o[0].control, outs[0][0].control),
                              ("rgb", o[1], outs[0][1]))} for o in outs]
    print(f"  fleet cores {names}: max|core - rung 0| {diffs}; "
          f"launches {rung_counts}")
    check(all(v == 0.0 for v in diffs[1].values()),
          f"fleet: rung 1 is not bit-equal to rung 0: {diffs[1]}")
    check(all(v <= E2E_TOL for v in diffs[2].values()),
          f"fleet: the plain core differs from rung 0 past {E2E_TOL}: "
          f"{diffs[2]}")
    report["rungs"] = {"names": names, "launches": rung_counts,
                       "max_abs_diff_to_rung0": diffs}

    # the clean supervised run
    build.reset_launches()                          # counts to 0 ...
    sub = [fleet.submit(clone(r)) for r in reqs]
    steps = []
    while len(fleet.queue) or fleet._inflight is not None:
        fleet.step()
        steps.append(fleet.last_tick_s * 1e3)
    torch.cuda.synchronize()
    counts = {k: v for k, v in build.LAUNCHES.items() if v}  # ... after
    want = {k: v * fleet.ticks for k, v in per_tick[0].items() if v}
    check(counts == want, f"fleet clean run: launches {counts}, want {want} "
          f"({fleet.ticks} ticks)")
    check(all(s.status is RequestStatus.DONE for s in sub),
          f"fleet clean run: statuses {[s.status.value for s in sub]}")
    check({s.request.result.telemetry.rung for s in sub} == {"cuda_fused"},
          "fleet clean run: a request served off rung 0")
    cog = {r.rid: r.result for r in ref.run_to_completion(
        [clone(r) for r in reqs])}
    clean_d = {f: max(float(np.abs(np.asarray(getattr(s.request.result, f))
                                   - np.asarray(getattr(cog[s.rid], f))).max())
                      for s in sub) for f in ("raw_pred", "control", "rgb")}
    check(all(v <= E2E_TOL for v in clean_d.values()),
          f"fleet clean run vs CognitiveEngine: {clean_d}")
    st = fleet.stats()
    check(st["delivered"] == FLEET_REQUESTS and st["nan_delivered"] == 0
          and st["supervisor"]["transitions"] == [],
          f"fleet clean run: stats {st}")
    report["clean"] = {
        "requests": FLEET_REQUESTS, "ticks": fleet.ticks, "launches": counts,
        "max_abs_diff_to_cognitive_engine": clean_d,
        "step_p50_ms": statistics.median(steps),
        "step_p99_ms": sorted(steps)[min(len(steps) - 1,
                                         int(0.99 * len(steps)))],
        "steps": len(steps),
        **{k: st[k] for k in ("latency_p50_s", "latency_p99_s",
                              "latency_p999_s", "availability")}}
    print(f"  fleet clean run ({card}): {FLEET_REQUESTS} requests DONE on "
          f"cuda_fused in {fleet.ticks} ticks, launches {counts}, max|fleet "
          f"- CognitiveEngine| {clean_d}; latency p50 "
          f"{st['latency_p50_s'] * 1e3:.3f} ms p99 "
          f"{st['latency_p99_s'] * 1e3:.3f} ms; step p50 "
          f"{report['clean']['step_p50_ms']:.3f} ms")

    # the chaos run
    plan = FaultPlan.from_config(FAULT_CONFIGS["chaos"], CHAOS_TICKS, BATCH)
    with tune.pinned(table):
        chaos = FleetEngine(params, cfg, fleet_cfg=FleetConfig(batch=BATCH),
                            mesh=None,
                            supervisor_cfg=SUPERVISOR_CONFIGS["soak"],
                            fault_plan=plan, **kw)
    submitted, rid, bad_tick = [], 0, -1
    while chaos.ticks < CHAOS_TICKS:
        if len(chaos.queue) < BATCH:
            for _ in range(BATCH):
                submitted.append(chaos.submit(clone(reqs[rid % len(reqs)],
                                                    rid)))
                rid += 1
        # once per tick: a step that dispatches nothing (every queued
        # request backing off) leaves the tick where it was
        if plan.malformed_at(chaos.ticks) and chaos.ticks != bad_tick:
            bad_tick = chaos.ticks
            submitted.append(chaos.submit(make_malformed_request(10 ** 6
                                                                 + rid)))
        chaos.step()
    chaos.drain()
    torch.cuda.synchronize()
    cs = chaos.stats()
    ends = {RequestStatus.DONE, RequestStatus.FAILED, RequestStatus.EXPIRED,
            RequestStatus.REJECTED}
    events = [e["event"] for e in cs["supervisor"]["transitions"]]
    check(cs["nan_delivered"] == 0, f"fleet chaos: {cs['nan_delivered']} "
          f"non-finite results delivered")
    check(all(s.status in ends for s in submitted),
          "fleet chaos: a request did not end terminal")
    n_done = sum(s.status is RequestStatus.DONE for s in submitted)
    check(cs["delivered"] == n_done, f"fleet chaos: {cs['delivered']} "
          f"deliveries for {n_done} requests DONE (one delivered twice)")
    check(all(np.isfinite(s.request.result.raw_pred).all()
              and np.isfinite(s.request.result.rgb).all()
              for s in submitted if s.status is RequestStatus.DONE),
          "fleet chaos: a delivered result is not finite")
    check("demote" in events and "promote" in events,
          f"fleet chaos: transitions {events}")
    report["chaos"] = {
        "faults": len(plan), "kinds": sorted(k.value for k in plan.kinds()),
        "submitted": len(submitted), "events": events,
        "rungs_served": sorted({s.request.result.telemetry.rung
                                for s in submitted
                                if s.status is RequestStatus.DONE}),
        **{k: v for k, v in cs.items() if k != "supervisor"},
        "supervisor": {k: v for k, v in cs["supervisor"].items()
                       if k != "transitions"}}
    print(f"  fleet chaos run ({len(plan)} faults over {CHAOS_TICKS} ticks, "
          f"{len(submitted)} submits): delivered {cs['delivered']}, failed "
          f"{cs['failed']}, malformed {cs['malformed']}, retries "
          f"{cs['retries']}, quarantined {cs['supervisor']['quarantined']},"
          f" nan delivered {cs['nan_delivered']}; transitions {events}")
    print("  fleet " + json.dumps(report))
    return report


def cognitive_phase(params, cfg, reqs, dev):
    """cognitive_forward on the "cuda" and "fused" ISP configs and
    cognitive_step(use_cuda=True), each against its plain run and with
    its launches counted."""
    import torch
    from repro_torch.configs.registry import ISP_CONFIGS
    from repro_torch.core.cognitive import cognitive_forward, cognitive_step
    from repro_torch.core.encoding import voxel_batch
    from repro_torch.kernels import build
    plain_cfg = dataclasses.replace(cfg, backend="torch")
    vox = voxel_batch(event_windows(reqs, dev), backend="cuda",
                      time_steps=cfg.time_steps, height=cfg.height,
                      width=cfg.width).contiguous()
    bayer = torch.stack([torch.as_tensor(r.bayer) for r in reqs
                         if r.events is not None]).to(dev)
    npu = {k: n for k, n in npu_launches_per_tick(cfg).items() if n}
    per_stage = dict(npu, demosaic=1, nlm=1)
    runs = {
        "cognitive_forward": (
            lambda: cognitive_forward(params, vox, bayer, cfg,
                                      ISP_CONFIGS["cuda"]),
            lambda: cognitive_forward(params, vox, bayer, plain_cfg,
                                      ISP_CONFIGS["default"]), per_stage),
        "cognitive_forward_fused": (
            lambda: cognitive_forward(params, vox, bayer, cfg,
                                      ISP_CONFIGS["fused"]),
            lambda: cognitive_forward(params, vox, bayer, plain_cfg,
                                      ISP_CONFIGS["default"]),
            dict(npu, isp_stencil_segment=4)),
        "cognitive_step": (
            lambda: cognitive_step(params, vox, bayer, cfg, use_cuda=True),
            lambda: cognitive_step(params, vox, bayer, plain_cfg),
            per_stage),
    }
    for name, (kernel_run, plain_run, want_counts) in runs.items():
        build.reset_launches()
        got = kernel_run()
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)
        check(counts == want_counts, f"{name}: launches {counts}, want "
              f"{want_counts}")
        want = plain_run()
        diffs = {"raw_pred": (got.npu.raw_pred, want.npu.raw_pred),
                 "control": (got.npu.control, want.npu.control),
                 "rgb": (got.rgb, want.rgb)}
        diffs = {k: float((a - b).abs().max()) for k, (a, b) in diffs.items()}
        check(bool(torch.isfinite(got.rgb).all()), f"{name}: non-finite rgb")
        check(all(d <= E2E_TOL for d in diffs.values()),
              f"{name} differs from its plain run: {diffs}")
        print(f"  {name}: launches {counts}; max|kernel - plain| "
              + ", ".join(f"{k} {d:.3g}" for k, d in diffs.items()))


def batch_cap_run(name, dev):
    """Kernel ``name`` past the old 65535 grid cap, on a tiny spatial
    shape: (the last BATCH_CAP_TAIL batch elements of its output at
    batch BIG_BATCH, the kernel on those elements alone), which must be
    equal.  ``event_voxel_steps``: BIG_BATCH time steps at batch 2,
    (the kernel, its plain version)."""
    import torch
    from repro_torch.configs.registry import ISP_CONFIGS
    from repro_torch.core.encoding import (EventStream, encode_batch,
                                           events_to_voxel_batch)
    from repro_torch.isp.fuse import compile_plan, segment_call
    from repro_torch.isp.stages import control_to_stage_params
    from repro_torch.kernels.backbone_fuse import LayerSpec
    from repro_torch.kernels.backbone_segment import (backbone_segment,
                                                      segment_operands)
    from repro_torch.kernels.demosaic import demosaic
    from repro_torch.kernels.event_voxel import event_voxel
    from repro_torch.kernels.lif_scan import norm_affine_lif
    from repro_torch.kernels.max_pool import max_pool
    from repro_torch.kernels.spike_conv_lif import spike_conv_lif
    g = torch.Generator(device=dev).manual_seed(0)
    B, n = BIG_BATCH, BATCH_CAP_TAIL

    def rand(*shape):
        return torch.rand(*shape, device=dev, generator=g)

    def spikes(*shape):
        return (rand(*shape) < 0.3).float()

    if name == "norm_affine_lif":
        y = torch.randn(2, B, 3, 5, device=dev, generator=g)
        sc, bi = rand(5) + 0.5, rand(5) - 0.5
        return (norm_affine_lif(y, sc, bi)[:, -n:],
                norm_affine_lif(y[:, -n:].contiguous(), sc, bi))
    if name in ("event_voxel", "event_voxel_steps", "encode_batch"):
        b, T = (2, B) if name == "event_voxel_steps" else (B, 2)
        N, H, W = 16, 4, 4
        evs = EventStream(
            t=rand(b, N), x=(rand(b, N) * W).int(), y=(rand(b, N) * H).int(),
            p=(rand(b, N) * 2).int(), valid=rand(b, N) < 0.9)
        kw = dict(time_steps=T, height=H, width=W, mode="count")
        tail = EventStream(*(a[-n:] for a in evs))
        if name == "encode_batch":
            # every third window staged as voxels
            vox = rand(T, b, H, W, 2)
            fe = torch.arange(b, device=dev) % 3 != 0
            return (encode_batch(evs, vox, fe, backend="cuda", **kw)[:, -n:],
                    encode_batch(tail, vox[:, -n:].contiguous(), fe[-n:],
                                 backend="cuda", **kw))
        got = event_voxel(evs, **kw)
        if name == "event_voxel_steps":
            return got, events_to_voxel_batch(evs, **kw)
        return got[-n:], event_voxel(tail, **kw)
    if name == "spike_conv_lif":
        T, N = 2, 4
        xf = spikes(B * T, 1, 2, 2)
        w = torch.randn(3, 3, 2, N, device=dev, generator=g)
        sc, bi = rand(N) + 0.5, rand(N) - 0.5
        return (spike_conv_lif(xf, w, sc, bi, T=T, B=B)[:, -n:],
                spike_conv_lif(xf[-n * T:].contiguous(), w, sc, bi, T=T,
                               B=n))
    if name.startswith("flash_"):
        return flash_batch_cap(name[len("flash_"):], B, n, g, dev)
    if name == "backbone_segment":
        specs = (LayerSpec("", cin=2, cout=4),)
        x = spikes(1, B, 4, 4, 2)
        flat = segment_operands(((torch.randn(3, 3, 2, 4, device=dev,
                                              generator=g),
                                  rand(4) + 0.5, rand(4) - 0.5),), specs)
        return (backbone_segment(x, flat, specs=specs)[:, -n:],
                backbone_segment(x[:, -n:].contiguous(), flat, specs=specs))
    if name == "max_pool":
        T = 2
        x = spikes(T, B, 2, 2, 4)
        return (max_pool(x)[-n * T:],
                max_pool(x[:, -n:].contiguous()))
    if name == "demosaic":
        x = rand(B, 6, 10)
        return demosaic(x)[-n:], demosaic(x[-n:].contiguous())
    if name == "pointwise_segment":
        kernel, _, args, kw = pointwise_call("[awb*+gamma]", (B, 2, 3), dev,
                                             g)
        x, pvec, stats, consts = args
        return (kernel(*args, **kw)[-n:],
                kernel(x[-n:], pvec[-n:].contiguous(),
                       stats[-n:].contiguous(), consts, **kw))
    if name == "stencil_segment":
        stages = ISP_CONFIGS["fused"].stages
        ex = next(e for e in compile_plan(stages)
                  if e.segment.stencil is not None)
        x = rand(B, 8, 8)
        sp = control_to_stage_params(rand(B, ISP_CONFIGS["fused"]
                                          .control_dim), stages)
        kernel, _, args, kw = segment_call(ex, x, sp)
        x, pvec, stats, consts = args
        return (kernel(*args, **kw)[-n:],
                kernel(x[-n:], pvec[-n:].contiguous(),
                       stats[-n:].contiguous(), consts, **kw))
    raise ValueError(f"batch_cap_run: no kernel {name!r}")


def flash_batch_cap(design, B, n, g, dev):
    """flash_attention's ``design`` ("mma_sync" or "f32") at batch B, Sq
    = 1 against 16 keys (causal, the query last), one head, d = 64: held
    to the plain scan (bf16: within bf16_error_bound; f32: F32_TOL),
    then (the last n batch elements, a run on them alone)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    dt = torch.bfloat16 if design == "mma_sync" else torch.float32
    Sk = 16
    q, k, v = (torch.randn(B, S, 1, 64, device=dev, generator=g).to(dt)
               for S in (1, Sk, Sk))
    kw = dict(causal=True, q_offset=Sk - 1, window=0)
    got = fa._launch(q, k, v, design=design, **kw)
    chunk = 8192                # the bound's plain scans, a slice at a time
    for b0 in range(0, B, chunk):
        sl = slice(b0, b0 + chunk)
        want = fa.flash_attention_plain(q[sl], k[sl], v[sl], block=Sk, **kw)
        diff = (got[sl].float() - want.float()).abs()
        bar = F32_TOL if design == "f32" else fa.bf16_error_bound(
            q[sl], k[sl], v[sl], got[sl], want, causal=True,
            q_offset=Sk - 1)
        check(bool((diff <= bar).all()), f"flash_attention {design} at "
              f"batch {B}: {int((diff > bar).sum())} outputs past the "
              f"bar against the plain scan (batch {b0}..)")
    tail = [t[-n:].contiguous() for t in (q, k, v)]
    return got[-n:], fa._launch(*tail, design=design, **kw)


def batch_cap_phase(dev):
    """Each of BATCH_CAP_KERNELS past the old grid cap, bit-equal on the
    checked batch elements."""
    import torch
    for name in BATCH_CAP_KERNELS:
        got, want = batch_cap_run(name, dev)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name} at batch {BIG_BATCH}: "
              f"{int((got != want).sum())} values differ")
        print(f"  {name}: past the old 65535 grid cap "
              f"({'time steps' if name.endswith('steps') else 'batch'} "
              f"{BIG_BATCH}), bit-equal on the checked "
              f"{'grid' if name.endswith('steps') else 'batch elements'}"
              + (", within the bar of the plain scan"
                 if name.startswith("flash_") else ""))
        del got, want
        torch.cuda.empty_cache()


def norm_phase(params_by_arch, dev, card):
    """norm_affine_lif alone at every served shape of the four
    backbones (numpy-seeded conv outputs): bit-equal to the contract
    replay and to the earlier design, then per arch the kernel, the
    earlier design, the plain version and the bound summed over a
    tick's launches, and the kernel under other plans."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.kernels import lif_scan as K
    from repro_torch.testing import norm_affine_lif_contract
    lif_kw = dict(tau=2.0, v_th=1.0, v_reset=0.0)
    earlier = earlier_norm()

    def replan(**kw):
        """The default plan with ``kw`` replaced (a tile no wider than C,
        threads for the chains, streamed where the slab does not fit)."""
        def plan(shape):
            p = dc.replace(K.norm_lif_plan(*shape), **kw)
            ct = min(p.ct, p.C)
            p = dc.replace(p, ct=ct, vec=p.vec if ct % 4 == 0 else 1,
                           threads=max(K.THREADS, -(-p.classes * ct // 32)
                                       * 32))
            if p.smem_bytes > K.MAX_SMEM:
                p = dc.replace(p, staged=False)
            return p
        return plan
    variants = {"default": lambda shape: K.norm_lif_plan(*shape),
                "wide_tile": replan(ct=32),
                "cluster1": replan(cluster=1),
                "cluster16": replan(cluster=16),
                "stream": replan(staged=False)}
    report = {"card": card}
    cache = {}
    for arch, (p, cfg) in params_by_arch.items():
        shapes = norm_shapes(p, cfg, BATCH)
        st = KernelStats()
        var_ms = {v: 0.0 for v in variants}
        for shape in shapes:
            if shape not in cache:
                rng = np.random.default_rng(sum(shape))
                T, B, HW, C = shape
                y = torch.tensor(rng.normal(0.2, 1.0, shape)
                                 .astype(np.float32), device=dev)
                sc = torch.tensor(rng.normal(1.0, 0.2, C).astype(np.float32),
                                  device=dev)
                bi = torch.tensor(rng.normal(0.0, 0.2, C).astype(np.float32),
                                  device=dev)
                want = norm_affine_lif_contract(y, sc, bi, **lif_kw)
                got = K.norm_affine_lif(y, sc, bi, **lif_kw)
                old = earlier(y, sc, bi, lif_kw) if earlier else None
                torch.cuda.synchronize()
                check(torch.equal(got.cpu(), want), f"norm_affine_lif "
                      f"{shape}: differs from the contract replay")
                check(old is None or torch.equal(old, got),
                      f"norm_affine_lif {shape}: differs from the earlier "
                      f"design")
                vms = {}
                for v, make in variants.items():
                    plan = make(shape)
                    run = K._norm_launch(y, sc, bi, plan, eps=K.NORM_EPS,
                                         **lif_kw)
                    torch.cuda.synchronize()
                    check(torch.equal(run.cpu(), want), f"norm_affine_lif "
                          f"{shape} under plan {v}: differs")
                    vms[v] = time_ms(lambda: K._norm_launch(
                        y, sc, bi, plan, eps=K.NORM_EPS, **lif_kw))
                n = y.numel()
                cache[shape] = dict(
                    ms=vms["default"],
                    plain_ms=time_ms(lambda: K.norm_affine_lif_plain(
                        y, sc, bi, **lif_kw)),
                    old_ms=time_ms(lambda: earlier(y, sc, bi, lif_kw))
                    if earlier else None,
                    nbytes=2 * n * 4 + 2 * C * 4, nops=14 * n, vms=vms)
                print(f"  {shape}: plan {K.norm_lif_plan(*shape)}; ms "
                      f"{vms}, earlier {cache[shape]['old_ms']}")
            c = cache[shape]
            st.add(shape, c["ms"], c["plain_ms"], c["nbytes"], c["nops"],
                   0.0, extra={"earlier_design_ms": c["old_ms"]})
            for v in variants:
                var_ms[v] += c["vms"][v]
        report[arch] = dict(st.summary(), plans_ms=var_ms)
    return report


def conv_lif_phase(params_by_arch, dev, card):
    """spike_conv_lif alone at every firing conv of the four backbones
    (its input shape, kernel and stride; numpy-seeded 15% spikes and
    weights, batch 8): equal to the per-op kernel pair under each gate,
    then per arch the kernel at its plan, at every other cluster size
    that holds the slab, the per-op pair, the plain version, the earlier
    design (where build/earlier holds its source) and the bound summed
    over a tick's launches."""
    import numpy as np
    import torch
    from repro_torch.kernels.lif_scan import norm_affine_lif
    from repro_torch.kernels.spike_conv import spike_conv
    from repro_torch.kernels.spike_conv_lif import (CLUSTERS, GATES,
                                                    MAX_SMEM, ROW_TILES,
                                                    STAGES,
                                                    _conv_lif_launch,
                                                    conv_lif_plan,
                                                    spike_conv_lif,
                                                    spike_conv_lif_plain)
    from repro_torch.core.layers import NORM_EPS, spike_im2col
    from repro_torch.testing import slab_occupancy_mask
    lif_kw = dict(tau=2.0, v_th=1.0, v_reset=0.0)
    earlier = earlier_conv_lif()
    report = {"card": card}
    cache = {}
    for arch, (p, cfg) in params_by_arch.items():
        st = KernelStats()
        cl_ms = {}
        for name, T, B, H, W, C, k, stride, N in conv_lif_layers(p, cfg,
                                                                 BATCH):
            shape = (T, B, H, W, C, k, stride, N)
            if shape not in cache:
                rng = np.random.default_rng(sum(shape))
                xf = torch.tensor((rng.random((B * T, H, W, C)) < 0.15)
                                  .astype(np.float32), device=dev)
                w = torch.tensor(rng.normal(0, 1, (k, k, C, N))
                                 .astype(np.float32), device=dev)
                sc = torch.tensor(rng.normal(1, 0.2, N).astype(np.float32),
                                  device=dev)
                bi = torch.tensor(rng.normal(0, 0.2, N).astype(np.float32),
                                  device=dev)
                kw = dict(T=T, B=B, stride=stride, **lif_kw)

                def pair():
                    y4 = spike_conv(xf, w, stride=stride).reshape(
                        B, T, -1, N).transpose(0, 1).contiguous()
                    return norm_affine_lif(y4, sc, bi, **lif_kw)
                want = pair()
                for gate in GATES:
                    got = spike_conv_lif(xf, w, sc, bi, gate=gate, **kw)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want), f"spike_conv_lif {shape} "
                          f"(gate {gate}): {int((got != want).sum())} "
                          f"spikes differ from the per-op pair's")
                HW = want.shape[2]
                plan = conv_lif_plan(T, B, HW, N, k * k * C)
                by_cluster, variants = {}, {}
                for c in CLUSTERS:
                    try:
                        pc = conv_lif_plan(T, B, HW, N, k * k * C,
                                           cluster=c)
                    except ValueError:
                        continue
                    by_cluster[c] = time_ms(lambda c=c: spike_conv_lif(
                        xf, w, sc, bi, cluster=c, **kw))
                    # the other row tiles and ring depths at this cluster
                    for bm in ROW_TILES:
                        for stages in STAGES:
                            pv = dataclasses.replace(pc, bm=bm,
                                                     stages=stages)
                            if pv.smem_bytes > MAX_SMEM or pv == pc or \
                                    bm > 2 * pc.rows:
                                continue
                            def run(pv=pv):
                                return _conv_lif_launch(
                                    xf, w, sc, bi, pv, stride=stride,
                                    gate="mask", eps=NORM_EPS, **lif_kw)
                            check(torch.equal(run(), want),
                                  f"spike_conv_lif {shape} under {pv}: "
                                  f"differs from the per-op pair")
                            variants[f"{c}/{bm}/{stages}"] = time_ms(run)
                patches = spike_im2col(xf, k, k, stride)[0]
                wmat = w.reshape(-1, N).contiguous()
                occ = slab_occupancy_mask(patches.reshape(B, T * HW, -1))
                live = sum(live_tile_elems(occ[b], T * HW, k * k * C)
                           for b in range(B))
                old_ms = time_ms(lambda: earlier(
                    patches, wmat, occ, sc, bi, T, B, HW, lif_kw)) \
                    if earlier else None
                cache[shape] = dict(
                    ms=by_cluster[plan.cluster], by_cluster=by_cluster,
                    plain_ms=time_ms(lambda: spike_conv_lif_plain(
                        xf, w, sc, bi, **kw)),
                    pair_ms=time_ms(pair), old_ms=old_ms,
                    nbytes=(xf.numel() + w.numel() + want.numel() + 2 * N)
                    * 4, nops=2.0 * N * live)
                best = min(variants.items(), key=lambda kv: kv[1],
                           default=("none", None))
                print(f"  {name} {shape}: plan tile {plan.ct} cluster "
                      f"{plan.cluster} bm {plan.bm} stages {plan.stages}; "
                      f"equal to the pair under {'/'.join(GATES)}; ms by "
                      f"cluster {by_cluster}, fastest other (cluster/bm/"
                      f"stages) {best}, per-op pair "
                      f"{cache[shape]['pair_ms']:.5f}, earlier design "
                      f"{old_ms}; all {variants}")
            c = cache[shape]
            st.add(shape, c["ms"], c["plain_ms"], c["nbytes"], c["nops"],
                   0.0, per_op_ms=c["pair_ms"],
                   extra={"earlier_design_ms": c["old_ms"]})
            best = min(c["by_cluster"].values())
            cl_ms["best_cluster"] = cl_ms.get("best_cluster", 0.0) + best
        report[arch] = dict(st.summary(), **cl_ms)
    return report


# ---------------------------------------------------------------------------
# the LM phase: serving full-width qwen2-7b
# ---------------------------------------------------------------------------

def tensors(tree):
    """Every tensor of a nested dict / list of tensors."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return [tree]


def grid_cap_check(vgg_params, vgg_cfg, vox):
    """spike_conv on VGG's first layer at batch GRID_CAP_BATCH (the
    batch-8 voxels tiled) and spike_matmul on its patches: more 64-row
    tiles than gridDim.y holds; both held to the plain GEMM, and the
    conv bit-equal to spike_matmul."""
    import torch
    from repro_torch.core import backbones as BB
    from repro_torch.core import layers as L
    from repro_torch.kernels.spike_conv import spike_conv
    from repro_torch.kernels.spike_matmul import spike_matmul

    spec = BB.vgg_specs(vgg_cfg)[0]
    p = vgg_params["backbone"][spec.name]
    B = vox.shape[1]
    x = vox.repeat(1, -(-GRID_CAP_BATCH // B), 1, 1, 1)[:, :GRID_CAP_BATCH]
    kh = p["w"].shape[0]
    xf = L.fold(x).contiguous()
    patches, _ = L.spike_im2col(xf, kh, kh, spec.stride)
    wmat = p["w"].reshape(-1, p["w"].shape[-1]).contiguous()
    M = patches.shape[0]
    check(M > 65535 * 64, f"grid cap: {M} rows do not pass the old cap")
    want = L.blocked_matmul(patches, wmat)
    got = {"spike_conv": spike_conv(xf, p["w"], stride=spec.stride)
           .reshape(M, -1),
           "spike_matmul": spike_matmul(patches, wmat)}
    torch.cuda.synchronize()
    check(torch.equal(got["spike_conv"], got["spike_matmul"]),
          f"spike_conv differs from spike_matmul on its patches at M={M}")
    errs = {}
    for name, y in got.items():
        check(torch.allclose(y, want, atol=1e-4, rtol=1e-5),
              f"{name} disagrees with its plain version at M={M}")
        errs[name] = float((y - want).abs().max())
    print(f"  grid cap: VGG {spec.name} at batch {GRID_CAP_BATCH}, M={M} "
          f"rows ({-(-M // 64)} row tiles > 65535), K={patches.shape[1]}, "
          f"N={wmat.shape[1]}: spike_conv bit-equal to spike_matmul; "
          f"max|kernel - plain| {errs}")


def patched_attention(fn, hook):
    """``fn()`` with every flash-attention call of the model (one per
    layer) going to ``hook(real, q, k, v, **kw)`` instead of the real
    wrapper ``real``."""
    from repro_torch.models import attention
    real = attention.flash_attention
    attention.flash_attention = lambda q, k, v, **kw: hook(real, q, k, v,
                                                            **kw)
    try:
        return fn()
    finally:
        attention.flash_attention = real


def profile_window(fn, n):
    """``fn()`` n times under torch.profiler -> per call: (wall ms with
    the profiler on, device busy ms, device ops, {device op name: ms})."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / n / 1e3)
    return wall_ms, sum(by_name.values()), len(dev) / n, by_name


# kernel name -> the most profile windows one ``ops_a_call`` of a call
# that launched it took (1: the first window was whole)
PROFILE_WINDOWS = {}


def ops_a_call(fn, n=20, tries=6):
    """(device ops of one call of ``fn``, the profile windows taken): the
    ops are the mean over ``n`` profiled calls, rounded.  CUPTI has been
    seen to drop one kernel of a window (0.8 ops a call for a one-op call
    over 5 calls, in some runs and not others) and all of a window's
    kernels (0 ops a call for a one-launch call over 20, in the last of
    three windows, an H100 run of this script); over 20 calls a dropped
    kernel moves the mean by 0.05, and a call with one op more still
    counts one more.  A window whose rounded device ops a call fall
    short of the kernel launches a call the wrappers counted in it
    (``build.LAUNCHES``) lost events and is profiled again, up to
    ``tries`` windows; one dropped kernel (0.95 for 1) passes, as the
    mean is meant to absorb it.  A retry costs one window of ``n``
    calls; six leave room past the three a window loss has been seen to
    exhaust.  Each kernel the call launched keeps the most windows one
    call took in ``PROFILE_WINDOWS``, which the "kernels" line reports,
    so that a loss which grows shows before it reaches the limit."""
    from repro_torch.kernels import build
    for windows in range(1, tries + 1):
        before = dict(build.LAUNCHES)
        ops = profile_window(fn, n)[2]
        launched = {k for k, v in build.LAUNCHES.items()
                    if v > before.get(k, 0)}
        if round(ops) >= sum(build.LAUNCHES[k] - before.get(k, 0)
                             for k in launched) / n:
            break
    for k in launched:
        PROFILE_WINDOWS[k] = max(PROFILE_WINDOWS.get(k, 0), windows)
    return round(ops), windows


def attention_work(q, k, v, kw):
    """(bytes, operations) of one attention call: q, k, v and the output
    each moved once; 2 d + 2 dv operations per visible (query, key) pair,
    counted from this call's mask."""
    import torch
    from repro_torch.kernels.flash_attention import visible_mask
    B, Sq, Hq, d = q.shape
    Sk, dv = k.shape[1], v.shape[3]
    dev = q.device
    pairs = int(visible_mask(kw["q_offset"] + torch.arange(Sq, device=dev),
                             torch.arange(Sk, device=dev), Sk=Sk,
                             causal=kw["causal"],
                             window=kw.get("window", 0)).sum())
    nbytes = (q.numel() + k.numel() + v.numel() + B * Sq * Hq * dv) \
        * q.element_size()
    return nbytes, pairs * B * Hq * (2.0 * d + 2.0 * dv)


def kernel_vs_plain(q, k, v, kw):
    """The kernel and the plain scan on the same inputs -> (max |err|,
    the largest share of the bar used, median |plain|, median bar);
    raises past the bar (float32 F32_TOL + F32_TOL * |plain|; bfloat16
    the rounding bound ``bf16_error_bound``, never past BF16_ATOL +
    BF16_RTOL * |plain|)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "flash_attention: non-finite")
    mag = want.float().abs()
    if q.dtype == torch.float32:
        bar = F32_TOL + F32_TOL * mag
    else:
        bar = torch.minimum(fa.bf16_error_bound(q, k, v, got, want, **kw),
                            BF16_ATOL + BF16_RTOL * mag)
    err = (got.float() - want.float()).abs()
    share = float((err / bar).max())
    check(share <= 1.0, f"flash_attention {q.dtype} {tuple(q.shape)}: "
          f"max|err| {float(err.max()):.3g} past the bar")
    return (float(err.max()), share, float(mag.median()),
            float(bar.median()))


def flash_phase(dev, card):
    """flash_attention alone at one layer of the qwen2-7b prefill (q [2,
    4096, 28, 128], k and v [2, 4096, 4, 128], causal; numpy-seeded bf16,
    no model): the "wgmma" kernel held to the plain scan within
    ``bf16_error_bound`` and the float32 kernel to it within F32_TOL on
    float32 copies; then the "wgmma" kernel, the "mma_sync" design at the
    same shape, SDPA (the yardstick; the port never calls it) and the
    float32 kernel timed in turns (w m s f f s m w), with the bound,
    TFLOP/s and the card.  -> the report."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.roofline import BF16_TENSOR_FLOPS

    cfg = get_config(LM_ARCH)
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)

    def normal(*shape):
        return torch.as_tensor(rng.standard_normal(shape, dtype=np.float32))
    q32 = normal(LM_BATCH, LM_SEQ, Hq, hd).to(dev)
    k32 = normal(LM_BATCH, LM_SEQ, Hkv, hd).to(dev)
    v32 = normal(LM_BATCH, LM_SEQ, Hkv, hd).to(dev)
    q, k, v = (t.bfloat16() for t in (q32, k32, v32))
    kw = dict(causal=True, q_offset=0, window=0)
    print(f"  --- flash_attention at one {LM_ARCH} prefill layer: q "
          f"{tuple(q.shape)}, k/v {tuple(k.shape)}, causal, bf16")
    build.reset_launches()
    e16, s16, mag16, bar16 = kernel_vs_plain(q, k, v, kw)
    check(build.LAUNCHES["flash_attention:wgmma"] == 1,
          f"bf16 at d = {hd} did not run the wgmma design: "
          f"{dict(build.LAUNCHES)}")
    e32, s32, _, _ = kernel_vs_plain(q32, k32, v32, kw)
    print(f"  wgmma vs plain: bf16 max|err| {e16:.3g} ({s16:.2f} of the "
          f"rounding bound; median |plain| {mag16:.3g}, median bar "
          f"{bar16:.3g}); float32 kernel max|err| {e32:.3g} ({s32:.2f} of "
          f"{F32_TOL} + {F32_TOL}|plain|)")
    blocks = fa.wgmma_schedule(LM_BATCH, LM_SEQ, LM_SEQ, Hq, causal=True,
                               n_blocks=torch.cuda.get_device_properties(
                                   dev).multi_processor_count)
    tiles = [sum(it[3] for it in b) for b in blocks]
    balance = max(tiles) / (sum(tiles) / len(tiles))

    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    fns = {
        "wgmma": lambda: fa.flash_attention(q, k, v, **kw),
        "mma_sync": lambda: fa._launch(q, k, v, design="mma_sync", **kw),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
        "f32": lambda: fa.flash_attention(q32, k32, v32, **kw),
    }
    runs = {n: [] for n in fns}
    for n in ("wgmma", "mma_sync", "sdpa", "f32", "f32", "sdpa", "mma_sync",
              "wgmma"):
        runs[n].append(time_ms(fns[n]))
    nbytes, nops = attention_work(q, k, v, kw)
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / BF16_TENSOR_FLOPS * 1e3
    f32_bound = max(2 * nbytes / HBM_BYTES_PER_S,
                    nops / FP32_FLOPS) * 1e3
    report = {"arch": LM_ARCH, "q": list(q.shape), "kv": list(k.shape),
              "card": card, "bound_ms": max(tb, to),
              "bound_by": "operations" if to >= tb else "bytes",
              "f32_bound_ms": f32_bound, "gflop": nops / 1e9,
              "bf16_max_abs_err": e16, "bf16_share_of_bound": s16,
              "f32_max_abs_err": e32, "schedule_tiles_max_over_mean":
              balance, "layers_per_prefill": cfg.num_layers, "designs": {}}
    for n, ms in runs.items():
        report["designs"][n] = {
            "ms_runs": ms, "ms": statistics.median(ms),
            "ms_per_prefill": statistics.median(ms) * cfg.num_layers,
            "tflops": nops / (statistics.median(ms) * 1e-3) / 1e12}
        print(f"  {n}: {' / '.join(f'{t:.4f}' for t in ms)} ms a layer, "
              f"{report['designs'][n]['ms_per_prefill']:.4f} ms a prefill, "
              f"{report['designs'][n]['tflops']:.1f} TFLOP/s")
    print(f"  bound {max(tb, to):.4f} ms a layer ({report['bound_by']}; "
          f"{nops / 1e9:.1f} GFLOP), float32 bound {f32_bound:.4f}; wgmma "
          f"schedule: {len(blocks)} blocks, tiles max/mean {balance:.3f}; "
          f"{card}")
    return report


def engine_run(p, c, e, label):
    """``e["requests"]`` requests of ``launch.serve.make_requests``
    through a ServeEngine of ``e``'s batch and max_len on model (p, c),
    every request answered with ``e["max_new"]`` in-range tokens ->
    (requests by rid, host ms of each tick)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(p, c, batch=e["batch"], max_len=e["max_len"])
    pending = make_requests(e["requests"], c.vocab_size, e["max_new"])
    done, ticks = [], []
    while pending or any(r is not None for r in eng.active):
        while pending and eng._free_slot() is not None:
            eng.submit(pending.pop(0))
        t = time.perf_counter()
        done.extend(eng.tick())
        ticks.append((time.perf_counter() - t) * 1e3)
    check(sorted(r.rid for r in done) == list(range(e["requests"])),
          f"{label}: the engine did not answer every request")
    for r in done:
        check(len(r.out_tokens) == e["max_new"] and all(
            0 <= t < c.vocab_size for t in r.out_tokens),
            f"{label} request {r.rid}: tokens {r.out_tokens}")
    return sorted(done, key=lambda r: r.rid), ticks


def engine_matches_prefill_decode(p, c, done, max_new, dev, label):
    """Each engine request's tokens equal its serve_prefill + greedy
    serve_decode continuation on (p, c)."""
    import torch
    from repro_torch.models.lm import serve_decode, serve_prefill
    for r in done:
        pr = torch.as_tensor(r.prompt, device=dev)[None]
        lg, cache = serve_prefill(p, c, {"tokens": pr},
                                  cache_len=pr.shape[1] + max_new)
        want = [int(lg[0].argmax())]
        for i in range(max_new - 1):
            lg, cache = serve_decode(p, c, cache,
                                     torch.tensor([[want[-1]]], device=dev),
                                     pr.shape[1] + i)
            want.append(int(lg[0].argmax()))
        check(r.out_tokens == want, f"{label} engine request {r.rid}: "
              f"{r.out_tokens} != prefill + decode {want}")


def lm_phase(dev, card):
    """LM serving on full-width qwen2-7b (bf16, random weights from a
    CUDA generator seeded 0): serve_prefill of LM_BATCH prompts of LM_SEQ
    tokens (flash_attention in every layer, counted), the kernel held to
    its plain version on layer 0's and the last layer's own q/k/v (bf16
    and float32 copies), the prefill held to the same prefill on the
    plain scan, greedy serve_decode from its cache (no flash launch), the
    float32 decode-vs-prefill check at LM_CHECK_LAYERS layers, the slot
    engine at full width and its tokens against prefill + decode on the
    float32 model; then the timings.  -> (the kernel's KernelStats, its
    launches on the main path, the report)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.roofline import BF16_TENSOR_FLOPS
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.models.lm import serve_decode, serve_prefill

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tensors(params))
    print(f"  {LM_ARCH}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} parameters "
          f"(config count {cfg.param_count()}), "
          f"{torch.cuda.memory_allocated(dev)} bytes resident, "
          f"init {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (LM_BATCH, LM_SEQ)), device=dev)
    cache_len = LM_SEQ + LM_DECODE

    def prefill():
        return serve_prefill(params, cfg, {"tokens": toks},
                             cache_len=cache_len)

    # the main path, counted
    build.reset_launches()
    logits, cache = prefill()
    torch.cuda.synchronize()
    launches = build.LAUNCHES["flash_attention"]
    check(launches == cfg.num_layers, f"serve_prefill launched "
          f"flash_attention {launches} times, want {cfg.num_layers}")
    check(build.LAUNCHES["flash_attention:wgmma"] == launches,
          f"flash_attention launches by design {dict(build.LAUNCHES)}: "
          f"want all {launches} on wgmma")
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), "prefill logits")
    check(len(cache) == cfg.num_layers and tuple(cache[0].k.shape) == (
        LM_BATCH, cache_len, cfg.num_kv_heads, cfg.head_dim), "prefill cache")
    print(f"  serve_prefill [{LM_BATCH}, {LM_SEQ}] (cache {cache_len}): "
          f"flash_attention launched {launches} times (one per layer), "
          f"all on the wgmma design")

    # each layer's own q/k/v, recorded from the same prefill
    calls = []

    def record(real, q, k, v, **kw):
        calls.append((q, k, v, kw))
        return real(q, k, v, **kw)
    patched_attention(prefill, record)
    check(len(calls) == cfg.num_layers, "one attention call per layer")
    err = {}
    for li in (0, cfg.num_layers - 1):
        q, k, v, kw = calls[li]
        e16, s16, mag16, bar16 = kernel_vs_plain(q, k, v, kw)
        e32, s32, _, _ = kernel_vs_plain(q.float(), k.float(), v.float(),
                                         kw)
        err[li] = e16
        print(f"  layer {li}: flash_attention vs plain, bf16 max|err| "
              f"{e16:.3g} ({s16:.2f} of the rounding bound; median |plain| "
              f"{mag16:.3g}, median bar {bar16:.3g}), float32 max|err| "
              f"{e32:.3g} ({s32:.2f} of {F32_TOL} + {F32_TOL}|plain|)")

    # end to end: the same prefill with attention on the plain scan
    logits_plain, _ = patched_attention(
        prefill, lambda real, q, k, v, **kw: fa.flash_attention_plain(
            q, k, v, **kw))
    diff = (logits - logits_plain).abs()
    rel = float(diff.max() / logits_plain.abs().max())
    check(rel < LOGITS_REL_TOL, f"prefill logits {rel:.3g} from the plain "
          f"scan's, past {LOGITS_REL_TOL}")
    top2 = logits_plain.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * diff.amax(dim=-1)     # no flip possible
    same = logits.argmax(-1) == logits_plain.argmax(-1)
    check(bool(same[decided].all()), "prefill argmax differs from the "
          "plain scan's where the margin decides it")
    print(f"  end to end: last logits vs the plain scan's, max rel diff "
          f"{rel:.3g} (< {LOGITS_REL_TOL}); argmax equal on {int(same.sum())}/{LM_BATCH} rows "
          f"(decided by the margin on {int(decided.sum())}: top-2 margins "
          f"{[round(float(m), 4) for m in margin]})")

    # prefill -> greedy decode from its cache
    build.reset_launches()
    nxt = logits.argmax(-1, keepdim=True)
    out = [nxt]
    t0 = time.perf_counter()
    for i in range(LM_DECODE - 1):
        lg, cache = serve_decode(params, cfg, cache, nxt, LM_SEQ + i)
        nxt = lg.argmax(-1, keepdim=True)
        out.append(nxt)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / (LM_DECODE - 1)
    out = torch.cat(out, dim=1)
    check(build.LAUNCHES["flash_attention"] == 0,
          "flash_attention launched during decode")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "decode tokens")
    print(f"  serve_decode: {LM_DECODE} greedy tokens per prompt from the "
          f"prefill cache, no flash_attention launch; "
          f"{decode_s * 1e3:.2f} ms a step at batch {LM_BATCH}; first "
          f"tokens {out[:, :6].tolist()}")
    # the decode's f32 wo product (three bf16 parts of the f32 input in
    # one bf16 GEMM) against the float32 copy of wo it avoids
    wo = params["layers"][0]["mixer"]["attn"]["wo"]
    x32 = torch.randn((LM_BATCH, wo.shape[0]), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(2))
    want = x32 @ wo.float()
    rel_wo = float((attention._f32_matmul(x32, wo) - want).abs().max()
                   / want.abs().max())
    check(rel_wo < F32_TOL, f"decode's f32 wo product: rel {rel_wo:.3g}")
    print(f"  decode's f32 wo product without a float32 copy of wo vs "
          f"with it: rel {rel_wo:.3g} (< {F32_TOL})")
    # where a decode step's time goes: 5 more steps (the last position)
    # under the profiler
    prof = {"decode": profile_window(
        lambda: serve_decode(params, cfg, cache, nxt, cache_len - 1), 5)}
    del cache

    # float32, LM_CHECK_LAYERS layers at full width: decode the last token
    # against a prefill of all of them
    cfg32 = dataclasses.replace(cfg, num_layers=LM_CHECK_LAYERS,
                                dtype="float32")
    p32 = tfm.init_params(torch.Generator(device=dev).manual_seed(1), cfg32,
                          device=dev)
    full, _ = serve_prefill(p32, cfg32, {"tokens": toks})
    _, c32 = serve_prefill(p32, cfg32, {"tokens": toks[:, :-1]},
                           cache_len=LM_SEQ)
    dec, _ = serve_decode(p32, cfg32, c32, toks[:, -1:], LM_SEQ - 1)
    del c32
    rel32 = float((dec - full).abs().max() / full.abs().max())
    check(rel32 < 1e-4, f"float32 decode vs prefill: rel {rel32:.3g}")
    print(f"  float32 at {LM_CHECK_LAYERS} layers: decode of token {LM_SEQ} "
          f"after a {LM_SEQ - 1}-token prefill vs the {LM_SEQ}-token "
          f"prefill, rel {rel32:.3g} (< 1e-4)")

    # the slot engine at full width, then its tokens on the float32 model
    # against prefill + greedy decode
    e = LM_ENGINE

    build.reset_launches()
    done, ticks = engine_run(params, cfg, e, LM_ARCH)
    check(build.LAUNCHES["flash_attention"] == 0,
          "the engine prefills by decode steps: no flash_attention launch")
    tick = {"p50_ms": statistics.median(ticks),
            "p90_ms": statistics.quantiles(ticks, n=10)[8],
            "ticks": len(ticks)}
    print(f"  ServeEngine (full width, batch {e['batch']}, max_len "
          f"{e['max_len']}): {len(done)} requests answered, "
          f"{e['max_new']} in-range tokens each; tick {tick}")
    done32, _ = engine_run(p32, cfg32, e, LM_ARCH)
    engine_matches_prefill_decode(p32, cfg32, done32, e["max_new"], dev,
                                  LM_ARCH)
    print(f"  ServeEngine on the float32 {LM_CHECK_LAYERS}-layer model: "
          f"every request's tokens equal its serve_prefill + serve_decode "
          f"continuation ({len(done32)} requests)")
    del p32

    # timings: per layer on its own q/k/v, summed over the prefill
    st = KernelStats()
    for li, (q, k, v, kw) in enumerate(calls):
        nbytes, nops = attention_work(q, k, v, kw)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], enable_gqa=True)
        st.add((tuple(q.shape), tuple(k.shape)),
               time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
               time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                       reps=LM_PLAIN_REPS, warmup=1),
               nbytes, nops, err.get(li, 0.0),
               library_ms=time_ms(library), peak_flops=BF16_TENSOR_FLOPS,
               extra={"mma_sync_ms": time_ms(lambda: fa._launch(
                   q, k, v, design="mma_sync", **kw))})
    del calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        prefill()
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t0) / 2
    prof["prefill"] = profile_window(prefill, 1)
    for name, (wall, busy, ops, by_name) in prof.items():
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        print(f"  {name} under the profiler: {ops:.0f} device ops, busy "
              f"{busy:.2f} ms of {wall:.2f} ms wall (idle share "
              f"{1 - busy / wall:.3f}); most time: "
              + "; ".join(f"{n[:60]} {ms:.2f}" for n, ms in top))
    report = {"arch": LM_ARCH, "batch": LM_BATCH, "seq": LM_SEQ,
              "prefill_s": prefill_s,
              "prefill_tokens_per_s": LM_BATCH * LM_SEQ / prefill_s,
              "decode_step_ms": decode_s * 1e3,
              "decode_tokens_per_s": LM_BATCH / decode_s,
              "engine_tick": tick, "logits_rel_vs_plain": rel,
              "profiled": {name: {"wall_ms": w, "device_busy_ms": b,
                                  "device_ops": o}
                           for name, (w, b, o, _) in prof.items()},
              "f32_decode_vs_prefill_rel": rel32,
              "flash_attention": st.summary(), "card": card}
    print(f"  timings ({card}): flash_attention per prefill "
          f"({len(st.shapes)} launches) kernel (wgmma) {st.ms:.4f} ms, the "
          f"mma_sync design {st.extra['mma_sync_ms']:.4f}, plain "
          f"{st.plain_ms:.4f}, SDPA {st.library_ms:.4f}, bound "
          f"{st.bound_ms:.4f} ({'operations' if st.ops_s >= st.bytes_s else 'bytes'}); "
          f"prefill {prefill_s * 1e3:.1f} ms = "
          f"{report['prefill_tokens_per_s']:.0f} tokens/s; decode step "
          f"{decode_s * 1e3:.2f} ms; engine tick p50 {tick['p50_ms']:.2f} "
          f"p90 {tick['p90_ms']:.2f} ms")
    del params
    return st, launches, report


# ---------------------------------------------------------------------------
# the MoE/MLA phase: arctic-480b and deepseek-v3-671b at full width
# ---------------------------------------------------------------------------

def moe_cut(arch, **extra):
    """``arch``'s published config with only its depth cut: MOE_DEPTH
    (and ``extra``) applied, the MoE fields of it to ``cfg.moe``."""
    import dataclasses as dc
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    cut = {**MOE_DEPTH[arch], **extra}
    moe_keys = {f.name for f in dc.fields(cfg.moe)}
    moe_cut = {k: v for k, v in cut.items() if k in moe_keys}
    return dc.replace(cfg, moe=dc.replace(cfg.moe, **moe_cut),
                      **{k: v for k, v in cut.items() if k not in moe_keys})


def routing_recorder(log, idx_log=None):
    """A stand-in for ``moe.experts`` that records each MoE layer's
    expert loads, its capacity and the pairs it drops (the pairs past
    an expert's capacity) in ``log``, its routing (top_idx) in
    ``idx_log`` if given, then runs the real experts."""
    import torch
    from repro_torch.models import moe
    real = moe.experts

    def experts(x2d, p, cfg, top_idx, top_w):
        counts = torch.bincount(top_idx.reshape(-1),
                                minlength=cfg.moe.num_experts)
        cap = moe.capacity(x2d.shape[0], cfg)
        log.append({"tokens": x2d.shape[0], "pairs": top_idx.numel(),
                    "capacity": cap, "max_load": int(counts.max()),
                    "min_load": int(counts.min()),
                    "dropped": int((counts - cap).clamp(min=0).sum())})
        if idx_log is not None:
            idx_log.append((top_idx, cap))
        return real(x2d, p, cfg, top_idx, top_w)
    return experts


def last_tokens_kept(idx_log, S):
    """Whether every logged MoE layer kept all the pairs of each prompt's
    last token (flat token S - 1 of each row of S): the dispatch keeps an
    expert's first ``cap`` pairs in token order."""
    for top_idx, cap in idx_log:
        for t in range(S - 1, top_idx.shape[0], S):
            for e in top_idx[t].tolist():
                if int((top_idx[:t] == e).sum()) >= cap:
                    return False
    return True


def patched_experts(fn, hook):
    """``fn()`` with ``moe.experts`` replaced by ``hook``."""
    from repro_torch.models import moe
    real = moe.experts
    moe.experts = hook
    try:
        return fn()
    finally:
        moe.experts = real


def library_attention_ms(q, k, v, kw):
    """SDPA on the same q/k/v on its flash, memory-efficient or cuDNN
    backend (never the math backend, which would hold the S x S scores)
    -> (ms, None), or (None, the error) where none of them takes the
    call (dv != d)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    G = q.shape[2] // k.shape[2]

    def library():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION]):
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=kw["causal"], enable_gqa=G > 1)
    try:
        library()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]
    return time_ms(library), None


def moe_run(arch, dev, card):
    """One MoE model at full width, its depth cut to MOE_DEPTH: bf16
    weights from a CUDA generator seeded 0, serve_prefill of LM_BATCH
    prompts of LM_SEQ tokens (flash_attention counted by design), the
    kernel against its plain scan on layer 0's own q/k/v (bf16 within the
    rounding bound, float32 copies within 1e-5), the prefill against the
    same prefill on the plain scan, per-layer routing figures, greedy
    serve_decode (no flash launch), the slot engine at full width, the
    timings; then, the bf16 model freed, the float32 decode against the
    full forward and the engine's tokens against prefill + decode at
    MOE_CHECK_DEPTH.  -> (layer 0's KernelStats, flash launches by
    design on the prefill, the report)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.roofline import BF16_TENSOR_FLOPS
    from repro_torch.models import transformer as tfm
    from repro_torch.models.lm import serve_decode, serve_prefill

    full = get_config(arch)
    cfg = moe_cut(arch)
    kinds = tfm.layer_kinds(cfg)
    head = (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
            cfg.mla.v_head_dim) if cfg.mla else (cfg.head_dim,) * 2
    design = fa.kernel_design(torch.bfloat16, *head)
    print(f"  --- {arch}: depth cut num_layers {full.num_layers} -> "
          f"{cfg.num_layers}, first_dense_layers "
          f"{full.moe.first_dense_layers} -> {cfg.moe.first_dense_layers}"
          f", mtp_depth {cfg.mtp_depth}; widths as published (d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of "
          f"{cfg.moe.d_expert}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}); "
          f"layers {['MoE' if m else 'dense' for _, m in kinds]}; "
          f"attention (d, dv) = {head} on {design!r}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tensors(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tensors(params))
    print(f"  {n_params} parameters ({n_bytes} bytes; config count "
          f"{cfg.param_count()} without the mtp subtree), init "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (LM_BATCH, LM_SEQ)), device=dev)
    cache_len = LM_SEQ + MOE_DECODE

    def prefill():
        return serve_prefill(params, cfg, {"tokens": toks},
                             cache_len=cache_len)

    # the main path, counted
    build.reset_launches()
    logits, cache = prefill()
    torch.cuda.synchronize()
    launches = {d: build.LAUNCHES[f"flash_attention:{d}"]
                for d in fa.DESIGNS}
    check(build.LAUNCHES["flash_attention"] == cfg.num_layers
          and launches[design] == cfg.num_layers,
          f"{arch} serve_prefill: flash_attention launches by design "
          f"{launches}, want {cfg.num_layers} on {design}")
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_size)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()), f"{arch} prefill logits")
    check(len(cache) == cfg.num_layers and cache[0][0].shape[:2] == (
        LM_BATCH, cache_len), f"{arch} prefill cache")
    print(f"  serve_prefill [{LM_BATCH}, {LM_SEQ}] (cache {cache_len}, "
          f"{type(cache[0]).__name__}): flash_attention launches by design "
          f"{launches}")

    # layer 0's own q/k/v and each MoE layer's routing, from the same
    # prefill
    calls, routing = [], []

    def record(real, q, k, v, **kw):
        if not calls:
            calls.append((q, k, v, kw))
        return real(q, k, v, **kw)
    patched_experts(lambda: patched_attention(prefill, record),
                    routing_recorder(routing))
    q, k, v, kw = calls.pop()
    e16, s16, mag16, bar16 = kernel_vs_plain(q, k, v, kw)
    e32, s32, _, _ = kernel_vs_plain(q.float(), k.float(), v.float(), kw)
    print(f"  layer 0: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
          f"{tuple(v.shape)}: flash_attention vs plain, bf16 max|err| "
          f"{e16:.3g} ({s16:.2f} of the rounding bound; median |plain| "
          f"{mag16:.3g}, median bar {bar16:.3g}), float32 max|err| "
          f"{e32:.3g} ({s32:.2f} of {F32_TOL} + {F32_TOL}|plain|)")
    moe_layers = [l for l, (_, m) in enumerate(kinds) if m]
    for l, r in zip(moe_layers, routing):
        print(f"  routing, layer {l}: {r['pairs']} (token, expert) pairs "
              f"over {cfg.moe.num_experts} experts, capacity "
              f"{r['capacity']}, load max {r['max_load']} min "
              f"{r['min_load']}, {r['dropped']} pairs dropped")

    logits_plain, _ = patched_attention(
        prefill, lambda real, q, k, v, **kw: fa.flash_attention_plain(
            q, k, v, **kw))
    diff = (logits - logits_plain).abs()
    rel = float(diff.max() / logits_plain.abs().max())
    check(rel < LOGITS_REL_TOL, f"{arch} prefill logits {rel:.3g} from the "
          f"plain scan's, past {LOGITS_REL_TOL}")
    top2 = logits_plain.topk(2, dim=-1).values
    decided = top2[:, 0] - top2[:, 1] > 2 * diff.amax(dim=-1)
    same = logits.argmax(-1) == logits_plain.argmax(-1)
    check(bool(same[decided].all()), f"{arch} prefill argmax differs from "
          "the plain scan's where the margin decides it")
    print(f"  end to end: last logits vs the plain scan's, max rel diff "
          f"{rel:.3g} (< {LOGITS_REL_TOL}); argmax equal on "
          f"{int(same.sum())}/{LM_BATCH} rows (decided by the margin on "
          f"{int(decided.sum())})")
    del logits_plain

    # prefill -> greedy decode from its cache
    build.reset_launches()
    nxt = logits.argmax(-1, keepdim=True)
    out = [nxt]
    t0 = time.perf_counter()
    for i in range(MOE_DECODE - 1):
        lg, cache = serve_decode(params, cfg, cache, nxt, LM_SEQ + i)
        nxt = lg.argmax(-1, keepdim=True)
        out.append(nxt)
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / (MOE_DECODE - 1)
    out = torch.cat(out, dim=1)
    check(build.LAUNCHES["flash_attention"] == 0,
          f"{arch}: flash_attention launched during decode")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"{arch} decode tokens")
    print(f"  serve_decode: {MOE_DECODE} greedy tokens per prompt, no "
          f"flash_attention launch, {decode_s * 1e3:.2f} ms a step at batch "
          f"{LM_BATCH}; tokens {out.tolist()}")
    del cache

    e = MOE_ENGINE

    build.reset_launches()
    done, ticks = engine_run(params, cfg, e, arch)
    check(build.LAUNCHES["flash_attention"] == 0,
          "the engine prefills by decode steps: no flash_attention launch")
    tick = {"p50_ms": statistics.median(ticks), "ticks": len(ticks)}
    print(f"  ServeEngine (full width, batch {e['batch']}, max_len "
          f"{e['max_len']}): {len(done)} requests, {e['max_new']} in-range "
          f"tokens each; tick p50 {tick['p50_ms']:.2f} ms")

    # timings: the prefill, the decode step, layer 0's kernel beside its
    # plain scan, SDPA and the bound
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        prefill()
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t0) / 2
    wall, busy, ops, by_name = profile_window(prefill, 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"  prefill under the profiler: {ops:.0f} device ops, busy "
          f"{busy:.2f} ms of {wall:.2f} ms wall (idle share "
          f"{1 - busy / wall:.3f}); most time: "
          + "; ".join(f"{n[:60]} {ms:.2f}" for n, ms in top))
    nbytes, nops = attention_work(q, k, v, kw)
    lib_ms, lib_err = library_attention_ms(q, k, v, kw)
    st = KernelStats()
    st.add((tuple(q.shape), tuple(k.shape), tuple(v.shape)),
           time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
           time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                   reps=LM_PLAIN_REPS, warmup=1),
           nbytes, nops, e16, library_ms=lib_ms,
           peak_flops=BF16_TENSOR_FLOPS)
    del q, k, v, params
    gc.collect()
    torch.cuda.empty_cache()
    peak_bf16 = torch.cuda.max_memory_allocated(dev)
    print(f"  timings ({card}): prefill {prefill_s * 1e3:.1f} ms = "
          f"{LM_BATCH * LM_SEQ / prefill_s:.0f} tokens/s; decode step "
          f"{decode_s * 1e3:.2f} ms; layer 0's flash_attention ({design}) "
          f"{st.ms:.4f} ms = {nops / st.ms / 1e9:.1f} TFLOP/s, plain "
          f"{st.plain_ms:.4f}, SDPA "
          f"{'none: ' + lib_err if lib_ms is None else f'{lib_ms:.4f}'}, "
          f"bound {st.bound_ms:.4f} ({nops / 1e12:.3f} TFLOP at "
          f"{BF16_TENSOR_FLOPS / 1e12:.0f} TFLOP/s); peak memory "
          f"{peak_bf16} bytes")

    # float32 at MOE_CHECK_DEPTH: decode the last token against the full
    # forward, and the engine's tokens against prefill + decode
    torch.cuda.reset_peak_memory_stats(dev)
    cfg32 = dataclasses.replace(moe_cut(arch, **MOE_CHECK_DEPTH[arch]),
                                dtype="float32")
    p32 = tfm.init_params(torch.Generator(device=dev).manual_seed(1), cfg32,
                          device=dev)

    def decode_vs_forward(S):
        """(rel of the decode of token S after an (S-1)-token prefill
        against the S-token prefill, pairs the S-token forward dropped,
        whether it kept every pair of the prompts' last tokens)."""
        log, idx_log = [], []
        full_logits, _ = patched_experts(
            lambda: serve_prefill(p32, cfg32, {"tokens": toks[:, :S]}),
            routing_recorder(log, idx_log))
        _, c32 = serve_prefill(p32, cfg32, {"tokens": toks[:, :S - 1]},
                               cache_len=S)
        dec, _ = serve_decode(p32, cfg32, c32, toks[:, S - 1:S], S - 1)
        rel = float((dec - full_logits).abs().max()
                    / full_logits.abs().max())
        return (rel, sum(r["dropped"] for r in log),
                last_tokens_kept(idx_log, S))

    rel_long, dropped_long, kept_long = decode_vs_forward(LM_SEQ)
    if kept_long:
        check(rel_long < 1e-4, f"{arch} float32 decode vs prefill at "
              f"{LM_SEQ}: rel {rel_long:.3g}")
    rel32, dropped32, _ = decode_vs_forward(MOE_CHECK_SEQ)
    check(dropped32 == 0 and rel32 < 1e-4, f"{arch} float32 decode vs "
          f"prefill at {MOE_CHECK_SEQ}: rel {rel32:.3g}, {dropped32} pairs "
          "dropped")
    done32, _ = engine_run(p32, cfg32, e, arch)
    engine_matches_prefill_decode(p32, cfg32, done32, e["max_new"], dev,
                                  arch)
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    peak_f32 = torch.cuda.max_memory_allocated(dev)
    print(f"  float32 at num_layers {cfg32.num_layers} (layers "
          f"{['MoE' if m else 'dense' for _, m in tfm.layer_kinds(cfg32)]}"
          f", mtp_depth {cfg32.mtp_depth}): decode of the last token after "
          f"a prefill of the others vs the whole prefill, at "
          f"{MOE_CHECK_SEQ} tokens a prompt (no pair can drop) rel "
          f"{rel32:.3g} (< 1e-4); at {LM_SEQ} rel {rel_long:.3g}, the "
          f"forward dropped {dropped_long} pairs, the last tokens' pairs "
          f"{'kept (held < 1e-4)' if kept_long else 'dropped (not held)'}"
          f"; the engine's tokens equal prefill + decode ({len(done32)} "
          f"requests); peak memory {peak_f32} bytes")
    report = {"arch": arch, "num_layers": cfg.num_layers,
              "first_dense_layers": cfg.moe.first_dense_layers,
              "mtp_depth": cfg.mtp_depth, "parameters": n_params,
              "parameter_bytes": n_bytes, "head_dims": list(head),
              "design": design, "flash_launches": launches,
              "routing": routing, "logits_rel_vs_plain": rel,
              "prefill_s": prefill_s,
              "prefill_tokens_per_s": LM_BATCH * LM_SEQ / prefill_s,
              "decode_step_ms": decode_s * 1e3, "engine_tick": tick,
              "prefill_profiled": {"wall_ms": wall, "device_busy_ms": busy,
                                   "device_ops": ops,
                                   "top_ms": dict(top)},
              "f32_check_layers": cfg32.num_layers,
              "f32_decode_vs_prefill_rel": rel32,
              "f32_decode_vs_prefill_at_seq": {
                  "rel": rel_long, "dropped": dropped_long,
                  "last_tokens_kept": kept_long},
              "peak_bytes_bf16": peak_bf16, "peak_bytes_f32": peak_f32,
              "layer0_flash_attention": {
                  **st.summary(), "sdpa_error": lib_err,
                  "tflops": nops / st.ms / 1e9,
                  "bf16_share_of_bound": s16, "f32_max_abs_err": e32},
              "card": card}
    return st, launches, report


def ptxas_entries(name, key):
    """{kernel: its ptxas report (registers, barriers, stack and spills)}
    for each entry function of ``name``'s build log whose mangled name
    holds ``key``; empty where another run built the library."""
    from repro_torch.kernels import build
    out, fn = {}, None
    for ln in build.build_log(name).splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn and key in fn and ("registers" in ln or "spill" in ln):
            out.setdefault(fn, []).append(ln.split(":", 1)[-1].strip())
    return {k: " | ".join(v) for k, v in out.items()}


def moe_phase(dev, card):
    """arctic-480b then deepseek-v3-671b through ``moe_run``, one after
    the other, each freed before the next.  -> (deepseek's layer-0
    KernelStats: the (192, 128) instance; each model's flash_attention
    launches by design on its prefill; the reports by model)."""
    reports, launches, stats = {}, {}, {}
    # the (192, 128) instances' registers and spills: 48 registers of Q
    # fragments and 64 of O accumulators a thread in "mma_sync"
    ptxas = {re.sub(r".*?(flash_[a-z0-9]+_kernel)ILi(\d+)ELi(\d+)E.*",
                    r"\1<\2, \3>", fn): report
             for fn, report in ptxas_entries("flash_attention",
                                             "ILi192ELi128E").items()}
    for fn, report in ptxas.items():
        print(f"  ptxas, {fn}: {report}")
    for arch in MOE_ARCHS:
        stats[arch], launches[arch], reports[arch] = moe_run(arch, dev,
                                                              card)
    reports["ptxas_192_128"] = ptxas
    return stats["deepseek-v3-671b"], launches, reports


# ---------------------------------------------------------------------------
# the train phase: surrogate-gradient BPTT + AdamW at full width
# ---------------------------------------------------------------------------

def _rel_l2(a, b):
    d, n = float((a - b).norm()), float(b.norm())
    return d / n if n else d


def _maxrel(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def grad_gap(grads, want):
    """(global relative L2 gap, the worst leaf's (path, relative L2 gap))
    of gradient trees ``grads`` against ``want``."""
    import torch
    from repro_torch.optim.adamw import tree_leaves
    w = dict(tree_leaves(want))
    per = {k: _rel_l2(g, w[k]) for k, g in tree_leaves(grads)}
    flat = torch.cat([g.reshape(-1) for _, g in tree_leaves(grads)])
    wflat = torch.cat([w[k].reshape(-1) for k, _ in tree_leaves(grads)])
    worst = max(per.items(), key=lambda kv: kv[1])
    return _rel_l2(flat, wflat), worst


def timed_step(loss_fn, params, opt, scene, cfg, opt_cfg, sched):
    """One train step in its three parts, each ended by a synchronise:
    -> (loss, parts, grads, (params, opt), {forward_ms, backward_ms,
    optimizer_ms})."""
    import torch
    from repro_torch.core import train as TR
    from repro_torch.optim.adamw import adamw_update
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, leaves = TR.with_leaves(params)
    with torch.enable_grad():
        loss, parts = loss_fn(p, scene, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = TR.grads_of(loss, p, leaves)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    new = adamw_update(params, grads, opt, opt_cfg, sched)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    return loss.detach(), parts, grads, new[:2], {
        "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
        "optimizer_ms": (t3 - t2) * 1e3}


def train_phase(all_archs, dev, card):
    """Full-width spiking-YOLO (64x64, T 5, batch 8) trained through the
    kernels: the reference's "detector" recipe, ``detect`` and
    ``cognitive`` steps on the per-op, forced-fused and forced-segment
    routes, each step's launches counted, its loss and every gradient
    leaf checked finite and held to the plain backend's on the card; then
    the per-op backward checks and times of rows 1-8 (``backward_phase``).
    Returns the report."""
    import numpy as np
    import torch
    from repro_torch.core import train as TR
    from repro_torch.core.backbones import fused_route_segments
    from repro_torch.core.encoding import voxel_batch
    from repro_torch.data.synthetic import make_scene_batch
    from repro_torch.kernels import build, ops, tune
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves
    from repro_torch.optim.schedule import warmup_cosine
    params, cfg = all_archs["spiking_yolo"]
    plain = dataclasses.replace(cfg, backend="torch")
    scene = make_scene_batch(torch.Generator().manual_seed(11), batch=BATCH,
                             height=cfg.height, width=cfg.width,
                             time_steps=cfg.time_steps, device=dev)
    opt_cfg = AdamWConfig(**TRAIN_RECIPE)
    sched = warmup_cosine(TRAIN_RECIPE["lr"], **TRAIN_SCHEDULE)
    keys = [tune.shape_key("conv_lif", **d)
            for d in conv_lif_dims(params, cfg, BATCH)]
    tables = {"per_op": tune.TuningTable(),
              "fused": ops.fused_conv_lif_table(keys),
              "segment": ops.fused_segment_table(
                  [k for *_, k in fused_route_segments(cfg, BATCH)])}
    vox = voxel_batch(scene.events, time_steps=cfg.time_steps,
                      height=cfg.height, width=cfg.width)
    print(f"  the scene's forward, layer by layer, kernel route vs plain "
          f"(flips by the near-threshold rule, {NEAR_TOL}):")
    with torch.no_grad(), tune.pinned(tables["per_op"]):
        flips = layer_walk(params, cfg, plain, vox)
    report = {"card": card, "arch": cfg.name, "batch": BATCH,
              "recipe": TRAIN_RECIPE, "flips": flips, "steps": {}}
    for mode in TR.MODES:
        loss_fn = TR.LOSSES[mode]
        lp, _, gp = TR.value_and_grad(loss_fn, params, scene, plain)
        check(bool(torch.isfinite(lp)), f"train {mode}: plain loss {lp}")
        route_grads = {}
        for route, table in tables.items():
            label = f"train {mode} {route}"
            opt = adamw_init(params, opt_cfg)
            with tune.pinned(table):
                build.reset_launches()
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                loss, parts, grads, (p1, o1), split = timed_step(
                    loss_fn, params, opt, scene, cfg, opt_cfg, sched)
                launches = {k: v for k, v in build.LAUNCHES.items() if v}
                peak = torch.cuda.max_memory_allocated(dev) - base
                need = TRAIN_ROUTE_KERNELS[route]
                check(all(launches.get(k, 0) > 0 for k in need),
                      f"{label}: launches {launches}, need {need}")
                check(bool(torch.isfinite(loss)), f"{label}: loss {loss}")
                check(all(bool(torch.isfinite(g).all())
                          for _, g in tree_leaves(grads)),
                      f"{label}: a non-finite gradient")
                total = sum(float(g.abs().sum())
                            for _, g in tree_leaves(grads))
                check(total > 0, f"{label}: every gradient is zero")
                loss_rel = abs(float(loss) - float(lp)) / abs(float(lp))
                gap, (leaf, leaf_gap) = grad_gap(grads, gp)
                check(loss_rel <= TRAIN_LOSS_RTOL and gap <= TRAIN_GRAD_RTOL,
                      f"{label}: loss {float(loss)} vs plain {float(lp)} "
                      f"(rel {loss_rel:.3g}), gradients {gap:.3g} from the "
                      f"plain backend's (worst leaf {leaf} {leaf_gap:.3g})")
                route_grads[route] = (loss, grads)
                # the step function itself, a few steps on
                step = TR.make_snn_train_step(cfg, opt_cfg, mode, sched)
                state = TR.SNNTrainState(p1, o1, torch.ones(
                    (), dtype=torch.int32, device=dev))
                losses = [float(loss)]
                step_ms = []
                for _ in range(TRAIN_STEPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, sp = step(state, scene)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(float(sp["loss"]))
                    check(np.isfinite(losses[-1]) and np.isfinite(
                        float(sp["grad_norm"])), f"{label}: step {sp}")
                # the split again, warm (the first step loaded the
                # route's kernels)
                split = timed_step(loss_fn, params, opt, scene, cfg, opt_cfg,
                                   sched)[-1]
                wall, busy, dev_ops, _ = profile_window(
                    lambda: step(state, scene), 2)
            row = {"loss_rel_vs_plain": loss_rel, "grad_gap_vs_plain": gap,
                   "worst_leaf": [leaf, leaf_gap], "losses": losses,
                   "step_ms": step_ms, **split, "device_ops": dev_ops,
                   "device_busy_ms": busy, "profiled_wall_ms": wall,
                   "peak_bytes": peak, "launches": launches,
                   "grad_norm": float(sp["grad_norm"])}
            report["steps"][f"{mode}/{route}"] = row
            print(f"  {label}: loss {float(loss):.6f} (plain "
                  f"{float(lp):.6f}, rel {loss_rel:.2e}), gradients "
                  f"{gap:.2e} from the plain backend's (worst leaf {leaf} "
                  f"{leaf_gap:.2e}); forward {split['forward_ms']:.1f} ms, "
                  f"backward {split['backward_ms']:.1f}, optimizer "
                  f"{split['optimizer_ms']:.1f}; steps "
                  f"{', '.join(f'{t:.1f}' for t in step_ms)} ms, losses "
                  f"{', '.join(f'{v:.4f}' for v in losses)}; {dev_ops:.0f} "
                  f"device ops a step, busy {busy:.2f} of {wall:.2f} ms "
                  f"profiled; peak {peak / 2**20:.1f} MiB; launches "
                  f"{launches}")
        # the three routes give the per-op route's spikes, so their
        # losses and gradients are the per-op route's
        l0, g0 = route_grads["per_op"]
        for route in ("fused", "segment"):
            lr, gr = route_grads[route]
            d = max(_maxrel(g, dict(tree_leaves(g0))[k])
                    for k, g in tree_leaves(gr))
            check(float(lr) == float(l0) and d <= BWD_RTOL,
                  f"train {mode} {route}: loss {float(lr)} vs per-op "
                  f"{float(l0)}, gradients {d:.3g} apart")
            report["steps"][f"{mode}/{route}"]["grad_rel_vs_per_op"] = d
    report["backward"] = backward_phase(all_archs, vox)
    return report


def forced_lif(z, spikes, cfg):
    """The plain LIF over currents z [T, ...] with the forward's
    ``spikes`` as its outputs and in its resets, differentiated by
    autograd through the surrogate ``spike`` (each spike straight-through
    onto the given one): the plain backward of that very forward."""
    import torch
    from repro_torch.core.lif import f32_decay, spike
    decay, vr = f32_decay(cfg.tau_mem), cfg.v_reset
    u = torch.full_like(z[0], vr)
    out = []
    for t in range(z.shape[0]):
        u = decay * (u - vr) + vr + z[t]
        sg = spike(u - cfg.v_threshold, cfg.surrogate_beta)
        s = spikes[t] + (sg - sg.detach())
        u = u * (1.0 - s) + vr * s
        out.append(s)
    return torch.stack(out)


class BackwardStats:
    """Per kernel row: the op's backward and the plain autograd backward,
    ms summed over the layers checked, and the worst relative gap."""

    def __init__(self):
        self.rows = {}

    def add(self, name, ms, plain_ms, err):
        r = self.rows.setdefault(name, {"launches": 0, "bwd_ms": 0.0,
                                        "plain_bwd_ms": 0.0,
                                        "max_rel": 0.0})
        r["launches"] += 1
        r["bwd_ms"] += ms
        r["plain_bwd_ms"] += plain_ms
        r["max_rel"] = max(r["max_rel"], err)


def bwd_check(st, name, op_fn, plain_fn, inputs, seed):
    """Gradients of ``op_fn(*inputs)`` (the kernel op) and of
    ``plain_fn(*inputs, out)`` (plain PyTorch, given the op's output) for
    one seeded output gradient: every input's within BWD_RTOL relative
    (max |diff| over max |plain|); both backwards timed.  Returns the
    op's output."""
    import torch
    ks = [t.detach().requires_grad_() for t in inputs]
    ps = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = op_fn(*ks)
        want = plain_fn(*ps, out.detach())
    g = torch.randn(out.shape, generator=torch.Generator(
        out.device).manual_seed(seed), device=out.device)
    gk = torch.autograd.grad(out, ks, g, retain_graph=True)
    gp = torch.autograd.grad(want, ps, g, retain_graph=True)
    err = max(_maxrel(a, b) for a, b in zip(gk, gp))
    check(all(bool(torch.isfinite(a).all()) for a in gk)
          and err <= BWD_RTOL, f"{name} backward: {err:.3g} from the plain "
          f"backward (bar {BWD_RTOL})")
    st.add(name, time_ms(lambda: torch.autograd.grad(
        out, ks, g, retain_graph=True), reps=BWD_REPS, warmup=1),
        time_ms(lambda: torch.autograd.grad(want, ps, g, retain_graph=True),
                reps=BWD_REPS, warmup=1), err)
    return out.detach()


def backward_phase(all_archs, vox):
    """Rows 1-8's backwards on the card at each arch's full-width layer
    shapes, on the kernel route's own inputs (the tick's forward walked
    layer by layer): each op's gradients held to plain autograd on the
    same forward (``forced_lif`` where a kernel's spikes are the
    forward), and both backwards timed.  Rows: spike_conv and
    norm_affine_lif (every conv), spike_conv_lif (every firing conv, the
    fused route), spike_dwconv (MobileNet), max_pool (VGG, DenseNet),
    lif_scan and spike_matmul (the control head), backbone_segment
    (every fused-route segment, held to the per-layer kernel route)."""
    import torch
    from repro_torch.core import layers as L
    from repro_torch.core.backbones import fused_route_segments
    from repro_torch.core.lif import lif_scan
    from repro_torch.kernels import ops, tune
    from repro_torch.kernels.spike_conv_lif import conv_lif_plan
    out = {}
    for ai, (arch, (params, cfg)) in enumerate(all_archs.items()):
        st = BackwardStats()
        seed = [ai * 1000]
        segs = fused_route_segments(cfg, BATCH)
        seg_in = {seg.layers[0].name: None for seg, _, _ in segs}

        def nxt():
            seed[0] += 1
            return seed[0]

        def norm_plain(y4, s, b, spikes):
            return forced_lif(L.instance_norm_affine(y4, s, b), spikes, cfg)

        def conv(name, p, x, stride, depthwise):
            if seg_in.get(name, 0) is None:     # a segment's first layer
                seg_in[name] = x
            T, B = x.shape[:2]
            w, s, b = p["w"], p["scale"], p["bias"]
            xf = L.fold(x).contiguous()
            if depthwise:
                y = bwd_check(st, "spike_dwconv", lambda xf, w:
                              ops.spike_dwconv_op(xf, w, stride=stride),
                              lambda xf, w, _: L.spike_conv(
                                  xf, w, stride=stride, depthwise=True),
                              (xf, w), nxt())
            else:
                y = bwd_check(st, "spike_conv", lambda xf, w:
                              ops.spike_conv_op(xf, w, stride=stride),
                              lambda xf, w, _: L.spike_conv(xf, w,
                                                            stride=stride),
                              (xf, w), nxt())
            y4 = L.unfold(y, T, B).reshape(T, B, -1, y.shape[-1]) \
                .contiguous()
            spikes = bwd_check(st, "norm_affine_lif", lambda y4, s, b:
                               ops.norm_affine_lif_op(
                                   y4, s, b, tau=cfg.tau_mem,
                                   v_th=cfg.v_threshold,
                                   v_reset=cfg.v_reset,
                                   beta=cfg.surrogate_beta),
                               norm_plain, (y4, s, b), nxt())
            if not depthwise:
                plan = conv_lif_plan(T, B, y4.shape[2], w.shape[3],
                                     w.shape[0] * w.shape[1] * w.shape[2])
                fused = tune.LaunchConfig(bm=plan.cluster, gate="mask",
                                          fused=True)
                lif = dict(tau=cfg.tau_mem, v_th=cfg.v_threshold,
                           v_reset=cfg.v_reset)

                def fused_plain(xf, w, s, b, spikes):
                    yp = L.unfold(L.spike_conv(xf, w, stride=stride), T, B)
                    return forced_lif(L.instance_norm_affine(
                        yp.reshape(y4.shape), s, b), spikes.reshape(
                            y4.shape), cfg).reshape(spikes.shape)
                got = bwd_check(st, "spike_conv_lif", lambda xf, w, s, b:
                                ops._conv_lif_apply(
                                    fused, xf, w, s, b, T=T, B=B,
                                    stride=stride, lif=lif,
                                    beta=cfg.surrogate_beta),
                                fused_plain, (xf, w, s, b), nxt())
                check(torch.equal(got.reshape(spikes.shape), spikes),
                      f"{arch} {name}: the fused kernel's spikes differ "
                      f"from the per-op pair's")
            return spikes.reshape(T, B, *y.shape[1:])

        def pool(name, x, window):
            T, B = x.shape[:2]
            return bwd_check(st, "max_pool", lambda x:
                             ops.max_pool_op(x, window=window),
                             lambda x, _: L.unfold(L.pool_slices(
                                 L.fold(x), window), T, B), (x,), nxt())

        with torch.no_grad():
            feats = backbone_walk(cfg, params["backbone"], vox, conv, pool,
                                  lambda fs: torch.cat(fs, dim=-1))
            h = conv("head_conv", params["head"]["conv"], feats, 1, False)
            T, B = h.shape[:2]
            bwd_check(st, "spike_conv", lambda xf, w: ops.spike_conv_op(
                xf, w), lambda xf, w, _: L.spike_conv(xf, w),
                (L.fold(h).contiguous(), params["head"]["pred"]["w"]),
                nxt())
            c = params["ctrl_hidden"]
            cur = feats.mean(dim=(2, 3)) @ c["w"]
            hc = bwd_check(st, "lif_scan", lambda z, b: ops.lif_scan_op(
                z, bias=b, tau=cfg.tau_mem, v_th=cfg.v_threshold,
                v_reset=cfg.v_reset, beta=cfg.surrogate_beta),
                lambda z, b, _: lif_scan(
                    z + b, tau=cfg.tau_mem, v_th=cfg.v_threshold,
                    v_reset=cfg.v_reset, beta=cfg.surrogate_beta),
                (cur, c["bias"]), nxt())
            bwd_check(st, "spike_matmul", ops.spike_matmul_op,
                      lambda x, w, _: L.blocked_matmul(x, w),
                      (hc.reshape(T * B, -1), params["ctrl_out"]["w"]),
                      nxt())
        # row 7: each fused-route segment on the walk's input to it, the
        # segment kernel's backward against the per-layer route's
        table = ops.fused_segment_table([k for *_, k in segs])
        for seg, _, _ in segs:
            x = seg_in[seg.layers[0].name]
            sp = tuple(s.anon() for s in seg.layers)
            flat = [t for s in seg.layers for t in (
                params["backbone"][s.name]["w"],
                params["backbone"][s.name]["scale"],
                params["backbone"][s.name]["bias"])]
            lif = dict(tau=cfg.tau_mem, v_th=cfg.v_threshold,
                       v_reset=cfg.v_reset, beta=cfg.surrogate_beta)

            def run(x, *flat):
                return ops.backbone_segment_op(
                    x, [flat[i:i + 3] for i in range(0, len(flat), 3)],
                    specs=sp, **lif)

            def fused(x, *flat):
                with tune.pinned(table):
                    return run(x, *flat)

            def per_layer(x, *rest):
                with tune.pinned(tune.TuningTable()):
                    return run(x, *rest[:-1])
            bwd_check(st, "backbone_segment", fused, per_layer,
                      (x, *flat), nxt())
        out[arch] = st.rows
        print(f"  {arch} backwards (op / plain ms summed, worst rel): "
              + "; ".join(f"{k} {r['launches']}x {r['bwd_ms']:.4f} / "
                          f"{r['plain_bwd_ms']:.4f} {r['max_rel']:.1e}"
                          for k, r in st.rows.items()))
    return out


# ---------------------------------------------------------------------------
# the detector loop: train/detector.py end to end on the kernels
# ---------------------------------------------------------------------------

def _first_diff(a, b):
    """The path of the first leaf where trees ``a`` and ``b`` differ
    (dtype, shape or any bit, compared on the CPU), else None."""
    import torch
    from repro_torch.optim.adamw import tree_leaves
    fa, fb = tree_leaves(a), tree_leaves(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return "the tree's paths"
    for (path, x), (_, y) in zip(fa, fb):
        if not torch.equal(x.cpu(), y.cpu()) or x.dtype != y.dtype:
            return path
    return None


def loop_split(rep):
    """Steady ms a step of a TrainReport's loop: host time of the data
    (the generator), of the step (its launches, behind the card only
    where the launch queue fills) and of the metric drains (each one
    waits for the card), the first step (which loads the kernels)
    excluded but the drains over every step."""
    hist = rep.history[1:]
    data = statistics.fmean(h["data_s"] for h in hist) * 1e3
    step = statistics.fmean(h["dt_s"] - h["data_s"] for h in hist) * 1e3
    drain = rep.drain_s / len(rep.history) * 1e3
    return {"data_ms": data, "step_ms": step, "drain_ms": drain,
            "total_ms": data + step + drain}


def _loss_means(rep):
    """(the losses, the mean of the first 10, the mean of the last 10)."""
    losses = [h["loss"] for h in rep.history]
    return losses, statistics.fmean(losses[:10]), statistics.fmean(
        losses[-10:])


def step_repeatable(step, state, scene):
    """Two steps from one state on one scene give the same bits."""
    a, _ = step(state, scene)
    b, _ = step(state, scene)
    return _first_diff(a, b)


def gate_run(dev, fails, log):
    """The reference's train-smoke gate (examples/train_detector.py:
    56-83) on TRAIN_CONFIGS["detector_smoke_cuda"]: 300 steps at batch 8
    on the reduced config, then a resume from step GATE_RESUME_AT."""
    import math
    import tempfile
    from repro_torch.configs.registry import TRAIN_CONFIGS
    from repro_torch.kernels import build
    from repro_torch.train import detector as DT
    tc = TRAIN_CONFIGS["detector_smoke_cuda"]
    with tempfile.TemporaryDirectory() as d:
        build.reset_launches()
        t0 = time.perf_counter()
        rep = DT.train_detector(tc, ckpt_dir=d, log=log, device=dev)
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        t1 = time.perf_counter()
        resumed = DT.resume_from(tc, d, at_step=GATE_RESUME_AT, log=log,
                                 device=dev)
        resume_s = time.perf_counter() - t1
    losses, l0, l1 = _loss_means(rep)
    diff = _first_diff(rep.state, resumed)
    cfg = rep.snn_cfg
    opt_cfg, sched = DT._recipe(tc)
    scene = DT.make_data_fn(tc, cfg, device=dev)(0)
    repeat = step_repeatable(DT.make_detector_train_step(cfg, opt_cfg, sched),
                             rep.state, scene)
    out = {"config": tc.name, "steps": tc.steps, "batch": tc.batch,
           "frame": [cfg.height, cfg.width], "time_steps": cfg.time_steps,
           "loss_first10": l0, "loss_last10": l1, "ap_before": rep.ap_before,
           "ap_after": rep.ap_after, "sparsity": rep.sparsity,
           "resume_at": GATE_RESUME_AT, "resume_bit_equal": diff is None,
           "resume_first_diff": diff, "step_repeatable": repeat is None,
           "wall_s": wall, "resume_s": resume_s, **loop_split(rep),
           "launches": launches}
    print(f"  gate ({tc.name}, {tc.steps} steps, batch {tc.batch}, "
          f"{cfg.height}x{cfg.width}): loss {l0:.4f} -> {l1:.4f}, AP@0.5 "
          f"{rep.ap_before:.4f} -> {rep.ap_after:.4f}, sparsity "
          f"{rep.sparsity:.4f}; resume from {GATE_RESUME_AT} bit-equal "
          f"{diff is None} (first diff {diff}), a step repeatable "
          f"{repeat is None} ({repeat}); {wall:.1f} s; ms a step: data "
          f"{out['data_ms']:.3f} step {out['step_ms']:.3f} drain "
          f"{out['drain_ms']:.3f}; launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        fails.append("gate: a non-finite loss")
    if l1 > GATE_LOSS_RATIO * l0:
        fails.append(f"gate: loss did not halve: {l0:.4f} -> {l1:.4f}")
    if rep.ap_before > GATE_AP_BEFORE_MAX:
        fails.append(f"gate: untrained AP@0.5 {rep.ap_before:.4f} > "
                     f"{GATE_AP_BEFORE_MAX}")
    if rep.ap_after < GATE_AP_AFTER_MIN or rep.ap_after <= rep.ap_before:
        fails.append(f"gate: AP@0.5 {rep.ap_before:.4f} -> "
                     f"{rep.ap_after:.4f} (bar {GATE_AP_AFTER_MIN})")
    if diff is not None:
        fails.append(f"gate: resume from step {GATE_RESUME_AT} differs at "
                     f"{diff} (a step repeatable: {repeat is None}, first "
                     f"diff {repeat})")
    need = TRAIN_ROUTE_KERNELS["per_op"]
    if not all(launches.get(k, 0) > 0 for k in need):
        fails.append(f"gate: launches {launches}, need {need}")
    return out


def checkpoint_round_trip(state, fails):
    """A full-width save (its synchronous stall: the host gather and the
    writer's start), the background write, a restore onto the card's
    state and one onto a CPU copy, each bit-equal."""
    import tempfile
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    leaves = [x for _, x in tree_leaves(state)]
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=1, async_write=True)
        stalls = []
        for step in (1, 2, 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cm.save(step, state)
            stalls.append((time.perf_counter() - t0) * 1e3)
            t1 = time.perf_counter()
            cm.wait()
            write_ms = (time.perf_counter() - t1) * 1e3
        t0 = time.perf_counter()
        card = cm.restore(like=state)
        torch.cuda.synchronize()
        restore_card_ms = (time.perf_counter() - t0) * 1e3
        cpu_like = tree_unflatten(state, [x.cpu() for x in leaves])
        t0 = time.perf_counter()
        host = cm.restore(like=cpu_like)
        restore_cpu_ms = (time.perf_counter() - t0) * 1e3
    on_card = all(x.is_cuda for _, x in tree_leaves(card))
    on_cpu = all(not x.is_cuda for _, x in tree_leaves(host))
    d_card, d_cpu = _first_diff(state, card), _first_diff(state, host)
    out = {"bytes": nbytes, "leaves": len(leaves), "save_stall_ms": stalls,
           "write_ms": write_ms, "restore_card_ms": restore_card_ms,
           "restore_cpu_ms": restore_cpu_ms,
           "card_bit_equal": d_card is None and on_card,
           "cpu_bit_equal": d_cpu is None and on_cpu}
    print(f"  checkpoint: {nbytes / 2**20:.1f} MiB in {len(leaves)} "
          f"leaves; save stall {', '.join(f'{s:.2f}' for s in stalls)} ms, "
          f"background write {write_ms:.1f} ms; restore onto the card "
          f"{restore_card_ms:.1f} ms (bit-equal {d_card is None}, on the "
          f"card {on_card}), onto the CPU {restore_cpu_ms:.1f} ms "
          f"(bit-equal {d_cpu is None}, on the CPU {on_cpu})")
    if not out["card_bit_equal"]:
        fails.append(f"checkpoint: restore onto the card differs at "
                     f"{d_card} (on the card: {on_card})")
    if not out["cpu_bit_equal"]:
        fails.append(f"checkpoint: restore onto the CPU differs at {d_cpu} "
                     f"(on the CPU: {on_cpu})")
    return out


def full_width_run(dev, fails, log):
    """TRAIN_CONFIGS["detector"] on "cuda" at full width over a
    FULL_STEPS horizon, its checkpoints in a temporary directory; a
    step's launches and device profile; a checkpoint round trip."""
    import tempfile
    import torch
    from repro_torch.configs.registry import TRAIN_CONFIGS
    from repro_torch.kernels import build
    from repro_torch.train import detector as DT
    tc = dataclasses.replace(TRAIN_CONFIGS["detector"], backend="cuda",
                             steps=FULL_STEPS)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rep = DT.train_detector(tc, ckpt_dir=d, log=log, device=dev)
        wall = time.perf_counter() - t0
    losses, l0, l1 = _loss_means(rep)
    cfg = rep.snn_cfg
    opt_cfg, sched = DT._recipe(tc)
    step = DT.make_detector_train_step(cfg, opt_cfg, sched)
    data = DT.make_data_fn(tc, cfg, device=dev)
    scene = data(0)
    torch.cuda.synchronize()
    build.reset_launches()
    step(rep.state, scene)
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    want = {k: v for k, v in npu_launches_per_tick(cfg).items() if v}
    prof_wall, busy, dev_ops, _ = profile_window(
        lambda: step(rep.state, scene), 2)
    data_ms = time_host(lambda: data(1))
    out = {"config": tc.name, "steps": tc.steps, "batch": tc.batch,
           "frame": [cfg.height, cfg.width], "time_steps": cfg.time_steps,
           "base_channels": cfg.base_channels, "stages": cfg.num_stages,
           "loss_first10": l0, "loss_last10": l1,
           "ap_before": rep.ap_before, "ap_after": rep.ap_after,
           "sparsity": rep.sparsity, "wall_s": wall, **loop_split(rep),
           "data_alone_ms": data_ms, "launches_a_step": launches,
           "launches_want": want, "device_ops_a_step": dev_ops,
           "device_busy_ms": busy, "profiled_wall_ms": prof_wall}
    print(f"  full width ({cfg.name} {cfg.height}x{cfg.width}, T "
          f"{cfg.time_steps}, batch {tc.batch}, {tc.steps} steps): loss "
          f"{l0:.4f} -> {l1:.4f}, AP@0.5 {rep.ap_before:.4f} -> "
          f"{rep.ap_after:.4f}, sparsity {rep.sparsity:.4f}; {wall:.1f} s; "
          f"ms a step: data {out['data_ms']:.3f} step "
          f"{out['step_ms']:.3f} drain {out['drain_ms']:.3f} (total "
          f"{out['total_ms']:.3f}); the generator alone {data_ms:.3f} ms; "
          f"a step: launches {launches} (want {want}), {dev_ops:.0f} "
          f"device ops, busy {busy:.2f} of {prof_wall:.2f} ms profiled")
    if not l1 < FULL_LOSS_RATIO * l0:
        fails.append(f"full width: loss {l0:.4f} -> {l1:.4f}, not under "
                     f"{FULL_LOSS_RATIO}x")
    if launches != want:
        fails.append(f"full width: a step launched {launches}, the "
                     f"forward's are {want}")
    out["checkpoint"] = checkpoint_round_trip(rep.state, fails)
    return out


def time_host(fn, reps=10):
    """Median host ms of ``fn()`` ended by a synchronise."""
    import torch
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def classify_check(dev, fails):
    """The classification head (detect off) at full width, batch 8, on
    the four archs: the kernel backend's logits against the plain
    backend's on the same weights and voxels, the forward's launches."""
    import torch
    from repro_torch.configs.registry import SNN_ARCHS
    from repro_torch.core.encoding import voxel_batch
    from repro_torch.core.npu import init_npu, npu_forward
    from repro_torch.data.synthetic import make_scene_batch
    from repro_torch.kernels import build
    out = {}
    for arch, base in SNN_ARCHS.items():
        kcfg = dataclasses.replace(base, detect=False, backend="cuda")
        pcfg = dataclasses.replace(kcfg, backend="torch")
        params = init_npu(torch.Generator().manual_seed(0), kcfg, device=dev)
        scene = make_scene_batch(torch.Generator().manual_seed(21),
                                 batch=BATCH, height=kcfg.height,
                                 width=kcfg.width,
                                 time_steps=kcfg.time_steps, device=dev)
        vox = voxel_batch(scene.events, time_steps=kcfg.time_steps,
                          height=kcfg.height, width=kcfg.width)
        with torch.no_grad():
            build.reset_launches()
            k = npu_forward(params, vox, kcfg).raw_pred
            torch.cuda.synchronize()
            launches = {n: v for n, v in build.LAUNCHES.items() if v}
            p = npu_forward(params, vox, pcfg).raw_pred
        err = float((k - p).abs().max())
        want = {n: v for n, v in npu_launches_per_tick(kcfg).items() if v}
        ok = (tuple(k.shape) == (BATCH, kcfg.num_classes)
              and bool(torch.isfinite(k).all()) and err <= CLASSIFY_TOL)
        out[arch] = {"max_abs_err": err, "launches": launches,
                     "launches_want": want,
                     "logit_range": [float(p.min()), float(p.max())]}
        print(f"  classify {arch}: logits {tuple(k.shape)}, kernel vs plain "
              f"max |diff| {err:.3g} (bar {CLASSIFY_TOL}), launches "
              f"{launches}")
        if not ok:
            fails.append(f"classify {arch}: logits {tuple(k.shape)}, "
                         f"max |diff| {err:.3g}")
        if launches != want:
            fails.append(f"classify {arch}: launches {launches}, want "
                         f"{want}")
    return out


def detector_phase(dev, card):
    """Phase 5c: the reduced train-smoke gate, the full-width run, the
    classification head, on the untuned (per-op) route.  Every check
    runs before the phase fails on the first of them."""
    from repro_torch.kernels import tune

    def log(msg):
        print(f"    {msg}")
    fails = []
    report = {"card": card}
    with tune.off():
        report["gate"] = gate_run(dev, fails, log)
        report["full"] = full_width_run(dev, fails, log)
        report["classify"] = classify_check(dev, fails)
    check(not fails, "detector phase: " + "; ".join(fails))
    return report


# ---------------------------------------------------------------------------
# Phase 5d: data parallelism
# ---------------------------------------------------------------------------

def dist_fleet_check(params, cfg, dev, card, mesh, label):
    """The fleet on ``mesh`` against the one-device fleet, full-width
    spiking-YOLO at batch BATCH on ENCODING_CONFIGS["cuda"] and each of
    ISP_CONFIGS["cuda"] and ["fused"], untuned (per-op) route: one
    staged tick's launches (the mesh's: the one-device count times its
    shards), then DIST_ROUNDS rounds of REQUESTS requests through both
    engines in turns, every request within E2E_DIST_TOL of the
    one-device fleet's, the step p50/p99 of each."""
    import numpy as np
    import torch
    from repro_torch.configs.base import FleetConfig
    from repro_torch.configs.registry import ENCODING_CONFIGS, ISP_CONFIGS
    from repro_torch.kernels import build, tune
    from repro_torch.serve.cognitive_engine import PerceptionRequest
    from repro_torch.serve.fleet import FleetEngine
    from repro_torch.serve.scheduler import RequestStatus
    from repro_torch.serve.transport import stage_request, validate_request

    reqs = fleet_requests(cfg)
    report = {}
    for isp in ("cuda", "fused"):
        kw = dict(isp_cfg=ISP_CONFIGS[isp], enc_cfg=ENCODING_CONFIGS["cuda"],
                  device=dev, fleet_cfg=FleetConfig(batch=BATCH))
        with tune.off():
            engines = {"one": FleetEngine(params, cfg, mesh=None, **kw),
                       "mesh": FleetEngine(params, cfg, mesh=mesh, **kw)}
        shards = engines["mesh"].core.n_devices
        check(shards > 1, f"dist fleet {label}: {shards} shards")
        check(all(s.buffer.is_pinned() for b in
                  engines["mesh"].buffers.banks for s in b.shards),
              f"dist fleet {label}: a shard's staging bank is not pinned")
        counts = {}
        for name, f in engines.items():
            bank = f._bank()
            for i, r in enumerate(reqs[:BATCH]):
                stage_request(bank, i, r, validate_request(r, 2),
                              f.core.enc_cfg)
            f.core.tick(bank)                       # warm-up
            torch.cuda.synchronize()
            build.reset_launches()                  # counts to 0 ...
            f.core.tick(bank)
            torch.cuda.synchronize()
            counts[name] = {k: v for k, v in build.LAUNCHES.items() if v}
        want = {k: shards * v for k, v in counts["one"].items()}
        check(counts["one"] and counts["mesh"] == want,
              f"dist fleet {label} {isp}: launches a tick {counts['mesh']}, "
              f"want {want}")
        steps = {name: [] for name in engines}
        results = {name: {} for name in engines}
        for rnd in range(DIST_ROUNDS):
            order = list(engines.items())
            if rnd % 2:
                order.reverse()
            base = REQUESTS * (rnd % (FLEET_REQUESTS // REQUESTS))
            for name, f in order:
                subs = [f.submit(PerceptionRequest(
                    rid=rnd * 1000 + r.rid, voxels=r.voxels, bayer=r.bayer,
                    events=r.events)) for r in reqs[base:base + REQUESTS]]
                while len(f.queue) or f._inflight is not None:
                    f.step()
                    steps[name].append(f.last_tick_s * 1e3)
                torch.cuda.synchronize()
                check(all(s.status is RequestStatus.DONE for s in subs),
                      f"dist fleet {label} {isp} {name}: statuses "
                      f"{[s.status.value for s in subs]}")
                results[name].update({s.rid: s.request.result for s in subs})
        diff = {fld: max(float(np.abs(
            np.asarray(getattr(results["mesh"][rid], fld))
            - np.asarray(getattr(results["one"][rid], fld))).max())
            for rid in results["one"]) for fld in ("raw_pred", "control",
                                                   "rgb")}
        check(all(v <= E2E_DIST_TOL for v in diff.values()),
              f"dist fleet {label} {isp}: max|mesh - one device| {diff}")

        def pct(xs, p):
            xs = sorted(xs)
            return xs[min(len(xs) - 1, int(p * len(xs)))]
        row = {"shards": shards, "devices": [str(d) for d in mesh.devices],
               "launches_a_tick": counts["mesh"],
               "launches_a_tick_one_device": counts["one"],
               "max_abs_diff_to_one_device": diff,
               "requests": DIST_ROUNDS * REQUESTS,
               **{f"step_{p}_ms{'' if n == 'mesh' else '_one_device'}":
                  pct(steps[n], q) for n in engines
                  for p, q in (("p50", 0.5), ("p99", 0.99))},
               "steps": len(steps["mesh"]),
               "steps_one_device": len(steps["one"])}
        report[isp] = row
        print(f"  dist fleet {label} ISP {isp} ({card}): launches a tick "
              f"{counts['mesh']} (one device {counts['one']})")
        print(f"  dist fleet {label} ISP {isp} ({card}): step p50 "
              f"{row['step_p50_ms']:.3f} ms p99 {row['step_p99_ms']:.3f} ms "
              f"over {row['steps']} steps; one device p50 "
              f"{row['step_p50_ms_one_device']:.3f} ms p99 "
              f"{row['step_p99_ms_one_device']:.3f} ms over "
              f"{row['steps_one_device']} steps (in turns)")
        print(f"  dist fleet {label} ISP {isp} ({card}): "
              f"{row['requests']} requests each, max|mesh - one device| "
              f"{diff}")
        del engines
    return report


def _flat(tree):
    import torch
    from repro_torch.optim.adamw import tree_leaves
    return torch.cat([x.detach().float().reshape(-1)
                      for _, x in tree_leaves(tree)])


def dist_rank_checks(rank, world, backend, dev):
    """One rank's half of the training checks (collective: every rank
    runs every step).  Returns rank 0's report, None elsewhere."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.configs.registry import TRAIN_CONFIGS
    from repro_torch.core.train import detection_loss, value_and_grad
    from repro_torch.distributed.compress import (
        dequantize_int8, make_manual_dp_train_step, quantize_int8)
    from repro_torch.distributed.pipeline_parallel import pipeline_forward
    from repro_torch.distributed.sharding import (MeshAxes, from_mesh,
                                                  maybe_all_gather,
                                                  rank_mesh, tree_map)
    from repro_torch.kernels import build, tune
    from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                         tree_leaves, tree_unflatten)
    from repro_torch.train import detector as DT

    comm = torch.device("cpu") if backend == "gloo" else dev

    def gather(x, group):
        return maybe_all_gather(x.detach().float().reshape(1, -1).to(comm),
                                group, 0).cpu()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    lead = rank == 0
    report = {"world": world, "backend": backend}
    with tune.off():
        tc = dc.replace(TRAIN_CONFIGS["detector"], backend="cuda",
                        batch=BATCH)
        cfg = DT.resolve_snn_config(tc)
        opt, sched = DT._recipe(tc)
        mesh = rank_mesh((world,), ("data",))
        pods = rank_mesh((world, 1), ("pod", "data"))
        ax = from_mesh(mesh)
        group = mesh.group("data")
        init = DT.init_detector_state(torch.Generator().manual_seed(
            tc.seed), cfg, opt, dev)
        glob = DT.make_data_fn(tc, cfg, device=dev)

        # the detector's data-parallel step
        state = DT.replicate_state(init, ax)
        data = DT.make_data_fn(tc, cfg, ax, dev)
        (loss_dp, _, grads_dp), _ = timed(lambda: DT.data_parallel_grads(
            state.params, data(0), cfg, ax))
        step = DT.make_detector_train_step(cfg, opt, sched, ax)
        build.reset_launches()
        losses, ms = [], []
        for s in range(DIST_STEPS):
            scene = data(s)
            (state, m), dt = timed(lambda: step(state, scene))
            losses.append(float(m["loss"]))
            ms.append(dt)
        launches = {k: v for k, v in build.LAUNCHES.items() if v}
        every = gather(_flat(state), group)
        if lead:
            ref_loss, _, ref_grads = value_and_grad(detection_loss,
                                                    init.params, glob(0), cfg)
            g, r = _flat(grads_dp), _flat(ref_grads)
            one = DT.make_detector_train_step(cfg, opt, sched)
            rstate, ref_losses, ref_ms = init, [], []
            for s in range(DIST_STEPS):
                scene = glob(s)
                (rstate, m), dt = timed(lambda: one(rstate, scene))
                ref_losses.append(float(m["loss"]))
                ref_ms.append(dt)
            rel = [abs(a - b) / abs(b) for a, b in zip(
                [float(loss_dp)] + losses, [float(ref_loss)] + ref_losses)]
            report["detector"] = {
                "losses": losses, "losses_one_process": ref_losses,
                "max_loss_rel_diff": max(rel),
                "grad_rel_l2": float((g - r).norm() / r.norm()),
                "ranks_bit_equal": all(torch.equal(every[i], every[0])
                                       for i in range(world)),
                "state_max_abs_diff_to_one_process": float(
                    (every[0] - _flat(rstate).cpu()).abs().max()),
                "host_ms_a_step": ms, "host_ms_a_step_one_process": ref_ms,
                "launches_rank0": launches}

        # the manual data-parallel step, int8 over "pod"
        pax = MeshAxes(pods, dp=("pod", "data"))

        def loss_fn(p, scene):
            return detection_loss(p, scene, cfg)

        def update(p, gr, o):
            return adamw_update(p, gr, o, opt)
        mstep = make_manual_dp_train_step(loss_fn, pax, update)
        p, o = init.params, adamw_init(init.params, opt)
        ef = tree_map(lambda x: torch.zeros(x.shape, dtype=torch.bfloat16,
                                            device=dev), p)
        mlosses, first = [], None
        for s in range(DIST_STEPS):
            scene = glob(s)
            p, o, ef, m = mstep(p, o, ef, scene)
            mlosses.append(float(m["loss"]))
            if first is None:
                first = p
        every = gather(_flat(first), pods.group(("pod", "data")))
        if lead:
            scene = glob(0)
            rows = BATCH // world
            shard_g, shard_l = [], []
            for k in range(world):
                sl, _, sg = value_and_grad(detection_loss, init.params,
                                           tree_map(lambda x: x[k * rows:(
                                               k + 1) * rows], scene), cfg)
                shard_g.append([x for _, x in tree_leaves(sg)])
                shard_l.append(float(sl))
            grads = []
            for leaves in zip(*shard_g):
                deq = [dequantize_int8(*quantize_int8(x), x.shape)
                       for x in leaves]
                grads.append(sum(deq) / world)
            want, _, _ = adamw_update(init.params, tree_unflatten(
                init.params, grads), adamw_init(init.params, opt), opt)
            report["manual_dp"] = {
                "losses": mlosses, "finite": bool(np.isfinite(mlosses).all()),
                "loss_replay_rel_diff": abs(mlosses[0] - np.mean(shard_l))
                / abs(np.mean(shard_l)),
                "step1_max_abs_diff_to_replay": float(
                    (every[0] - _flat(want).cpu()).abs().max()),
                "ranks_bit_equal": all(torch.equal(every[i], every[0])
                                       for i in range(world))}

    # the pipeline ring on the card's tensors
    rng = np.random.default_rng(0)
    S, M, d = world, 8, 16
    Ws = torch.from_numpy(rng.normal(0, 0.3, (S, d, d)).astype(
        np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(0, 1, (M, 2, d)).astype(np.float32)).to(
        dev)
    try:
        y = pipeline_forward(lambda q, h: torch.tanh(h @ q["w"]),
                             {"w": Ws}, x, group)
        ref = x
        for s in range(S):
            ref = torch.tanh(ref @ Ws[s])
        pipe = {"max_abs_err": float((y - ref).abs().max())}
    except RuntimeError as e:
        why = str(e).splitlines()[0] if str(e) else ""
        if not gloo_refused_cuda(backend, why):
            raise
        print(f"  dist pipeline rank {rank}: {backend} refused CUDA "
              f"tensors in batch_isend_irecv: {why}", flush=True)
        pipe = {"not_run": f"{backend} refused CUDA tensors in "
                           f"batch_isend_irecv: {why}"}
    report["pipeline"] = pipe
    return report if lead else None


def gloo_refused_cuda(backend, why):
    """True when ``why`` (an error's first line) is gloo's TCP transport
    failing on CUDA tensors: nothing else may turn the pipeline's card
    check into "not run"."""
    return (backend == "gloo" and "gloo/transport" in why
            and any(e in why for e in GLOO_CUDA_P2P_ERRORS))


def dist_worker(rank, world, backend, store, out, devices):
    """A spawned rank of the training checks: the card ``devices[rank]``,
    the process group through the file store ``store``; rank 0 writes its
    report as JSON to ``out``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", devices[rank])
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        report = dist_rank_checks(rank, world, backend, dev)
        if report is not None:
            Path(out).write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def dist_train_check(card, devices, backend, label):
    """Spawn ``len(devices)`` ranks (``torch.multiprocessing``) and hold
    their report: the detector's data-parallel step within
    DIST_LOSS_RTOL (loss) and DIST_GRAD_RTOL (gradients' relative L2)
    of the one-process step on the same route, its state after
    DIST_STEPS steps within DIST_STATE_TOL of the one-process state,
    every rank's state bit-equal; the manual data-parallel step finite, its first step
    within DIST_REPLAY_TOL of a one-process replay, ranks bit-equal; the
    pipeline ring within 1e-5, or why it did not run."""
    import tempfile
    import torch.multiprocessing as mp
    world = len(devices)
    tmp = Path(tempfile.mkdtemp(prefix="dist-", dir=ROOT / "build"))
    out = tmp / "report.json"
    t0 = time.perf_counter()
    mp.spawn(dist_worker, args=(world, backend, str(tmp / "store"),
                                str(out), list(devices)),
             nprocs=world, join=True)
    wall = time.perf_counter() - t0
    rep = json.loads(out.read_text())
    shutil.rmtree(tmp, ignore_errors=True)
    det, man, pipe = rep["detector"], rep["manual_dp"], rep["pipeline"]
    print(f"  dist detector step {label} ({card}): losses {det['losses']} "
          f"(one process {det['losses_one_process']}), max loss rel diff "
          f"{det['max_loss_rel_diff']:.3g}, gradients' rel L2 "
          f"{det['grad_rel_l2']:.3g}, ranks bit-equal "
          f"{det['ranks_bit_equal']}, state vs one process "
          f"{det['state_max_abs_diff_to_one_process']:.3g}")
    print(f"  dist detector step {label} ({card}): host ms a step "
          f"{[round(v, 3) for v in det['host_ms_a_step']]} (one process "
          f"{[round(v, 3) for v in det['host_ms_a_step_one_process']]}); "
          f"rank 0's launches over {DIST_STEPS} steps "
          f"{det['launches_rank0']}")
    print(f"  dist manual-DP step {label} ({card}): losses {man['losses']}, "
          f"step 1 vs replay {man['step1_max_abs_diff_to_replay']:.3g}, "
          f"loss vs replay {man['loss_replay_rel_diff']:.3g}, ranks "
          f"bit-equal {man['ranks_bit_equal']}")
    print(f"  dist pipeline {label} ({card}): {pipe}")
    print(f"  dist ranks {label} ({card}): {world} ranks, {wall:.1f} s "
          f"with start-up")
    check(det["max_loss_rel_diff"] <= DIST_LOSS_RTOL
          and det["grad_rel_l2"] <= DIST_GRAD_RTOL
          and det["state_max_abs_diff_to_one_process"] <= DIST_STATE_TOL
          and det["ranks_bit_equal"],
          f"dist detector step {label}: {det}")
    check(man["finite"] and man["ranks_bit_equal"]
          and man["step1_max_abs_diff_to_replay"] <= DIST_REPLAY_TOL
          and man["loss_replay_rel_diff"] <= DIST_LOSS_RTOL,
          f"dist manual-DP step {label}: {man}")
    check("not_run" in pipe or pipe["max_abs_err"] <= 1e-5,
          f"dist pipeline {label}: {pipe}")
    rep["wall_s"] = wall
    return rep


def dist_phase(params, cfg, dev, card):
    """Phase 5d: data parallelism on the card.  The fleet on an explicit
    two-entry mesh [cuda:0, cuda:0] against the one-device fleet; the
    detector's data-parallel step, the manual data-parallel step and the
    pipeline ring on 2 ranks spawned on the one card over gloo with CUDA
    tensors (NCCL refuses two ranks on one device); with 2+ cards the
    same on real cards with NCCL, and the fleet on ``mesh="auto"``.
    Returns the report (one "dist" line)."""
    import torch
    from repro_torch.distributed.sharding import local_mesh
    report = {"card": card, "visible": torch.cuda.device_count()}
    report["fleet_one_card"] = dist_fleet_check(
        params, cfg, dev, card, local_mesh([dev, dev]), "[cuda:0, cuda:0]")
    report["train_one_card"] = dist_train_check(card, [0, 0], "gloo",
                                                "gloo x2 on cuda:0")
    n = torch.cuda.device_count()
    if n >= 2:
        from repro_torch.launch.mesh import make_serving_mesh
        report["fleet_cards"] = dist_fleet_check(
            params, cfg, dev, card, make_serving_mesh(BATCH),
            'mesh="auto"')
        report["train_cards"] = dist_train_check(card, [0, 1], "nccl",
                                                 "nccl on cuda:0, cuda:1")
    else:
        print(f"  dist on several cards ({card}): not run: "
              f"{n} card visible (NCCL ranks and mesh=\"auto\" need 2+)")
        report["several_cards"] = "not run: one card visible"
    return report


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.configs.registry import SNN_ARCHS
    from repro_torch.core.npu import init_npu
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernel_archs = sys.argv[2:] if sys.argv[1:2] == ["--kernel-phase"] \
        else None
    flash_only = sys.argv[1:] == ["--flash-phase"]
    norm_only = sys.argv[1:] == ["--norm-phase"]
    conv_lif_only = sys.argv[1:] == ["--conv-lif-phase"]
    segment_only = sys.argv[1:] == ["--segment-phase"]
    isp_pool_only = sys.argv[1:] == ["--isp-pool-phase"]
    train_only = sys.argv[1:] == ["--train-phase"]
    detector_only = sys.argv[1:] == ["--detector-phase"]
    dist_only = sys.argv[1:] == ["--dist-phase"]
    moe_only = sys.argv[1:] == ["--moe-phase"]
    if sys.argv[1:] and not kernel_archs and not flash_only \
            and not norm_only and not conv_lif_only and not segment_only \
            and not isp_pool_only and not train_only and not detector_only \
            and not dist_only and not moe_only:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[1/7] device: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")

    t0 = time.perf_counter()
    built = (["flash_attention"] if flash_only or moe_only else
             ["norm_affine_lif"] if norm_only else
             ["spike_conv_lif", "spike_conv", "norm_affine_lif"]
             if conv_lif_only else
             ["backbone_segment", "spike_conv", "norm_affine_lif",
              "spike_dwconv", "max_pool"] if segment_only
             else ["isp_fused", "max_pool"] if isp_pool_only
             else list(NPU_KERNELS) if train_only or detector_only
             else list(NPU_KERNELS) + ["event_voxel", "demosaic", "nlm",
                                       "isp_fused"] if dist_only
             else list(build.SOURCES))
    build.build_all(built)
    print(f"[2/7] build: {time.perf_counter() - t0:.1f} s")
    for name in built:
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: {' | '.join(regs)}")

    dev = torch.device("cuda")
    if flash_only:
        print(json.dumps({"flash_phase": flash_phase(dev, card)}))
        return 0
    if moe_only:
        t0 = time.perf_counter()
        _, _, moe_report = moe_phase(dev, card)
        print(f"  MoE phase: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"moe": moe_report}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if detector_only:
        t0 = time.perf_counter()
        report = detector_phase(dev, card)
        print(f"  detector phase: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"detector": report}))
        return 0
    cfg = dataclasses.replace(SNN_ARCHS["spiking_yolo"], backend="cuda")
    params = init_npu(torch.Generator().manual_seed(0), cfg, device=dev)
    if dist_only:
        t0 = time.perf_counter()
        report = dist_phase(params, cfg, dev, card)
        print(f"  dist phase: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"dist": report}))
        return 0
    archs = {}
    for arch in NEW_ARCHS:
        acfg = dataclasses.replace(SNN_ARCHS[arch], backend="cuda")
        archs[arch] = (init_npu(torch.Generator().manual_seed(0), acfg,
                                device=dev), acfg)
    if isp_pool_only:
        print(json.dumps({"isp_pool_phase": isp_pool_phase(archs, dev,
                                                           card)}))
        return 0
    if norm_only:
        print(json.dumps({"norm_phase": norm_phase(
            {"spiking_yolo": (params, cfg), **archs}, dev, card)}))
        return 0
    if conv_lif_only:
        print(json.dumps({"conv_lif_phase": conv_lif_phase(
            {"spiking_yolo": (params, cfg), **archs}, dev, card)}))
        return 0
    if train_only:
        t0 = time.perf_counter()
        report = train_phase({"spiking_yolo": (params, cfg), **archs}, dev,
                             card)
        print(f"  train phase: {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"train": report}))
        return 0
    reqs = make_requests(cfg, np.random.default_rng(0))
    vox = torch.stack([torch.as_tensor(r.voxels)
                       for r in reqs[:BATCH]], dim=1).to(dev)
    if segment_only:
        print(json.dumps({"segment_phase": segment_phase(
            {"spiking_yolo": (params, cfg), **archs}, vox), "card": card}))
        return 0
    if kernel_archs:
        all_archs = {"spiking_yolo": (params, cfg), **archs}
        for arch in kernel_archs:
            print(f"  --- {arch} (full width, batch {BATCH}), layer by layer")
            sts = kernel_phase(*all_archs[arch], vox)
            print(json.dumps({arch: {k: s.summary() for k, s in sts.items()
                                     if s.shapes}}))
        return 0

    from repro_torch.core.backbones import fused_route_segments, layer_runs
    from repro_torch.kernels.backbone_fuse import describe_plan
    print("[3/7] per-kernel parity on the main path's inputs "
          f"(batch {BATCH}); segment plans at the default budget:")
    for arch, (_, c) in {"spiking_yolo": (params, cfg), **archs}.items():
        plans = " | ".join(describe_plan(sp, H=h, W=w, T=c.time_steps)
                           for sp, h, w in layer_runs(c))
        n_seg = len(fused_route_segments(c, BATCH))
        print(f"  {arch}: {plans}  ({n_seg} on the fused route)")
        check(n_seg == SEGMENTS_PER_TICK[arch], f"{arch}: {n_seg} fused-route "
              f"segments, want {SEGMENTS_PER_TICK[arch]}")
    st = kernel_phase(params, cfg, vox)
    tick_st, tick_rows = tick_kernel_phase(params, cfg, reqs, dev,
                                           st["lif_scan"])
    st.update(tick_st)
    fused_st, preview_counts = fused_isp_phase(params, cfg, reqs, dev,
                                               card, tick_rows)
    st.update(fused_st)
    arch_st = {"spiking_yolo": {k: st[k] for k in NPU_KERNELS}}
    for arch, (p, acfg) in archs.items():
        print(f"  --- {arch} (full width, batch {BATCH}), layer by layer")
        arch_st[arch] = kernel_phase(p, acfg, vox)
    grid_cap_check(*archs["spiking_vgg"], vox)
    batch_cap_phase(dev)
    # the new kernels' rows: spike_dwconv on MobileNet's forward, max_pool
    # on VGG's and DenseNet's
    st["spike_dwconv"] = arch_st["spiking_mobilenet"]["spike_dwconv"]
    st["max_pool"] = KernelStats().merge(
        arch_st["spiking_vgg"]["max_pool"]).merge(
        arch_st["spiking_densenet"]["max_pool"])
    # the segment kernel's row: every fused-route segment of the four archs
    st["backbone_segment"] = KernelStats()
    for sts in arch_st.values():
        st["backbone_segment"].merge(sts["backbone_segment"])
    print("[4/7] timings (ms per tick, medians of CUDA-event runs)")
    for name, s in st.items():
        print(f"  {name}: kernel {s.ms:.4f} plain {s.plain_ms:.4f} "
              f"library {s.library_ms} bound {s.bound_ms:.4f} over "
              f"{len(s.shapes)} launches"
              + (f" (per-op pair {s.per_op_ms:.4f})" if s.per_op_ms else ""))
    for arch, sts in arch_st.items():
        for name, s in sts.items():
            if s.shapes:
                print(f"  {arch} {name}: kernel {s.ms:.4f} plain "
                      f"{s.plain_ms:.4f} library {s.library_ms} bound "
                      f"{s.bound_ms:.4f} over {len(s.shapes)} launches"
                      + (f" (per-op pair {s.per_op_ms:.4f})"
                         if s.per_op_ms else ""))
    large_isp_line(dev)
    pointwise_shapes_line(dev, card)
    # every stencil segment on a VGA batch, beside the earlier design
    isp_segment_line(*random_isp_inputs(VGA, dev, torch.Generator(
        dev).manual_seed(5)), str(list(VGA)), card)

    print("[5/7] the launch table swept on the card (smoke policy, batch "
          f"{BATCH}); serving: CognitiveEngine, full spiking_yolo and "
          f"{', '.join(NEW_ARCHS)}; the cognitive loop")
    tables = sweep_phase({"spiking_yolo": (params, cfg), **archs}, vox)
    launches, latency = serve_phase(params, cfg, reqs, dev, archs, tables)
    cognitive_phase(params, cfg, reqs, dev)
    fleet_report = fleet_phase(params, cfg, dev, card,
                               tables["spiking_yolo"][0])
    print(f"[5b/7] training: full-width spiking_yolo (batch {BATCH}), "
          f"detect and cognitive steps on the per-op, forced-fused and "
          f"forced-segment routes; rows 1-8's backwards")
    t_train = time.perf_counter()
    train_report = train_phase({"spiking_yolo": (params, cfg), **archs}, dev,
                               card)
    print(f"  train phase: {time.perf_counter() - t_train:.1f} s")
    print("[5c/7] the detector loop: the reduced train-smoke gate "
          "(detector_smoke_cuda, 300 steps, resume from step "
          f"{GATE_RESUME_AT}), full-width detector over {FULL_STEPS} steps "
          "with a checkpoint round trip, the classification head on the "
          "four archs")
    t_det = time.perf_counter()
    detector_report = detector_phase(dev, card)
    print(f"  detector phase: {time.perf_counter() - t_det:.1f} s")
    print("[5d/7] data parallelism: the fleet on a two-entry mesh [cuda:0, "
          "cuda:0] beside the one-device fleet; the detector's and the "
          "manual data-parallel steps on 2 gloo ranks on the card; NCCL "
          "and mesh=\"auto\" where 2+ cards are visible")
    t_dist = time.perf_counter()
    dist_report = dist_phase(params, cfg, dev, card)
    print(f"  dist phase: {time.perf_counter() - t_dist:.1f} s")

    # release the SNN engines' memory before the 15 GB model
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[6/7] LM serving: full-width {LM_ARCH} (bf16, random weights), "
          f"serve_prefill [{LM_BATCH}, {LM_SEQ}] -> serve_decode, "
          f"ServeEngine; {torch.cuda.memory_allocated(dev)} bytes still "
          f"allocated")
    st["flash_attention"], fa_launches, lm_report = lm_phase(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[6b/7] MoE and MLA: full-width {' and '.join(MOE_ARCHS)}, depth "
          f"cut ({MOE_DEPTH}), serve_prefill [{LM_BATCH}, {LM_SEQ}] -> "
          f"serve_decode, ServeEngine; "
          f"{torch.cuda.memory_allocated(dev)} bytes still allocated")
    t_moe = time.perf_counter()
    mla_st, moe_launches, moe_report = moe_phase(dev, card)
    print(f"  MoE phase: {time.perf_counter() - t_moe:.1f} s")

    # launches from the main path that runs each kernel: the all-kernel
    # engines, the fused-ISP engine, fast_preview fused, spiking-YOLO's
    # forced-fused engine
    path_launches = dict(launches["all_kernels"])
    path_launches["isp_stencil_segment"] = \
        launches["fused_isp"]["isp_stencil_segment"]
    path_launches["isp_pointwise_segment"] = \
        preview_counts["isp_pointwise_segment"]
    path_launches["spike_dwconv"] = \
        launches["spiking_mobilenet"]["spike_dwconv"]
    path_launches["max_pool"] = (launches["spiking_vgg"]["max_pool"]
                                 + launches["spiking_densenet"]["max_pool"])
    path_launches["spike_conv_lif"] = \
        launches["all_kernels_fused"]["spike_conv_lif"]
    path_launches["backbone_segment"] = sum(
        launches[n].get("backbone_segment", 0) for n in
        ("all_kernels_segment", *(a + "_segment" for a in archs)))
    path_launches["flash_attention"] = fa_launches
    rows = [st[k].row(k, path_launches[k]) for k in KERNELS]
    # row 14: beside qwen2-7b's (128, 128) "wgmma" prefill, deepseek-v3's
    # (192, 128) instance (its layer 0 timed) and the MoE models' launches
    mla = mla_st.summary()
    rows[list(KERNELS).index("flash_attention")].update({
        "moe_prefill_launches": moe_launches,
        "mla_192_128": {
            "design": moe_report["deepseek-v3-671b"]["design"],
            "launches": moe_launches["deepseek-v3-671b"]["mma_sync"],
            **{k: mla[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "library_ms", "max_abs_err")},
            "bound_by": "operations" if mla_st.ops_s >= mla_st.bytes_s
            else "bytes"}})
    print("[7/7] report")
    print(json.dumps({"serve": {"batch": BATCH, "requests": REQUESTS,
                                "tick_latency": latency}}))
    print(json.dumps({"arch_kernels": {
        arch: {k: s.summary() for k, s in sts.items() if s.shapes}
        for arch, sts in arch_st.items()}}))
    print(json.dumps({"lm": lm_report}))
    print(json.dumps({"moe": moe_report}))
    print(json.dumps({"fleet": {k: fleet_report[k] for k in
                                ("clean", "chaos", "harvest")}}))
    print(json.dumps({"train": train_report}))
    print(json.dumps({"detector": detector_report}))
    print(json.dumps({"dist": dist_report}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
