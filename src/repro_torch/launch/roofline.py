"""Roofline launch estimate and the fused-segment budget for one NVIDIA
H100 SXM, used by ``repro_torch.kernels.tune`` to RANK candidate launch
configs before the sweep times the most promising ones, and by the
backbone segment planner (``repro_torch.kernels.backbone_fuse``).  Only
the relative order of two estimates matters, so the model is minimal:
the larger of the compute and the memory time, plus a fixed host cost
per device launch.

The card's figures are NVIDIA's data-sheet peaks at the 700 W limit:
3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores
(the port's SNN GEMMs run in full fp32 on CUDA cores) and 989 TFLOP/s
of dense bf16 on the tensor cores (the flash-attention kernel's bound,
``chip_smoke.py``).  ``LAUNCH_S`` is the
host time of one eager launch through a kernel wrapper, as
``chip_smoke.py``'s ``launch overhead`` line measures it: 26.6 us on an
H100 80GB HBM3 at 700 W (a plain torch op costs the host less; the
estimate counts every device op at this rate).

The segment budget: ``L2_BYTES`` is the H100's L2 cache as
``cudaDeviceProp.l2CacheSize`` reports it (50 MiB).  The backbone
segment kernel (``csrc/backbone_segment.cu``) holds each layer's conv
output in its cluster's shared memory and hands a layer's spikes to the
next through a per-batch-element buffer that stays on chip only while
it sits in L2, and the served batch's 8 elements are all in flight at
once; so one element's working set may take an eighth of L2:
``SEGMENT_BUDGET_BYTES`` = 6,553,600 bytes.  The planner counts that
working set with the reference's formula (``residency_estimate``, 4
bytes per f32 element), which keeps its plans equal to the reference's;
whether a segment's slab fits a cluster is the kernel's own plan's
question (``kernels/backbone_segment.py`` ``segment_plan``).
"""
from __future__ import annotations

HBM_BW = 3.35e12            # bytes/s
PEAK_FLOPS = 67e12          # fp32 FLOP/s, CUDA cores
BF16_TENSOR_FLOPS = 989e12  # dense bf16 FLOP/s, tensor cores
SMS = 132                   # streaming multiprocessors
LAUNCH_S = 26.6e-6          # host seconds per eager kernel launch
L2_BYTES = 50 * 2 ** 20     # cudaDeviceProp.l2CacheSize of an H100 SXM
SERVED_BATCH = 8            # batch elements in flight in one tick
SEGMENT_BUDGET_BYTES = L2_BYTES // SERVED_BATCH
F32_BYTES = 4


def kernel_launch_estimate(flops: float, bytes_moved: float,
                           launches: int) -> float:
    """Seconds for ``launches`` device operations that together do
    ``flops`` fp32 operations and move ``bytes_moved`` bytes."""
    return max(flops / PEAK_FLOPS, bytes_moved / HBM_BW) + launches * LAUNCH_S


def residency_estimate(*elem_counts: int) -> int:
    """Bytes of a segment's working set, given the f32 element counts of
    its live buffers (the counterpart of the reference's
    ``vmem_residency_estimate``): every buffer at f32 width, no
    alignment padding, a monotone budget signal rather than an
    allocator."""
    return F32_BYTES * sum(int(n) for n in elem_counts)
