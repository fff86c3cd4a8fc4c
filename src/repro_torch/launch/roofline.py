"""Roofline launch estimate for one NVIDIA H100 SXM, used by
``repro_torch.kernels.tune`` to RANK candidate launch configs before
the sweep times the most promising ones.  Only the relative order of two
estimates matters, so the model is minimal: the larger of the compute
and the memory time, plus a fixed host cost per device launch.

The card's figures are NVIDIA's data-sheet peaks at the 700 W limit:
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores
(the port's GEMMs run in full fp32 on CUDA cores).  ``LAUNCH_S`` is the
host time of one eager launch through a kernel wrapper, as
``chip_smoke.py``'s ``launch overhead`` line measures it: 26.6 us on an
H100 80GB HBM3 at 700 W (a plain torch op costs the host less; the
estimate counts every device op at this rate).
"""
from __future__ import annotations

HBM_BW = 3.35e12            # bytes/s
PEAK_FLOPS = 67e12          # fp32 FLOP/s, CUDA cores
SMS = 132                   # streaming multiprocessors
LAUNCH_S = 26.6e-6          # host seconds per eager kernel launch


def kernel_launch_estimate(flops: float, bytes_moved: float,
                           launches: int) -> float:
    """Seconds for ``launches`` device operations that together do
    ``flops`` fp32 operations and move ``bytes_moved`` bytes."""
    return max(flops / PEAK_FLOPS, bytes_moved / HBM_BW) + launches * LAUNCH_S
