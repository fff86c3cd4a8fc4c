"""Block constants shared by the plain formulations and the kernels,
copied from the JAX package's ``repro.kernels.blocks``.

``CANONICAL_K_BLOCK`` is the accumulation granularity: every matmul of
the spike-conv path sums K in 128-wide blocks, in order, and adds each
block's partial product to the running sum (``blocked_matmul``).  The
CUDA GEMM keeps the same block structure.  ``DEFAULT_BM``/``DEFAULT_BK``
are the untuned launch tile of the TPU kernels; the port keeps them as
the granularity of the occupancy mask (one bit per 128x128 tile) and,
with ``DEFAULT_BN``, as the launch table's default ``LaunchConfig``.
"""
from __future__ import annotations

CANONICAL_K_BLOCK = 128

DEFAULT_BM = 128
DEFAULT_BN = 128
DEFAULT_BK = CANONICAL_K_BLOCK
