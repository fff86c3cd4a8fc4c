"""Tile-skip spike matmul: the plain version and the wrapper of its CUDA
kernel (``csrc/spike_matmul.cu``), which skips the all-zero parts of x
inside the kernel.  ``matmul_path`` picks one of its two paths by shape:
"small" (one block holds up to 64 rows and 1024 outputs whole; the
control head) or "tiled" (the 64x64-tile GEMM, every other shape).  Both
give the bits of the canonical K-block chain, so the choice changes no
result, and both count as one ``spike_matmul`` launch."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.layers import blocked_matmul
from repro_torch.kernels.build import (check_f32, check_launch, load,
                                       stream_of)

PATHS = ("small", "tiled")
SMALL_MAX_OUTPUTS = 4096    # M * N at most on the small path
SMALL_MAX_N = 64            # w's columns at most on the small path
SMALL_ROWS = 64             # rows of x a small block holds at most
SMALL_BLOCK_OUTPUTS = 1024  # outputs (one a thread) a small block at most

_SIG = ("spike_matmul_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def matmul_path(M: int, N: int) -> str:
    """The kernel's path for an [M, K] @ [K, N] product: "small" where
    a few blocks hold every output, else "tiled"."""
    return ("small" if M * N <= SMALL_MAX_OUTPUTS and N <= SMALL_MAX_N
            else "tiled")


def small_rows(M: int, N: int) -> int:
    """Rows of x a block of the small path holds."""
    return max(1, min(M, SMALL_ROWS, SMALL_BLOCK_OUTPUTS // N))


def _launch(x: torch.Tensor, w: torch.Tensor, path: str) -> torch.Tensor:
    """Launch ``path`` on CUDA tensors.  The wrapper passes
    ``matmul_path``'s choice; timing and parity code may pass "tiled" at
    a small shape to hold the two paths against each other."""
    if path not in PATHS:
        raise ValueError(f"spike_matmul: path must be one of {PATHS}, got "
                         f"{path!r}")
    M, K = x.shape
    N = w.shape[1]
    if path == "small" and matmul_path(M, N) != "small":
        raise ValueError(f"spike_matmul: [{M}, {K}] @ [{K}, {N}] is past "
                         f"the small path")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    rows = small_rows(M, N) if path == "small" else 0
    lib = load("spike_matmul", _SIG)
    with torch.cuda.device(x.device):
        err = lib.spike_matmul_launch(x.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), M, K, N, rows,
                                      stream_of(x.device))
    check_launch("spike_matmul", err)
    return out


def spike_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] spikes (0/1), w [K, N] -> x @ w [M, N] float32."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"spike_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    dev = check_f32("spike_matmul", x, w)
    if dev.type == "cpu":
        return blocked_matmul(x, w)
    return _launch(x, w, matmul_path(x.shape[0], w.shape[1]))
