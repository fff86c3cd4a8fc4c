"""PyTorch / CUDA port of the cognitive serving tick (``repro``'s
``encode -> npu_forward -> control -> ISP``) for NVIDIA Hopper.

The package mirrors the JAX package's layout (``configs``, ``core``,
``isp``, ``kernels``, ``serve``) and function names so each piece has an
obvious counterpart, but imports nothing of it: it keeps its own copies
of the configs and block constants.  Tensors keep the JAX layout at
public functions — ``[T, B, H, W, C]`` activations, batch-major NHWC
folds, HWIO conv weights.

Spiking layers dispatch on ``SNNConfig.backend``: ``"torch"`` is the
plain PyTorch formulation, ``"cuda"`` routes the hot path through the
hand-written Hopper kernels in :mod:`repro_torch.kernels` (built with
``nvcc`` at first use).  Entry points default to ``device="cuda"``; the
CPU is used only when a caller passes ``device="cpu"``.
"""
