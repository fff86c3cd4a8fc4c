"""Config dataclasses of the serving tick and the kernel autotuner,
copied from the JAX package's ``repro.configs.base`` (field names and
defaults unchanged) with the port's backend names: ``"torch"`` for
the plain PyTorch path and ``"cuda"`` for the hand-written kernels.
``repro_torch.convert`` maps the JAX names (``"jnp"`` / ``"pallas"``)
onto these.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# Default stage ordering = the paper's fixed §V pipeline.
DEFAULT_ISP_STAGES: Tuple[str, ...] = (
    "exposure", "dpc", "demosaic", "awb", "nlm", "gamma", "sharpen")


@dataclasses.dataclass(frozen=True)
class ISPConfig:
    """An ordered tuple of registered ISP stage names plus the backend
    their implementations resolve through (see ``repro_torch.isp.stages``):
    ``"torch"`` (plain PyTorch), ``"cuda"`` (the demosaic and NLM
    kernels; every other stage runs its ``"torch"`` impl) or
    ``"cuda_fused"`` (the fusion planner's segment kernels,
    ``repro_torch.isp.fuse``)."""
    name: str = "default"
    stages: Tuple[str, ...] = DEFAULT_ISP_STAGES
    backend: str = "torch"

    @property
    def control_dim(self) -> int:
        """Width of the NPU control vector: one slot per declared stage
        parameter, in pipeline order."""
        from repro_torch.isp.stages import control_dim_for  # import cycle
        return control_dim_for(self.stages)


@dataclasses.dataclass(frozen=True)
class EncodingConfig:
    """DVS ingestion policy: ``mode`` "binary" | "count" | "signed";
    ``oob`` "clip" | "drop" for timestamps outside the window;
    ``event_capacity`` is the per-slot event FIFO depth (overfull
    submissions are budgeted earliest-first); ``backend`` "torch" (plain
    scatter) or "cuda" (the voxelization kernel)."""
    name: str = "paper_binary"
    mode: str = "binary"
    oob: str = "clip"
    window: float = 1.0
    event_capacity: int = 2048
    backend: str = "torch"


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    """Spiking backbone config (the paper's own architectures).

    ``backend``: "torch" (plain PyTorch reference) or "cuda" (the
    hand-written Hopper kernels: gated spike conv, fused
    norm+affine+LIF, LIF scan, tile-skip spike matmul)."""
    name: str = "spiking_yolo"
    backbone: str = "yolo"
    in_channels: int = 2
    time_steps: int = 5
    height: int = 64
    width: int = 64
    num_classes: int = 2
    base_channels: int = 16
    num_stages: int = 3
    tau_mem: float = 2.0
    v_threshold: float = 1.0
    v_reset: float = 0.0
    surrogate_beta: float = 4.0
    detect: bool = True
    num_anchors: int = 2
    backend: str = "torch"
    control_dim: int = 8


@dataclasses.dataclass(frozen=True)
class TuneConfig:
    """One launch-table sweep policy (``repro_torch.kernels.tune``): the
    candidates of a shape are ranked by the roofline estimate, and only
    the ``prune_to`` most promising (plus the untuned default) are timed,
    ``reps`` times each after a warm-up call."""
    name: str = "default"
    reps: int = 5                   # timed repetitions per candidate
    prune_to: int = 8               # candidates timed after the ranking
    max_candidates: int = 64        # cap on the enumerated space
