"""Config dataclasses of the serving tick, the fleet that serves it, the
detector's training runs, the kernel autotuner and the LM stack, copied from the JAX package's
``repro.configs.base`` (field names and defaults unchanged) with the
port's backend names: ``"torch"`` for the plain PyTorch path and
``"cuda"`` for the hand-written kernels.
``repro_torch.convert`` maps the JAX names (``"jnp"`` / ``"pallas"``)
onto these.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # 0 => dense FFN only
    top_k: int = 2
    d_expert: int = 0               # expert hidden size (d_ff of each expert)
    num_shared_experts: int = 0     # deepseek-style always-on shared experts
    dense_residual: bool = False    # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 2.0    # static EP capacity slack
    router_aux_weight: float = 1e-2
    moe_layer_period: int = 1       # apply MoE every k-th layer (jamba: 2)
    moe_layer_offset: int = 1       # which residue of the period is MoE
    first_dense_layers: int = 0     # deepseek: first k layers stay dense


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba / xLSTM block parameters."""
    kind: str = "mamba"             # "mamba" | "mlstm" | "slstm"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 => ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"           # dense|moe|hybrid|ssm|audio|vlm
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    d_ff: int = 512
    vocab_size: int = 256
    head_dim: int = 0               # 0 => d_model // num_heads
    max_seq_len: int = 4096
    rope_theta: float = 1e6
    qkv_bias: bool = False          # qwen-style
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    causal: bool = True             # False => encoder-only (hubert)
    act: str = "silu"               # "silu"|"gelu"
    norm_kind: str = "rms"          # "rms"|"ln"
    dtype: str = "bfloat16"

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # hybrid layouts: string pattern over layers, cycled. chars:
    #   'A' attention block, 'M' mamba block, 'L' mLSTM, 'S' sLSTM
    # "" => all attention.
    layer_pattern: str = ""

    # windowed attention for long-context attention layers (0 = full)
    attention_window: int = 0

    # multi-token prediction depth (deepseek MTP); 0 = off
    mtp_depth: int = 0

    # modality frontend stub: if >0, inputs include precomputed embeddings
    # of this dimensionality concatenated ahead of token embeddings.
    frontend_embed_tokens: int = 0   # number of prefix embedding positions

    # cost-extraction mode: fully unroll every internal lax.scan so
    # XLA cost_analysis sees every trip (it counts while bodies ONCE —
    # see launch/dryrun.py two-point correction). Never set for real runs.
    unroll_scans: bool = False

    # -- derived helpers ---------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def pattern_at(self, layer: int) -> str:
        if not self.layer_pattern:
            return "A"
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def is_moe_layer(self, layer: int) -> bool:
        if self.moe is None or self.moe.num_experts == 0:
            return False
        if layer < self.moe.first_dense_layers:
            return False
        p = self.moe.moe_layer_period
        return (layer % p) == (self.moe.moe_layer_offset % p)

    def param_count(self) -> int:
        """Analytic total parameter count (used for 6ND roofline)."""
        c = self
        hd = c.resolved_head_dim
        d = c.d_model
        emb = c.vocab_size * d * (1 if c.tie_embeddings else 2)
        total = emb
        for layer in range(c.num_layers):
            kind = self.pattern_at(layer)
            if kind == "A":
                if c.mla is not None:
                    m = c.mla
                    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * m.q_lora_rank + m.q_lora_rank * c.num_heads * qk
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * c.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    total += c.num_heads * m.v_head_dim * d
                else:
                    total += d * c.num_heads * hd          # q
                    total += 2 * d * c.num_kv_heads * hd   # k,v
                    total += c.num_heads * hd * d          # o
            elif kind == "M":
                s = c.ssm or SSMConfig()
                di = s.expand * d
                dtr = s.dt_rank or -(-d // 16)
                total += d * 2 * di            # in_proj
                total += di * s.d_conv         # conv
                total += di * (dtr + 2 * s.d_state)  # x_proj
                total += dtr * di              # dt_proj
                total += di * s.d_state + di   # A, D
                total += di * d                # out_proj
            elif kind in ("L", "S"):
                s = c.ssm or SSMConfig()
                di = s.expand * d
                if kind == "L":
                    total += d * di * 3 + di * d + 2 * di  # q,k,v, out, gates
                else:
                    total += 4 * d * d + 4 * d * d + d * d  # sLSTM gates+rec+out
            # FFN / MoE
            if self.is_moe_layer(layer):
                m = c.moe
                total += d * m.num_experts              # router
                total += m.num_experts * 3 * d * m.d_expert
                total += m.num_shared_experts * 3 * d * m.d_expert
                if m.dense_residual:
                    total += 3 * d * c.d_ff
            elif kind == "A" or not c.layer_pattern:
                if c.d_ff:
                    total += 3 * d * c.d_ff
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k only) for 6·N_active·D."""
        c = self
        if c.moe is None or c.moe.num_experts == 0:
            return self.param_count()
        total = self.param_count()
        m = c.moe
        n_moe_layers = sum(1 for l in range(c.num_layers) if self.is_moe_layer(l))
        all_expert = n_moe_layers * m.num_experts * 3 * c.d_model * m.d_expert
        active_expert = n_moe_layers * m.top_k * 3 * c.d_model * m.d_expert
        return int(total - all_expert + active_expert)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: (kind, seq_len, global_batch)."""
    name: str = "train_4k"
    kind: str = "train"             # train | prefill | decode | long_decode
    seq_len: int = 4096
    global_batch: int = 256


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


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
class TrainConfig:
    """One detector training run (``repro_torch.train.detector``).

    ``arch``/``backend`` resolve to an :class:`SNNConfig`
    (``reduced=True`` selects the CPU/CI dims of ``reduced_snn``); the
    run uses AdamW under the warmup-cosine schedule, and every training
    batch is seeded from ``(seed, step)`` so a resumed run replays the
    data order of an uninterrupted one.  ``eval_seed`` seeds the
    held-out eval scenes, a stream of its own (disjoint from the
    training stream by construction).  ``shard``: data-parallel over
    the visible cards (the port trains on one card: no mesh)."""
    name: str = "detector"
    arch: str = "spiking_yolo"      # key into registry SNN_ARCHS
    backend: str = "torch"          # "torch" | "cuda" spiking-layer path
    reduced: bool = True            # reduced_snn dims (CPU/CI) vs full
    steps: int = 300
    batch: int = 8                  # global batch
    lr: float = 4e-3
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    warmup: int = 20                # warmup_cosine ramp steps
    min_lr_ratio: float = 0.3       # cosine floor as a fraction of lr
    ckpt_every: int = 100
    keep_ckpts: int = 3
    log_every: int = 25
    seed: int = 0                   # training data + init stream
    eval_seed: int = 1000           # held-out eval scene stream
    eval_batches: int = 4
    eval_batch: int = 8
    max_boxes: int = 4              # scene generator knobs
    n_events: int = 2048
    shard: bool = True


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


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Continuous-batching serving policy for the cognitive path
    (``repro_torch.serve.fleet``).

    ``batch``: tick batch (slot count).
    ``max_queue``: admission-control bound; submits beyond it are
    REJECTED immediately (backpressure, not buffering).
    ``default_deadline_ms``: per-request deadline measured from
    enqueue, applied when the submit carries none (None = requests
    never expire).
    ``double_buffer``: two host staging banks, so tick N+1's pack and
    upload overlap tick N's compute (results then deliver one
    ``step()`` later: pipeline depth 2).
    ``shard``: partition the tick batch over a data mesh when more than
    one device is visible (the port serves one card: no mesh)."""
    name: str = "fleet"
    batch: int = 8
    max_queue: int = 64
    default_deadline_ms: Optional[float] = None
    double_buffer: bool = True
    shard: bool = True


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """One deterministic fault-injection schedule
    (``repro_torch.serve.faults``).  ``FaultPlan.from_config`` expands it
    into an explicit per-(tick, slot) event list with
    ``numpy.random.default_rng(seed)``: the same config always gives the
    same schedule.  Probabilities are per dispatched tick; slot-targeted
    kinds draw their slot uniformly.

    * ``p_corrupt_input``: NaN poison written into a staged voxel slot
      just before upload;
    * ``p_nan_output``: NaN/Inf forced into one slot of the fetched NPU
      outputs;
    * ``p_transient``: the tick raises ``TransientTickError`` at
      harvest;
    * ``p_stall``: the tick's harvest stalls ``stall_ms`` past its
      dispatch;
    * ``p_malformed``: the client edge submits a structurally invalid
      request that tick.
    """
    name: str = "chaos"
    seed: int = 0
    p_corrupt_input: float = 0.0
    p_nan_output: float = 0.0
    p_transient: float = 0.0
    p_stall: float = 0.0
    p_malformed: float = 0.0
    stall_ms: float = 50.0
    inf_fraction: float = 0.25      # poison with +inf instead of NaN


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Self-healing policy for the fleet
    (``repro_torch.serve.supervisor``).

    Health: every delivered slot passes a NaN/Inf guard (``nan_guard``:
    a non-finite result is quarantined, never delivered); a tick whose
    dispatch-to-harvest wall time exceeds ``tick_deadline_ms`` counts as
    a stall; tick wall times feed a ``HeartbeatMonitor`` whose straggler
    detector (``straggler_factor`` x the running median for
    ``straggler_patience`` consecutive ticks) flags a slowing engine.

    Breaker: ``breaker_threshold`` consecutive failed ticks demote the
    engine one rung down the fallback ladder (``"cuda_fused"`` ->
    ``"cuda"`` -> ``"torch"``); after ``half_open_after`` degraded ticks
    the next tick probes the rung above, and ``recovery_threshold``
    clean probes promote back up.

    Requests: transiently failed ones retry up to ``max_retries`` times
    behind ``retry_backoff_ms * 2^attempt`` plus seeded jitter; one in
    flight past ``hedge_after_ms`` gets one hedged duplicate (first
    delivery wins).  ``prewarm`` runs every rung once at construction."""
    name: str = "supervisor"
    nan_guard: bool = True
    tick_deadline_ms: Optional[float] = None
    breaker_threshold: int = 3
    half_open_after: int = 8
    recovery_threshold: int = 2
    heartbeat_timeout_s: float = 60.0
    straggler_factor: float = 6.0
    straggler_patience: int = 4
    max_retries: int = 2
    retry_backoff_ms: float = 4.0
    retry_jitter_ms: float = 1.0
    retry_seed: int = 0
    hedge_after_ms: Optional[float] = None
    prewarm: bool = False           # run every ladder rung up front
