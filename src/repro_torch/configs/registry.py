"""Named configurations of the port, copied from the JAX package's
``repro.configs.registry``: the ten LM architectures (with ``reduced``
and the shape cells), the paper's four spiking architectures, the ISP
orderings, the event encodings, the detector's training runs, the
fleet's serving, fault and supervision policies and the autotuner's
sweep policies.
The JAX ``"pallas"`` entries are ``"cuda"`` here, its ``"pallas_fused"``
ones ``"cuda_fused"``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.configs import base
from repro_torch.configs.base import (DEFAULT_ISP_STAGES, EncodingConfig,
                                      FaultConfig, FleetConfig, ISPConfig,
                                      MLAConfig, ModelConfig, MoEConfig,
                                      SNNConfig, SSMConfig,
                                      SupervisorConfig, TrainConfig,
                                      TuneConfig)

# ---------------------------------------------------------------------------
# The LM architectures (the reference registry's ten, same fields)
# ---------------------------------------------------------------------------

ARCHS: Dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


_register(ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072, max_seq_len=131072,
    rope_theta=1e6))

_register(ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    head_dim=128, d_ff=13696, vocab_size=151552, rope_theta=1e6))

_register(ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    head_dim=128, d_ff=6912, vocab_size=151936, qkv_bias=True,
    rope_theta=5e6))

_register(ModelConfig(
    name="qwen2-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    head_dim=128, d_ff=18944, vocab_size=152064, qkv_bias=True,
    rope_theta=1e6))

_register(ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=4864, vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, d_expert=4864,
                  dense_residual=True, capacity_factor=2.0)))

_register(ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, num_heads=128, num_kv_heads=128,
    d_ff=18432,               # dense layers use 18432 (hf config);
                              # the assigned d_ff=2048 is the expert width
    vocab_size=129280, mtp_depth=1,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048,
                  num_shared_experts=1, first_dense_layers=3,
                  moe_layer_offset=0, capacity_factor=2.0)))

_register(ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, causal=False, act="gelu", norm_kind="ln"))

_register(ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=32000, rope_theta=1e6,
    frontend_embed_tokens=576))

_register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=65536,
    layer_pattern="MMMMAMMM",          # attention at layer 4 of each 8
    attention_window=4096,             # windowed attn => long_500k runnable
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336,
                  moe_layer_period=2, moe_layer_offset=1,
                  capacity_factor=2.0)))

_register(ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    layer_pattern="LLLLLLLS",          # xLSTM[7:1]
    ssm=SSMConfig(kind="mlstm", expand=2)))


# ---------------------------------------------------------------------------
# Shape-cell applicability
# ---------------------------------------------------------------------------

_FULL_ATTENTION = {"mistral-nemo-12b", "glm4-9b", "qwen1.5-4b", "qwen2-7b",
                   "arctic-480b", "deepseek-v3-671b",
                   "llava-next-mistral-7b"}


def shape_cells(arch: str) -> List[Tuple[str, str]]:
    """Runnable (arch, shape) cells, with the reference's skip rules."""
    cfg = ARCHS[arch]
    cells = []
    for s in base.SHAPES:
        if not cfg.causal and s.kind == "decode":
            continue                       # encoder-only: no decode step
        if s.name == "long_500k" and arch in _FULL_ATTENTION:
            continue                       # needs sub-quadratic attention
        cells.append((arch, s.name))
    return cells


def get_config(name: str) -> ModelConfig:
    return ARCHS[name]


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduced(name: str) -> ModelConfig:
    cfg = ARCHS[name]
    changes = dict(
        num_layers=max(2, len(cfg.layer_pattern) or 2),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2))
        if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128,
        max_seq_len=256,
        frontend_embed_tokens=min(cfg.frontend_embed_tokens, 8),
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_expert=32,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
        if cfg.moe.first_dense_layers:
            changes["num_layers"] = 3
    if cfg.mla is not None:
        changes["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                   qk_nope_head_dim=16, qk_rope_head_dim=8,
                                   v_head_dim=16)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=4, d_conv=4,
                                             expand=2)
    if cfg.layer_pattern:
        changes["num_layers"] = 2 * len(cfg.layer_pattern)
    return dataclasses.replace(cfg, **changes)



SNN_ARCHS: Dict[str, SNNConfig] = {
    "spiking_vgg": SNNConfig(name="spiking_vgg", backbone="vgg",
                             base_channels=32, num_stages=4),
    "spiking_densenet": SNNConfig(name="spiking_densenet", backbone="densenet",
                                  base_channels=24, num_stages=3),
    "spiking_mobilenet": SNNConfig(name="spiking_mobilenet",
                                   backbone="mobilenet",
                                   base_channels=32, num_stages=4),
    "spiking_yolo": SNNConfig(name="spiking_yolo", backbone="yolo",
                              base_channels=32, num_stages=4),
}


def get_snn_config(name: str) -> SNNConfig:
    return SNN_ARCHS[name]


def reduced_snn(name: str, backend: str = "torch") -> SNNConfig:
    """CPU/CI-sized dims: 32x32, T=3, 8 base channels, 2 stages."""
    return dataclasses.replace(
        SNN_ARCHS[name], base_channels=8, num_stages=2, time_steps=3,
        height=32, width=32, backend=backend)


_HDR_STAGES = (DEFAULT_ISP_STAGES[:5] + ("tonemap", "ccm")
               + DEFAULT_ISP_STAGES[5:])

ISP_CONFIGS: Dict[str, ISPConfig] = {
    "default": ISPConfig(name="default"),
    # demosaic and NLM on their CUDA kernels
    "cuda": ISPConfig(name="cuda", backend="cuda"),
    # the default ordering through the fusion planner: [exposure+dpc]
    # [demosaic] [awb*+nlm] [gamma+sharpen], 4 segment kernels
    "fused": ISPConfig(name="fused", backend="cuda_fused"),
    # HDR capture: tone-map after denoise, colour-matrix before gamma.
    "hdr": ISPConfig(name="hdr", stages=_HDR_STAGES),
    # the hdr ordering fused: its pointwise tail joins the sharpen
    # segment, 9 stages in 4 launches
    "hdr_fused": ISPConfig(name="hdr_fused", stages=_HDR_STAGES,
                           backend="cuda_fused"),
    # Latency-critical preview: drop NLM (the most expensive stage)
    # and sharpen — bare exposure/DPC/demosaic/AWB/gamma, control_dim 6.
    "fast_preview": ISPConfig(
        name="fast_preview",
        stages=("exposure", "dpc", "demosaic", "awb", "gamma")),
}

ENCODING_CONFIGS: Dict[str, EncodingConfig] = {
    # the paper's §IV-A one-hot encoding (boundary events alias in)
    "paper_binary": EncodingConfig(name="paper_binary"),
    # rate-preserving counts with strict window semantics
    "count_strict": EncodingConfig(name="count_strict", mode="count",
                                   oob="drop"),
    # polarity-split (net, total) channels for motion-direction cues
    "signed": EncodingConfig(name="signed", mode="signed"),
    # the voxelization kernel
    "cuda": EncodingConfig(name="cuda", backend="cuda"),
    # night/low-light traffic: tiny FIFO, drop stragglers
    "night_lowrate": EncodingConfig(name="night_lowrate", mode="count",
                                    oob="drop", event_capacity=256),
}


TRAIN_CONFIGS: Dict[str, TrainConfig] = {
    # CI-sized smoke: a few hundred steps on synthetic scenes lift
    # AP@0.5 from ~0.00 to >=0.15 (chip_smoke.py's detector phase)
    "detector_smoke": TrainConfig(name="detector_smoke", steps=300),
    # the same run through the kernel-backed spiking layers
    "detector_smoke_cuda": TrainConfig(name="detector_smoke_cuda",
                                       backend="cuda", steps=300),
    # longer single-card run at the full paper dims
    "detector": TrainConfig(name="detector", reduced=False, steps=2000,
                            warmup=100, ckpt_every=200),
}


def get_train_config(name: str) -> TrainConfig:
    return TRAIN_CONFIGS[name]


FLEET_CONFIGS: Dict[str, FleetConfig] = {
    # balanced default: double-buffered, bounded queue
    "fleet": FleetConfig(name="fleet"),
    # ADAS/UAV edge profile: small batch, hard 50 ms deadline, depth-1
    # pipeline (no extra tick of latency), tiny admission queue
    "edge_realtime": FleetConfig(name="edge_realtime", batch=4,
                                 max_queue=8, default_deadline_ms=50.0,
                                 double_buffer=False),
    # offline/throughput profile: wide ticks, deep queue, no deadlines
    "throughput": FleetConfig(name="throughput", batch=16, max_queue=512),
}


def get_fleet_config(name: str) -> FleetConfig:
    return FLEET_CONFIGS[name]


FAULT_CONFIGS: Dict[str, FaultConfig] = {
    # clean control run
    "none": FaultConfig(name="none"),
    # the chaos-smoke schedule: every fault kind present, rates high
    # enough that a short soak sees each one several times
    "chaos": FaultConfig(name="chaos", seed=7,
                         p_corrupt_input=0.02, p_nan_output=0.05,
                         p_transient=0.05, p_stall=0.03,
                         p_malformed=0.03, stall_ms=40.0),
    # NaN storm: the quarantine and breaker paths
    "nan_storm": FaultConfig(name="nan_storm", seed=11,
                             p_nan_output=0.25, inf_fraction=0.5),
    # flaky accelerator: transient launch failures and stalls
    "flaky_device": FaultConfig(name="flaky_device", seed=13,
                                p_transient=0.15, p_stall=0.05,
                                stall_ms=80.0),
}


def get_fault_config(name: str) -> FaultConfig:
    return FAULT_CONFIGS[name]


SUPERVISOR_CONFIGS: Dict[str, SupervisorConfig] = {
    # balanced default: quarantine, breaker, retries, no hedging
    "supervisor": SupervisorConfig(name="supervisor"),
    # soak profile: a single failed tick demotes, so a short run walks
    # the whole demote -> probe -> promote cycle; hedging past 250 ms
    # covers stalled ticks
    "soak": SupervisorConfig(name="soak", breaker_threshold=1,
                             half_open_after=4, recovery_threshold=2,
                             max_retries=3, retry_backoff_ms=2.0,
                             hedge_after_ms=250.0),
    # edge profile: no retries (a stale frame is worthless), a hard tick
    # deadline folded into the breaker's health
    "edge_strict": SupervisorConfig(name="edge_strict", max_retries=0,
                                    tick_deadline_ms=50.0,
                                    breaker_threshold=2),
}


def get_supervisor_config(name: str) -> SupervisorConfig:
    return SUPERVISOR_CONFIGS[name]

TUNE_CONFIGS: Dict[str, TuneConfig] = {
    # full sweep: every legal candidate ranked, the top 8 timed
    "default": TuneConfig(name="default"),
    # a bounded sweep: fewer reps, harder pruning (a valid table, less
    # exhaustively searched)
    "smoke": TuneConfig(name="smoke", reps=2, prune_to=4,
                        max_candidates=16),
}


def get_tune_config(name: str) -> TuneConfig:
    return TUNE_CONFIGS[name]
