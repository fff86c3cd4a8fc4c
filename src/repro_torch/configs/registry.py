"""Named configurations of the port, copied from the JAX package's
``repro.configs.registry``: the paper's four spiking architectures, the
ISP orderings, the event encodings and the autotuner's sweep policies.
The JAX ``"pallas"`` entries are ``"cuda"`` here, its ``"pallas_fused"``
ones ``"cuda_fused"``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import (DEFAULT_ISP_STAGES, EncodingConfig,
                                      ISPConfig, SNNConfig, TuneConfig)

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
