"""Named configurations of the slice, copied from the JAX package's
``repro.configs.registry``: the paper's spiking-YOLO architecture, the
default ISP ordering and the paper's binary event encoding."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import EncodingConfig, ISPConfig, SNNConfig

# The other three paper backbones (vgg, densenet, mobilenet) come with
# the depthwise and max-pool ports.
SNN_ARCHS: Dict[str, SNNConfig] = {
    "spiking_yolo": SNNConfig(name="spiking_yolo", backbone="yolo",
                              base_channels=32, num_stages=4),
}


def reduced_snn(name: str, backend: str = "torch") -> SNNConfig:
    """CPU/CI-sized dims: 32x32, T=3, 8 base channels, 2 stages."""
    return dataclasses.replace(
        SNN_ARCHS[name], base_channels=8, num_stages=2, time_steps=3,
        height=32, width=32, backend=backend)


ISP_CONFIGS: Dict[str, ISPConfig] = {
    "default": ISPConfig(name="default"),
}

ENCODING_CONFIGS: Dict[str, EncodingConfig] = {
    # the paper's §IV-A one-hot encoding (boundary events alias in)
    "paper_binary": EncodingConfig(name="paper_binary"),
}

