"""Spiking-YOLO detection head and box decoding, the counterpart of
``repro.core.yolo`` (loss and AP come with training).

Rate decoding: the head's 1x1 readout integrates spikes without firing
(normalised analog currents) and predictions are the temporal mean.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import SNNConfig
from repro_torch.core.layers import apply_spiking_conv, init_spiking_conv

# anchors as (w, h) fractions of the image
ANCHORS = ((0.15, 0.15), (0.4, 0.4))


def init_yolo_head(gen: torch.Generator, cin: int, cfg: SNNConfig):
    nout = cfg.num_anchors * (5 + cfg.num_classes)
    return {"conv": init_spiking_conv(gen, cin, cin, kernel=3),
            "pred": init_spiking_conv(gen, cin, nout, kernel=1)}


def apply_yolo_head(p, feats, cfg: SNNConfig, tape=None):
    """feats: [T, B, h, w, C] -> raw predictions [B, h, w, A, 5+nc]."""
    x = apply_spiking_conv(p["conv"], feats, cfg, tape=tape,
                           tag="head_conv")
    x = apply_spiking_conv(p["pred"], x, cfg, fire=False)   # analog readout
    x = x.mean(dim=0)                                       # rate decode
    B, h, w, _ = x.shape
    return x.reshape(B, h, w, cfg.num_anchors, 5 + cfg.num_classes)


def decode_boxes(raw: torch.Tensor, cfg: SNNConfig):
    """raw: [B,h,w,A,5+nc] -> (boxes [B,h*w*A,4] xyxy-normalised,
    scores [B,h*w*A], classes [B,h*w*A])."""
    B, h, w, A, _ = raw.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=raw.device),
                            torch.arange(w, device=raw.device),
                            indexing="ij")
    cx = (torch.sigmoid(raw[..., 0]) + gx[None, :, :, None]) / w
    cy = (torch.sigmoid(raw[..., 1]) + gy[None, :, :, None]) / h
    anchors = torch.tensor(ANCHORS, dtype=torch.float32, device=raw.device)
    bw = anchors[:, 0] * torch.exp(torch.clamp(raw[..., 2], -4, 4))
    bh = anchors[:, 1] * torch.exp(torch.clamp(raw[..., 3], -4, 4))
    obj = torch.sigmoid(raw[..., 4])
    cls_prob = torch.softmax(raw[..., 5:], dim=-1)
    best, cls = cls_prob.max(dim=-1)
    score = obj * best
    boxes = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                        dim=-1)
    n = h * w * A
    return boxes.reshape(B, n, 4), score.reshape(B, n), cls.reshape(B, n)
