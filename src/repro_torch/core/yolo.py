"""Spiking-YOLO detection head, box decoding, loss and AP@0.5, the
counterpart of ``repro.core.yolo``.

Rate decoding: the head's 1x1 readout integrates spikes without firing
(normalised analog currents) and predictions are the temporal mean.
The AP evaluation is numpy, as the reference's.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def _assign_targets(gt_boxes, gt_valid, h: int, w: int, cfg: SNNConfig):
    """gt_boxes [B, M, 5] (cls, cx, cy, bw, bh normalised), gt_valid [B, M]
    -> target grid [B, h, w, A, 5+nc] and mask [B, h, w, A] bool.  The M
    boxes are written in order, so a later valid box overwrites an
    earlier one at the same cell and anchor (the reference's scan);
    cells by truncating casts, anchors by the first best shape IoU."""
    B, M, _ = gt_boxes.shape
    dev = gt_boxes.device
    anchors = torch.tensor(ANCHORS, dtype=torch.float32, device=dev)
    cls, cx, cy, bw, bh = gt_boxes.float().unbind(-1)
    gi = torch.clamp((cx * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((cy * h).to(torch.int32), 0, h - 1).long()
    # best anchor by shape IoU
    inter = (torch.minimum(bw[..., None], anchors[:, 0])
             * torch.minimum(bh[..., None], anchors[:, 1]))
    union = bw[..., None] * bh[..., None] + anchors[:, 0] * anchors[:, 1] \
        - inter
    a = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=-1)
    tx = cx * w - gi
    ty = cy * h - gj
    tw = torch.log(torch.clamp(bw / anchors[a, 0], min=1e-6))
    th = torch.log(torch.clamp(bh / anchors[a, 1], min=1e-6))
    # one_hot of the truncated class; out of range gives zeros, as JAX's
    onehot = (cls.to(torch.int32)[..., None] == torch.arange(
        cfg.num_classes, device=dev)).float()
    rows = torch.cat([torch.stack([tx, ty, tw, th, torch.ones_like(tx)],
                                  dim=-1), onehot], dim=-1)
    tgt = torch.zeros((B, h, w, cfg.num_anchors, 5 + cfg.num_classes),
                      device=dev)
    msk = torch.zeros((B, h, w, cfg.num_anchors), dtype=torch.bool,
                      device=dev)
    bi = torch.arange(B, device=dev)
    valid = gt_valid.bool()
    for m in range(M):
        at = (bi, gj[:, m], gi[:, m], a[:, m])
        v = valid[:, m]
        tgt[at] = torch.where(v[:, None], rows[:, m], tgt[at])
        msk[at] = msk[at] | v
    return tgt, msk


def yolo_loss(raw, gt_boxes, gt_valid, cfg: SNNConfig
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """raw [B, h, w, A, 5+nc]; gt_boxes [B, M, 5]; gt_valid [B, M] ->
    (loss, {"xy", "wh", "obj", "cls"})."""
    B, h, w, A, _ = raw.shape
    tgt, msk = _assign_targets(gt_boxes, gt_valid, h, w, cfg)
    mf = msk.float()
    npos = torch.clamp(mf.sum(), min=1.0)

    xy_pred = torch.sigmoid(raw[..., 0:2])
    xy_loss = (mf[..., None] * (xy_pred - tgt[..., 0:2]) ** 2).sum() / npos
    wh_loss = (mf[..., None] * (raw[..., 2:4] - tgt[..., 2:4]) ** 2).sum() \
        / npos
    obj_logit = raw[..., 4]
    obj_loss = ((1 - mf) * F.softplus(obj_logit)).mean() \
        + (mf * F.softplus(-obj_logit)).sum() / npos
    cls_logp = torch.log_softmax(raw[..., 5:], dim=-1)
    cls_loss = -(mf[..., None] * tgt[..., 5:] * cls_logp).sum() / npos
    return 5.0 * xy_loss + 5.0 * wh_loss + obj_loss + cls_loss, {
        "xy": xy_loss, "wh": wh_loss, "obj": obj_loss, "cls": cls_loss}


# ---------------------------------------------------------------------------
# AP@0.5 (numpy, offline eval), the reference's own
# ---------------------------------------------------------------------------

def _iou_np(a, b):
    """a: [N,4], b: [M,4] xyxy -> [N,M]."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    ar_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ar_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(ar_a[:, None] + ar_b[None] - inter, 1e-9)


def nms_greedy(boxes: np.ndarray, iou_thresh: float = 0.5) -> np.ndarray:
    """Greedy NMS over score-DESCENDING boxes -> kept indices (keep box
    i iff its IoU with every earlier kept box is < ``iou_thresh``)."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0,), np.int64)
    iou = _iou_np(boxes, boxes)
    idx = np.arange(n)
    keep = np.ones(n, bool)
    for i in range(n):
        if keep[i]:
            keep &= (iou[i] < iou_thresh) | (idx <= i)
    return idx[keep]


def average_precision(pred_boxes: List[np.ndarray],
                      pred_scores: List[np.ndarray],
                      gt_boxes: List[np.ndarray],
                      iou_thresh: float = 0.5,
                      score_thresh: float = 0.05) -> float:
    """Dataset AP@IoU (single class; per-class AP averages over calls)."""
    records = []   # (score, is_tp)
    n_gt = 0
    for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
        keep = ps >= score_thresh
        pb, ps = pb[keep], ps[keep]
        order = np.argsort(-ps)
        pb, ps = pb[order], ps[order]
        sel = nms_greedy(pb)
        pb, ps = pb[sel], ps[sel]
        n_gt += len(gb)
        matched = np.zeros(len(gb), bool)
        for i in range(len(pb)):
            if len(gb) == 0:
                records.append((ps[i], False))
                continue
            ious = _iou_np(pb[i:i + 1], gb)[0]
            j = int(np.argmax(ious))
            if ious[j] >= iou_thresh and not matched[j]:
                matched[j] = True
                records.append((ps[i], True))
            else:
                records.append((ps[i], False))
    if n_gt == 0 or not records:
        return 0.0
    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records])
    fps = np.cumsum([not r[1] for r in records])
    recall = tps / n_gt
    precision = tps / np.maximum(tps + fps, 1)
    # VOC-style continuous integration
    ap, prev_r = 0.0, 0.0
    max_p = np.maximum.accumulate(precision[::-1])[::-1]
    for r, p in zip(recall, max_p):
        ap += (r - prev_r) * p
        prev_r = r
    return float(ap)
