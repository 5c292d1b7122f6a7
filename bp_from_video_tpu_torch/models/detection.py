"""Detector post-processing — the counterpart of
``bp_from_video_tpu/models/detection.py``: raw SSD tensors -> scored boxes
and keypoints -> weighted non-max suppression with a static output size,
batched over a leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

Tensor = torch.Tensor
_NAN = float("nan")


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    input_size: int          # x/y/w/h scale (128 face, 192 palm)
    num_keypoints: int       # 6 face, 7 palm
    score_clip: float = 100.0
    min_score: float = 0.5
    iou_threshold: float = 0.3  # min_suppression_threshold


FACE_DECODE = DecodeConfig(input_size=128, num_keypoints=6)
PALM_DECODE = DecodeConfig(input_size=192, num_keypoints=7, min_score=0.5)


class RawDetections(NamedTuple):
    boxes: Tensor   # [B, A, 4] (x0, y0, x1, y1) normalized
    kps: Tensor     # [B, A, K, 2] normalized
    scores: Tensor  # [B, A]


def decode(cfg: DecodeConfig, regressors: Tensor, logits: Tensor,
           anchors: Tensor) -> RawDetections:
    """Decode SSD regressors [B, A, D] and logits [B, A, 1] against
    fixed-size anchors [A, 2] (centers; w = h = 1)."""
    s = cfg.input_size
    b, a = regressors.shape[0], anchors.shape[0]
    raw = regressors.reshape(b, a, -1)
    cx = raw[..., 0] / s + anchors[:, 0]
    cy = raw[..., 1] / s + anchors[:, 1]
    w = raw[..., 2] / s
    h = raw[..., 3] / s
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    kp = raw[..., 4:4 + 2 * cfg.num_keypoints].reshape(
        b, a, cfg.num_keypoints, 2)
    kps = kp / s + anchors[:, None, :]
    clipped = torch.clamp(logits.reshape(b, a), -cfg.score_clip,
                          cfg.score_clip)
    return RawDetections(boxes, kps, torch.sigmoid(clipped))


def iou(box: Tensor, boxes: Tensor) -> Tensor:
    """IoU of one box [B, 4] vs many [B, A, 4] (corner format)."""
    box = box[:, None]
    x0 = torch.maximum(box[..., 0], boxes[..., 0])
    y0 = torch.maximum(box[..., 1], boxes[..., 1])
    x1 = torch.minimum(box[..., 2], boxes[..., 2])
    y1 = torch.minimum(box[..., 3], boxes[..., 3])
    inter = torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0)
    area = (torch.clamp(box[..., 2] - box[..., 0], min=0)
            * torch.clamp(box[..., 3] - box[..., 1], min=0))
    areas = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
             * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    union = area + areas - inter
    return inter / torch.where(union > 0, union, 1.0)


class NMSOut(NamedTuple):
    boxes: Tensor   # [B, K, 4]
    kps: Tensor     # [B, K, P, 2]
    scores: Tensor  # [B, K]
    count: Tensor   # [B] int32


def weighted_nms(cfg: DecodeConfig, dets: RawDetections, max_out: int
                 ) -> NMSOut:
    """Weighted NMS with a static output size: take the best remaining
    candidate, blend every overlapping candidate (IoU > threshold) weighted
    by score, suppress the cluster; ``max_out`` rounds."""
    alive = dets.scores >= cfg.min_score
    boxes, kps, scores = dets.boxes, dets.kps, dets.scores
    out_boxes, out_kps, out_scores, out_valid = [], [], [], []
    for _ in range(max_out):
        masked = torch.where(alive, scores, -float("inf"))
        idx = torch.argmax(masked, -1)                          # [B]
        has = alive.any(-1)
        best_box = torch.gather(boxes, 1, idx[:, None, None].expand(-1, 1, 4)
                                )[:, 0]
        cluster = alive & (iou(best_box, boxes) > cfg.iou_threshold)
        wsum = torch.clamp(torch.where(cluster, scores, 0.0).sum(-1),
                           min=1e-12)
        wb = torch.where(cluster[..., None], boxes * scores[..., None],
                         0.0).sum(1) / wsum[:, None]
        wk = torch.where(cluster[..., None, None],
                         kps * scores[..., None, None], 0.0).sum(1) \
            / wsum[:, None, None]
        out_boxes.append(torch.where(has[:, None], wb, _NAN))
        out_kps.append(torch.where(has[:, None, None], wk, _NAN))
        out_scores.append(torch.where(
            has, torch.gather(scores, 1, idx[:, None])[:, 0], _NAN))
        out_valid.append(has)
        alive = alive & ~cluster
    return NMSOut(torch.stack(out_boxes, 1), torch.stack(out_kps, 1),
                  torch.stack(out_scores, 1),
                  torch.stack(out_valid, 1).sum(1).to(torch.int32))


def sort_by_area_desc(nms: NMSOut) -> NMSOut:
    """Detections by bbox area, descending (NaN areas sink): the reference
    package's stable ascending argsort, reversed."""
    b = nms.boxes
    area = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    order = torch.argsort(torch.where(torch.isnan(area), -float("inf"), area),
                          dim=-1, stable=True).flip(-1)

    def take(t):
        idx = order.reshape(order.shape + (1,) * (t.ndim - 2))
        return torch.gather(t, 1, idx.expand_as(t))
    return NMSOut(take(nms.boxes), take(nms.kps), take(nms.scores), nms.count)
