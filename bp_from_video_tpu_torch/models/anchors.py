"""SSD anchor generation for the BlazeFace/BlazePalm detector family — a
numpy copy of ``bp_from_video_tpu/models/anchors.py`` (only the anchor
centers matter: fixed anchor sizes, per merged-stride feature map,
row-major, anchors-per-cell innermost)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    input_size: int
    strides: tuple[int, ...]
    anchor_offset: float = 0.5
    aspect_ratios: tuple[float, ...] = (1.0,)
    interpolated_scale_aspect_ratio: float = 1.0
    fixed_anchor_size: bool = True


# BlazeFace short-range: 128x128 input, 896 anchors (16*16*2 + 8*8*6).
FACE_SHORT_RANGE = AnchorConfig(input_size=128, strides=(8, 16, 16, 16))
# BlazePalm (full/lite): 192x192 input, 2016 anchors (24*24*2 + 12*12*6).
PALM = AnchorConfig(input_size=192, strides=(8, 16, 16, 16))


def generate_anchors(cfg: AnchorConfig) -> np.ndarray:
    """Anchor centers (x, y) normalized to [0,1], shape (A, 2).  Layers with
    identical strides merge into one feature map whose cells get the union
    of the merged layers' anchors."""
    num_layers = len(cfg.strides)
    anchors = []
    layer = 0
    while layer < num_layers:
        stride = cfg.strides[layer]
        per_cell = 0
        last = layer
        while last < num_layers and cfg.strides[last] == stride:
            per_cell += len(cfg.aspect_ratios)
            if cfg.interpolated_scale_aspect_ratio > 0.0:
                per_cell += 1
            last += 1
        cells = int(np.ceil(cfg.input_size / stride))
        for y in range(cells):
            for x in range(cells):
                cx = (x + cfg.anchor_offset) / cells
                cy = (y + cfg.anchor_offset) / cells
                for _ in range(per_cell):
                    anchors.append((cx, cy))
        layer = last
    return np.asarray(anchors, np.float32)
