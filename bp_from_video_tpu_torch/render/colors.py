"""Colour constants and the signal colormap — the counterpart of
``bp_from_video_tpu/render/colors.py`` (reference drawer.py:18-42).

RGB, the on-device frame layout; the host window shell flips to BGR.  The
signal palette is matplotlib's default cycle (tab10), written out.
"""

from __future__ import annotations

import functools

import torch

from bp_from_video_tpu_torch.config import ModelType

BLACK = (0, 0, 0)
GRAY = (128, 128, 128)
LIGHT_GRAY = (224, 224, 224)
WHITE = (255, 255, 255)
RED = (255, 0, 0)
GREEN = (0, 255, 0)
BLUE = (0, 0, 255)
CYAN = (0, 255, 255)
MAGENTA = (255, 0, 255)
YELLOW = (255, 255, 0)
BLUE_AZURE = (0, 128, 255)
GREEN_SPRING = (0, 255, 128)
GREEN_PARIS = (128, 255, 0)

MODEL_COLORMAP = {
    ModelType.FACE_DETECTOR: BLUE_AZURE,
    ModelType.FACE_LANDMARKER: GREEN_SPRING,
    ModelType.HAND_LANDMARKER: GREEN_PARIS,
    ModelType.PERSON_SEGMENTER: WHITE,
}

# matplotlib C0..C9 (tab10), RGB 0-255.
TAB10 = (
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207),
)


def signal_colormap(num_signals: int) -> dict[int, tuple[int, int, int]]:
    return {i: TAB10[i % len(TAB10)] for i in range(num_signals)}


@functools.cache
def const(values: tuple, device: torch.device,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``values`` (a colour, a table of colours, a row of glyph indices) as
    a tensor on ``device``, built once: a tensor made from host values in
    the compose path would be a host-to-device copy, which synchronizes
    the stream.  Read only."""
    return torch.tensor(values, dtype=dtype, device=device)
