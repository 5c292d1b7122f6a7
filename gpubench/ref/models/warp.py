"""Rect geometry and the cover crop of the landmark pipeline — the
cover-crop part of ``bp_from_video_tpu/models/warp.py``.

A rect is (cx, cy, w, h, rotation) in pixels; every field may carry leading
batch dims.  The crop of a rect's axis-aligned cover is a separable
bilinear resample (two matmuls, ``crop_rect``), batched over leading dims.
Landmark projection is the exact inverse of the crop grid.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


Tensor = torch.Tensor


class Rect(NamedTuple):
    cx: Tensor
    cy: Tensor
    w: Tensor
    h: Tensor
    rotation: Tensor  # radians


def rect_arr(r: Rect) -> Tensor:
    """Rect -> [..., 5] tensor."""
    return torch.stack([r.cx, r.cy, r.w, r.h, r.rotation], -1)


def arr_rect(a: Tensor) -> Rect:
    """[..., 5] tensor -> Rect."""
    return Rect(a[..., 0], a[..., 1], a[..., 2], a[..., 3], a[..., 4])


def normalize_radians(a: Tensor) -> Tensor:
    """Wrap to [-pi, pi)."""
    return a - 2.0 * math.pi * torch.floor((a + math.pi) / (2.0 * math.pi))


def rotation_from_points(p0: Tensor, p1: Tensor, target_angle: float
                         ) -> Tensor:
    """Rotation aligning the p0 -> p1 direction ([..., 2] points) to
    ``target_angle`` (y-down image coordinates)."""
    return normalize_radians(
        target_angle - torch.atan2(-(p1[..., 1] - p0[..., 1]),
                                   p1[..., 0] - p0[..., 0]))


def landmarks_to_rect(pts_px: Tensor, rot_start: int, rot_end: int,
                      target_angle: float) -> Rect:
    """Tracking rect from landmarks [..., L, 2]: their axis-aligned bbox +
    rotation from two anchor landmarks."""
    x0 = pts_px[..., 0].amin(-1)
    x1 = pts_px[..., 0].amax(-1)
    y0 = pts_px[..., 1].amin(-1)
    y1 = pts_px[..., 1].amax(-1)
    rot = rotation_from_points(pts_px[..., rot_start, :],
                               pts_px[..., rot_end, :], target_angle)
    return Rect((x0 + x1) / 2.0, (y0 + y1) / 2.0, x1 - x0, y1 - y0, rot)


def rect_transform(r: Rect, scale: float, shift_x: float = 0.0,
                   shift_y: float = 0.0, square_long: bool = True) -> Rect:
    """Rotation-aware shift, square-long, then scale."""
    sx = r.w * shift_x
    sy = r.h * shift_y
    cos, sin = torch.cos(r.rotation), torch.sin(r.rotation)
    cx = r.cx + sx * cos - sy * sin
    cy = r.cy + sx * sin + sy * cos
    if square_long:
        side = torch.maximum(r.w, r.h)
        return Rect(cx, cy, side * scale, side * scale, r.rotation)
    return Rect(cx, cy, r.w * scale, r.h * scale, r.rotation)


def axis_aligned_cover(r: Rect) -> Rect:
    """The axis-aligned rect covering the rotated rect ``r`` (same
    center); crop and projection both use it, so they stay consistent."""
    cos = torch.abs(torch.cos(r.rotation))
    sin = torch.abs(torch.sin(r.rotation))
    return Rect(r.cx, r.cy, r.w * cos + r.h * sin, r.w * sin + r.h * cos,
                torch.zeros_like(r.rotation))


def interp_matrix(samples: Tensor, in_len: int, mode: str = "zero"
                  ) -> Tensor:
    """Bilinear interpolation matrix [..., out, in] sampling a signal at
    pixel-center coordinates ``samples`` [..., out] (triangle kernel:
    'zero' pads with zeros, 'edge' clamps)."""
    if mode == "edge":
        samples = torch.clamp(samples, 0.0, in_len - 1.0)
    grid = torch.arange(in_len, dtype=torch.float32, device=samples.device)
    return torch.clamp(1.0 - torch.abs(samples[..., None] - grid), min=0.0)


def _round(x: Tensor, dtype) -> Tensor:
    """Round f32 values to ``dtype`` and back: the operand rounding of a
    ``dtype`` matmul that accumulates in f32."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def resample_separable(frame: Tensor, ys: Tensor, xs: Tensor,
                       dtype=torch.float32, mode: str = "zero") -> Tensor:
    """Separable bilinear resample of ``frame`` [..., H, W, C] at pixel
    coordinates ``ys`` [..., oy] x ``xs`` [..., ox] -> f32
    [..., oy, ox, C]; matmul operands rounded to ``dtype``, f32
    accumulation, the row-pass result rounded to ``dtype``."""
    h, w, c = frame.shape[-3:]
    wy = _round(interp_matrix(ys, h, mode), dtype)              # [.., oy, H]
    wx = _round(interp_matrix(xs, w, mode), dtype)              # [.., ox, W]
    f = _round(frame.reshape(frame.shape[:-3] + (h, w * c))
               .to(torch.float32), dtype)
    tmp = _round(wy @ f, dtype)                                 # [.., oy, W*C]
    tmp = tmp.reshape(tmp.shape[:-1] + (w, c))
    return torch.einsum("...ywc,...xw->...yxc", tmp, wx)


def crop_rect(frame: Tensor, r: Rect, out_size: int,
              dtype=torch.float32) -> Tensor:
    """Bilinear crop of the rect ``r`` into [..., out_size, out_size, C],
    zero outside the frame: ``r`` is taken as axis-aligned (rotation
    ignored) and the crop is two matmuls with operands rounded to
    ``dtype``."""
    s = out_size
    u = (torch.arange(s, dtype=torch.float32, device=frame.device) + 0.5
         ) / s - 0.5
    ys = r.cy[..., None] + u * r.h[..., None] - 0.5
    xs = r.cx[..., None] + u * r.w[..., None] - 0.5
    return resample_separable(frame, ys, xs, dtype)


def project_landmarks(norm_pts: Tensor, r: Rect) -> Tensor:
    """Landmark-net outputs (normalized crop coords [..., L, 2+]) -> frame
    pixels [..., L, 2]; the inverse of the crop grid mapping."""
    u = norm_pts[..., 0] - 0.5
    v = norm_pts[..., 1] - 0.5
    cos = torch.cos(r.rotation)[..., None]
    sin = torch.sin(r.rotation)[..., None]
    rw, rh = r.w[..., None], r.h[..., None]
    x = r.cx[..., None] + u * rw * cos - v * rh * sin
    y = r.cy[..., None] + u * rw * sin + v * rh * cos
    return torch.stack([x, y], -1)


# --- detector input: centered letterbox --------------------------------------
