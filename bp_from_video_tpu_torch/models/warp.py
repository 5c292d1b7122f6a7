"""Rect geometry and separable resampling for the landmark and detector
pipelines — the cover-crop part of ``bp_from_video_tpu/models/warp.py``.

A rect is (cx, cy, w, h, rotation) in pixels; every field may carry leading
batch dims.  Crops sample the axis-aligned cover of the tracking rect as a
separable bilinear resample (two matmuls), and landmark projection is the
exact inverse of the crop grid.  The rotated crop modes (``exact``,
``shear``) are not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def detection_to_rect(box_px: Tensor, kp_px: Tensor, kp_start: int,
                      kp_end: int, target_angle: float) -> Rect:
    """Rect from detection boxes [..., 4] (pixel corners) + rotation from
    two of the keypoints [..., K, 2]."""
    cx = (box_px[..., 0] + box_px[..., 2]) / 2.0
    cy = (box_px[..., 1] + box_px[..., 3]) / 2.0
    w = box_px[..., 2] - box_px[..., 0]
    h = box_px[..., 3] - box_px[..., 1]
    rot = rotation_from_points(kp_px[..., kp_start, :], kp_px[..., kp_end, :],
                               target_angle)
    return Rect(cx, cy, w, h, rot)


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
              exact_rotation: bool = False, dtype=torch.float32) -> Tensor:
    """Bilinear crop of the axis-aligned rect ``r`` (rotation ignored) into
    [..., out_size, out_size, C], zero outside the frame."""
    if exact_rotation:
        raise NotImplementedError(
            "exact-rotation crops: not ported yet (ROADMAP Queue 1 item 10)")
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


class Letterbox(NamedTuple):
    image: Tensor    # [..., S, S, C] f32
    scale: Tensor    # pixels per letterbox unit
    pad_x: Tensor    # left pad in letterbox pixels
    pad_y: Tensor


def letterbox(frame: Tensor, out_size: int, dtype=torch.float32
              ) -> Letterbox:
    """Keep-aspect resize of frames [..., H, W, C] into a centered
    (out_size, out_size) canvas, zero padding."""
    h, w = frame.shape[-3], frame.shape[-2]
    dev = frame.device
    s = out_size
    # The f32 quotient made on the host and filled on the device: no
    # host-to-device copy (which would synchronize), and no CUDA division by
    # a scalar (a multiplication by its reciprocal, off by an ulp).
    scale = torch.full((), float(np.float32(max(h, w)) / np.float32(s)),
                       dtype=torch.float32, device=dev)
    pad_x = (s - w / scale) / 2.0
    pad_y = (s - h / scale) / 2.0
    j = torch.arange(s, dtype=torch.float32, device=dev) + 0.5
    xs = (j - pad_x) * scale
    ys = (j - pad_y) * scale
    img = resample_separable(frame, ys - 0.5, xs - 0.5, dtype=dtype)
    return Letterbox(img, scale, pad_x, pad_y)


def resize_bilinear(image: Tensor, out_h: int, out_w: int,
                    dtype=torch.float32) -> Tensor:
    """Half-pixel bilinear resize of [..., H, W, C] with edge clamp, as two
    matmuls."""
    h, w = image.shape[-3], image.shape[-2]
    dev = image.device
    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5
          ) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5
          ) * (w / out_w) - 0.5
    return resample_separable(image, ys, xs, dtype=dtype, mode="edge")


def unletterbox_points(pts_norm: Tensor, lb: Letterbox, out_size: int
                       ) -> Tensor:
    """Detector outputs (normalized letterbox coords [..., 2]) -> frame
    pixels."""
    x = (pts_norm[..., 0] * out_size - lb.pad_x) * lb.scale
    y = (pts_norm[..., 1] * out_size - lb.pad_y) * lb.scale
    return torch.stack([x, y], -1)
