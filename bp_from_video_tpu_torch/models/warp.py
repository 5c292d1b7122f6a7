"""Rect geometry and separable resampling for the landmark and detector
pipelines — the cover-crop part of ``bp_from_video_tpu/models/warp.py``.

A rect is (cx, cy, w, h, rotation) in pixels; every field may carry leading
batch dims.  Three crops of a rect, each batched over leading dims:
the axis-aligned cover as a separable bilinear resample (two matmuls,
``crop_rect``), the rotated rect as four clamped gathers (``crop_rect`` with
``exact_rotation``) and the rotated rect with no gather at all
(``crop_rect_shear``: a separable resample, then three shear passes of
rDFT phase ramps).  Landmark projection is the exact inverse of the crop
grid.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from bp_from_video_tpu_torch.ops import dft

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
    """Bilinear crop of the rect ``r`` into [..., out_size, out_size, C],
    zero outside the frame.  ``exact_rotation``: the rotated grid, sampled
    by :func:`bilinear_sample` (f32); otherwise ``r`` is taken as
    axis-aligned (rotation ignored) and the crop is two matmuls with
    operands rounded to ``dtype``."""
    s = out_size
    u = (torch.arange(s, dtype=torch.float32, device=frame.device) + 0.5
         ) / s - 0.5
    if not exact_rotation:
        ys = r.cy[..., None] + u * r.h[..., None] - 0.5
        xs = r.cx[..., None] + u * r.w[..., None] - 0.5
        return resample_separable(frame, ys, xs, dtype)
    vv, uu = u[:, None], u[None, :]                 # rows, cols
    cos = torch.cos(r.rotation)[..., None, None]
    sin = torch.sin(r.rotation)[..., None, None]
    rw, rh = r.w[..., None, None], r.h[..., None, None]
    xs = r.cx[..., None, None] + uu * rw * cos - vv * rh * sin
    ys = r.cy[..., None, None] + uu * rw * sin + vv * rh * cos
    return bilinear_sample(frame, xs, ys)


def bilinear_sample(frame: Tensor, xs: Tensor, ys: Tensor) -> Tensor:
    """Bilinear sample of ``frame`` [..., H, W, C] at pixel coordinates
    ``xs``, ``ys`` [..., oh, ow] (integer k = the center of pixel k) ->
    f32 [..., oh, ow, C], zero outside: four clamped index gathers, each
    masked to the frame, blended in the reference's order of terms."""
    h, w, c = frame.shape[-3:]
    lead = frame.shape[:-3]
    flat = frame.to(torch.float32).reshape(lead + (h * w, c))
    x = xs - 0.5
    y = ys - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        n = math.prod(idx.shape[len(lead):])
        v = torch.gather(flat, -2, idx.reshape(lead + (n, 1)).expand(
            lead + (n, c)))
        return torch.where(inb[..., None], v.reshape(idx.shape + (c,)), 0.0)

    a = gather(y0i, x0i)
    b = gather(y0i, x0i + 1)
    cc = gather(y0i + 1, x0i)
    d = gather(y0i + 1, x0i + 1)
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + cc * fy * (1 - fx) + d * fy * fx)


_RDFT: dict = {}


def _rdft_mats(n: int, device) -> tuple[Tensor, Tensor, Tensor]:
    """Real-DFT analysis and synthesis matrices for length ``n`` (cached
    per size and device): ``x @ f`` gives [Re | Im] of the rFFT (n//2+1
    each), ``[Re' | Im'] @ i`` synthesizes; with the frequencies ``kk``
    (cycles a sample).  Angles reduced mod n on exact int32 products
    (``ops/dft._angles``), as the reference builds them."""
    key = (n, str(device))
    if key not in _RDFT:
        nf = n // 2 + 1
        ang = dft._angles(n, nf, n, device)                     # [n, nf]
        f = torch.cat([torch.cos(ang), -torch.sin(ang)], 1)     # [n, 2nf]
        wts = torch.full((nf, 1), 2.0, dtype=torch.float32, device=device)
        wts[0] = 1.0
        if n % 2 == 0:
            wts[-1] = 1.0
        # Divided by a tensor: IEEE quotients on the card as on the CPU.
        nt = torch.full((), float(n), dtype=torch.float32, device=device)
        angt = ang.T
        i_c = torch.cos(angt) * wts / nt                        # [nf, n]
        i_s = torch.sin(angt) * wts / nt
        kk = torch.arange(nf, dtype=torch.float32, device=device) / nt
        _RDFT[key] = (f, torch.cat([i_c, -i_s], 0), kk)
    return _RDFT[key]


def fract_shift(img: Tensor, shifts: Tensor, axis: int,
                method: str = "fft") -> Tensor:
    """Translate ``img`` along ``axis`` by per-slice fractional ``shifts``
    with rDFT phase ramps (periodic sinc interpolation): out[j] =
    in[j + shift].  ``shifts`` has ``img``'s shape with ``axis`` removed
    (or broadcasts to it).  ``method``: 'fft' (``torch.fft``; cuFFT on the
    card; what the reference runs off the TPU) or 'dft' (two f32 matmuls
    against the cached trig matrices, the reference's TPU form)."""
    ax = axis % img.ndim
    x = img.to(torch.float32).movedim(ax, -1)
    n = x.shape[-1]
    sh = shifts.to(torch.float32)[..., None]
    if method == "fft":
        k = torch.fft.rfftfreq(n, device=x.device)
        ang = 2.0 * math.pi * k * sh
        spec = torch.fft.rfft(x, dim=-1)
        out = torch.fft.irfft(spec * torch.complex(torch.cos(ang),
                                                   torch.sin(ang)),
                              n=n, dim=-1)
        return out.movedim(-1, ax)
    if method != "dft":
        raise ValueError(f"fract_shift: method {method!r}")
    f_mat, i_mat, kk = _rdft_mats(n, x.device)
    nf = kk.shape[0]
    spec = x @ f_mat
    re, im = spec[..., :nf], spec[..., nf:]
    ang = 2.0 * math.pi * kk * sh
    pc, ps = torch.cos(ang), torch.sin(ang)
    spec2 = torch.cat([re * pc - im * ps, re * ps + im * pc], -1)
    return (spec2 @ i_mat).movedim(-1, ax)


def rotate_shear(img: Tensor, theta: Tensor, r=1.0,
                 method: str = "fft") -> Tensor:
    """Rotate ``img`` [..., H, W, C] about its center by ``theta`` [...]
    (y-down screen convention, as :func:`crop_rect`'s rotated grid) with
    three shears, each a per-row or per-column :func:`fract_shift`.  ``r``
    (scalar or [...]) is the grid's row-pitch / column-pitch ratio: with
    k1 = k3 = -r tan(theta/2) and k2 = sin(theta)/r an anisotropic grid
    rotates correctly."""
    h, w = img.shape[-3], img.shape[-2]
    dev = img.device
    t = torch.tan(theta / 2.0)
    k1 = (-r * t)[..., None]
    k2 = (torch.sin(theta) / r)[..., None]
    a = torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0
    b = torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0
    x = fract_shift(img, (k1 * a)[..., None], -2, method)
    x = fract_shift(x, (k2 * b)[..., None], -3, method)
    return fract_shift(x, (k1 * a)[..., None], -2, method)


def quarter_turns(img: Tensor, n4: Tensor) -> Tensor:
    """``img`` [..., T, T, C] turned by ``n4`` [...] (0-3) quarter turns
    each (``torch.rot90`` over the two spatial axes), chosen per image on
    the device."""
    out = img
    k = n4[..., None, None, None]
    for q in (1, 2, 3):
        out = torch.where(k == q, torch.rot90(img, q, (-3, -2)), out)
    return out


def crop_rect_shear(frame: Tensor, r: Rect, out_size: int,
                    dtype=torch.float32, expand: float = 1.5,
                    method: str = "fft") -> Tensor:
    """Rotated-rect crop with no gather: resample the axis-aligned
    neighbourhood of the rect center at the rect's pixel pitch (two
    matmuls, zero outside the frame) on a canvas of ``expand`` x the crop
    rounded up to a multiple of 64, fold the rotation's quarter turns out
    as exact index permutations, rotate by the residual (|angle| <= 45
    degrees) with :func:`rotate_shear`, and take the central window.
    ``frame`` [..., H, W, C] broadcasts against the rect fields [...] (a
    frame of shape [S, 1, H, W, C] serves rects [S, n]).  Returns f32
    [..., out_size, out_size, C].  The sampling grid is :func:`crop_rect`'s
    rotated grid, so :func:`project_landmarks` with the same rect inverts
    it; the interpolation is periodic sinc, not bilinear.  Quarter-turn
    folding is exact for square rects (the trackers' rects are); keep
    anisotropic rects within 45 degrees."""
    s = out_size
    tdim = int(-(-int(s * expand) // 64) * 64)
    u = (torch.arange(tdim, dtype=torch.float32, device=frame.device)
         + 0.5 - tdim / 2) / s
    ys = r.cy[..., None] + u * r.h[..., None] - 0.5
    xs = r.cx[..., None] + u * r.w[..., None] - 0.5
    g = resample_separable(frame, ys, xs, dtype)      # [..., t, t, C]
    rot = normalize_radians(r.rotation)
    nq = torch.round(rot / (math.pi / 2))
    theta_r = rot - nq * (math.pi / 2)
    n4 = torch.remainder(nq.to(torch.int32), 4)
    g = quarter_turns(g, n4)
    ratio = torch.where(n4 % 2 == 1, r.w / r.h, r.h / r.w)
    out = rotate_shear(g, theta_r, ratio, method)
    o0 = (tdim - s) // 2
    return out[..., o0:o0 + s, o0:o0 + s, :]


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


def _resize_mm(x: Tensor, out_h: int, out_w: int, specs: tuple[str, str],
               h: int, w: int, dtype, out_dtype) -> Tensor:
    """Half-pixel bilinear resize as two contractions against edge-clamped
    interpolation matrices (TFLite RESIZE_BILINEAR half-pixel semantics,
    no antialiasing on downscale).  Operands and the row-pass result are
    rounded to ``dtype``, sums are f32; integer inputs are rounded."""
    floating = x.is_floating_point()
    if dtype is None:
        dtype = x.dtype if floating else torch.float32
    dev = x.device
    f32 = torch.float32
    ys = (torch.arange(out_h, dtype=f32, device=dev) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=f32, device=dev) + 0.5) * (w / out_w) - 0.5
    wy = _round(interp_matrix(ys, h, "edge"), dtype)            # [oh, H]
    wx = _round(interp_matrix(xs, w, "edge"), dtype)            # [ow, W]
    t = _round(torch.einsum(specs[0], _round(x.to(f32), dtype), wy), dtype)
    out = torch.einsum(specs[1], t, wx)
    if not floating:
        out = torch.round(out)
    return out.to(x.dtype if out_dtype is None else out_dtype)


def resize_bilinear_planar(x: Tensor, out_h: int, out_w: int, dtype=None,
                           out_dtype=None) -> Tensor:
    """Half-pixel bilinear resize over the last two axes ([..., H, W], the
    planar activation layout); ``out_dtype`` keeps the f32 sums."""
    return _resize_mm(x, out_h, out_w, ("...hw,oh->...ow", "...hw,pw->...hp"),
                      x.shape[-2], x.shape[-1], dtype, out_dtype)


def resize_bilinear_nhwc(x: Tensor, out_h: int, out_w: int, dtype=None,
                         out_dtype=None) -> Tensor:
    """``resize_bilinear_planar`` for NHWC batches [B, H, W, C]."""
    return _resize_mm(x, out_h, out_w, ("bhwc,oh->bowc", "bhwc,pw->bhpc"),
                      x.shape[1], x.shape[2], dtype, out_dtype)


def unletterbox_points(pts_norm: Tensor, lb: Letterbox, out_size: int
                       ) -> Tensor:
    """Detector outputs (normalized letterbox coords [..., 2]) -> frame
    pixels."""
    x = (pts_norm[..., 0] * out_size - lb.pad_x) * lb.scale
    y = (pts_norm[..., 1] * out_size - lb.pad_y) * lb.scale
    return torch.stack([x, y], -1)
