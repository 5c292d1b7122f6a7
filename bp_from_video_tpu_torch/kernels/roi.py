"""Kernel K4: per-(stream, ROI) rectangular channel sums + denominator
(``csrc/roi_sums.cu``).

Counterpart of ``bp_from_video_tpu/pallas/roi_kernel.py`` ``roi_sums``:
integral ROIs (x, y, x0, y0, x1, y1) with Python slice semantics (negative
bounds wrap, then clamp), sums of the three channel planes over
frame[y0:y1, x0:x1], and the denominator (pixel count, or with a weight map
the weight sum, the sums then weighting each pixel).

Tolerance against the plain version: unweighted sums are exact in the CUDA
kernel (32-bit integer accumulation) and exact in f32 below 2^24; a rect
whose sum passes 2^24 (a full 480x640 rect of 255s is 7.8e7) differs by f32
rounding of the plain version's partial sums, so compare sums with
rtol 1e-6.  Weighted sums accumulate in another order: rtol 1e-5.
"""

from __future__ import annotations

import ctypes

import torch

from bp_from_video_tpu_torch.kernels import build

Tensor = torch.Tensor
MAX_ROIS = 8


def _span(start: Tensor, stop: Tensor, size: int) -> Tensor:
    """[..., size] f32 indicator of ``a[start:stop]``."""
    def norm(i):
        return torch.clamp(torch.where(i < 0, i + size, i), 0, size
                           ).to(torch.int32)
    s, e = norm(start)[..., None], norm(stop)[..., None]
    i = torch.arange(size, device=start.device)
    return ((i >= s) & (i < e)).to(torch.float32)


def roi_sums_plain(frames_planar: Tensor, rois: Tensor,
                   weights: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of K4 (row-mask @ plane @ col-mask, as the
    TPU kernel's two dots)."""
    h, w = frames_planar.shape[2], frames_planar.shape[3]
    rm = _span(rois[..., 3], rois[..., 5], h)                   # [S, R, H]
    cm = _span(rois[..., 2], rois[..., 4], w)                   # [S, R, W]
    f = frames_planar.to(torch.float32)                         # [S, 3, H, W]
    if weights is not None:
        wmap = weights.to(torch.float32)
        f = f * wmap[:, None]
        den = ((rm @ wmap) * cm).sum(-1)
    else:
        den = rm.sum(-1) * cm.sum(-1)
    rows = torch.einsum("srh,schw->srcw", rm, f)
    sums = torch.einsum("srcw,srw->src", rows, cm)
    return sums, den


def roi_sums(frames_planar: Tensor, rois: Tensor,
             weights: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Rectangular channel sums for every (stream, ROI).

    frames_planar: uint8 [S, 3, H, W]; rois: f32 [S, R, 6] (finite: the
    caller replaces non-finite ROIs by an empty rect); weights: optional
    f32 [S, H, W].  Returns (sums f32 [S, R, 3], denoms f32 [S, R])."""
    s, ch, h, w = frames_planar.shape
    r = rois.shape[1]
    if r > MAX_ROIS:
        raise ValueError(f"roi kernel supports up to {MAX_ROIS} ROIs, "
                         f"got {r}")
    if (frames_planar.dtype != torch.uint8 or ch != 3
            or rois.dtype != torch.float32 or tuple(rois.shape) != (s, r, 6)
            or (weights is not None
                and tuple(weights.shape) != (s, h, w))):
        raise ValueError(f"roi_sums: frames {frames_planar.dtype} "
                         f"{tuple(frames_planar.shape)}, rois "
                         f"{tuple(rois.shape)}")
    if frames_planar.device.type == "cpu":
        return roi_sums_plain(frames_planar, rois, weights)
    dev = frames_planar.device
    if not frames_planar.is_cuda or rois.device != dev or (
            weights is not None and weights.device != dev):
        raise ValueError("roi_sums: all operands on one CUDA device")
    frames_planar = frames_planar.contiguous()
    rois = rois.contiguous()
    wts = (None if weights is None
           else weights.to(torch.float32).contiguous())
    sums = torch.empty((s, r, 3), dtype=torch.float32, device=dev)
    den = torch.empty((s, r), dtype=torch.float32, device=dev)
    lib = build.load("roi_sums")
    fn = lib.roi_sums_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(frames_planar.data_ptr(), rois.data_ptr(),
             None if wts is None else wts.data_ptr(), sums.data_ptr(),
             den.data_ptr(), s, r, h, w,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "roi_sums")
    roi_sums.launches += 1
    return sums, den


roi_sums.launches = 0
