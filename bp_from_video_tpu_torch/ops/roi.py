"""ROI geometry and pixel sampling — the counterpart of
``bp_from_video_tpu/ops/roi.py`` (reference roi.py + signal_processor.py:
133-193), batched over a leading stream axis.

The crop-and-mean is a separable masked reduction with numpy slice
semantics (negative wrap, clamp, empty slice -> NaN).  ``sample_rois_batch``
with ``use_pallas`` routes through kernel K4 (``kernels/roi.roi_sums``: the
CUDA kernel for a CUDA tensor, its plain version for a CPU tensor).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bp_from_video_tpu_torch.config import (ModelType, ROIConfig,
                                            SignalColorChannel)
from bp_from_video_tpu_torch.kernels import roi as roi_kernel

Tensor = torch.Tensor
_NAN = float("nan")


class Detections(NamedTuple):
    """Fixed-size per-model detection bundle (leading stream axis [S]),
    sorted by bbox area descending.

    bbox:   f32[S, D, 4]  (x0, y0, x1, y1) pixel corners
    points: f32[S, D, L, 2]  landmark pixel coordinates (x, y)
    count:  i32[S] — number of valid detections (leading slots)
    """

    bbox: Tensor
    points: Tensor
    count: Tensor

    @staticmethod
    def empty(s: int, max_dets: int, num_points: int, device
              ) -> "Detections":
        return Detections(
            bbox=torch.full((s, max_dets, 4), _NAN, device=device),
            points=torch.full((s, max_dets, num_points, 2), _NAN,
                              device=device),
            count=torch.zeros((s,), dtype=torch.int32, device=device))


def calc_roi(cfg: ROIConfig, dets: Detections) -> Tensor:
    """One ROI 6-tuple (x, y, x0, y0, x1, y1) per stream [S, 6] from the
    largest detection, NaN when there is none; anchor = round(mean of the
    configured landmarks), corners = anchor + margins scaled by the bbox
    (rounding half to even, like np.round)."""
    # One slice per landmark: indexing with a Python list would copy the
    # list to the device, which synchronizes the stream.
    pts = torch.stack([dets.points[:, 0, i] for i in cfg.landmark_indices],
                      1)                                # [S, k, 2]
    anchor = torch.round(pts.mean(-2))                  # [S, 2]
    bbox = dets.bbox[:, 0]
    bw = bbox[:, 2] - bbox[:, 0]
    bh = bbox[:, 3] - bbox[:, 1]
    left_m, top_m, right_m, bottom_m = cfg.relative_bbox
    x, y = anchor[:, 0], anchor[:, 1]
    corners = torch.stack([
        torch.round(x + left_m * bw), torch.round(y + top_m * bh),
        torch.round(x + right_m * bw), torch.round(y + bottom_m * bh)], -1)
    out = torch.cat([anchor, corners], -1)
    return torch.where((dets.count > 0)[:, None], out, _NAN)


def calc_rois(roi_cfgs: tuple[ROIConfig, ...],
              by_model: dict[ModelType, Detections]) -> Tensor:
    """All configured ROIs as f32[S, R, 6]; only landmarker models are
    legal sources, like the reference."""
    rows = []
    for cfg in roi_cfgs:
        if cfg.model_type not in (ModelType.FACE_LANDMARKER,
                                  ModelType.HAND_LANDMARKER):
            raise NotImplementedError(cfg.model_type)
        rows.append(calc_roi(cfg, by_model[cfg.model_type]))
    return torch.stack(rows, 1)


def _slice_indicator(start: Tensor, stop: Tensor, size: int) -> Tensor:
    """[..., size] indicator of Python slice ``a[start:stop]``."""
    def norm(i):
        return torch.clamp(torch.where(i < 0, i + size, i), 0, size)
    s, e = norm(start)[..., None], norm(stop)[..., None]
    i = torch.arange(size, device=start.device)
    return ((i >= s) & (i < e)).to(torch.float32)


def _mix_channel(means: Tensor, channel: SignalColorChannel) -> Tensor:
    if channel is SignalColorChannel.GREEN:
        return means[..., 1]
    if channel is SignalColorChannel.CHROM_GREEN:
        return (means[..., 1] / 2.0 - means[..., 2] / 4.0
                - means[..., 0] / 4.0 + 0.5)
    raise NotImplementedError(channel)  # pragma: no cover


def sample_rois(frames_rgb: Tensor, rois: Tensor,
                channel: SignalColorChannel,
                weights: Tensor | None = None) -> Tensor:
    """Per-ROI channel statistic of NHWC frames [S, H, W, 3] for ROIs
    [S, R, 6] -> f32[S, R] (the reference package's XLA path): NaN when the
    ROI is NaN or the crop is empty; ``weights`` [S, H, W] makes it a
    weighted mean."""
    h, w = frames_rgb.shape[1], frames_rgb.shape[2]
    fin = torch.isfinite(rois)
    finite = fin.all(-1)
    s = torch.where(fin, rois, 0.0).to(torch.int32)
    r = _slice_indicator(s[..., 3], s[..., 5], h)            # [S, R, H]
    q = _slice_indicator(s[..., 2], s[..., 4], w)            # [S, R, W]
    f = frames_rgb.to(torch.float32)
    if weights is not None:
        wmap = weights[:, None] * r[..., :, None] * q[..., None, :]
        denom = wmap.sum((-2, -1))
        sums = torch.einsum("srhw,shwc->src", wmap, f)
    else:
        denom = r.sum(-1) * q.sum(-1)
        tmp = torch.einsum("srh,shwc->srwc", r, f)
        sums = torch.einsum("srw,srwc->src", q, tmp)
    valid = finite & (denom > 0)
    means = sums / torch.where(denom > 0, denom, 1.0)[..., None]
    return torch.where(valid, _mix_channel(means, channel), _NAN)


def is_planar_frames(frames: Tensor) -> bool:
    """True when a 4-D frame batch is planar ([S, 3, H, W])."""
    return (frames.ndim == 4 and frames.shape[1] == 3
            and frames.shape[-1] != 3)


def sample_rois_batch(frames_rgb: Tensor, rois: Tensor,
                      channel: SignalColorChannel,
                      weights: Tensor | None = None,
                      use_pallas: bool = False) -> Tensor:
    """Stream-batched ROI sampling: frames [S, H, W, 3] or planar
    [S, 3, H, W] + rois [S, R, 6] -> f32[S, R].  ``use_pallas`` (the JAX
    config's name for the fused kernel path) routes uint8 frames through
    kernel K4; identical NaN semantics either way."""
    planar_in = is_planar_frames(frames_rgb)
    if not (use_pallas and frames_rgb.dtype == torch.uint8):
        nhwc = frames_rgb.permute(0, 2, 3, 1) if planar_in else frames_rgb
        return sample_rois(nhwc, rois, channel, weights)
    finite = torch.isfinite(rois).all(-1)                    # [S, R]
    safe = torch.where(finite[..., None], torch.nan_to_num(rois), 0.0)
    planar = (frames_rgb if planar_in
              else frames_rgb.permute(0, 3, 1, 2).contiguous())
    sums, den = roi_kernel.roi_sums(planar, safe.contiguous(), weights)
    means = sums / torch.where(den > 0, den, 1.0)[..., None]
    valid = finite & (den > 0)
    return torch.where(valid, _mix_channel(means, channel), _NAN)
