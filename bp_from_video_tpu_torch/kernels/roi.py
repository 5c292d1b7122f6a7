"""Kernel K4: per-(stream, ROI) rectangular channel sums + denominator, and
the ROI sample made from them (``csrc/roi_sums.cu``).

Counterpart of ``bp_from_video_tpu/pallas/roi_kernel.py`` ``roi_sums``:
integral ROIs (x, y, x0, y0, x1, y1) with Python slice semantics (negative
bounds wrap, then clamp), sums of the three channel planes over
frame[y0:y1, x0:x1], and the denominator (pixel count, or with a weight map
the weight sum, the sums then weighting each pixel).  A weight map with
contiguous rows is read in place, whatever its stream stride
(``weights_in_place``): the segmenter's skin channel, a view of its
[S, 6, H, W] confidences, costs no copy.

Two entries launch the one kernel: ``roi_sums`` returns the sums and
denominators; ``roi_samples`` also does in the same launch what
``bp_from_video_tpu/ops/roi.py`` ``sample_rois_batch`` does around the
Pallas call (finite mask, mean, channel mix, NaN where invalid), which
``jax.jit`` fuses into one program on the TPU.  The kernel reads the frames
in 4-byte words where the width and the pointers allow it (``word_route``),
else byte by byte; both are routes of the same kernel.

Tolerance against the plain versions: unweighted sums are exact in the CUDA
kernel (32-bit integer accumulation) and exact in f32 below 2^24, and the
sample then takes one IEEE division and the same mix: bit-equal.  A rect
whose sum passes 2^24 (a full 480x640 rect of 255s is 7.8e7) differs by f32
rounding of the plain version's partial sums: rtol 1e-6 on sums and
samples.  Weighted sums accumulate in another order: rtol 1e-5.
"""

from __future__ import annotations

import ctypes

import torch

from bp_from_video_tpu_torch.config import SignalColorChannel
from bp_from_video_tpu_torch.kernels import build

Tensor = torch.Tensor
MAX_ROIS = 8
_NAN = float("nan")
# The C entry's channel codes.
_CHANNELS = {SignalColorChannel.GREEN: 1, SignalColorChannel.CHROM_GREEN: 2}


def _span(start: Tensor, stop: Tensor, size: int) -> Tensor:
    """[..., size] f32 indicator of ``a[start:stop]``."""
    def norm(i):
        return torch.clamp(torch.where(i < 0, i + size, i), 0, size
                           ).to(torch.int32)
    s, e = norm(start)[..., None], norm(stop)[..., None]
    i = torch.arange(size, device=start.device)
    return ((i >= s) & (i < e)).to(torch.float32)


def mix_channel(means: Tensor, channel: SignalColorChannel) -> Tensor:
    """The sampled statistic of per-channel means [..., 3] (RGB)."""
    if channel is SignalColorChannel.GREEN:
        return means[..., 1]
    if channel is SignalColorChannel.CHROM_GREEN:
        return (means[..., 1] / 2.0 - means[..., 2] / 4.0
                - means[..., 0] / 4.0 + 0.5)
    raise NotImplementedError(channel)  # pragma: no cover


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


def roi_samples_plain(frames_planar: Tensor, rois: Tensor,
                      channel: SignalColorChannel,
                      weights: Tensor | None = None) -> Tensor:
    """Plain PyTorch version of the sample entry: a non-finite ROI row
    becomes an empty rect, then the means of ``roi_sums_plain``, mixed, NaN
    unless the row is finite and the denominator positive."""
    finite = torch.isfinite(rois).all(-1)                    # [S, R]
    safe = torch.where(finite[..., None], torch.nan_to_num(rois), 0.0)
    sums, den = roi_sums_plain(frames_planar, safe, weights)
    means = sums / torch.where(den > 0, den, 1.0)[..., None]
    valid = finite & (den > 0)
    return torch.where(valid, mix_channel(means, channel), _NAN)


def weights_in_place(weights: Tensor) -> bool:
    """True when the kernel reads a weight map [S, H, W] as it lies: f32
    with contiguous rows, its streams any whole number of maps apart (a
    channel view of the segmenter's [S, 6, H, W] confidences is one)."""
    s, h, w = weights.shape
    return (weights.dtype == torch.float32 and weights.stride(2) == 1
            and weights.stride(1) == w
            and (s == 1 or weights.stride(0) >= h * w))


def _wstride(weights: Tensor) -> int:
    """A weight map's stream stride in floats, as the C entry takes it."""
    s, h, w = weights.shape
    return weights.stride(0) if s > 1 else h * w


def _weights_operand(weights: Tensor | None) -> tuple[Tensor | None, int]:
    """The weight map as the kernel reads it and its stream stride in
    floats; a copy only when it cannot be read in place."""
    if weights is None:
        return None, 0
    if not weights_in_place(weights):
        weights = weights.to(torch.float32).contiguous()
    return weights, _wstride(weights)


def word_route(frames_planar: Tensor, weights: Tensor | None = None,
               wstride: int | None = None) -> bool:
    """True when the kernel may read the frames in 4-byte words: the width
    a multiple of 4, the frames 4-byte aligned, and the weight map of every
    stream 16-byte aligned.  ``weights`` is the map as the kernel reads it
    (one that ``weights_in_place`` accepts), ``wstride`` its stream stride
    in floats (by default the view's)."""
    if weights is not None and wstride is None:
        wstride = _wstride(weights)
    return (frames_planar.shape[-1] % 4 == 0
            and frames_planar.data_ptr() % 4 == 0
            and (weights is None or (weights.data_ptr() % 16 == 0
                                     and wstride % 4 == 0)))


def _check(what: str, frames_planar: Tensor, rois: Tensor,
           weights: Tensor | None) -> None:
    s, ch, h, w = frames_planar.shape
    r = rois.shape[1]
    if r > MAX_ROIS:
        raise ValueError(f"roi kernel supports up to {MAX_ROIS} ROIs, "
                         f"got {r}")
    if (frames_planar.dtype != torch.uint8 or ch != 3
            or rois.dtype != torch.float32 or tuple(rois.shape) != (s, r, 6)
            or (weights is not None
                and tuple(weights.shape) != (s, h, w))):
        raise ValueError(f"{what}: frames {frames_planar.dtype} "
                         f"{tuple(frames_planar.shape)}, rois "
                         f"{tuple(rois.shape)}")


def _launch(entry: str, frames_planar: Tensor, rois: Tensor,
            weights: Tensor | None, outs: tuple[Tensor, ...],
            *extra: int) -> None:
    """Launch one C entry on the frames' stream: outputs, sizes, route and
    ``extra`` int arguments."""
    dev = frames_planar.device
    if not frames_planar.is_cuda or rois.device != dev or (
            weights is not None and weights.device != dev):
        raise ValueError(f"{entry}: all operands on one CUDA device")
    s, _, h, w = frames_planar.shape
    frames_planar = frames_planar.contiguous()
    rois = rois.contiguous()
    wts, wstride = _weights_operand(weights)
    lib = build.load("roi_sums")
    fn = getattr(lib, entry + "_launch")
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * len(outs)
                   + [ctypes.c_int] * (5 + len(extra)) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(frames_planar.data_ptr(), rois.data_ptr(),
             None if wts is None else wts.data_ptr(), wstride,
             *(o.data_ptr() for o in outs), s, rois.shape[1], h, w,
             4 if word_route(frames_planar, wts, wstride) else 1, *extra,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, entry)


def roi_sums(frames_planar: Tensor, rois: Tensor,
             weights: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Rectangular channel sums for every (stream, ROI).

    frames_planar: uint8 [S, 3, H, W]; rois: f32 [S, R, 6] (finite: the
    caller replaces non-finite ROIs by an empty rect); weights: optional
    f32 [S, H, W].  Returns (sums f32 [S, R, 3], denoms f32 [S, R])."""
    _check("roi_sums", frames_planar, rois, weights)
    if frames_planar.device.type == "cpu":
        return roi_sums_plain(frames_planar, rois, weights)
    s, r = rois.shape[:2]
    sums = torch.empty((s, r, 3), dtype=torch.float32,
                       device=frames_planar.device)
    den = torch.empty((s, r), dtype=torch.float32,
                      device=frames_planar.device)
    _launch("roi_sums", frames_planar, rois, weights, (sums, den))
    roi_sums.launches += 1
    return sums, den


def roi_samples(frames_planar: Tensor, rois: Tensor,
                channel: SignalColorChannel,
                weights: Tensor | None = None) -> Tensor:
    """The ROI sample of every (stream, ROI) in one launch: the channel
    statistic of the ROI's means, NaN where the ROI row has a non-finite
    entry or the denominator is not positive.

    frames_planar: uint8 [S, 3, H, W]; rois: f32 [S, R, 6], NaN allowed;
    weights: optional f32 [S, H, W] (weighted means).  Returns f32
    [S, R]."""
    _check("roi_samples", frames_planar, rois, weights)
    if channel not in _CHANNELS:
        raise NotImplementedError(channel)
    if frames_planar.device.type == "cpu":
        return roi_samples_plain(frames_planar, rois, channel, weights)
    out = torch.empty(rois.shape[:2], dtype=torch.float32,
                      device=frames_planar.device)
    _launch("roi_samples", frames_planar, rois, weights, (out,),
            _CHANNELS[channel])
    roi_samples.launches += 1
    roi_samples.weighted_launches += weights is not None
    return out


roi_sums.launches = 0
roi_samples.launches = 0
# Of those, the launches with a weight map (the segmenter's skin weights).
roi_samples.weighted_launches = 0
