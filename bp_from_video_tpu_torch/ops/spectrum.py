"""Spectral estimators — the counterpart of
``bp_from_video_tpu/ops/spectrum.py`` (reference signal_processor.py:
248-273): the rFFT magnitude spectrum, the Welch periodogram and the
generalized (floating-mean, normalized) Lomb-Scargle periodogram, as masked
dense trig contractions batched over leading dims (the valid count K is a
``[...]`` tensor, so a transform of dynamic length K is a fixed-size
projection).  The contractions must be true f32: the package never enables
TF32 (a reduced-precision trig contraction flips near-tie BPM bins).  The
frequency axes are elementwise and do not depend on it.
"""

from __future__ import annotations

import math

import torch

from bp_from_video_tpu_torch.config import (SignalConfig,
                                            SignalSpectrumTransform as T)
from bp_from_video_tpu_torch.ops import dft
from bp_from_video_tpu_torch.ops import signal as sig

Tensor = torch.Tensor

_F32_EPSNEG = float(torch.finfo(torch.float32).eps) / 2.0  # numpy epsneg
_NAN = float("nan")


def _dot(m: Tensor, v: Tensor) -> Tensor:
    """[..., F, N] @ [..., N] -> [..., F]."""
    return (m @ v[..., None])[..., 0]


def _masked_dft(yc: Tensor, k: Tensor) -> tuple[Tensor, Tensor]:
    """DFT of the first ``k`` [...] entries of compacted ``yc`` [..., N] at
    bins 0..N-1 of an implicit length-``k`` transform:
    X_b = sum_n y_n e^{-2 pi i b n / k}.  Returns (re, im) [..., N]."""
    n = yc.shape[-1]
    i = torch.arange(n, dtype=torch.float32, device=yc.device)
    kf = torch.clamp(k, min=1).to(torch.float32)
    # Divided by a tensor (IEEE), as the reference's 2 pi / max(k, 1).
    step = torch.full_like(kf, 2.0 * math.pi) / kf
    ang = step[..., None, None] * (i[:, None] * i[None, :])   # [..., N, N]
    ym = torch.where(sig.arange_mask(n, k), yc, 0.0)
    return _dot(torch.cos(ang), ym), -_dot(torch.sin(ang), ym)


def dft_rfft(x: Tensor, y: Tensor, fs: Tensor) -> tuple[Tensor, Tensor]:
    """freqs = rfftfreq(K, 1 / fs); mags = 2 |rfft(y_valid)| / K."""
    n = x.shape[-1]
    cy = sig.compact(sig.valid_y(y), y)
    k = cy.count
    re, im = _masked_dft(cy.values, k)
    kf = torch.clamp(k, min=1)[..., None]
    mags = 2.0 * torch.sqrt(re * re + im * im) / kf
    bins = torch.arange(n, dtype=torch.float32, device=x.device)
    freqs = bins * fs[..., None] / kf
    out_mask = sig.arange_mask(n, k // 2 + 1)
    return (torch.where(out_mask, freqs, _NAN),
            torch.where(out_mask, mags, _NAN))


_WELCH_NPERSEG = 256  # scipy.signal.welch default nperseg


def welch(x: Tensor, y: Tensor, fs: Tensor) -> tuple[Tensor, Tensor]:
    """scipy.signal.welch(y_valid, fs), in scipy's two regimes: K <= 256
    (nperseg clamps to K: one hann-windowed, constant-detrended,
    density-scaled segment of dynamic length K) and K > 256 (nperseg 256,
    50 % overlap, the mean of the valid segments' periodograms; only for
    rings longer than 256).  Per row, the regime is a ``where`` on K."""
    n = x.shape[-1]
    cy = sig.compact(sig.valid_y(y), y)
    k = cy.count
    freqs1, pxx1 = _welch_single(n, cy.values, k, fs)
    if n <= _WELCH_NPERSEG:
        return freqs1, pxx1
    freqs2, pxx2 = _welch_segmented(n, cy.values, k, fs)
    seg = (k > _WELCH_NPERSEG)[..., None]
    return torch.where(seg, freqs2, freqs1), torch.where(seg, pxx2, pxx1)


def _welch_single(n: int, yv: Tensor, k: Tensor, fs: Tensor
                  ) -> tuple[Tensor, Tensor]:
    """One segment of dynamic length K (scipy's nperseg-clamped branch)."""
    kf = torch.clamp(k, min=1).to(torch.float32)[..., None]
    m = sig.arange_mask(n, k).to(yv.dtype)
    mean = (yv * m).sum(-1, keepdim=True) / kf
    yd = (yv - mean) * m
    # Periodic hann window of dynamic length K.
    i = torch.arange(n, dtype=torch.float32, device=yv.device)
    win = (0.5 - 0.5 * torch.cos(2.0 * math.pi * i / kf)) * m
    re, im = _masked_dft(yd * win, k)
    scale = 1.0 / (fs * (win * win).sum(-1))
    pxx = (re * re + im * im) * scale[..., None]
    # One-sided doubling: every bin but DC, and Nyquist when K is even.
    bins = torch.arange(n, device=yv.device)
    kk = k[..., None]
    is_nyq = (kk % 2 == 0) & (bins == kk // 2)
    pxx = torch.where((bins > 0) & ~is_nyq, 2.0 * pxx, pxx)
    freqs = bins.to(torch.float32) * fs[..., None] / torch.clamp(kk, min=1)
    out_mask = bins < kk // 2 + 1
    return (torch.where(out_mask, freqs, _NAN),
            torch.where(out_mask, pxx, _NAN))


def _welch_segmented(n: int, yv: Tensor, k: Tensor, fs: Tensor
                     ) -> tuple[Tensor, Tensor]:
    """scipy's multi-segment branch: nperseg 256, noverlap 128, periodic
    hann, constant detrend per segment, mean of the valid segments'
    periodograms (a segment s is valid when s * 128 + 256 <= K)."""
    nps = _WELCH_NPERSEG
    step = nps // 2
    max_segs = (n - step) // step
    segs = yv.unfold(-1, nps, step)[..., :max_segs, :]    # [..., G, nps]
    nseg = torch.clamp((k - step) // step, min=1)
    seg_ok = (torch.arange(max_segs, device=yv.device)
              < nseg[..., None]).to(torch.float32)
    segs = segs - segs.mean(-1, keepdim=True)
    i = torch.arange(nps, dtype=torch.float32, device=yv.device)
    win = 0.5 - 0.5 * torch.cos(2.0 * math.pi * i / nps)
    spec = dft.rfft(segs * win, nps)                     # [..., G, nps/2+1]
    scale = 1.0 / (fs * (win * win).sum())
    pxx = (spec.real ** 2 + spec.imag ** 2) * scale[..., None, None]
    bins = torch.arange(nps // 2 + 1, device=yv.device)
    pxx = torch.where((bins > 0) & (bins < nps // 2), 2.0 * pxx, pxx)
    pxx = (pxx * seg_ok[..., None]).sum(-2) / seg_ok.sum(-1, keepdim=True)
    freqs = bins.to(torch.float32) * fs[..., None] / nps
    pad = n - (nps // 2 + 1)
    return (torch.nn.functional.pad(freqs, (0, pad), value=_NAN),
            torch.nn.functional.pad(pxx, (0, pad), value=_NAN))


def lombscargle(x: Tensor, y: Tensor, min_freq: float, max_freq: float
                ) -> tuple[Tensor, Tensor]:
    """scipy ``lombscargle(..., floating_mean=True, normalize=True)`` over
    ``freqs = linspace(min_freq, max_freq, K)`` on the raw timestamps,
    NaN beyond the K valid bins.  x, y: [..., N]."""
    n = x.shape[-1]
    w = sig.valid_y(y) & sig.valid_x(x)
    k = w.sum(-1)
    kf = k.clamp(min=1).to(torch.float32)[..., None]
    wt = w.to(torch.float32) / kf
    xs = torch.where(w, x, 0.0)
    ys = torch.where(w, y, 0.0)

    i = torch.arange(n, dtype=torch.float32, device=x.device)
    freqs = min_freq + i * (max_freq - min_freq) / torch.clamp(kf - 1.0,
                                                               min=1.0)
    omega = 2.0 * math.pi * freqs
    ang = omega[..., :, None] * xs[..., None, :]           # [..., F, N]
    cos = torch.cos(ang)
    sin = torch.sin(ang)

    y_mean = (wt * ys).sum(-1)[..., None]
    cc = _dot(cos * cos, wt)
    cs = _dot(cos * sin, wt)
    c1 = _dot(cos, wt)
    s1 = _dot(sin, wt)
    ss = 1.0 - cc - s1 * s1
    cc = cc - c1 * c1
    cs = cs - c1 * s1

    tau = 0.5 * torch.atan2(2.0 * cs, cc - ss)
    cos_tau = torch.cos(tau)[..., None]
    sin_tau = torch.sin(tau)[..., None]
    cos_t = cos * cos_tau + sin * sin_tau
    sin_t = sin * cos_tau - cos * sin_tau

    wy = wt * ys
    yc_ = _dot(cos_t, wy)
    ys_ = _dot(sin_t, wy)
    cc_t = _dot(cos_t * cos_t, wt)
    c_t = _dot(cos_t, wt)
    s_t = _dot(sin_t, wt)
    ss_t = 1.0 - cc_t - s_t * s_t
    cc_t = cc_t - c_t * c_t
    yc_ = yc_ - y_mean * c_t
    ys_ = ys_ - y_mean * s_t

    cc_t = torch.clamp(cc_t, min=_F32_EPSNEG)
    ss_t = torch.clamp(ss_t, min=_F32_EPSNEG)
    a = yc_ / cc_t
    b = ys_ / ss_t
    pgram = 2.0 * (a * yc_ + b * ys_)
    yy = (wy * ys).sum(-1)[..., None] - y_mean * y_mean
    pgram = pgram * (0.5 / yy)

    out_mask = torch.arange(n, device=x.device) < k[..., None]
    return (torch.where(out_mask, freqs, _NAN),
            torch.where(out_mask, pgram, _NAN))


def transform_signal(cfg: SignalConfig, x: Tensor, y: Tensor
                     ) -> tuple[Tensor, Tensor]:
    """Dispatch on the configured transform; all-NaN when fewer than two
    valid samples or non-finite fs."""
    w = sig.valid_y(y)
    fs = sig.mean_fs(x)
    ok = ((w.sum(-1) >= 2) & torch.isfinite(fs))[..., None]
    if cfg.spectrum_transform in (T.DFT_RFFT, T.PGRAM_WELCH):
        fn = dft_rfft if cfg.spectrum_transform is T.DFT_RFFT else welch
        freqs, mags = fn(x, y, torch.where(torch.isfinite(fs), fs, 1.0))
    elif cfg.spectrum_transform is T.PGRAM_LS:
        freqs, mags = lombscargle(x, y, cfg.min_freq, cfg.max_freq)
    else:  # pragma: no cover
        raise NotImplementedError(cfg.spectrum_transform)
    return torch.where(ok, freqs, _NAN), torch.where(ok, mags, _NAN)
