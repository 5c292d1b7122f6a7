"""Spectral estimators — the counterpart of
``bp_from_video_tpu/ops/spectrum.py`` (reference signal_processor.py:
248-273).  This slice ports the generalized (floating-mean, normalized)
Lomb-Scargle periodogram, the default BPM path, as masked dense trig
contractions batched over leading dims.  The contractions must be true f32:
the package never enables TF32 (a reduced-precision trig contraction flips
near-tie BPM bins).
"""

from __future__ import annotations

import math

import torch

from bp_from_video_tpu_torch.config import (SignalConfig,
                                            SignalSpectrumTransform as T)
from bp_from_video_tpu_torch.ops import signal as sig

Tensor = torch.Tensor

_F32_EPSNEG = float(torch.finfo(torch.float32).eps) / 2.0  # numpy epsneg
_NAN = float("nan")


def _dot(m: Tensor, v: Tensor) -> Tensor:
    """[..., F, N] @ [..., N] -> [..., F]."""
    return (m @ v[..., None])[..., 0]


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
    if cfg.spectrum_transform is T.PGRAM_LS:
        freqs, mags = lombscargle(x, y, cfg.min_freq, cfg.max_freq)
    elif cfg.spectrum_transform in (T.DFT_RFFT, T.PGRAM_WELCH):
        raise NotImplementedError(
            f"{cfg.spectrum_transform}: not ported yet (ROADMAP Queue 1 "
            "item 9, rest of the DSP)")
    else:  # pragma: no cover
        raise NotImplementedError(cfg.spectrum_transform)
    return torch.where(ok, freqs, _NAN), torch.where(ok, mags, _NAN)
