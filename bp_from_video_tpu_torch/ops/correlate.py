"""Pairwise cross-correlation for pulse transit time — the counterpart of
``bp_from_video_tpu/ops/correlate.py`` (reference signal_processor.py:
280-295).  Output entry j of the static 2N-1 window is lag index j-(K-1)
of the reference's dynamic-length result (K = jointly valid count); the
K-dependent re-alignments are phase ramps on the matmul-DFT spectra, as in
the reference package.  Batched over leading dims.
"""

from __future__ import annotations

import math

import torch

from bp_from_video_tpu_torch.ops import dft
from bp_from_video_tpu_torch.ops import signal as sig

Tensor = torch.Tensor
_NAN = float("nan")


def _fft_len(n: int) -> int:
    """DFT length covering the shift wraparound (>= 3N-2, 256 multiple)."""
    return -(-(3 * n) // 256) * 256


def _shift_spectrum(spec: Tensor, shift: Tensor, length: int) -> Tensor:
    """Phase ramp realizing ``out[j] = in[j + shift]`` (circular);
    ``shift`` [...] per spectrum."""
    f = torch.arange(spec.shape[-1], dtype=torch.float32, device=spec.device)
    ang = (2.0 * math.pi / length) * f * shift.to(torch.float32)[..., None]
    return spec * torch.complex(torch.cos(ang), torch.sin(ang))


def correlate_pair(x_a: Tensor, y_a: Tensor, y_b: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """(lags_seconds, normalized_correlation), each [..., 2N-1]:
    corr = correlate(a, b) / max(a·a, b·b, a·b) over jointly valid
    samples; lags from the real timestamps.  All-NaN when K < 2."""
    n = x_a.shape[-1]
    nfft = _fft_len(n)
    w = sig.valid_y(y_a) & sig.valid_y(y_b)
    k = w.sum(-1)
    ok = k >= 2

    ca = sig.compact(w, y_a).values
    cb = sig.compact(w, y_b).values
    cx = sig.compact(w, x_a).values

    spec = dft.rfft(ca, nfft) * torch.conj(dft.rfft(cb, nfft))
    full_s = dft.irfft(_shift_spectrum(spec, -(k - 1), nfft), nfft,
                       out_len=2 * n - 1)

    aa = (ca * ca).sum(-1)
    bb = (cb * cb).sum(-1)
    ab = (ca * cb).sum(-1)
    denom = torch.maximum(torch.maximum(aa, bb), ab)
    denom = torch.where(denom == 0, 1.0, denom)
    corr = full_s / denom[..., None]

    j = torch.arange(2 * n - 1, device=x_a.device)
    li = j - (k - 1)[..., None]
    x_last = sig.take_at(cx, -1, k)
    centered = torch.where(torch.arange(n, device=x_a.device) < k[..., None],
                           cx - x_last[..., None], 0.0)
    fwd = torch.cat([centered, torch.zeros_like(centered[..., :n - 1])], -1)
    fr = dft.rfft(centered.flip(-1), nfft)
    bwd = dft.irfft(_shift_spectrum(fr, n - 1 - 2 * (k - 1), nfft), nfft,
                    out_len=2 * n - 1)
    x_rev_c = torch.where(li <= 0, fwd, bwd)
    lags = -x_rev_c * torch.sign(li).to(x_a.dtype)

    valid_out = (j < 2 * k[..., None] - 1) & ok[..., None]
    return (torch.where(valid_out, lags, _NAN),
            torch.where(valid_out, corr, _NAN))
