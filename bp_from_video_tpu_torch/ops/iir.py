"""Zero-phase Butterworth band-pass — the counterpart of
``bp_from_video_tpu/ops/iir.py`` (reference signal_processor.py:159-162,
:225-230: ``scipy.signal.butter(..., output='sos')`` + ``sosfiltfilt``).

Same construction as the reference package: the band-pass is designed from
a per-signal sampling frequency in closed form (prototype -> lp2bp ->
bilinear), the whole section cascade is applied as one spectral multiply
(rfft -> analytic response -> irfft, ``ops/dft``), and ``sosfiltfilt``'s odd
extension and reversals use per-signal dynamic counts over static shapes.
Everything is batched over leading dims (one band design per signal).
"""

from __future__ import annotations

import math

import torch

from bp_from_video_tpu_torch.ops import dft

Tensor = torch.Tensor


def _ipow(x: Tensor, y: int) -> Tensor:
    """x**y by binary exponentiation in the same multiply order as XLA's
    ``integer_pow`` (so complex powers round like the reference)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def butter_bandpass_poles(order: int, lo: Tensor, hi: Tensor, fs: Tensor
                          ) -> tuple[Tensor, Tensor]:
    """Digital poles of ``butter(order, [lo, hi], 'bandpass', fs=fs)`` —
    one representative per conjugate pair, ``[..., order]`` complex — plus
    the overall real gain ``[...]``."""
    if order % 2 != 0:
        raise ValueError("even butterworth order required (reference default 16)")
    w_lo = 4.0 * torch.tan(math.pi * lo / fs)
    w_hi = 4.0 * torch.tan(math.pi * hi / fs)
    bw = w_hi - w_lo
    wo2 = w_lo * w_hi
    m = torch.arange(1, order, 2, dtype=torch.float32, device=lo.device)
    p = -torch.exp(1j * math.pi * m / (2 * order))
    p_lp = p * (bw / 2.0)[..., None]
    s = torch.sqrt(p_lp * p_lp - wo2[..., None])
    p_bp = torch.cat([p_lp + s, p_lp - s], dim=-1)
    fs2 = 4.0
    p_d = (fs2 + p_bp) / (fs2 - p_bp)
    log_prod_p = torch.log(torch.abs(fs2 - p_bp) ** 2).sum(-1)
    log_k = order * (torch.log(bw) + math.log(fs2)) - log_prod_p
    return p_d, torch.exp(log_k)


def default_padlen(order: int) -> int:
    """scipy's default sosfiltfilt padlen for this design: 3*(2*n_sec+1)."""
    return 3 * (2 * order + 1)


def sosfilt_conv(p_d: Tensor, gain: Tensor, x: Tensor, x0: Tensor
                 ) -> Tensor:
    """Causal Butterworth cascade of ``x`` [..., L] (with section 0's
    steady-state initial condition from ``x0`` [...]) as ONE spectral
    multiply; circular wraparound decays like r^nfft, nfft >= 2L."""
    length = x.shape[-1]
    n_sec = p_d.shape[-1]
    g = torch.exp(torch.log(gain) / n_sec)
    nfft = -(-(2 * length) // 256) * 256
    w = 2.0 * math.pi * torch.arange(nfft // 2 + 1, dtype=torch.float32,
                                     device=x.device) / nfft
    z1 = torch.exp(-1j * w)
    z2 = z1 * z1
    b = g[..., None] * (1.0 - z2)                                 # [..., F]
    a = (1.0 - (2.0 * p_d.real)[..., :, None] * z1
         + (torch.abs(p_d) ** 2)[..., :, None] * z2)              # [..., n, F]
    inv_a = torch.prod(1.0 / a, dim=-2)
    h_all = _ipow(b, n_sec) * inv_a
    h_zi = _ipow(b, n_sec - 1) * inv_a
    xf = dft.rfft(x, nfft)
    yf = h_all * xf + h_zi * ((-g * x0)[..., None] * (1.0 + z1))
    return dft.irfft(yf, nfft, out_len=length).to(x.dtype)


def _take(a: Tensor, idx: Tensor) -> Tensor:
    """a[..., idx] with idx clamped in range (callers mask the rest)."""
    idx = idx.clamp(0, a.shape[-1] - 1)
    return torch.gather(a, -1, idx.expand(a.shape[:-1] + idx.shape[-1:]))


def odd_ext(yc: Tensor, count: Tensor, padlen: Tensor, ext_cap: int
            ) -> Tensor:
    """Odd extension of the first ``count`` entries of ``yc`` by
    ``padlen`` on each side into a length-``ext_cap`` buffer (zeros
    beyond) — scipy's ``odd_ext`` with per-signal dynamic counts."""
    i = torch.arange(ext_cap, device=yc.device)
    p = padlen[..., None]
    cnt = count[..., None]
    y0 = yc[..., :1]
    y_last = _take(yc, cnt - 1)
    left = 2.0 * y0 - _take(yc, p - i)
    mid = _take(yc, i - p)
    right = 2.0 * y_last - _take(yc, 2 * cnt - 2 + p - i)
    zero = torch.zeros((), dtype=yc.dtype, device=yc.device)
    return torch.where(i < p, left, torch.where(
        i < p + cnt, mid, torch.where(i < 2 * p + cnt, right, zero)))


def _reverse_prefix(a: Tensor, length: Tensor) -> Tensor:
    """Reverse the first ``length`` entries of ``a`` (zeros elsewhere)."""
    i = torch.arange(a.shape[-1], device=a.device)
    ln = length[..., None]
    return torch.where(i < ln, _take(a, ln - 1 - i), 0.0)


def sosfiltfilt(order: int, lo: Tensor, hi: Tensor, fs: Tensor,
                yc: Tensor, count: Tensor, ext_cap: int) -> Tensor:
    """Zero-phase band-pass of the first ``count`` entries of compacted
    ``yc`` [..., n] (scipy ``sosfiltfilt(butter(...), y,
    padlen=min(3*(2*nsec+1), count-1))``); returns compacted output."""
    p_d, gain = butter_bandpass_poles(order, lo, hi, fs)
    padlen = torch.clamp(count - 1, max=default_padlen(order))
    n = yc.shape[-1]
    nmask = torch.arange(n, device=yc.device) < count[..., None]
    mean = (torch.where(nmask, yc, 0.0).sum(-1)
            / count.clamp(min=1))[..., None]
    yz = torch.where(nmask, yc - mean, 0.0)
    ext = odd_ext(yz, count, padlen, ext_cap)
    ext_len = count + 2 * padlen
    y = sosfilt_conv(p_d, gain, ext, ext[..., 0])
    y = _reverse_prefix(y, ext_len)
    y = sosfilt_conv(p_d, gain, y, y[..., 0])
    y = _reverse_prefix(y, ext_len)
    out = _take(y, padlen[..., None] + torch.arange(n, device=yc.device))
    return torch.where(nmask, out, 0.0)
