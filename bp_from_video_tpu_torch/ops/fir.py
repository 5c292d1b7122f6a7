"""Least-squares FIR band-pass — the counterpart of
``bp_from_video_tpu/ops/fir.py`` (reference signal_processor.py:163-170,
:231-236: ``scipy.signal.firls(taps, bands, [0,0,1,1,0,0], fs)`` +
``filtfilt(fir, 1.0, y, padlen)``).

The firls design solves a small symmetric positive definite system whose
entries are closed-form sinc integrals, one design per signal (each stream
has its own sampling frequency), batched over leading dims.  The system
goes through ``torch.linalg.cholesky_ex`` and ``torch.cholesky_solve``:
``torch.linalg.cholesky`` checks its info flag on the host, a device sync
every step.  The Gram matrix is assembled by indexing ``q`` (a gather,
exact), not by a float one-hot product.  The zero-phase application is two
causal convolutions through the matmul DFT of ``ops/dft``: for an FIR
filter, scipy's steady-state initial conditions equal a prefix of
``numtaps - 1`` copies of the first sample.
"""

from __future__ import annotations

import math

import torch

from bp_from_video_tpu_torch.ops import dft
from bp_from_video_tpu_torch.ops.iir import _reverse_prefix, _shifted, odd_ext

Tensor = torch.Tensor
_CACHE: dict = {}


def _gram_index(m_half: int, device) -> tuple[Tensor, Tensor]:
    """Static [M+1, M+1] indices |i - j| and i + j into q."""
    key = ("gram", m_half, str(device))
    if key not in _CACHE:
        i = torch.arange(m_half + 1, device=device)
        _CACHE[key] = ((i[:, None] - i[None, :]).abs(), i[:, None] + i[None, :])
    return _CACHE[key]


def firls_bandpass(numtaps: int, bands: Tensor, desired: Tensor, fs: Tensor
                   ) -> Tensor:
    """Type-I linear-phase least-squares FIR design, as
    ``scipy.signal.firls(numtaps, bands, desired, fs=fs)`` for piecewise-
    linear desired responses with unit weights.

    bands: [..., nbands, 2] edge pairs in Hz; desired: [nbands, 2]
    response at the edges; fs: [...].  Returns taps [..., numtaps]."""
    if numtaps % 2 != 1:
        raise ValueError("firls requires odd numtaps")
    m_half = (numtaps - 1) // 2
    dev = bands.device
    # Divided by a tensor: IEEE quotients (``2.0 / fs`` would multiply by
    # a reciprocal).
    f = bands * (torch.full_like(fs, 2.0) / fs)[..., None, None]
    d = desired.to(f.dtype)
    n_all = torch.arange(numtaps, dtype=torch.float32, device=dev)

    # q(n) = sum over bands of [f sinc(n f)]_{f0}^{f1}, n = 0..2M.
    g = torch.sinc(f[..., None, :, :] * n_all[:, None, None]) \
        * f[..., None, :, :]                          # [..., T, nb, 2]
    q = (g[..., 1] - g[..., 0]).sum(-1)               # [..., T]
    i_abs, i_sum = _gram_index(m_half, dev)
    q_mat = q[..., i_abs] + q[..., i_sum]             # [..., M+1, M+1]

    # b(n) with linear desired D(f) = slope f + const on each band.
    n = n_all[: m_half + 1][:, None, None]            # [M+1, 1, 1]
    fe = f[..., None, :, :]                           # [..., 1, nb, 2]
    slope = (d[:, 1:] - d[:, :1]) / (f[..., 1:] - f[..., :1])  # [..., nb, 1]
    const = d[:, :1] - f[..., :1] * slope
    sl = slope[..., None, :, :]
    b = fe * (sl * fe + const[..., None, :, :]) * torch.sinc(fe * n)
    b0 = b[..., :1, :, :] - sl * fe * fe / 2.0
    n1 = n[1:]
    b1 = b[..., 1:, :, :] + sl * torch.cos(n1 * math.pi * fe) \
        / (math.pi * n1) ** 2
    b = torch.cat([b0, b1], -3)
    b_vec = (b[..., 1] - b[..., 0]).sum(-1)           # [..., M+1]

    # Q is the Gram matrix of the cosine basis over the bands: SPD.
    chol, _info = torch.linalg.cholesky_ex(q_mat)
    a = torch.cholesky_solve(b_vec[..., None], chol)[..., 0]
    return torch.cat([a[..., 1:].flip(-1), 2.0 * a[..., :1], a[..., 1:]], -1)


def reference_fir_bands(lo: float, hi: float, df: float, fs: Tensor
                        ) -> tuple[Tensor, Tensor]:
    """The band layout the reference builds for FILTER_FIR
    (signal_processor.py:164-170): bands [..., 3, 2], desired [3, 2]."""
    lo_t = torch.full_like(fs, lo)
    hi_t = torch.full_like(fs, hi)
    b1 = torch.clamp(lo_t - df, min=df)
    b4 = torch.minimum(hi_t + df, fs / 2.0 - df)
    bands = torch.stack([torch.stack([torch.zeros_like(b1), b1], -1),
                         torch.stack([lo_t, hi_t], -1),
                         torch.stack([b4, fs / 2.0], -1)], -2)
    key = ("desired", str(fs.device))
    if key not in _CACHE:           # built once: a host-to-device copy syncs
        _CACHE[key] = torch.tensor([[0.0, 0.0], [1.0, 1.0], [0.0, 0.0]],
                                   device=fs.device)
    return bands, _CACHE[key]


def _causal_fir(h: Tensor, x: Tensor) -> Tensor:
    """Causal convolution conv(h, x)[..., :len(x)] through the matmul
    real DFT (nfft the linear-convolution length rounded up to 256)."""
    length = x.shape[-1]
    nfft = -(-(length + h.shape[-1] - 1) // 256) * 256
    return dft.irfft(dft.rfft(x, nfft) * dft.rfft(h, nfft), nfft,
                     out_len=length).to(x.dtype)


def filtfilt_fir(h: Tensor, yc: Tensor, count: Tensor, ext_cap: int
                 ) -> Tensor:
    """Zero-phase FIR filtering of the first ``count`` [...] entries of
    compacted ``yc`` [..., n] with taps ``h`` [..., numtaps], as
    ``scipy.signal.filtfilt(h, 1.0, y, padlen)`` with padlen =
    min(3 numtaps, count - 1).  ``ext_cap`` must be >= n + 2 * 3 numtaps
    + numtaps - 1."""
    numtaps = h.shape[-1]
    n = yc.shape[-1]
    padlen = torch.clamp(count - 1, max=3 * numtaps)
    nmask = torch.arange(n, device=yc.device) < count[..., None]
    yz = torch.where(nmask, yc, 0.0)
    pre = numtaps - 1               # the constant history standing for zi
    ext = odd_ext(yz, count, padlen, ext_cap - pre)
    ext_len = count + 2 * padlen

    def one_pass(s: Tensor) -> Tensor:
        head = s[..., :1].expand(s.shape[:-1] + (pre,))
        y = _causal_fir(h, torch.cat([head, s], -1))[..., pre:]
        keep = torch.arange(y.shape[-1], device=y.device) < ext_len[..., None]
        return torch.where(keep, y, 0.0)

    y = _reverse_prefix(one_pass(ext), ext_len)
    y = _reverse_prefix(one_pass(y), ext_len)
    out = _shifted(y, 0, n, padlen, n)
    return torch.where(nmask, out, 0.0)
