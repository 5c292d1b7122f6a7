"""The per-frame DSP chain — the counterpart of
``bp_from_video_tpu/ops/chain.py`` (reference signal_processor.py:196-241):
derivatives, linear / cubic interpolation onto a uniform grid, constant /
linear detrending, and Butterworth / FIR zero-phase band-pass, applied in
configured order over the valid samples of NaN-masked rings.

Batched over leading dims with time on the last axis: where the JAX module
runs one ring under ``vmap``, every per-ring scalar here (valid counts,
``fs``, the grid step, detrend sums) is a ``[...]`` tensor.  Nothing reads
a value back to the host.  Segment selection is by index
(``signal.selmm``), so interpolated values and grid timestamps do not
depend on the matmul precision in force.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bp_from_video_tpu_torch.config import (SignalConfig,
                                            SignalProcessingMethod as M)
from bp_from_video_tpu_torch.ops import fir, iir, tridiag
from bp_from_video_tpu_torch.ops import signal as sig
from bp_from_video_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


class ChainState(NamedTuple):
    x: Tensor       # [..., N] timestamps
    y: Tensor       # [..., N] values, NaN at invalid slots
    valid: Tensor   # [..., N] current valid mask
    block: Tensor   # [..., N] x-finite mask
    fs: Tensor      # [...] sampling frequency


def _safe(v: Tensor, fallback: float = 1.0) -> Tensor:
    return torch.where(torch.isfinite(v), v, fallback)


# --- individual methods ------------------------------------------------------


def diff1(st: ChainState) -> ChainState:
    """y[valid] = diff(y[valid], n=1, prepend=y[valid][0])."""
    c = sig.compact(st.valid, st.y)
    v = c.values
    d = v - torch.cat([v[..., :1], v[..., :-1]], -1)
    return st._replace(y=sig.scatter_back(st.valid, d, st.y))


def diff2(st: ChainState) -> ChainState:
    """y[valid] = diff(y[valid], n=2, prepend=y[valid][:2])."""
    c = sig.compact(st.valid, st.y)
    v = c.values
    z = torch.cat([v[..., :2], v], -1)
    d1 = z[..., 1:] - z[..., :-1]
    d2 = (d1[..., 1:] - d1[..., :-1])[..., : v.shape[-1]]
    return st._replace(y=sig.scatter_back(st.valid, d2, st.y))


def _block_grid(st: ChainState) -> tuple[Tensor, Tensor, Tensor]:
    """Uniform grid spanning x[block] with block.sum() points (np.linspace
    with retstep): (grid [..., N], step [...], count [...])."""
    n = st.x.shape[-1]
    cb = sig.compact(st.block, st.x)
    kb = cb.count
    x0 = cb.values[..., 0]
    x1 = sig.take_at(cb.values, -1, kb)
    ts = (x1 - x0) / torch.clamp(kb - 1, min=1)
    i = torch.arange(n, dtype=st.x.dtype, device=st.x.device)
    return x0[..., None] + i * ts[..., None], ts, kb


def interp_linear(st: ChainState) -> ChainState:
    """np.interp of the valid samples onto the uniform block grid;
    valid := block, fs := 1 / step."""
    grid, ts, _ = _block_grid(st)
    cx = sig.compact(st.valid, st.x)
    cy = sig.compact(st.valid, st.y)
    k = cx.count
    m, x0s, x1s = sig.bracket_matrix(cx.values, k, grid)
    mf = sig.select_rows(m)
    y1s = torch.cat([cy.values[..., 1:], cy.values[..., -1:]], -1)
    x_j = sig.selmm(mf, sig.zero_infs(x0s))
    x_j1 = sig.selmm(mf, sig.zero_infs(x1s))
    y_j = sig.selmm(mf, cy.values)
    y_j1 = sig.selmm(mf, y1s)
    t = (grid - x_j) / torch.where(x_j1 == x_j, 1.0, x_j1 - x_j)
    y_new = y_j + torch.clamp(t, 0.0, 1.0) * (y_j1 - y_j)   # np.interp clamps
    # Outside the valid x-range: the endpoint values (this also covers
    # grid == x_last, which the half-open brackets do not hit).
    y_new = torch.where(grid <= cx.values[..., :1], cy.values[..., :1], y_new)
    y_last = sig.take_at(cy.values, -1, k)[..., None]
    x_last = sig.take_at(cx.values, -1, k)[..., None]
    y_new = torch.where(grid >= x_last, y_last, y_new)
    x_out = sig.scatter_back(st.block, grid, st.x)
    y_out = sig.scatter_back(st.block, y_new, st.y)
    return ChainState(x_out, y_out, st.block, st.block, 1.0 / ts)


def _notaknot_m(xc: Tensor, yc: Tensor, k: Tensor) -> Tensor:
    """Second derivatives at the knots of the not-a-knot cubic spline
    through the first ``k`` [...] points of (xc, yc) [..., N]; k == 2 is a
    line and k == 3 a parabola, as in scipy.

    Solved in scipy's slope formulation, whose not-a-knot boundary rows are
    themselves tridiagonal (``tridiag.pcr_solve``); the slopes then give
    the knot second derivatives: on segment j, y''(x_j) = (6 slope_j -
    4 s_j - 2 s_{j+1}) / h_j, and the last knot takes segment k-2's right
    end."""
    n = xc.shape[-1]
    kk = k[..., None]
    seg = torch.arange(n - 1, device=xc.device) < kk - 1
    hs = torch.where(seg, xc[..., 1:] - xc[..., :-1], 1.0)
    hs = torch.where(hs == 0, 1.0, hs)
    slope = torch.where(seg, (yc[..., 1:] - yc[..., :-1]) / hs, 0.0)
    one = torch.ones_like(xc[..., :1])
    zero = torch.zeros_like(xc[..., :1])
    h_j = torch.cat([hs, one], -1)
    h_jm1 = torch.cat([one, hs], -1)
    s_j = torch.cat([slope, zero], -1)
    s_jm1 = torch.cat([zero, slope], -1)
    idx = torch.arange(n, device=xc.device)
    interior = (idx >= 1) & (idx <= kk - 2)

    # Interior rows (scipy's i = 1..k-2): h_i s_{i-1} + 2 (h_{i-1} + h_i)
    # s_i + h_{i-1} s_{i+1} = 3 (h_i slope_{i-1} + h_{i-1} slope_i).
    a = torch.where(interior, h_j, 0.0)
    b = torch.where(interior, 2.0 * (h_jm1 + h_j), 1.0)
    c = torch.where(interior, h_jm1, 0.0)
    d = torch.where(interior, 3.0 * (h_j * s_jm1 + h_jm1 * s_j), 0.0)

    h0, h1 = hs[..., 0], hs[..., 1]
    s0, s1 = slope[..., 0], slope[..., 1]
    hk2 = sig.take_at(hs, -1, k - 1)       # h_{k-2}, the last segment
    hk3 = sig.take_at(hs, -2, k - 1)
    sk2 = sig.take_at(slope, -1, k - 1)
    sk3 = sig.take_at(slope, -2, k - 1)

    big = k > 3
    # k > 3: not-a-knot rows; k == 3: scipy's parabola rows (s0 + s1 =
    # 2 slope0 and s_{k-2} + s_{k-1} = 2 slope_{k-2}).
    d0f = h0 + h1
    b_f = torch.where(big, h1, 1.0)
    c_f = torch.where(big, d0f, 1.0)
    d_f = torch.where(big, ((h0 + 2.0 * d0f) * h1 * s0 + h0 * h0 * s1) / d0f,
                      2.0 * s0)
    dlf = hk3 + hk2
    a_l = torch.where(big, dlf, 1.0)
    b_l = torch.where(big, hk3, 1.0)
    d_l = torch.where(big,
                      (hk2 * hk2 * sk3 + (2.0 * dlf + hk2) * hk3 * sk2) / dlf,
                      2.0 * sk2)
    # k == 2: both boundary rows read s = slope0 (a line); k <= 1: identity.
    small = k <= 2
    s_line = torch.where(k == 2, s0, 0.0)
    b_f = torch.where(small, 1.0, b_f)
    c_f = torch.where(small, 0.0, c_f)
    d_f = torch.where(small, s_line, d_f)
    a_l = torch.where(small, 0.0, a_l)
    b_l = torch.where(small, 1.0, b_l)
    d_l = torch.where(small, s_line, d_l)

    is_first = idx == 0
    is_last = idx == kk - 1
    a = torch.where(is_first, 0.0, torch.where(is_last, a_l[..., None], a))
    b = torch.where(is_first, b_f[..., None],
                    torch.where(is_last, b_l[..., None], b))
    c = torch.where(is_first, c_f[..., None], torch.where(is_last, 0.0, c))
    d = torch.where(is_first, d_f[..., None],
                    torch.where(is_last, d_l[..., None], d))

    s_knots = tridiag.pcr_solve(a, b, c, d)

    # Slopes -> knot second derivatives (Hermite segment ends).
    sj1 = torch.cat([s_knots[..., 1:], s_knots[..., -1:]], -1)
    m2_left = (6.0 * s_j - 4.0 * s_knots - 2.0 * sj1) / h_j
    m2_last = ((-6.0 * sig.take_at(s_j, -2, k)
                + 2.0 * sig.take_at(s_knots, -2, k)
                + 4.0 * sig.take_at(sj1, -2, k)) / sig.take_at(h_j, -2, k))
    m2 = torch.where(idx == kk - 1, m2_last[..., None], m2_left)
    return torch.where(kk <= 2, 0.0, m2)


def _spline_eval(xc: Tensor, yc: Tensor, m2: Tensor, k: Tensor, t: Tensor
                 ) -> Tensor:
    """The cubic with knot second derivatives ``m2`` at points ``t``
    [..., Q], extrapolating with the end polynomials like scipy
    CubicSpline: queries left of the data use segment 0, queries at or
    right of the last knot segment k-2."""
    m, x0s, x1s = sig.bracket_matrix(xc, k, t)
    col = torch.arange(xc.shape[-1], device=xc.device)
    x_last = sig.take_at(xc, -1, k)[..., None]
    first = col == 0
    last_seg = col == torch.clamp(k - 2, min=0)[..., None]
    m = (m | ((t < x0s[..., :1])[..., :, None] & first)
         | ((t >= x_last)[..., :, None] & last_seg[..., None, :]))
    mf = sig.select_rows(m)
    y1s = torch.cat([yc[..., 1:], yc[..., -1:]], -1)
    m2n = torch.cat([m2[..., 1:], m2[..., -1:]], -1)
    xj = sig.selmm(mf, sig.zero_infs(x0s))
    xj1 = sig.selmm(mf, sig.zero_infs(x1s))
    # The k-2 extrapolation segment's right knot is x_last itself (x1s has
    # the inf sentinel at and beyond count-1): rebuild it from the data.
    xj1 = torch.where(t >= x_last, x_last, xj1)
    yj = sig.selmm(mf, yc)
    yj1 = sig.selmm(mf, y1s)
    m2j = sig.selmm(mf, m2)
    m2j1 = sig.selmm(mf, m2n)
    h = torch.where(xj1 == xj, 1.0, xj1 - xj)
    dr = xj1 - t
    dl = t - xj
    return (m2j * dr ** 3 / (6.0 * h) + m2j1 * dl ** 3 / (6.0 * h)
            + (yj / h - m2j * h / 6.0) * dr
            + (yj1 / h - m2j1 * h / 6.0) * dl)


def interp_cubic(st: ChainState) -> ChainState:
    """Not-a-knot cubic spline of the valid samples onto the uniform block
    grid (scipy.interpolate.CubicSpline); valid := block, fs := 1 / step."""
    grid, ts, _ = _block_grid(st)
    cx = sig.compact(st.valid, st.x)
    cy = sig.compact(st.valid, st.y)
    m2 = _notaknot_m(cx.values, cy.values, cx.count)
    y_new = _spline_eval(cx.values, cy.values, m2, cx.count, grid)
    x_out = sig.scatter_back(st.block, grid, st.x)
    y_out = sig.scatter_back(st.block, y_new, st.y)
    return ChainState(x_out, y_out, st.block, st.block, 1.0 / ts)


def detrend_const(st: ChainState) -> ChainState:
    """Subtract the mean of the valid samples."""
    cnt = torch.clamp(st.valid.sum(-1), min=1)
    mean = torch.where(st.valid, st.y, 0.0).sum(-1) / cnt
    return st._replace(y=torch.where(st.valid, st.y - mean[..., None], st.y))


def detrend_linear(st: ChainState) -> ChainState:
    """Subtract the least-squares line over the sample index
    (scipy.signal.detrend(type='linear')).  The sums and the residual are
    taken in f64 and rounded once: in f32 the line's intercept (about the
    signal's DC) rounds in the sums, and the residual, a few units beside
    a DC of about 100, would carry errors of several ulps of the DC in an
    order-dependent way."""
    c = sig.compact(st.valid, st.y)
    n = c.values.shape[-1]
    f64 = torch.float64
    v = c.values.to(f64)
    kf = torch.clamp(c.count, min=1).to(f64)
    i = torch.arange(n, dtype=f64, device=st.y.device)
    m = sig.arange_mask(n, c.count)
    si = torch.where(m, i, 0.0).sum(-1)
    sii = torch.where(m, i * i, 0.0).sum(-1)
    sy = torch.where(m, v, 0.0).sum(-1)
    siy = torch.where(m, i * v, 0.0).sum(-1)
    det = kf * sii - si * si
    det = torch.where(det == 0, 1.0, det)
    slope = (kf * siy - si * sy) / det
    icept = (sy - slope * si) / kf
    resid = v - (slope[..., None] * i + icept[..., None])
    return st._replace(y=sig.scatter_back(st.valid, resid.to(st.y.dtype),
                                          st.y))


def make_filter_butter(cfg: SignalConfig, st: ChainState) -> ChainState:
    """Butterworth band-pass with the Nyquist-clamped band; a sampling rate
    too low to hold the band degrades the samples to NaN."""
    fs = _safe(st.fs, 100.0)
    lo = torch.clamp(fs / 2.0 - 2.0 * cfg.butter_min_bw, max=cfg.min_freq)
    hi = torch.clamp(fs / 2.0 - cfg.butter_min_bw, max=cfg.max_freq)
    band_ok = (lo > 0.0) & (hi > lo)
    lo_s = torch.where(band_ok, lo, 0.1)
    hi_s = torch.where(band_ok, hi, 0.2)
    fs_s = torch.where(band_ok, fs, 100.0)
    c = sig.compact(st.valid, st.y)
    ext_cap = st.y.shape[-1] + 2 * iir.default_padlen(cfg.butter_order)
    out = iir.sosfiltfilt(cfg.butter_order, lo_s, hi_s, fs_s, c.values,
                          c.count.clamp(min=2), ext_cap)
    out = torch.where(band_ok[..., None], out, float("nan"))
    return st._replace(y=sig.scatter_back(st.valid, out, st.y))


def make_filter_fir(cfg: SignalConfig, st: ChainState) -> ChainState:
    """Least-squares FIR band-pass.  Where the sampling rate cannot hold
    the reference's band layout (edges overlapping or out of order, e.g.
    fs < 2 (max_freq + fir_df)) the firls system is singular and scipy
    would raise; the samples degrade to NaN instead."""
    fs = _safe(st.fs, 100.0)
    bands, desired = fir.reference_fir_bands(cfg.min_freq, cfg.max_freq,
                                             cfg.fir_df, fs)
    # Monotone non-overlapping edges: 0 < b1 <= lo < hi <= b4 < fs/2.
    edges = bands.flatten(-2)
    band_ok = ((edges[..., 1:] >= edges[..., :-1]).all(-1)
               & (edges[..., 1] > 0.0))
    fallback = torch.arange(6, dtype=bands.dtype, device=bands.device
                            ).reshape(3, 2)
    bands_s = torch.where(band_ok[..., None, None], bands, fallback)
    fs_s = torch.where(band_ok, fs, 100.0)
    h = fir.firls_bandpass(cfg.fir_taps, bands_s, desired, fs_s)
    c = sig.compact(st.valid, st.y)
    ext_cap = st.y.shape[-1] + 2 * 3 * cfg.fir_taps + cfg.fir_taps - 1
    out = fir.filtfilt_fir(h, c.values, c.count.clamp(min=2), ext_cap)
    out = torch.where(band_ok[..., None], out, float("nan"))
    return st._replace(y=sig.scatter_back(st.valid, out, st.y))


_METHOD_FNS = {
    M.DIFF_1: lambda cfg, st: diff1(st),
    M.DIFF_2: lambda cfg, st: diff2(st),
    M.INTERP_LINEAR: lambda cfg, st: interp_linear(st),
    M.INTERP_CUBIC: lambda cfg, st: interp_cubic(st),
    M.DETREND_CONST: lambda cfg, st: detrend_const(st),
    M.DETREND_LINEAR: lambda cfg, st: detrend_linear(st),
    M.FILTER_BUTTER: make_filter_butter,
    M.FILTER_FIR: make_filter_fir,
}


def process_signal(cfg: SignalConfig, x: Tensor, y: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """Run the configured chain over signal rings (x, y: [..., N]); the
    chain only applies where >= 2 samples are valid and fs is finite,
    elsewhere (x, y) pass through untouched.  Each method is a span
    ``bpv.dsp.<method>``."""
    st = ChainState(x=x, y=y, valid=sig.valid_y(y), block=sig.valid_x(x),
                    fs=sig.mean_fs(x))
    ok = ((st.valid.sum(-1) >= 2) & torch.isfinite(st.fs))[..., None]
    out = st
    for method in cfg.processing_methods:
        with span(f"bpv.dsp.{method.value}"):
            out = _METHOD_FNS[method](cfg, out)
    return torch.where(ok, out.x, x), torch.where(ok, out.y, y)
