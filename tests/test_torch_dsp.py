"""The port's signal rings and DSP (ops/signal, iir, spectrum, correlate,
chain) against the reference package on the same NaN-prefilled rings.

The reference functions take one signal with time on axis 0 and are
vmapped here; the port takes a batch with time on the last axis.  Both run
in f32 on the CPU, through the same matmul-DFT bases, so results agree to
f32 roundoff; every tolerance below says why it is what it is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from bp_from_video_tpu.config import SignalConfig as JSignalConfig
from bp_from_video_tpu.ops import chain as jchain
from bp_from_video_tpu.ops import correlate as jcorr
from bp_from_video_tpu.ops import iir as jiir
from bp_from_video_tpu.ops import signal as jsig
from bp_from_video_tpu.ops import spectrum as jspec
from bp_from_video_tpu_torch.config import (SignalConfig,
                                            SignalProcessingMethod,
                                            SignalSpectrumTransform)
from bp_from_video_tpu_torch.ops import chain, correlate, iir, spectrum
from bp_from_video_tpu_torch.ops import signal as sig

N = 64
FS = 30.0


def _rings(seed=0, b=4, n=N, hz=1.3, delay=0):
    """NaN-prefilled rings: stream i holds its last k_i samples of a noisy
    pulse at ``hz`` with jittered timestamps (k_i = 0, 1, n/3, n)."""
    rng = np.random.default_rng(seed)
    x = np.full((b, n), np.nan, np.float32)
    y = np.full((b, n), np.nan, np.float32)
    counts = [0, 1, n // 3, n][:b]
    for i, k in enumerate(counts):
        t = (np.arange(k) + rng.uniform(-0.1, 0.1, k)) / FS + 3.0
        x[i, n - k:] = t
        y[i, n - k:] = (100 + 2 * np.sin(2 * np.pi * hz * (t - delay / FS))
                        + 0.3 * rng.standard_normal(k))
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), equal_nan=True, **kw)


def test_ring_push_and_push_if():
    x, y = _rings()
    new_x = np.arange(4, dtype=np.float32) + 10.0
    new_y = np.arange(4, dtype=np.float32) * 2.0
    cond = np.array([True, False, True, False])
    jx, jy = jax.vmap(jsig.push_if)(jnp.asarray(cond), jnp.asarray(x),
                                    jnp.asarray(y), jnp.asarray(new_x),
                                    jnp.asarray(new_y))
    _close(sig.push_if(_t(cond), _t(x), _t(new_x)), jx, rtol=0)
    _close(sig.push_if(_t(cond), _t(y), _t(new_y)), jy, rtol=0)
    # Vector rings (the ROI ring): time on axis -2.
    v = np.full((4, 5, 6), np.nan, np.float32)
    v[2:, 3:] = np.random.default_rng(1).uniform(0, 9, (2, 2, 6))
    nv = np.ones((4, 6), np.float32)
    _, jv = jax.vmap(jsig.push_if)(jnp.asarray(cond), jnp.zeros((4, 5)),
                                   jnp.asarray(v), jnp.zeros(4),
                                   jnp.asarray(nv))
    _close(sig.push_if(_t(cond), _t(v), _t(nv), dim=-2), jv, rtol=0)


def test_masks_means_and_ranges():
    x, y = _rings()
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    _close(sig.mean_fs(_t(x)), jax.vmap(jsig.mean_fs)(jx), rtol=1e-6)
    _close(sig.masked_mean(_t(y)), jax.vmap(jsig.masked_mean)(jy), rtol=1e-6)
    _close(sig.masked_mean(_t(y), as_int=True),
           jax.vmap(lambda a: jsig.masked_mean(a, as_int=True))(jy), rtol=0)
    v = np.full((3, 5, 6), np.nan, np.float32)
    v[1:, 2:] = np.random.default_rng(2).uniform(0, 50, (2, 3, 6))
    v[2, 3, 1] = np.nan                     # one row not all-finite
    _close(sig.masked_mean(_t(v), as_int=True, vec=True),
           jax.vmap(lambda a: jsig.masked_mean(a, as_int=True))(
               jnp.asarray(v)), rtol=0)
    for got, want in zip(sig.auto_range(_t(x), _t(y)),
                         jax.vmap(jsig.auto_range)(jx, jy)):
        _close(got, want, rtol=0)
    for got, want in zip(sig.peak_auto(_t(x), _t(y)),
                         jax.vmap(jsig.peak_auto)(jx, jy)):
        _close(got, want, rtol=0)
    for got, want in zip(sig.peak(_t(x), _t(y), 3.2, 4.0),
                         jax.vmap(lambda a, b: jsig.peak(a, b, 3.2, 4.0))(
                             jx, jy)):
        _close(got, want, rtol=0)
    los = np.array([[1.0, np.nan, 3.0], [np.nan, np.nan, 2.0]], np.float32)
    his = np.array([[5.0, 4.0, np.nan], [7.0, np.nan, 9.0]], np.float32)
    for got, want in zip(sig.group_range(_t(los), _t(his)),
                         jax.vmap(jsig.group_range)(jnp.asarray(los),
                                                    jnp.asarray(his))):
        _close(got, want, rtol=0)


def test_compact_scatter_back_and_take_at():
    x, y = _rings()
    m = np.isfinite(y)
    got = sig.compact(_t(m), _t(y), fill=-1.0)
    want = jax.vmap(lambda mm, yy: jsig.compact(mm, yy, fill=-1.0))(
        jnp.asarray(m), jnp.asarray(y))
    _close(got.values, want.values, rtol=0)
    np.testing.assert_array_equal(_np(got.count), np.asarray(want.count))
    back = sig.scatter_back(_t(m), got.values * 2.0, _t(y))
    _close(back, jax.vmap(jsig.scatter_back)(
        jnp.asarray(m), want.values * 2.0, jnp.asarray(y)), rtol=0)
    _close(sig.take_at(got.values, -1, got.count),
           jax.vmap(lambda v, c: jsig.take_at(v, -1, c))(want.values,
                                                         want.count), rtol=0)


def test_sosfiltfilt_matches_reference_and_scipy():
    x, y = _rings()
    m = np.isfinite(y)
    c = sig.compact(_t(m), _t(y))
    k = c.count.clamp(min=2)
    fs = sig.mean_fs(_t(x))
    fs = torch.where(torch.isfinite(fs), fs, 30.0)
    lo = torch.full((4,), 0.8)
    hi = torch.full((4,), 4.0)
    cap = N + 2 * iir.default_padlen(16)
    got = iir.sosfiltfilt(16, lo, hi, fs, c.values, k, cap)
    want = jax.vmap(lambda l_, h_, f_, v, n: jiir.sosfiltfilt(
        16, l_, h_, f_, v, n, cap))(jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(fs), jnp.asarray(c.values),
                                    jnp.asarray(k))
    # Same closed-form design and matmul DFT in f32: roundoff only,
    # relative to the signal's 2-unit amplitude.
    _close(got, want, atol=2e-4, rtol=0)
    # Independent oracle: scipy in f64 on the full ring, with the
    # reference's padlen = min(99, count - 1).
    sos = scipy.signal.butter(16, [0.8, 4.0], "bandpass", fs=float(fs[3]),
                              output="sos")
    ref = scipy.signal.sosfiltfilt(sos, y[3].astype(np.float64),
                                   padlen=N - 1)
    # f32 pipeline against f64: the reference package's documented ~1e-4
    # relative accuracy after pre-centering (a 2-unit pulse -> 1e-3).
    np.testing.assert_allclose(_np(got[3]), ref, atol=1e-3)


def test_lombscargle_matches_reference_and_scipy():
    x, y = _rings()
    # With the 100-unit DC left in, the floating-mean terms cancel ~5000:1,
    # so f32 roundoff in another summation order reaches ~1e-3 relative.
    _, gp = spectrum.lombscargle(_t(x), _t(y), 0.8, 4.0)
    _, wp = jax.vmap(lambda a, b: jspec.lombscargle(a, b, 0.8, 4.0))(
        jnp.asarray(x), jnp.asarray(y))
    _close(gp, wp, rtol=5e-3, atol=1e-4)
    # Centered, as the engine feeds it (the filtered signal): trig
    # contractions in another summation order, true f32 both.
    y = y - 100.0
    gf, gp = spectrum.lombscargle(_t(x), _t(y), 0.8, 4.0)
    wf, wp = jax.vmap(lambda a, b: jspec.lombscargle(a, b, 0.8, 4.0))(
        jnp.asarray(x), jnp.asarray(y))
    _close(gf, wf, rtol=1e-6)
    _close(gp, wp, rtol=1e-4, atol=1e-5)
    k = int(np.isfinite(y[3]).sum())
    freqs = np.linspace(0.8, 4.0, k)
    ref = scipy.signal.lombscargle(x[3, -k:].astype(np.float64),
                                   y[3, -k:].astype(np.float64),
                                   2 * np.pi * freqs, floating_mean=True,
                                   normalize=True)
    np.testing.assert_allclose(_np(gp[3, :k]), ref, atol=2e-3)
    assert int(torch.argmax(gp[3, :k])) == int(np.argmax(ref))


def test_correlate_pair_matches_reference():
    xa, ya = _rings(seed=4)
    _, yb = _rings(seed=4, delay=3)
    yb[:, :5] = np.nan                       # a shorter joint valid span
    gx, gy = correlate.correlate_pair(_t(xa), _t(ya), _t(yb))
    wx, wy = jax.vmap(jcorr.correlate_pair)(jnp.asarray(xa),
                                            jnp.asarray(ya),
                                            jnp.asarray(yb))
    # Lags: FFT phase-ramp shifts of timestamps centered on the last one
    # (roundoff scales with the lag, ~1e-6 s); correlation: f32 roundoff of
    # the normalized sums.
    _close(gx, wx, atol=1e-5, rtol=0)
    _close(gy, wy, atol=1e-5, rtol=0)
    assert torch.isnan(gy[0]).all() and torch.isnan(gy[1]).all()
    np.testing.assert_array_equal(
        _np(sig.peak_auto(gx, gy)[0]),
        np.asarray(jax.vmap(jsig.peak_auto)(wx, wy)[0]))


def test_process_signal_and_transform_match_reference():
    x, y = _rings(seed=5)
    cfg, jcfg = SignalConfig(signal_max_samples=N), JSignalConfig(
        signal_max_samples=N)
    px, py = chain.process_signal(cfg, _t(x), _t(y))
    jx, jy = jax.vmap(lambda a, b: jchain.process_signal(jcfg, a, b))(
        jnp.asarray(x), jnp.asarray(y))
    _close(px, jx, rtol=0)
    # The Butterworth chain's f32 roundoff (see the sosfiltfilt test).
    _close(py, jy, atol=2e-4, rtol=0)
    sx, sy = spectrum.transform_signal(cfg, px, py)
    wx, wy = jax.vmap(lambda a, b: jspec.transform_signal(jcfg, a, b))(
        jx, jy)
    _close(sx, wx, rtol=1e-6)
    # Lomb-Scargle of slightly different inputs: normalized power to 1e-3.
    _close(sy, wy, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(
        _np(sig.peak_auto(sx, sy)[0]),
        np.asarray(jax.vmap(jsig.peak_auto)(wx, wy)[0]))


@pytest.mark.parametrize("method", [SignalProcessingMethod.FILTER_FIR,
                                    SignalProcessingMethod.INTERP_CUBIC,
                                    SignalProcessingMethod.DIFF_1])
def test_unported_chain_methods_raise(method):
    x, y = _rings()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        chain.process_signal(SignalConfig(processing_methods=(method,)),
                             _t(x), _t(y))


def test_unported_spectra_raise():
    x, y = _rings()
    cfg = SignalConfig(spectrum_transform=SignalSpectrumTransform.PGRAM_WELCH)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        spectrum.transform_signal(cfg, _t(x), _t(y))
