"""The port's DSP chain (ops/chain, tridiag, fir) against the reference
package on the same NaN-masked rings, and against scipy as an independent
oracle.

The reference chain takes one ring with time on axis 0 and is vmapped here;
the port takes a batch with time on the last axis.  Both run in f32 on the
CPU.  Tolerances, and why:

- interpolation and detrending: atol 1e-5 of the signal's range (f32
  roundoff of values near 100 in another summation order; the port's
  linear detrend sums in f64, so the difference is the reference's own
  roundoff, up to 3.5e-5 on these rings);
- FIR output: atol 2e-4, as the Butterworth ``sosfiltfilt`` test has (the
  taps' Cholesky solve and the matmul DFT in f32);
- FIR taps: atol 1e-5;
- timestamps of the interpolation grid: rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.interpolate
import scipy.signal
import torch

from bp_from_video_tpu.config import SignalConfig as JSignalConfig
from bp_from_video_tpu.config import SignalProcessingMethod as JM
from bp_from_video_tpu.ops import chain as jchain
from bp_from_video_tpu.ops import fir as jfir
from bp_from_video_tpu.ops import tridiag as jtridiag
from bp_from_video_tpu_torch.config import SignalConfig
from bp_from_video_tpu_torch.config import SignalProcessingMethod as M
from bp_from_video_tpu_torch.ops import chain, fir, tridiag
from bp_from_video_tpu_torch.ops import signal as sig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 64
FS = 30.0


def _rings(seed=0, n=N):
    """Rows: all NaN; k = 2; k = 3; a full ring with NaN gaps in y only; a
    third of a ring with jittered timestamps; a full ring at 2 fps (too
    slow for the FIR and Butterworth bands: the NaN band); gaps in x and y
    at different slots; a full clean ring."""
    rng = np.random.default_rng(seed)
    x = np.full((8, n), np.nan, np.float32)
    y = np.full((8, n), np.nan, np.float32)

    def fill(row, k, fs=FS, jitter=0.1):
        t = (np.arange(k) + rng.uniform(-jitter, jitter, k)) / fs + 3.0
        x[row, n - k:] = t
        y[row, n - k:] = (100 + 2 * np.sin(2 * np.pi * 1.3 * t)
                          + 0.3 * rng.standard_normal(k))
    fill(1, 2)
    fill(2, 3)
    fill(3, n)
    y[3, [5, 6, 7, 30, 41]] = np.nan
    fill(4, n // 3)
    fill(5, n, fs=2.0)
    fill(6, n)
    x[6, [10, 40]] = np.nan
    y[6, [12, 13, 50]] = np.nan
    fill(7, n, jitter=0.0)
    return x, y


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _reference(methods, x, y):
    cfg = JSignalConfig(signal_max_samples=N,
                        processing_methods=tuple(JM[m.name] for m in methods))
    fn = jax.jit(jax.vmap(lambda a, b: jchain.process_signal(cfg, a, b)))
    return fn(jnp.asarray(x), jnp.asarray(y))


def _port(methods, x, y):
    cfg = SignalConfig(signal_max_samples=N, processing_methods=methods)
    return chain.process_signal(cfg, _t(x), _t(y))


_ALL = (M.DIFF_1, M.INTERP_LINEAR, M.DETREND_CONST, M.DIFF_2,
        M.INTERP_CUBIC, M.DETREND_LINEAR, M.FILTER_BUTTER, M.FILTER_FIR)
_SEG_FIR = (M.INTERP_CUBIC, M.DETREND_LINEAR, M.FILTER_FIR)
_FILTERS = (M.FILTER_BUTTER, M.FILTER_FIR)


@pytest.mark.parametrize("methods", [(m,) for m in M] + [_SEG_FIR, _ALL],
                         ids=[m.name for m in M] + ["segmenter_fir", "all8"])
def test_chain_matches_reference(methods):
    x, y = _rings()
    px, py = _port(methods, x, y)
    jx, jy = _reference(methods, x, y)
    np.testing.assert_allclose(_np(px), np.asarray(jx), rtol=1e-6, atol=0,
                               equal_nan=True)
    # NaN in the same slots: the masks carry over exactly.
    np.testing.assert_array_equal(np.isnan(_np(py)), np.isnan(np.asarray(jy)))
    rng_y = np.nanmax(y) - np.nanmin(y)
    atol = 2e-4 if any(m in _FILTERS for m in methods) else 1e-5 * rng_y
    np.testing.assert_allclose(_np(py), np.asarray(jy), rtol=0, atol=atol,
                               equal_nan=True)
    if M.FILTER_FIR in methods:
        # The 2 fps ring cannot hold the FIR's band layout: NaN where it
        # was valid (the Butterworth band clamps to 0.8-0.9 Hz and holds).
        assert np.isnan(_np(py)[5]).all()
    # An all-NaN ring and a ring of one... two samples pass through.
    np.testing.assert_array_equal(np.isnan(_np(py)[0]), True)


def test_interp_cubic_matches_scipy_spline():
    """The not-a-knot spline onto the uniform grid against scipy
    CubicSpline in f64: rows with k = 3 (a parabola), y-gaps, and a clean
    ring; k = 2 is a line."""
    x, y = _rings(1)
    px, py = _port((M.INTERP_CUBIC,), x, y)
    for row in (1, 2, 3, 4, 7):
        v = np.isfinite(y[row])
        xv, yv = x[row, v].astype(np.float64), y[row, v].astype(np.float64)
        blk = np.isfinite(x[row])
        grid = np.linspace(x[row, blk][0], x[row, blk][-1], blk.sum())
        if v.sum() == 2:
            want = np.interp(grid, xv, yv)
        else:
            want = scipy.interpolate.CubicSpline(xv, yv,
                                                 bc_type="not-a-knot")(grid)
        np.testing.assert_allclose(_np(px)[row, blk], grid, rtol=1e-6)
        # f32 against f64: 1e-5 of the range, scaled by the spline's
        # condition (extrapolation at the edges of a gap-free grid).
        np.testing.assert_allclose(_np(py)[row, blk], want,
                                   atol=5e-5 * (yv.max() - yv.min() + 1))


def test_interp_linear_and_detrend_match_numpy_scipy():
    x, y = _rings(2)
    _, pl = _port((M.INTERP_LINEAR,), x, y)
    _, pd = _port((M.DETREND_LINEAR,), x, y)
    for row in (3, 4, 7):
        v = np.isfinite(y[row])
        blk = np.isfinite(x[row])
        xv, yv = x[row, v].astype(np.float64), y[row, v].astype(np.float64)
        grid = np.linspace(x[row, blk][0], x[row, blk][-1], blk.sum())
        rng_y = yv.max() - yv.min()
        np.testing.assert_allclose(_np(pl)[row, blk], np.interp(grid, xv, yv),
                                   atol=1e-5 * rng_y + 2e-5)
        np.testing.assert_allclose(_np(pd)[row, v],
                                   scipy.signal.detrend(yv, type="linear"),
                                   atol=1e-5 * rng_y + 2e-5)


def test_filter_fir_matches_scipy_filtfilt():
    """The FIR chain element on a clean ring against scipy.signal.firls +
    filtfilt in f64 with the reference's padlen."""
    x, y = _rings(3)
    cfg = SignalConfig(signal_max_samples=N,
                       processing_methods=(M.FILTER_FIR,))
    _, py = chain.process_signal(cfg, _t(x), _t(y))
    row = 7
    fs = float(sig.mean_fs(_t(x[row:row + 1]))[0])
    df = cfg.fir_df
    bands = [0, max(cfg.min_freq - df, df), cfg.min_freq, cfg.max_freq,
             min(cfg.max_freq + df, fs / 2 - df), fs / 2]
    h = scipy.signal.firls(cfg.fir_taps, bands, [0, 0, 1, 1, 0, 0], fs=fs)
    want = scipy.signal.filtfilt(h, 1.0, y[row].astype(np.float64),
                                 padlen=N - 1)
    # f32 against f64 (the DC of 100 cancels in the band-pass).
    np.testing.assert_allclose(_np(py)[row], want, atol=2e-3)


def test_pcr_solve_matches_reference_and_numpy():
    rng = np.random.default_rng(4)
    b_, n = 3, 37
    a = rng.uniform(-1, 1, (b_, n)).astype(np.float32)
    c = rng.uniform(-1, 1, (b_, n)).astype(np.float32)
    b = (np.abs(a) + np.abs(c) + rng.uniform(0.5, 2, (b_, n))).astype(
        np.float32)
    d = rng.standard_normal((b_, n)).astype(np.float32)
    a[:, 0] = 0
    c[:, -1] = 0
    got = _np(tridiag.pcr_solve(_t(a), _t(b), _t(c), _t(d)))
    want = np.asarray(jtridiag.pcr_solve(jnp.asarray(a), jnp.asarray(b),
                                         jnp.asarray(c), jnp.asarray(d)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for i in range(b_):
        m = (np.diag(b[i].astype(np.float64)) + np.diag(a[i, 1:], -1)
             + np.diag(c[i, :-1], 1))
        np.testing.assert_allclose(got[i], np.linalg.solve(m, d[i]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fs", [30.0, 14.5, 60.0])
def test_firls_bandpass_matches_reference_and_scipy(fs):
    cfg = SignalConfig()
    fs_t = torch.tensor([fs, fs], dtype=torch.float32)
    bands, desired = fir.reference_fir_bands(cfg.min_freq, cfg.max_freq,
                                             cfg.fir_df, fs_t)
    got = _np(fir.firls_bandpass(cfg.fir_taps, bands, desired, fs_t))
    jb, jd = jfir.reference_fir_bands(jnp.float32(cfg.min_freq),
                                      jnp.float32(cfg.max_freq),
                                      jnp.float32(cfg.fir_df),
                                      jnp.float32(fs))
    want = np.asarray(jfir.firls_bandpass(cfg.fir_taps, jb, jd,
                                          jnp.float32(fs)))
    np.testing.assert_allclose(_np(bands)[0], np.asarray(jb), rtol=1e-7)
    np.testing.assert_allclose(got[0], want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[0], got[1])
    ref = scipy.signal.firls(cfg.fir_taps, _np(bands)[0].reshape(-1)
                             .astype(np.float64), [0, 0, 1, 1, 0, 0], fs=fs)
    np.testing.assert_allclose(got[0], ref, atol=1e-5, rtol=0)


def test_selection_is_a_gather():
    """``selmm`` picks values exactly (no float product), 0 where a row has
    no bracket; ``take_at`` takes the count per row."""
    cx = torch.tensor([[1e4 + 0.25, 1e4 + 0.5, 1e4 + 0.75, 0.0]])
    k = torch.tensor([3])
    q = torch.tensor([[1e4 + 0.3, 1e4 + 0.6, 1e4 + 0.9, 5.0]])
    m, x0s, _ = sig.bracket_matrix(cx, k, q)
    sel = sig.select_rows(m)
    got = sig.selmm(sel, sig.zero_infs(x0s))
    assert got.tolist() == [[1e4 + 0.25, 1e4 + 0.5, 0.0, 0.0]]
    assert sel.has.tolist() == [[True, True, False, False]]
    assert sel.idx[0, :2].tolist() == [0, 1]
    v = torch.arange(12.0).reshape(3, 4)
    cnt = torch.tensor([4, 2, 0])
    assert sig.take_at(v, -1, cnt).tolist() == [3.0, 5.0, 11.0]
