"""The port's spectra (``dft_rfft``, ``welch`` in both of scipy's regimes)
against the reference package on the same NaN-masked rings, and Welch
against ``scipy.signal.welch``.

Tolerance: rtol 1e-4 and atol 1e-6 of each row's largest bin (the same
trig projections in f32, summed in another order); frequencies rtol 1e-6.
Rings of 250 samples (the default ring: one segment of dynamic length K)
and of 600 samples (K > 256: scipy's 256-sample segments at 50 % overlap).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from bp_from_video_tpu.ops import spectrum as jspec
from bp_from_video_tpu_torch.config import SignalConfig
from bp_from_video_tpu_torch.config import SignalSpectrumTransform as T
from bp_from_video_tpu_torch.ops import signal as sig
from bp_from_video_tpu_torch.ops import spectrum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FS = 30.0


def _rings(n, seed=0):
    """Rows: all NaN; 2 samples; 101 samples (odd K); 200 samples (even K)
    with y-gaps; a full ring; for n = 600 also 300 and 520 samples (2 and
    3 Welch segments)."""
    rng = np.random.default_rng(seed)
    counts = [0, 2, 101, 200, n] + ([300, 520] if n > 256 else [])
    x = np.full((len(counts), n), np.nan, np.float32)
    y = np.full((len(counts), n), np.nan, np.float32)
    for i, k in enumerate(counts):
        t = (np.arange(k) + rng.uniform(-0.05, 0.05, k)) / FS + 2.0
        x[i, n - k:] = t
        y[i, n - k:] = (2 * np.sin(2 * np.pi * 1.2 * t)
                        + 0.5 * rng.standard_normal(k))
    y[3, [n - 150, n - 90, n - 3]] = np.nan
    return x, y


def _close_spec(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    top = np.nanmax(np.abs(np.nan_to_num(want)), axis=-1, keepdims=True)
    err = np.abs(np.nan_to_num(got) - np.nan_to_num(want))
    assert np.all(err <= 1e-4 * np.abs(np.nan_to_num(want)) + 1e-6 * top), \
        float(np.max(err / (top + 1e-30)))


@pytest.mark.parametrize("n", [250, 600])
@pytest.mark.parametrize("transform", ["dft_rfft", "welch"])
def test_spectrum_matches_reference(transform, n):
    x, y = _rings(n)
    fs = sig.mean_fs(torch.from_numpy(x))
    fs = torch.where(torch.isfinite(fs), fs, 1.0)
    gf, gp = getattr(spectrum, transform)(torch.from_numpy(x),
                                          torch.from_numpy(y), fs)
    jfn = jax.jit(jax.vmap(getattr(jspec, transform)))
    wf, wp = jfn(jnp.asarray(x), jnp.asarray(y), jnp.asarray(fs.numpy()))
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-6,
                               equal_nan=True)
    _close_spec(gp.numpy(), wp)


@pytest.mark.parametrize("n", [250, 600])
def test_welch_matches_scipy(n):
    x, y = _rings(n, seed=1)
    fs = sig.mean_fs(torch.from_numpy(x))
    gf, gp = spectrum.welch(torch.from_numpy(x), torch.from_numpy(y), fs)
    for row in range(2, x.shape[0]):
        v = np.isfinite(y[row])
        f, p = scipy.signal.welch(y[row, v].astype(np.float64),
                                  fs=float(fs[row]))
        k = len(f)
        np.testing.assert_allclose(gf[row, :k].numpy(), f, rtol=1e-5)
        # f32 against f64: 1e-4 of the largest bin.
        np.testing.assert_allclose(gp[row, :k].numpy(), p,
                                   atol=1e-4 * p.max())
        assert np.isnan(gp[row, k:].numpy()).all()
        assert int(np.argmax(gp[row, :k].numpy())) == int(np.argmax(p))


@pytest.mark.parametrize("transform", [T.DFT_RFFT, T.PGRAM_WELCH])
def test_transform_signal_routes_both(transform):
    x, y = _rings(250, seed=2)
    cfg = SignalConfig(spectrum_transform=transform)
    sx, sy = spectrum.transform_signal(cfg, torch.from_numpy(x),
                                       torch.from_numpy(y))
    # Fewer than two valid samples: all NaN; otherwise the peak near the
    # rings' 1.2 Hz (a bin of a 200-sample transform is 0.15 Hz).
    assert torch.isnan(sx[0]).all() and torch.isnan(sy[0]).all()
    px, _ = sig.peak(sx[2:], sy[2:], 0.7, 4.0)
    assert bool(((px - 1.2).abs() <= 0.16).all()), px
