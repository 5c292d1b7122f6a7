"""The per-frame DSP chain — the counterpart of
``bp_from_video_tpu/ops/chain.py`` (reference signal_processor.py:196-241),
trimmed to the method the benchmark's configurations run: the Butterworth
zero-phase band-pass over the valid samples of NaN-masked rings.

Batched over leading dims with time on the last axis: every per-ring
scalar (valid counts, ``fs``) is a ``[...]`` tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpubench.ref.config import SignalConfig, SignalProcessingMethod as M
from gpubench.ref.ops import iir
from gpubench.ref.ops import signal as sig

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


_METHOD_FNS = {M.FILTER_BUTTER: make_filter_butter}


def process_signal(cfg: SignalConfig, x: Tensor, y: Tensor
                   ) -> tuple[Tensor, Tensor]:
    """Run the configured chain over signal rings (x, y: [..., N]); the
    chain only applies where >= 2 samples are valid and fs is finite,
    elsewhere (x, y) pass through untouched."""
    st = ChainState(x=x, y=y, valid=sig.valid_y(y), block=sig.valid_x(x),
                    fs=sig.mean_fs(x))
    ok = ((st.valid.sum(-1) >= 2) & torch.isfinite(st.fs))[..., None]
    out = st
    for method in cfg.processing_methods:
        if method not in _METHOD_FNS:
            raise NotImplementedError(f"the reference has no {method}")
        out = _METHOD_FNS[method](cfg, out)
    return torch.where(ok, out.x, x), torch.where(ok, out.y, y)
