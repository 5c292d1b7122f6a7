"""The batched per-frame engine — the counterpart of
``bp_from_video_tpu/runtime/engine.py``:

    batch_step(params, state, frames, timestamps) -> (state, StepOutputs)

runs inference (detect-then-track), ROI geometry, ROI sampling (kernel K4),
the ring pushes, the DSP chain, Lomb-Scargle spectra, BPM peaks,
face-to-palm correlation and PTT peaks for a batch of streams.  Every
state and output field carries a leading stream axis [S]; rings keep time
on their last axis (the ROI ring on its second-to-last, before the 6-tuple).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.config import EngineConfig, ModelType
from bp_from_video_tpu_torch.models.runner import (InferenceRunner,
                                                   ModelResults, TrackState,
                                                   map_leaves)
from bp_from_video_tpu_torch.ops import chain, correlate, spectrum
from bp_from_video_tpu_torch.ops import roi as roi_ops
from bp_from_video_tpu_torch.ops import signal as sig

Tensor = torch.Tensor
_NAN = float("nan")


class SignalState(NamedTuple):
    """Per-stream rings (leading [S]; ``ns`` signals, ``P`` pairs)."""

    roi_x: Tensor   # [S, Nr]
    roi_y: Tensor   # [S, ns, Nr, 6]
    raw_x: Tensor   # [S, N]
    raw_y: Tensor   # [S, ns, N]
    bpm_x: Tensor   # [S, Np]
    bpm_y: Tensor   # [S, ns, Np]
    ptt_x: Tensor   # [S, Np]
    ptt_y: Tensor   # [S, P, Np]


class EngineState(NamedTuple):
    signals: SignalState
    track: TrackState


class StepOutputs(NamedTuple):
    """Everything the display/driver layer consumes per frame."""

    models: ModelResults
    rois: Tensor         # [S, ns, 6] temporally-filtered integral ROIs
    raw_x: Tensor        # [S, N]
    raw_y: Tensor        # [S, ns, N]
    proc_x: Tensor       # [S, ns, N]
    proc_y: Tensor       # [S, ns, N]
    spec_x: Tensor       # [S, ns, N]
    spec_y: Tensor       # [S, ns, N]
    corr_x: Tensor       # [S, P, 2N-1]
    corr_y: Tensor       # [S, P, 2N-1]
    bpm: Tensor          # [S, ns] rounded means over the peak ring
    ptt: Tensor          # [S, P]
    curr_fs: Tensor      # [S] instantaneous fs (raw ring tail)
    mean_fs: Tensor      # [S] mean fs of the bpm ring
    proc_range: Tensor   # [S, 4] joint (min_x, max_x, min_y, max_y)
    spec_range: Tensor   # [S, 4]
    corr_range: Tensor   # [S, 4]


def _group_range(xs: Tensor, ys: Tensor) -> Tensor:
    """[S, n, L] signal groups -> [S, 4] joint auto ranges."""
    lo_x, hi_x, lo_y, hi_y = sig.auto_range(xs, ys)
    lo_x, hi_x = sig.group_range(lo_x, hi_x)
    lo_y, hi_y = sig.group_range(lo_y, hi_y)
    return torch.stack([lo_x, hi_x, lo_y, hi_y], -1)


class Engine:
    """Builds the runner for a static EngineConfig; ``device=None`` means
    ``"cuda"`` (raises without CUDA unless ``device="cpu"``)."""

    def __init__(self, config: EngineConfig, asset_dir: str | None = None,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.runner = InferenceRunner(
            config.inference, config.frame_height, config.frame_width,
            asset_dir=asset_dir,
            dtype=(torch.bfloat16 if config.compute_dtype == "bfloat16"
                   else torch.float32),
            device=self.device)
        self.params = self.runner.params
        self._pairs = list(itertools.combinations(
            range(config.signal.num_signals), 2))

    # -- state ----------------------------------------------------------------

    def init_signal_state(self, num_streams: int) -> SignalState:
        c = self.config.signal
        ns, p = c.num_signals, max(c.num_pairs, 1)
        nr, n, np_ = c.roi_max_samples, c.signal_max_samples, c.peak_max_samples

        def nan(*shape):
            return torch.full((num_streams,) + shape, _NAN,
                              dtype=torch.float32, device=self.device)
        return SignalState(nan(nr), nan(ns, nr, 6), nan(n), nan(ns, n),
                           nan(np_), nan(ns, np_), nan(np_), nan(p, np_))

    def init_state(self, num_streams: int | None = None) -> EngineState:
        """Fresh state for ``num_streams`` (default: the config's)."""
        s = self.config.num_streams if num_streams is None else num_streams
        return EngineState(self.init_signal_state(s),
                           self.runner.init_state(s))

    # -- the step ---------------------------------------------------------------

    def roi_stage(self, st: SignalState, models: ModelResults,
                  timestamps: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """ROI geometry + the temporal-filter ring; returns (roi_x, roi_y,
        rois [S, ns, 6])."""
        cfg = self.config.signal
        by_model = {ModelType.FACE_LANDMARKER: models.face_landmarker,
                    ModelType.HAND_LANDMARKER: models.hand_landmarker}
        rois_now = roi_ops.calc_rois(cfg.roi_configs, by_model)
        # A timestamp equal to the ring tail is a re-send of the frame
        # already pushed: the ring must not advance.
        fresh = torch.isfinite(timestamps) & (timestamps != st.roi_x[:, -1])
        roi_x = sig.push_if(fresh, st.roi_x, timestamps)
        roi_y = sig.push_if(fresh, st.roi_y, rois_now, dim=-2)
        rois = sig.masked_mean(roi_y, as_int=True, vec=True)
        return roi_x, roi_y, rois

    def signal_step(self, st: SignalState, models: ModelResults,
                    frames_rgb: Tensor, timestamps: Tensor
                    ) -> tuple[SignalState, StepOutputs]:
        """The DSP half of the step, taking inference results as input: ROI
        geometry and ring, pixel sampling (kernel K4 with ``use_pallas``),
        then :meth:`signal_post`."""
        roi_x, roi_y, rois = self.roi_stage(st, models, timestamps)
        samples = roi_ops.sample_rois_batch(
            frames_rgb, rois, self.config.signal.color_channel, None,
            use_pallas=self.config.inference.use_pallas)
        return self.signal_post(st, roi_x, roi_y, rois, models, samples,
                                timestamps)

    def signal_post(self, st: SignalState, roi_x: Tensor, roi_y: Tensor,
                    rois: Tensor, models: ModelResults, samples: Tensor,
                    timestamps: Tensor) -> tuple[SignalState, StepOutputs]:
        """Raw ring push, then :meth:`signal_analyze`."""
        fresh = torch.isfinite(timestamps) & (timestamps != st.raw_x[:, -1])
        raw_x = sig.push_if(fresh, st.raw_x, timestamps)
        raw_y = sig.push_if(fresh, st.raw_y, samples)
        st = SignalState(roi_x, roi_y, raw_x, raw_y,
                         st.bpm_x, st.bpm_y, st.ptt_x, st.ptt_y)
        return self.signal_analyze(st, rois, models, timestamps, fresh)

    def signal_analyze(self, st: SignalState, rois: Tensor,
                       models: ModelResults, timestamps: Tensor,
                       fresh: Tensor) -> tuple[SignalState, StepOutputs]:
        """DSP chain, spectra, correlation, peak rings, HUD statistics and
        plot ranges on the already-pushed rings."""
        cfg = self.config.signal
        raw_x, raw_y = st.raw_x, st.raw_y
        s = raw_x.shape[0]
        x_b = raw_x[:, None, :].expand_as(raw_y)
        proc_x, proc_y = chain.process_signal(cfg, x_b, raw_y)
        spec_x, spec_y = spectrum.transform_signal(cfg, proc_x, proc_y)
        # The peak window is the spectrum's auto data range (the reference's
        # effective behaviour, see ops/signal.peak_auto).
        bpm_now = sig.peak_auto(spec_x, spec_y)[0] * 60.0          # [S, ns]
        bpm_x = sig.push_if(fresh, st.bpm_x, timestamps)
        bpm_y = sig.push_if(fresh, st.bpm_y, bpm_now)

        n = cfg.signal_max_samples
        p_cnt = max(cfg.num_pairs, 1)
        if self._pairs:
            outs = [correlate.correlate_pair(proc_x[:, a], proc_y[:, a],
                                             proc_y[:, b])
                    for a, b in self._pairs]
            corr_x = torch.stack([c[0] for c in outs], 1)
            corr_y = torch.stack([c[1] for c in outs], 1)
            ptt_now = sig.peak_auto(corr_x, corr_y)[0] * 1000.0    # [S, P]
        else:
            corr_x = torch.full((s, p_cnt, 2 * n - 1), _NAN,
                                device=raw_x.device)
            corr_y = torch.full_like(corr_x, _NAN)
            ptt_now = torch.full((s, p_cnt), _NAN, device=raw_x.device)
        ptt_x = sig.push_if(fresh, st.ptt_x, timestamps)
        ptt_y = sig.push_if(fresh, st.ptt_y, ptt_now)

        bpm_mean = sig.masked_mean(bpm_y, as_int=True)
        ptt_mean = sig.masked_mean(ptt_y, as_int=True)
        mean_fs = sig.mean_fs(bpm_x)
        curr_fs = 1.0 / (raw_x[:, -1] - raw_x[:, -2])

        new = SignalState(st.roi_x, st.roi_y, raw_x, raw_y,
                          bpm_x, bpm_y, ptt_x, ptt_y)
        out = StepOutputs(models, rois, raw_x, raw_y, proc_x, proc_y,
                          spec_x, spec_y, corr_x, corr_y, bpm_mean, ptt_mean,
                          curr_fs, mean_fs, _group_range(proc_x, proc_y),
                          _group_range(spec_x, spec_y),
                          _group_range(corr_x, corr_y))
        return new, out

    def batch_step(self, params, state: EngineState, frames_rgb: Tensor,
                   timestamps: Tensor) -> tuple[EngineState, StepOutputs]:
        """One frame per stream: frames uint8 [S, H, W, 3] or planar
        [S, 3, H, W], timestamps f32 [S] seconds."""
        track, models = self.runner.predict_batch(params, state.track,
                                                  frames_rgb)
        signals, out = self.signal_step(state.signals, models, frames_rgb,
                                        timestamps)
        return EngineState(signals, track), out

    def step(self, params, state: EngineState, frame_rgb: Tensor,
             timestamp: Tensor) -> tuple[EngineState, StepOutputs]:
        """One frame of one stream, whose state has no stream axis (e.g.
        ``map_leaves(lambda x: x[0], engine.init_state(1))``): the S=1 case
        of :meth:`batch_step`."""
        new, out = self.batch_step(params,
                                   map_leaves(lambda x: x[None], state),
                                   frame_rgb[None], timestamp.reshape(1))
        return (map_leaves(lambda x: x[0], new),
                map_leaves(lambda x: x[0], out))
