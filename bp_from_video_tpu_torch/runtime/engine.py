"""The batched per-frame engine — the counterpart of
``bp_from_video_tpu/runtime/engine.py``:

    batch_step(params, state, frames, timestamps) -> (state, StepOutputs)

(and ``batch_step_lagged``, F frames a stream in one step) runs inference
(detect-then-track), ROI geometry, ROI sampling (kernel K4), the ring
pushes, the DSP chain, spectra (Lomb-Scargle, Welch or rFFT), BPM peaks,
face-to-palm correlation and PTT peaks for a batch of streams.  Every
state and output field carries a leading stream axis [S]; rings keep time
on their last axis (the ROI ring on its second-to-last, before the 6-tuple).

Each call is one ``bpv.step`` span with two halves under it: ``bpv.runner``
(``InferenceRunner.predict_batch``, and the lagged step's tiling of the
track state it takes) and ``bpv.signal`` (``bpv.roi``, ``bpv.sample``,
``bpv.push``, then the analysis: ``bpv.dsp.<method>``, ``bpv.spectrum``,
``bpv.correlate`` and ``bpv.outputs`` on an eager call, one ``bpv.analyze``
on a call replayed as a CUDA graph, ``runtime/signal_graph.py``); each call
counts ``steps`` (``utils/profiling``).

With an rPPG net (``config.RppgEngineConfig``, e.g. ``physformer_config``
or ``physmamba_config``) the state is a :class:`RppgEngineState`: beside
the rings of :class:`SignalState`, a :class:`ClipState` ring of each
stream's last T face crops.  A call crops each of its frames at the face
rect from before the call (K1 at the net's crop size) and pushes the crops
(``bpv.clip``, counting ``clip.pushed``; sub-spans ``bpv.clip.crop`` and
``bpv.clip.push``); the streams whose ring is full and has had ``hop`` new
crops are read to the host (``bpv.sync.clip_gate``, ``sync.clip_gate``),
their clips standardised (``bpv.clip.standardise``, the gate included: K8
``clip_standardise`` for a bf16 net on the card with ``use_pallas``, else
its plain version) and run through the net (``bpv.net.<module>``, the
module its config names, counting ``clip.runs``); the net's BVP and the
ring's timestamps become those streams' raw rings, and ``bpv.signal`` is
the unchanged analysis with the BPM ring pushed where the net ran.  The
lagged step then runs the landmark nets on the window's last frame only.
"""

from __future__ import annotations

import importlib
import itertools
import math
from typing import NamedTuple

import torch

from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.config import EngineConfig, ModelType
from bp_from_video_tpu_torch.kernels import clip_standardise
from bp_from_video_tpu_torch.kernels import warp as warp_kernel
from bp_from_video_tpu_torch.models import warp
from bp_from_video_tpu_torch.models.runner import (InferenceRunner,
                                                   ModelResults, TrackState,
                                                   _pow2_ladder, _seed,
                                                   map_leaves,
                                                   skin_confidence)
from bp_from_video_tpu_torch.ops.roi import is_planar_frames
from bp_from_video_tpu_torch.ops import chain, correlate, spectrum
from bp_from_video_tpu_torch.ops import roi as roi_ops
from bp_from_video_tpu_torch.ops import signal as sig
from bp_from_video_tpu_torch.runtime.signal_graph import SignalGraphs
from bp_from_video_tpu_torch.utils.profiling import count, span

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


class ClipState(NamedTuple):
    """Each stream's ring of its last T face crops for the rPPG net (leading
    [S]), circular: slot ``(head + i) % T`` holds the i-th oldest crop.
    Slot T of ``crops`` and ``ts`` takes the writes of crops that are not
    pushed (a stale or missing timestamp), so a push is one scatter."""

    crops: Tensor   # [S, T + 1, C, C, 3] compute dtype, the net's layout
    ts: Tensor      # [S, T + 1] f32 seconds, NaN where no crop yet
    head: Tensor    # int64 [S]: the oldest crop's slot, the next write's
    new: Tensor     # int32 [S]: crops pushed since the net last ran

    def ordered_ts(self) -> Tensor:
        """[S, T] timestamps, oldest first."""
        return torch.gather(self.ts, 1, clip_standardise.ring_slots(
            self.head, self.ts.shape[1] - 1))

    def ordered(self, rows: Tensor | None = None) -> Tensor:
        """The crops oldest first, [S, T, C, C, 3] (of ``rows`` only when
        given)."""
        return clip_standardise.ordered_crops(self.crops, self.head, rows)


class EngineState(NamedTuple):
    signals: SignalState
    track: TrackState


class RppgEngineState(NamedTuple):
    """The state of an engine with an rPPG net: :class:`EngineState`'s
    fields and the clip ring."""

    signals: SignalState
    track: TrackState
    clip: ClipState


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


def _raw_push(st: SignalState, samples: Tensor, timestamps: Tensor
              ) -> tuple[SignalState, Tensor]:
    """The raw ring pushed where ``timestamps`` is fresh (finite and not
    the ring's tail); returns (state, fresh)."""
    with span("bpv.push"):
        fresh = torch.isfinite(timestamps) & (timestamps != st.raw_x[:, -1])
        return st._replace(raw_x=sig.push_if(fresh, st.raw_x, timestamps),
                           raw_y=sig.push_if(fresh, st.raw_y, samples)), fresh


def _group_range(xs: Tensor, ys: Tensor) -> Tensor:
    """[S, n, L] signal groups -> [S, 4] joint auto ranges."""
    lo_x, hi_x, lo_y, hi_y = sig.auto_range(xs, ys)
    lo_x, hi_x = sig.group_range(lo_x, hi_x)
    lo_y, hi_y = sig.group_range(lo_y, hi_y)
    return torch.stack([lo_x, hi_x, lo_y, hi_y], -1)


class Engine:
    """Builds the runner for a static EngineConfig; ``device=None`` means
    ``"cuda"`` (raises without CUDA unless ``device="cpu"``).  ``graphs``
    goes to the runner unchanged (already parsed landmark graphs).

    With an rPPG net configured (``config.rppg_net`` of a
    ``config.RppgEngineConfig``) the engine also builds the net
    (``self.rppg``: ``models/<module>.Net`` of the module the net's config
    names, from ``rppg_params``: unfolded weights as that module's
    ``init_params`` lays them out, seeded when None); its
    state is a :class:`RppgEngineState`, which adds the clip ring to
    :class:`EngineState`'s fields, and the net's BVP is each stream's one
    signal: no ROI may be configured."""

    def __init__(self, config: EngineConfig, asset_dir: str | None = None,
                 device=None, graphs: dict | None = None,
                 rppg_params: dict | None = None):
        self.config = config
        self.device = resolve_device(device)
        dtype = (torch.bfloat16 if config.compute_dtype == "bfloat16"
                 else torch.float32)
        self.runner = InferenceRunner(
            config.inference, config.frame_height, config.frame_width,
            asset_dir=asset_dir, dtype=dtype, device=self.device,
            graphs=graphs)
        self.params = self.runner.params
        self._pairs = list(itertools.combinations(
            range(config.signal.num_signals), 2))
        self._analysis = SignalGraphs(self._analyze)
        self.rppg = self.standardise_clips = None
        net = getattr(config, "rppg_net", None)
        if net is not None:
            sc = config.signal
            if sc.roi_configs or not config.inference.face_landmarker:
                raise ValueError("an rPPG net takes the face landmarker's "
                                 "rect and is the one signal: no ROI")
            if sc.signal_max_samples != net.clip_frames:
                raise ValueError(
                    f"signal_max_samples={sc.signal_max_samples}: the "
                    f"net's BVP fills the raw ring, {net.clip_frames}")
            mod = importlib.import_module(
                f"bp_from_video_tpu_torch.models.{net.module}")
            if rppg_params is None:
                rppg_params = mod.init_params(net, _seed("rppg"))
            self.rppg = mod.Net(net, rppg_params, dtype, self.device,
                                use_kernel=config.inference.use_pallas)
            self._net_span = f"bpv.net.{net.module}"
            # K8 takes a bf16 ring on the card; anything else the plain
            # route, chosen here once.
            self.standardise_clips = (
                clip_standardise.clip_standardise
                if (config.inference.use_pallas
                    and self.device.type == "cuda"
                    and dtype == torch.bfloat16)
                else clip_standardise.clip_standardise_plain)

    # -- state ----------------------------------------------------------------

    def init_signal_state(self, num_streams: int) -> SignalState:
        c = self.config.signal
        ns = 1 if self.rppg is not None else c.num_signals
        p = max(c.num_pairs, 1)
        nr, n, np_ = c.roi_max_samples, c.signal_max_samples, c.peak_max_samples

        def nan(*shape):
            return torch.full((num_streams,) + shape, _NAN,
                              dtype=torch.float32, device=self.device)
        return SignalState(nan(nr), nan(ns, nr, 6), nan(n), nan(ns, n),
                           nan(np_), nan(ns, np_), nan(np_), nan(p, np_))

    def init_clip_state(self, num_streams: int) -> ClipState:
        net, dev = self.config.rppg_net, self.device
        t, c = net.clip_frames, net.crop
        return ClipState(
            crops=torch.zeros((num_streams, t + 1, c, c, 3),
                              dtype=self.runner.dtype, device=dev),
            ts=torch.full((num_streams, t + 1), _NAN, dtype=torch.float32,
                          device=dev),
            head=torch.zeros(num_streams, dtype=torch.int64, device=dev),
            new=torch.zeros(num_streams, dtype=torch.int32, device=dev))

    def init_state(self, num_streams: int | None = None
                   ) -> EngineState | RppgEngineState:
        """Fresh state for ``num_streams`` (default: the config's)."""
        s = self.config.num_streams if num_streams is None else num_streams
        sig_st, track = self.init_signal_state(s), self.runner.init_state(s)
        if self.rppg is None:
            return EngineState(sig_st, track)
        return RppgEngineState(sig_st, track, self.init_clip_state(s))

    # -- the step ---------------------------------------------------------------

    def roi_stage(self, st: SignalState, models: ModelResults,
                  timestamps: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        """ROI geometry + the temporal-filter ring; returns (roi_x, roi_y,
        rois [S, ns, 6])."""
        cfg = self.config.signal
        by_model = {ModelType.FACE_LANDMARKER: models.face_landmarker,
                    ModelType.HAND_LANDMARKER: models.hand_landmarker}
        with span("bpv.roi"):
            rois_now = roi_ops.calc_rois(cfg.roi_configs, by_model)
            # A timestamp equal to the ring tail is a re-send of the frame
            # already pushed: the ring must not advance.
            fresh = (torch.isfinite(timestamps)
                     & (timestamps != st.roi_x[:, -1]))
            roi_x = sig.push_if(fresh, st.roi_x, timestamps)
            roi_y = sig.push_if(fresh, st.roi_y, rois_now, dim=-2)
            rois = sig.masked_mean(roi_y, as_int=True, vec=True)
            return roi_x, roi_y, rois

    def signal_step(self, st: SignalState, models: ModelResults,
                    frames_rgb: Tensor, timestamps: Tensor
                    ) -> tuple[SignalState, StepOutputs]:
        """The DSP half of the step, taking inference results as input: ROI
        geometry and ring, pixel sampling (kernel K4 with ``use_pallas``;
        weighted by the segmenter's skin confidence when the segmenter
        runs), then :meth:`signal_post`."""
        roi_x, roi_y, rois = self.roi_stage(st, models, timestamps)
        samples = self._sample(frames_rgb, rois, models.seg_conf)
        return self.signal_post(st, roi_x, roi_y, rois, models, samples,
                                timestamps)

    def _sample(self, frames_rgb: Tensor, rois: Tensor, seg_conf: Tensor
                ) -> Tensor:
        """Pixel samples of ``rois`` [B, ns, 6] in frames [B, ...]
        (kernel K4 with ``use_pallas``), weighted by the skin confidence
        of ``seg_conf`` when the segmenter runs -> [B, ns]."""
        with span("bpv.sample"):
            weights = None
            if self.config.inference.person_segmenter:
                weights = skin_confidence(seg_conf)
            return roi_ops.sample_rois_batch(
                frames_rgb, rois, self.config.signal.color_channel, weights,
                use_pallas=self.config.inference.use_pallas)

    def signal_post(self, st: SignalState, roi_x: Tensor, roi_y: Tensor,
                    rois: Tensor, models: ModelResults, samples: Tensor,
                    timestamps: Tensor) -> tuple[SignalState, StepOutputs]:
        """Raw ring push, then :meth:`signal_analyze`."""
        st, fresh = _raw_push(st._replace(roi_x=roi_x, roi_y=roi_y), samples,
                              timestamps)
        return self.signal_analyze(st, rois, models, timestamps, fresh)

    def signal_analyze(self, st: SignalState, rois: Tensor,
                       models: ModelResults, timestamps: Tensor,
                       fresh: Tensor) -> tuple[SignalState, StepOutputs]:
        """DSP chain, spectra, correlation, peak rings, HUD statistics and
        plot ranges on the already-pushed rings.  On a CUDA device the
        analysis is replayed as one CUDA graph a call
        (``runtime/signal_graph.py``); ``rois``, ``models``, the ROI rings
        and the raw rings pass through as they came."""
        got = self._analysis(st.raw_x, st.raw_y, st.bpm_x, st.bpm_y,
                             st.ptt_x, st.ptt_y, timestamps, fresh)
        new = SignalState(st.roi_x, st.roi_y, st.raw_x, st.raw_y, *got[:4])
        return new, StepOutputs(models, rois, st.raw_x, st.raw_y, *got[4:])

    def _analyze(self, raw_x: Tensor, raw_y: Tensor, bpm_x: Tensor,
                 bpm_y: Tensor, ptt_x: Tensor, ptt_y: Tensor,
                 timestamps: Tensor, fresh: Tensor) -> tuple[Tensor, ...]:
        """The eager analysis -> (bpm_x, bpm_y, ptt_x, ptt_y) rings, then
        :class:`StepOutputs` from ``proc_x`` to ``corr_range``."""
        cfg = self.config.signal
        s = raw_x.shape[0]
        x_b = raw_x[:, None, :].expand_as(raw_y)
        proc_x, proc_y = chain.process_signal(cfg, x_b, raw_y)
        with span("bpv.spectrum"):
            spec_x, spec_y = spectrum.transform_signal(cfg, proc_x, proc_y)

        n = cfg.signal_max_samples
        p_cnt = max(cfg.num_pairs, 1)
        with span("bpv.correlate"):
            if self._pairs:
                outs = [correlate.correlate_pair(proc_x[:, a], proc_y[:, a],
                                                 proc_y[:, b])
                        for a, b in self._pairs]
                corr_x = torch.stack([c[0] for c in outs], 1)
                corr_y = torch.stack([c[1] for c in outs], 1)
            else:
                corr_x = torch.full((s, p_cnt, 2 * n - 1), _NAN,
                                    device=raw_x.device)
                corr_y = torch.full_like(corr_x, _NAN)

        with span("bpv.outputs"):
            # The peak window is the spectrum's auto data range (the
            # reference's effective behaviour, see ops/signal.peak_auto).
            bpm_now = sig.peak_auto(spec_x, spec_y)[0] * 60.0      # [S, ns]
            new_bpm_x = sig.push_if(fresh, bpm_x, timestamps)
            new_bpm_y = sig.push_if(fresh, bpm_y, bpm_now)
            if self._pairs:
                ptt_now = sig.peak_auto(corr_x, corr_y)[0] * 1000.0  # [S, P]
            else:
                ptt_now = torch.full((s, p_cnt), _NAN, device=raw_x.device)
            new_ptt_x = sig.push_if(fresh, ptt_x, timestamps)
            new_ptt_y = sig.push_if(fresh, ptt_y, ptt_now)

            bpm_mean = sig.masked_mean(new_bpm_y, as_int=True)
            ptt_mean = sig.masked_mean(new_ptt_y, as_int=True)
            mean_fs = sig.mean_fs(new_bpm_x)
            curr_fs = 1.0 / (raw_x[:, -1] - raw_x[:, -2])
            return (new_bpm_x, new_bpm_y, new_ptt_x, new_ptt_y,
                    proc_x, proc_y, spec_x, spec_y, corr_x, corr_y,
                    bpm_mean, ptt_mean, curr_fs, mean_fs,
                    _group_range(proc_x, proc_y),
                    _group_range(spec_x, spec_y),
                    _group_range(corr_x, corr_y))

    def batch_step(self, params, state: EngineState, frames_rgb: Tensor,
                   timestamps: Tensor) -> tuple[EngineState, StepOutputs]:
        """One frame per stream: frames uint8 [S, H, W, 3] or planar
        [S, 3, H, W], timestamps f32 [S] seconds."""
        with span("bpv.step"):
            count("steps")
            with span("bpv.runner"):
                track, models = self.runner.predict_batch(
                    params, state.track, frames_rgb)
            if self.rppg is not None:
                return self._rppg_half(state, track, models,
                                       frames_rgb[None], timestamps[None])
            with span("bpv.signal"):
                signals, out = self.signal_step(state.signals, models,
                                                frames_rgb, timestamps)
            return EngineState(signals, track), out

    def batch_step_lagged(self, params, state: EngineState,
                          frames_rgb: Tensor, timestamps: Tensor
                          ) -> tuple[EngineState, StepOutputs]:
        """Lagged-rect temporal micro-batch: F frames per stream in one
        step (frames [F, S, ...] in either layout, timestamps [F, S]).

        Every frame of the window is cropped with the tracking rects from
        before the window, so the nets run once at batch F*S; the track
        advances from the last frame's block.  Per frame, in order, the
        ROI ring takes its ROIs and the raw ring its sample (pushed where
        the timestamp is fresh); the window analysis runs once, on the
        last frame.  The ROI sampling of all F frames is one K4 launch:
        each (stream, ROI) sum is computed alone, so it is bit-equal to F
        launches of S streams.

        With an rPPG net (and so no ROI) no frame but the last feeds
        anything the landmark nets give, so they run on the last frame
        only; every frame of the window is cropped at the face rect from
        before the window into the clip ring, one K1 launch for the F x S
        crops (:meth:`_rppg_half`)."""
        with span("bpv.step"):
            count("steps")
            f_n, s_n = timestamps.shape
            if self.rppg is not None:
                with span("bpv.runner"):
                    track, models = self.runner.predict_batch(
                        params, state.track, frames_rgb[-1])
                return self._rppg_half(state, track, models, frames_rgb,
                                       timestamps)
            flat = frames_rgb.reshape((f_n * s_n,) + frames_rgb.shape[2:])
            with span("bpv.runner"):
                tiled = map_leaves(
                    lambda a: a.repeat((f_n,) + (1,) * (a.ndim - 1)),
                    state.track)
                track_flat, models_flat = self.runner.predict_batch(
                    params, tiled, flat)
            with span("bpv.signal"):
                signals, out, new_track = self._lagged_signal(
                    state.signals, track_flat, models_flat, flat, timestamps)
            return EngineState(signals, new_track), out

    def _lagged_signal(self, sig_st: SignalState, track_flat: TrackState,
                       models_flat: ModelResults, flat: Tensor,
                       timestamps: Tensor):
        """The lagged step after its nets: the last frame's track, each
        frame's ROIs and raw samples pushed in order, one K4 launch for
        the window, the analysis on the last frame -> (signals, outputs,
        track)."""
        f_n, s_n = timestamps.shape
        new_track = map_leaves(lambda a: a[(f_n - 1) * s_n:], track_flat)
        models_f = map_leaves(
            lambda a: a.reshape((f_n, s_n) + a.shape[1:]), models_flat)
        rois_f = []
        for f in range(f_n):
            roi_x, roi_y, rois = self.roi_stage(
                sig_st, map_leaves(lambda a: a[f], models_f), timestamps[f])
            sig_st = sig_st._replace(roi_x=roi_x, roi_y=roi_y)
            rois_f.append(rois)
        samples = self._sample(flat, torch.cat(rois_f), models_flat.seg_conf
                               ).reshape(f_n, s_n, -1)
        for f in range(f_n):
            sig_st, _ = _raw_push(sig_st, samples[f], timestamps[f])

        ts_last = timestamps[-1]
        fresh_last = torch.isfinite(ts_last) & (ts_last != sig_st.bpm_x[:, -1])
        signals, out = self.signal_analyze(
            sig_st, rois_f[-1], map_leaves(lambda a: a[-1], models_f),
            ts_last, fresh_last)
        return signals, out, new_track

    # -- the rPPG net's half of the step -----------------------------------

    def _face_crops(self, frames_rgb: Tensor, track: TrackState) -> Tensor:
        """Every frame of [F, S, ...] frames cropped at the cover of its
        stream's face rect in ``track``: [F * S, C, C, 3] in the compute
        dtype, scaled to [0, 1].  One K1 launch where the runner's crops
        take K1 (``use_pallas``, uint8 frames), else the plain crop."""
        f_n, s_n = frames_rgb.shape[:2]
        size = self.config.rppg_net.crop
        rect = warp.rect_arr(warp.axis_aligned_cover(warp.arr_rect(
            self.runner._safe_rect(track.face_rect))))            # [S, 5]
        rects = rect.repeat(f_n, 1)                              # [F*S, 5]
        flat = frames_rgb.reshape((f_n * s_n,) + frames_rgb.shape[2:])
        planar = is_planar_frames(flat)
        dtype = self.runner.dtype
        if self.config.inference.use_pallas and flat.dtype == torch.uint8:
            if not planar:
                flat = flat.permute(0, 3, 1, 2).contiguous()
            crops = warp_kernel.multi_crop(
                flat, rects[:, None, :4].contiguous(), (size,), dtype=dtype,
                out_dtype=dtype, scale=1.0 / 255.0)[0]
            return crops.permute(0, 2, 3, 1)
        nhwc = flat.permute(0, 2, 3, 1) if planar else flat
        return (warp.crop_rect(nhwc, warp.arr_rect(rects), size)
                / 255.0).to(dtype)

    def _clip_push(self, clip: ClipState, crops: Tensor, ts: Tensor
                   ) -> ClipState:
        """``crops`` [F * S, ...] (frame-major) pushed in frame order where
        their timestamps ``ts`` [F, S] are finite and later than the
        stream's newest crop; the others go to the spare slot."""
        f_n, s_n = ts.shape
        t = clip.ts.shape[1] - 1
        newest = torch.gather(clip.ts, 1, ((clip.head - 1) % t)[:, None])
        prev = torch.cat([newest.T, ts[:-1]]).nan_to_num(nan=-math.inf)
        fresh = torch.isfinite(ts) & (ts > torch.cummax(prev, 0).values)
        rank = torch.cumsum(fresh, 0) - 1                       # [F, S]
        slot = torch.where(fresh, (clip.head + rank) % t, t)
        rows = torch.arange(s_n, device=ts.device) * (t + 1)
        idx = (rows + slot).reshape(-1)
        n = fresh.sum(0)
        return ClipState(
            clip.crops.flatten(0, 1).index_copy(0, idx, crops)
            .view_as(clip.crops),
            clip.ts.reshape(-1).index_copy(0, idx, ts.reshape(-1))
            .view_as(clip.ts),
            (clip.head + n) % t,
            torch.clamp(clip.new + n.to(torch.int32), max=t))

    def _clip_input(self, clip: ClipState
                    ) -> tuple[Tensor, Tensor | None, int, Tensor | None]:
        """The streams the net runs on this call: those whose ring is full
        and has had ``hop`` new crops since the net last ran.  Reads their
        count to the host (one sync) -> (due [S], rows the net runs on
        (None: every stream, in order), due count, their clips
        standardised by ``standardise_clips``, [B, T, C, C, 3]).  ``rows``
        pads the due streams to the next size of ``_pow2_ladder(S)``, so a
        count pays for its power of two and the net sees few shapes."""
        s_n = clip.new.shape[0]
        full = torch.isfinite(clip.ordered_ts()).all(1)
        due = full & (clip.new >= self.config.rppg_net.hop)
        total = due.sum()
        with span("bpv.sync.clip_gate"):
            n_due = int(total.item())
        count("sync.clip_gate")
        if n_due == 0:
            return due, None, 0, None
        kk = next(v for v in _pow2_ladder(s_n) if v >= n_due)
        rows = (None if kk == s_n else
                torch.argsort((~due).to(torch.int8), stable=True)[:kk])
        return due, rows, n_due, self.standardise_clips(clip.crops,
                                                        clip.head, rows)

    def _rppg_half(self, state: RppgEngineState, track: TrackState,
                   models: ModelResults, frames_rgb: Tensor,
                   timestamps: Tensor
                   ) -> tuple[RppgEngineState, StepOutputs]:
        """After the runner: F frames [F, S, ...] cropped at the face rects
        from before the call and pushed (``bpv.clip``), the net on the
        streams due (``bpv.net.<module>``), its BVP and the ring's
        timestamps as the raw ring of each such stream's one signal, then
        the analysis on every stream (``bpv.signal``; the BPM ring pushed
        where the net ran)."""
        f_n, s_n = timestamps.shape
        with span("bpv.clip"):
            with span("bpv.clip.crop"):
                crops = self._face_crops(frames_rgb, state.track)
            with span("bpv.clip.push"):
                clip = self._clip_push(state.clip, crops, timestamps)
            count("clip.pushed", f_n * s_n)
            with span("bpv.clip.standardise"):
                due, rows, n_due, x = self._clip_input(clip)
        bvp = None
        if n_due:
            count("clip.runs", n_due)
            with span(self._net_span):
                bvp = self.rppg(x)
        sig_st = state.signals
        with span("bpv.signal"):
            if bvp is not None:
                if rows is not None:
                    bvp = torch.zeros((s_n, bvp.shape[1]), dtype=bvp.dtype,
                                      device=bvp.device).index_copy(
                                          0, rows, bvp)
                sig_st = sig_st._replace(
                    raw_x=torch.where(due[:, None], clip.ordered_ts(),
                                      sig_st.raw_x),
                    raw_y=torch.where(due[:, None, None], bvp[:, None],
                                      sig_st.raw_y))
                clip = clip._replace(new=torch.where(due, 0, clip.new))
            rois = torch.full((s_n, 1, 6), _NAN, device=timestamps.device)
            signals, out = self.signal_analyze(sig_st, rois, models,
                                               sig_st.raw_x[:, -1], due)
        return RppgEngineState(signals, track, clip), out

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
