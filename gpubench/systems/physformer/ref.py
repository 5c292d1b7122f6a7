"""The physformer system's plain reference, in float32 with TF32 off: it
imports nothing of the port, of the JAX package or of JAX.

- The net: a frozen copy of the port's ``models/physformer_ref.py``
  (PhysFormer's forward pass as published, Yu et al., CVPR 2022,
  arXiv:2111.12082: unfolded BatchNorm, unfolded ``CDC_T``,
  ``softmax(QK^T / gra_sharp)``), with its departures: dropout off, the
  input standardised per clip over the chunk, the attention maps not kept.
  :func:`init_params` draws its weights from the seed, laid out as the
  port's ``init_params`` lays them (the port folds them itself).
- The tracker and the crop: ``gpubench/ref``'s face landmark runner (the
  compiled face mesh op by op, the 1.5x rect of its landmarks) and its
  plain separable crop of the rect's axis-aligned cover, scaled to [0, 1].
- The clip ring, kept oldest first: a call pushes each frame whose
  timestamp is finite and later than the stream's newest crop; the net
  runs on the streams whose ring is full and has had ``hop`` new crops,
  in blocks of :data:`BLOCK` clips.
- The signal: the net's BVP and the ring's timestamps are the raw ring of
  each stream's one signal; the configuration's DSP (linear detrend,
  Butterworth over 0.75-2.5 Hz, an rFFT peak: :func:`signal_config`) runs
  on it.  ``gpubench/ref`` has the Butterworth; the linear detrend and the
  rFFT spectrum are frozen copies of the port's plain ``ops``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from gpubench.ref.config import InferenceConfig, SignalConfig
from gpubench.ref.config import SignalProcessingMethod as M
from gpubench.ref.config import SignalSpectrumTransform as T
from gpubench.ref.models import warp
from gpubench.ref.models.runner import (FACE_ROT_LANDMARKS,
                                        NUM_FACE_LANDMARKS,
                                        PRESENCE_THRESHOLD, InferenceRunner,
                                        TrackState, _clip_floor)
from gpubench.ref.ops import chain, signal as sig
from gpubench.ref.ops.roi import Detections, is_planar_frames
from gpubench.ref.runtime.engine import (SignalState, StepOutputs,
                                         _group_range)

Tensor = torch.Tensor
BN_EPS = 1e-5
LN_EPS = 1e-6
BLOCK = 4          # clips a reference forward pass takes at a time
_NAN = float("nan")


# -- the net, as published ---------------------------------------------------


def init_params(net: dict, seed: int, device=None) -> dict:
    """Seeded unfolded weights and BatchNorm statistics of the net ``net``
    ({dim, ff_dim, num_layers, patch, ...}): convs at 1/sqrt(fan-in)
    (sqrt(2/fan-in) before a ReLU), BatchNorm and LayerNorm near their
    identities."""
    gen = torch.Generator().manual_seed(int(seed) % 2**63)
    d, ff, pt = net["dim"], net["ff_dim"], net["patch"]

    def conv(cout, cin, *k, gain=1.0):
        fan = cin * math.prod(k)
        return torch.randn((cout, cin) + k, generator=gen) * (
            gain / math.sqrt(fan))

    def vec(n, scale=0.1, base=0.0):
        return base + scale * torch.randn(n, generator=gen)

    def bn(n):
        return {"gamma": vec(n, 0.1, 1.0), "beta": vec(n),
                "mean": vec(n), "var": 0.5 + torch.rand(n, generator=gen)}

    def ln(n):
        return {"w": vec(n, 0.1, 1.0), "b": vec(n)}

    p = {"stem0": {"w": conv(d // 4, 3, 1, 5, 5, gain=2 ** 0.5),
                   "b": vec(d // 4), "bn": bn(d // 4)},
         "stem1": {"w": conv(d // 2, d // 4, 3, 3, 3, gain=2 ** 0.5),
                   "b": vec(d // 2), "bn": bn(d // 2)},
         "stem2": {"w": conv(d, d // 2, 3, 3, 3, gain=2 ** 0.5),
                   "b": vec(d), "bn": bn(d)},
         "patch": {"w": conv(d, d, pt, pt, pt), "b": vec(d)},
         "blocks": [{"ln1": ln(d),
                     "q": {"w": conv(d, d, 3, 3, 3), "bn": bn(d)},
                     "k": {"w": conv(d, d, 3, 3, 3), "bn": bn(d)},
                     "v": {"w": conv(d, d, 1, 1, 1)},
                     "proj": {"w": conv(d, d), "b": vec(d)},
                     "ln2": ln(d),
                     "fc1": {"w": conv(ff, d, 1, 1, 1), "bn": bn(ff)},
                     "dw": {"w": conv(ff, 1, 3, 3, 3), "bn": bn(ff)},
                     "fc2": {"w": conv(d, ff, 1, 1, 1), "bn": bn(d)}}
                    for _ in range(net["num_layers"])],
         "up1": {"w": conv(d, d, 3, 1, 1), "b": vec(d), "bn": bn(d)},
         "up2": {"w": conv(d // 2, d, 3, 1, 1), "b": vec(d // 2),
                 "bn": bn(d // 2)},
         "last": {"w": conv(1, d // 2, 1), "b": vec(1)}}
    return _map(lambda t: t.to(device), p)


def _map(fn, p):
    if isinstance(p, dict):
        return {k: _map(fn, v) for k, v in p.items()}
    if isinstance(p, list):
        return [_map(fn, v) for v in p]
    return fn(p)


def standardise(clip: Tensor) -> Tensor:
    """[B, ...] -> f32, each row less its mean over the rest, over its
    population standard deviation; a constant row gives zeros."""
    x = clip.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    x = x - x.mean(dims, keepdim=True)
    x = x / x.pow(2).mean(dims, keepdim=True).sqrt()
    return torch.nan_to_num(x, nan=0.0)


def _bn(x, p):
    return F.batch_norm(x, p["mean"], p["var"], p["gamma"], p["beta"],
                        False, 0.0, BN_EPS)


def _cdc_t(x, w, theta):
    out = F.conv3d(x, w, padding=1)
    if abs(theta) < 1e-8:
        return out
    diff = (w[:, :, 0].sum((2, 3)) + w[:, :, 2].sum((2, 3)))
    return out - theta * F.conv3d(x, diff[..., None, None, None])


def _grid(x, gt, g):
    b, p, c = x.shape
    return x.transpose(1, 2).reshape(b, c, gt, g, g)


def _tokens(x):
    return x.flatten(2).transpose(1, 2)


def _attention(blk, x, gt, g, heads, theta, gra_sharp):
    h = _grid(x, gt, g)
    q = _tokens(_bn(_cdc_t(h, blk["q"]["w"], theta), blk["q"]["bn"]))
    k = _tokens(_bn(_cdc_t(h, blk["k"]["w"], theta), blk["k"]["bn"]))
    v = _tokens(F.conv3d(h, blk["v"]["w"]))
    b, p, c = q.shape
    q, k, v = (t.reshape(b, p, heads, c // heads).transpose(1, 2)
               for t in (q, k, v))
    scores = torch.softmax(q @ k.transpose(-2, -1) / gra_sharp, dim=-1)
    out = (scores @ v).transpose(1, 2).reshape(b, p, c)
    return F.linear(out, blk["proj"]["w"], blk["proj"]["b"])


def _feed_forward(blk, x, gt, g):
    h = _grid(x, gt, g)
    h = F.elu(_bn(F.conv3d(h, blk["fc1"]["w"]), blk["fc1"]["bn"]))
    h = F.elu(_bn(F.conv3d(h, blk["dw"]["w"], padding=1,
                           groups=h.shape[1]), blk["dw"]["bn"]))
    h = _bn(F.conv3d(h, blk["fc2"]["w"]), blk["fc2"]["bn"])
    return _tokens(h)


def forward(params: dict, x: Tensor, num_heads: int, theta: float,
            gra_sharp: float) -> Tensor:
    """The BVP [B, T] of standardised clips ``x`` [B, 3, T, H, W]."""
    x = x.to(torch.float32)
    for name, pad in (("stem0", (0, 2, 2)), ("stem1", 1), ("stem2", 1)):
        p = params[name]
        x = F.relu(_bn(F.conv3d(x, p["w"], p["b"], padding=pad), p["bn"]))
        x = F.max_pool3d(x, (1, 2, 2), (1, 2, 2))
    pe = params["patch"]
    x = F.conv3d(x, pe["w"], pe["b"], stride=pe["w"].shape[2:])
    gt, g = x.shape[2], x.shape[3]
    x = _tokens(x)
    for blk in params["blocks"]:
        ln1, ln2 = blk["ln1"], blk["ln2"]
        h = F.layer_norm(x, x.shape[-1:], ln1["w"], ln1["b"], LN_EPS)
        x = x + _attention(blk, h, gt, g, num_heads, theta, gra_sharp)
        h = F.layer_norm(x, x.shape[-1:], ln2["w"], ln2["b"], LN_EPS)
        x = x + _feed_forward(blk, h, gt, g)
    x = _grid(x, gt, g)
    for name in ("up1", "up2"):
        p = params[name]
        x = F.interpolate(x, scale_factor=(2.0, 1.0, 1.0), mode="nearest")
        x = F.elu(_bn(F.conv3d(x, p["w"], p["b"], padding=(1, 0, 0)),
                      p["bn"]))
    x = x.mean(3).mean(3)
    return F.conv1d(x, params["last"]["w"], params["last"]["b"])[:, 0]


# -- the DSP the configuration states ----------------------------------------


def signal_config(clip_frames: int) -> SignalConfig:
    """One signal of ``clip_frames`` samples: linear detrend, order-2
    Butterworth over 0.75-2.5 Hz, an rFFT spectrum and its peak."""
    return SignalConfig(roi_configs=(), signal_max_samples=clip_frames,
                        processing_methods=(M.DETREND_LINEAR,
                                            M.FILTER_BUTTER),
                        spectrum_transform=T.DFT_RFFT, butter_order=2,
                        min_freq=0.75, max_freq=2.5)


def _arange_mask(n: int, count: Tensor) -> Tensor:
    return torch.arange(n, device=count.device) < count[..., None]


def detrend_linear(cfg, st):
    """The least-squares line over the sample index subtracted (sums and
    residual in f64, rounded once)."""
    c = sig.compact(st.valid, st.y)
    n = c.values.shape[-1]
    f64 = torch.float64
    v = c.values.to(f64)
    kf = torch.clamp(c.count, min=1).to(f64)
    i = torch.arange(n, dtype=f64, device=st.y.device)
    m = _arange_mask(n, c.count)
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


_METHODS = {M.DETREND_LINEAR: detrend_linear,
            M.FILTER_BUTTER: chain.make_filter_butter}


def process_signal(cfg: SignalConfig, x: Tensor, y: Tensor):
    """The chain over rings [..., N] where >= 2 samples are valid and fs is
    finite; elsewhere (x, y) pass through."""
    st = chain.ChainState(x=x, y=y, valid=sig.valid_y(y),
                          block=sig.valid_x(x), fs=sig.mean_fs(x))
    ok = ((st.valid.sum(-1) >= 2) & torch.isfinite(st.fs))[..., None]
    out = st
    for method in cfg.processing_methods:
        out = _METHODS[method](cfg, out)
    return torch.where(ok, out.x, x), torch.where(ok, out.y, y)


def dft_rfft(x: Tensor, y: Tensor, fs: Tensor):
    """freqs = rfftfreq(K, 1 / fs); mags = 2 |rfft(y_valid)| / K over the K
    valid samples."""
    n = x.shape[-1]
    cy = sig.compact(sig.valid_y(y), y)
    k = cy.count
    i = torch.arange(n, dtype=torch.float32, device=x.device)
    kf = torch.clamp(k, min=1).to(torch.float32)
    step = torch.full_like(kf, 2.0 * math.pi) / kf
    ang = step[..., None, None] * (i[:, None] * i[None, :])
    ym = torch.where(_arange_mask(n, k), cy.values, 0.0)
    re = (torch.cos(ang) @ ym[..., None])[..., 0]
    im = -(torch.sin(ang) @ ym[..., None])[..., 0]
    mags = 2.0 * torch.sqrt(re * re + im * im) / kf[..., None]
    freqs = i * fs[..., None] / kf[..., None]
    out_mask = _arange_mask(n, k // 2 + 1)
    return (torch.where(out_mask, freqs, _NAN),
            torch.where(out_mask, mags, _NAN))


def transform_signal(cfg: SignalConfig, x: Tensor, y: Tensor):
    """The rFFT spectrum; all-NaN with fewer than two valid samples or a
    non-finite fs."""
    w = sig.valid_y(y)
    fs = sig.mean_fs(x)
    ok = ((w.sum(-1) >= 2) & torch.isfinite(fs))[..., None]
    freqs, mags = dft_rfft(x, y, torch.where(torch.isfinite(fs), fs, 1.0))
    return torch.where(ok, freqs, _NAN), torch.where(ok, mags, _NAN)


def signal_analyze(cfg: SignalConfig, st, models, timestamps: Tensor,
                   fresh: Tensor) -> tuple[SignalState, StepOutputs]:
    """The analysis of one signal a stream on the pushed rings of ``st``:
    the chain, the spectrum, its peak pushed into the BPM ring where
    ``fresh``; PTT is NaN (no pair)."""
    raw_x, raw_y = st.raw_x, st.raw_y
    s, n = raw_x.shape[0], cfg.signal_max_samples
    x_b = raw_x[:, None, :].expand_as(raw_y)
    proc_x, proc_y = process_signal(cfg, x_b, raw_y)
    spec_x, spec_y = transform_signal(cfg, proc_x, proc_y)
    bpm_now = sig.peak_auto(spec_x, spec_y)[0] * 60.0
    bpm_x = sig.push_if(fresh, st.bpm_x, timestamps)
    bpm_y = sig.push_if(fresh, st.bpm_y, bpm_now)
    corr_x = torch.full((s, 1, 2 * n - 1), _NAN, device=raw_x.device)
    corr_y = torch.full_like(corr_x, _NAN)
    ptt_now = torch.full((s, 1), _NAN, device=raw_x.device)
    ptt_x = sig.push_if(fresh, st.ptt_x, timestamps)
    ptt_y = sig.push_if(fresh, st.ptt_y, ptt_now)
    new = SignalState(st.roi_x, st.roi_y, raw_x, raw_y, bpm_x, bpm_y,
                      ptt_x, ptt_y)
    rois = torch.full((s, 1, 6), _NAN, device=raw_x.device)
    out = StepOutputs(models, rois, raw_x, raw_y, proc_x, proc_y, spec_x,
                      spec_y, corr_x, corr_y,
                      sig.masked_mean(bpm_y, as_int=True),
                      sig.masked_mean(ptt_y, as_int=True),
                      1.0 / (raw_x[:, -1] - raw_x[:, -2]),
                      sig.mean_fs(bpm_x), _group_range(proc_x, proc_y),
                      _group_range(spec_x, spec_y),
                      _group_range(corr_x, corr_y))
    return new, out


# -- the tracker, the crop, the ring and the step ----------------------------


class FaceTracker(InferenceRunner):
    """``gpubench/ref``'s landmark runner with the face landmarker alone
    (the runner's own constructor insists on both landmarkers)."""

    def __init__(self, h: int, w: int, graph, device):
        self.cfg = InferenceConfig(hand_landmarker=False)
        self.h, self.w = h, w
        self.dtype = torch.float32
        self.device = device
        self.params, self.sizes, self._graph_fns = {}, {}, {}
        self._default_rect = torch.tensor([w / 2, h / 2, w, h, 0.0],
                                          dtype=torch.float32, device=device)
        self._load_compiled_landmark("flm_lm", graph, NUM_FACE_LANDMARKS)

    def predict_face(self, state: TrackState, frames: Tensor):
        """The face mesh on one frame a stream ([S, ...] either layout) at
        the tracked rects -> (track, results)."""
        if not bool(state.face_tracking.all()):
            raise RuntimeError("a stream lost its track: the reference "
                               "follows tracked streams only")
        nhwc = frames.permute(0, 2, 3, 1) if is_planar_frames(frames) \
            else frames
        res = self.empty_results(frames.shape[0])
        crops, prect = self._crops("flm_lm", nhwc,
                                   self._safe_rect(state.face_rect))
        lm, presence = self._landmarks("flm_lm", self.params["flm_lm"],
                                       crops)
        pts = self._project_lm("flm_lm", lm, prect)
        nxt = warp.rect_arr(warp.rect_transform(
            warp.landmarks_to_rect(pts, *FACE_ROT_LANDMARKS, 0.0),
            scale=1.5))
        present = state.face_tracking & (presence > PRESENCE_THRESHOLD)
        pts_i = _clip_floor(pts, self.w, self.h)
        bbox = torch.cat([pts_i.amin(1), pts_i.amax(1)], -1)
        res = res._replace(face_landmarker=Detections(
            bbox=torch.where(present[:, None], bbox, _NAN)[:, None],
            points=torch.where(present[:, None, None], pts_i, _NAN)[:, None],
            count=present.to(torch.int32)))
        track = state._replace(
            face_rect=torch.where(present[:, None], nxt, state.face_rect),
            face_tracking=present,
            face_det_age=torch.zeros_like(state.face_det_age))
        return track, res


def face_crops(frames: Tensor, face_rect: Tensor, size: int,
               dtype=torch.float32) -> Tensor:
    """Frames [F, S, ...] cropped at the axis-aligned cover of each
    stream's rect [S, 5]: f32 [S, F, size, size, 3] in [0, 1], a frame at
    a time (the resample's product operands rounded to ``dtype``)."""
    cover = warp.axis_aligned_cover(warp.arr_rect(face_rect))
    out = []
    for f in frames:
        nhwc = f.permute(0, 2, 3, 1) if is_planar_frames(f) else f
        out.append(warp.crop_rect(nhwc, cover, size, dtype) / 255.0)
    return torch.stack(out, 1)


class Clip(NamedTuple):
    """Each stream's last T crops and their timestamps, oldest first, and
    the crops pushed since the net last ran."""

    crops: Tensor   # [S, T, C, C, 3] f32
    ts: Tensor      # [S, T]
    new: Tensor     # [S]

    # The port's clip ring's readers, so that the judge reads either.
    def ordered(self) -> Tensor:
        return self.crops

    def ordered_ts(self) -> Tensor:
        return self.ts


class State(NamedTuple):
    signals: SignalState
    track: TrackState
    clip: Clip


def push(clip: Clip, crops: Tensor, ts: Tensor) -> Clip:
    """``crops`` [S, F, ...] pushed frame by frame where the timestamp
    ``ts`` [F, S] is finite and later than the stream's newest crop."""
    s, t = clip.ts.shape
    newest = clip.ts[:, -1]
    fresh = []
    for tf in ts:
        ok = torch.isfinite(tf) & ~(tf <= newest)
        newest = torch.where(ok, tf, newest)
        fresh.append(ok)
    keep = torch.cat([torch.ones_like(clip.ts, dtype=torch.bool),
                      torch.stack(fresh, 1)], 1)                 # [S, T+F]
    # The newest T kept entries of the old ring followed by the window.
    order = torch.argsort(keep.to(torch.int8), dim=1, stable=True)[:, -t:]
    allc = torch.cat([clip.crops, crops], 1)
    rows = torch.arange(s, device=ts.device)[:, None]
    return Clip(allc[rows, order], torch.cat([clip.ts, ts.T], 1)[rows, order],
                clip.new + torch.stack(fresh, 1).sum(1))


class Reference:
    """The plain reference of the physformer system's step (built by the
    system's ``build_reference``, which turns TF32 off)."""

    def __init__(self, net: dict, params: dict, graph, h: int, w: int,
                 device):
        self.net, self.params, self.device = net, params, device
        self.config = signal_config(net["clip_frames"])
        self.tracker = FaceTracker(h, w, graph, device)

    def init_state(self, s: int) -> State:
        c, n, t = self.config, self.config.signal_max_samples, \
            self.net["clip_frames"]
        np_, nr = c.peak_max_samples, c.roi_max_samples

        def nan(*shape):
            return torch.full((s,) + shape, _NAN, device=self.device)
        sz = self.net["crop"]
        return State(
            SignalState(nan(nr), nan(1, nr, 6), nan(n), nan(1, n), nan(np_),
                        nan(1, np_), nan(np_), nan(1, np_)),
            self.tracker.init_state(s),
            Clip(torch.zeros((s, t, sz, sz, 3), device=self.device),
                 nan(t), torch.zeros(s, dtype=torch.int64,
                                     device=self.device)))

    def bvp(self, clips: Tensor) -> Tensor:
        """The net's BVP [B, T] of clips [B, T, C, C, 3] in [0, 1], each
        standardised, in blocks of :data:`BLOCK` clips."""
        n = self.net
        return torch.cat([forward(
            self.params, standardise(b).permute(0, 4, 1, 2, 3),
            n["num_heads"], n["theta"], n["gra_sharp"])
            for b in clips.split(BLOCK)])

    def step(self, state: State, frames: Tensor, ts: Tensor):
        """One call: frames [S, ...] with ts [S], or [F, S, ...] with
        [F, S] -> (state, outputs)."""
        if ts.ndim == 1:
            frames, ts = frames[None], ts[None]
        track, models = self.tracker.predict_face(state.track, frames[-1])
        clip, due = self.push(state.clip, frames, ts, state.track.face_rect)
        st = state.signals
        if bool(due.any()):
            rows = torch.nonzero(due)[:, 0]
            raw = st.raw_y.clone()
            raw[rows, 0] = self.bvp(clip.crops[rows])
            st = st._replace(raw_y=raw, raw_x=torch.where(
                due[:, None], clip.ts, st.raw_x))
            clip = clip._replace(new=torch.where(due, 0, clip.new))
        signals, out = self.analyze(st, models, st.raw_x[:, -1], due)
        return State(signals, track, clip), out

    def crops(self, frames: Tensor, face_rect: Tensor,
              dtype=torch.float32) -> Tensor:
        """:func:`face_crops` at the tracker's safe rects."""
        return face_crops(frames, self.tracker._safe_rect(face_rect),
                          self.net["crop"], dtype)

    def push(self, clip: Clip, frames: Tensor, ts: Tensor,
             face_rect: Tensor) -> tuple[Clip, Tensor]:
        """The call's frames cropped and pushed -> (clip, the streams the
        net runs on: the ring full and ``hop`` crops new)."""
        clip = push(clip, self.crops(frames, face_rect), ts)
        return clip, (torch.isfinite(clip.ts).all(1)
                      & (clip.new >= self.net["hop"]))

    def analyze(self, st, models, timestamps, fresh):
        return signal_analyze(self.config, st, models, timestamps, fresh)
