"""How ``correct`` is decided: the reference judges what the port produced,
stage by stage on the calls the window kept, and as a whole on a run of
its own from the start.

Judged stage by stage (:func:`judge`).  For each kept call the harness
holds the port's state before it, its frames and timestamps, its outputs
and its state after it.  The reference works each stage out again in
float32.  The nets and the ROIs start from the port's state before the
call; the sampling of the last frame takes the port's ROIs; the DSP takes
the port's pushed rings.  Each number is the gap between the two sides:

- ``face_lm_gap_px``, ``hand_lm_gap_px``: per crop, the mean over its
  landmarks of |reference - port| in frame pixels (both floored, as the
  output holds them), the largest over crops, for each landmark net: the
  crop (K1) and the net (the compiled mesh with K3 and K6; the hand
  stand-in with K3) with its readout.  A landmark present on one side only
  reads infinite.
- ``rect_gap_px``: the largest gap of the next tracking rects (centre,
  size, and the turn as pixels at the rect's edge): the tracker.
- ``roi_gap_px``: per stream, the mean gap over the newest ROI ring
  entries and the ROIs sampled (the reference from its own landmarks on
  the port's older ring): ROI geometry, ring and means.
- ``sample_gap``: the largest relative gap of the last frame's samples
  pushed, the reference sampling the port's ROIs of that frame plainly:
  K4.
- ``frame_sample_gap`` (F > 1): every other frame of the call.  The port's
  ROIs of those frames are not kept, so the reference samples frame f at
  the port's last ROIs moved by the reference's own change of ROI from f
  to the last frame; per frame the mean over streams and ROIs of the
  relative gap to the sample the port pushed for f, the largest over
  frames: a call that samples or pushes fewer than its F frames.
- ``proc_gap``, ``spec_gap``, ``corr_gap``: per stream and signal the
  largest gap over the largest reference magnitude, of the processed
  signal, the spectrum and the face-to-palm correlation, the reference
  running the DSP on the port's pushed rings.
- ``bpm_gap``, ``ptt_gap``: the largest gap of the newest peak pushed
  (BPM, ms) and of the ring means the user reads.

Judged on a run of the reference's own (:func:`judge_own`): from the same
start, frames and timestamps, the reference runs the first calls of the
run by itself, with its own nets, ROIs, samples and DSP, and its state and
outputs after the last are held against the port's:

- ``own_raw_gap``: per stream and signal, the mean over the raw ring's
  samples of |port - reference| over the mean |reference|, the largest
  over rows.
- ``own_proc_gap``: as ``proc_gap``, of the processed signal.
- ``own_bpm_gap``, ``own_ptt_gap``: the largest gap of the BPM and PTT
  the user reads.

Non-finite values must match in place; a mismatch reads infinite.  Only
the numbers the configuration gives a limit are compared; the others are
logged.
"""

from __future__ import annotations

import dataclasses
import math

import torch

INF = float("inf")


@dataclasses.dataclass
class Checked:
    """One call the window kept for the check."""

    call: int
    frames: torch.Tensor
    ts: torch.Tensor
    state_in: object
    out: object
    state_out: object


def _finite_match(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool((torch.isfinite(a) == torch.isfinite(b)).all())


def _mean_gap(a, b, dims) -> float:
    """Largest over the leading axes of the mean |a - b| over ``dims``;
    infinite where finiteness differs."""
    a, b = a.double(), b.double()
    if not _finite_match(a, b):
        return INF
    ok = torch.isfinite(a)
    d = torch.where(ok, (a - b).abs(), 0.0)
    n = ok.to(torch.float64).sum(dims).clamp(min=1)
    return float((d.sum(dims) / n).max()) if d.numel() else 0.0


def _max_gap(a, b) -> float:
    a, b = a.double(), b.double()
    if not _finite_match(a, b):
        return INF
    ok = torch.isfinite(a)
    d = torch.where(ok, (a - b).abs(), 0.0)
    return float(d.max()) if d.numel() else 0.0


def _rel_gap(ref, cand) -> float:
    """Per row (all but the last axis) max |Δ| / max |ref| over the last
    axis, the largest over rows; rows that are all zero or non-finite in
    the reference compare absolutely."""
    ref, cand = ref.double(), cand.double()
    if not _finite_match(ref, cand):
        return INF
    ok = torch.isfinite(ref)
    d = torch.where(ok, (ref - cand).abs(), 0.0).amax(-1)
    scale = torch.where(ok, ref.abs(), 0.0).amax(-1)
    scale = torch.where(scale > 0, scale, 1.0)
    return float((d / scale).max()) if d.numel() else 0.0


def _mean_rel_gap(ref, cand) -> float:
    """Per row (all but the last axis) mean |Δ| / mean |ref| over the last
    axis's finite values, the largest over rows."""
    ref, cand = ref.double(), cand.double()
    if not _finite_match(ref, cand):
        return INF
    ok = torch.isfinite(ref)
    d = torch.where(ok, (ref - cand).abs(), 0.0).sum(-1)
    scale = torch.where(ok, ref.abs(), 0.0).sum(-1)
    scale = torch.where(scale > 0, scale, 1.0)
    return float((d / scale).max()) if d.numel() else 0.0


def _rect_gap(r, c) -> float:
    """Largest gap of rects [..., 5] (cx, cy, w, h px; turn as px at half
    the larger side)."""
    half = torch.maximum(r[..., 2], r[..., 3]).abs() / 2
    turn_r, turn_c = r[..., 4] * half, c[..., 4] * half
    return max(_max_gap(r[..., :4], c[..., :4]), _max_gap(turn_r, turn_c))


def _tracking_match(ref_tr, cand_tr) -> bool:
    return (bool((ref_tr.face_tracking == cand_tr.face_tracking).all())
            and bool((ref_tr.hand_tracking == cand_tr.hand_tracking).all()))


def _frame_sample_gap(cfg, c: Checked, rois_ref: list, rois_last) -> float:
    """``frame_sample_gap`` of a lagged call: ``rois_ref`` the reference's
    ROIs of each frame, ``rois_last`` the port's of the last."""
    from gpubench.ref.ops import roi as roi_ops
    f_n = c.ts.shape[0]
    raw = c.state_out.signals.raw_y[..., -f_n:]
    gaps = []
    for f in range(f_n - 1):
        rois = rois_last + (rois_ref[f] - rois_ref[-1])
        samp = roi_ops.sample_rois_batch(
            c.frames[f], rois, cfg.signal.color_channel)
        ref, prog = samp.double(), raw[..., f].double()
        if not _finite_match(ref, prog):
            return INF
        ok = torch.isfinite(ref)
        rel = torch.where(ok, (ref - prog).abs() / ref.abs().clamp(
            min=1e-6), 0.0)
        gaps.append(float(rel.sum() / ok.sum().clamp(min=1)))
    return max(gaps) if gaps else 0.0


def judge(ref, c: Checked) -> dict:
    """Every number of one kept call that the configuration's layers have
    (see the module's docstring)."""
    from gpubench.ref.models.runner import map_leaves
    from gpubench.ref.ops import roi as roi_ops
    cfg = ref.config
    run, params = ref.runner, ref.params
    lagged = c.ts.ndim == 2
    out, st_in, st_out = c.out, c.state_in, c.state_out
    res = {}
    with torch.no_grad():
        if lagged:
            f_n, s_n = c.ts.shape
            flat = c.frames.reshape((f_n * s_n,) + c.frames.shape[2:])
            tiled = map_leaves(
                lambda a: a.repeat((f_n,) + (1,) * (a.ndim - 1)), st_in.track)
            tr_flat, m_flat = run.predict_batch(params, tiled, flat)
            tr_r = map_leaves(lambda a: a[(f_n - 1) * s_n:], tr_flat)
            m_f = map_leaves(lambda a: a.reshape((f_n, s_n) + a.shape[1:]),
                             m_flat)
            models = [map_leaves(lambda a, f=f: a[f], m_f) for f in range(f_n)]
            ts_f = list(c.ts)
            last_frames = c.frames[-1]
        else:
            f_n = 1
            tr_r, m_r = run.predict_batch(params, st_in.track, c.frames)
            models, ts_f = [m_r], [c.ts]
            last_frames = c.frames
        m_last = models[-1]
        if cfg.inference.face_landmarker:
            res["face_lm_gap_px"] = _mean_gap(
                m_last.face_landmarker.points,
                out.models.face_landmarker.points, (-2, -1))
        if cfg.inference.hand_landmarker:
            res["hand_lm_gap_px"] = _mean_gap(
                m_last.hand_landmarker.points,
                out.models.hand_landmarker.points, (-2, -1))
        res["rect_gap_px"] = (
            max(_rect_gap(tr_r.face_rect, st_out.track.face_rect),
                _rect_gap(tr_r.hand_rects, st_out.track.hand_rects))
            if _tracking_match(tr_r, st_out.track) else INF)

        # ROI geometry and ring: the reference's landmarks on the port's
        # older ring, frame by frame.
        sig_st, rois_ref = st_in.signals, []
        for f in range(f_n):
            roi_x, roi_y, rois_r = ref.roi_stage(sig_st, models[f], ts_f[f])
            sig_st = sig_st._replace(roi_x=roi_x, roi_y=roi_y)
            rois_ref.append(rois_r)
        new_r = sig_st.roi_y[..., -f_n:, :]
        new_p = st_out.signals.roi_y[..., -f_n:, :]
        s = new_r.shape[0]
        res["roi_gap_px"] = _mean_gap(
            torch.cat([new_r.reshape(s, -1), rois_r.reshape(s, -1)], -1),
            torch.cat([new_p.reshape(s, -1), out.rois.reshape(s, -1)], -1),
            (-1,))

        # Sampling: the last frame at the port's ROIs of it; in a lagged
        # call every other frame as frame_sample_gap says.
        raw = st_out.signals.raw_y[..., -f_n:]
        samp_r = roi_ops.sample_rois_batch(
            last_frames, out.rois, cfg.signal.color_channel)
        res["sample_gap"] = _rel_gap(samp_r.reshape(-1, 1),
                                     raw[..., -1].reshape(-1, 1))
        if lagged:
            res["frame_sample_gap"] = _frame_sample_gap(cfg, c, rois_ref,
                                                        out.rois)

        # DSP on the port's pushed rings.
        st = st_out.signals._replace(
            bpm_x=st_in.signals.bpm_x, bpm_y=st_in.signals.bpm_y,
            ptt_x=st_in.signals.ptt_x, ptt_y=st_in.signals.ptt_y)
        ts_last = ts_f[-1]
        fresh = torch.isfinite(ts_last) & (ts_last != st.bpm_x[:, -1])
        st_r, out_r = ref.signal_analyze(st, out.rois, out.models, ts_last,
                                         fresh)
        res["proc_gap"] = _rel_gap(out_r.proc_y, out.proc_y)
        res["spec_gap"] = _rel_gap(out_r.spec_y, out.spec_y)
        if cfg.signal.num_pairs:
            res["corr_gap"] = _rel_gap(out_r.corr_y, out.corr_y)
        res["bpm_gap"] = max(
            _max_gap(st_r.bpm_y[..., -1], st_out.signals.bpm_y[..., -1]),
            _max_gap(out_r.bpm.float(), out.bpm.float()))
        if cfg.signal.num_pairs:
            res["ptt_gap"] = max(
                _max_gap(st_r.ptt_y[..., -1], st_out.signals.ptt_y[..., -1]),
                _max_gap(out_r.ptt.float(), out.ptt.float()))
    return res


def own_run(step, state, inputs, calls: int):
    """(state, outputs) after calls ``0 .. calls - 1`` from ``state`` of
    ``step(state, frames, ts)`` (the reference's, or the control's in its
    place); ``inputs(call)`` gives each call's frames and timestamps."""
    out = None
    with torch.no_grad():
        for call in range(calls):
            state, out = step(state, *inputs(call))
    return state, out


def judge_own(cfg, ref_state, ref_out, state, out) -> dict:
    """The ``own_*`` numbers: the port's ``state``/``out`` after the
    reference's own run against its ``ref_state``/``ref_out``."""
    res = {"own_raw_gap": _mean_rel_gap(ref_state.signals.raw_y,
                                        state.signals.raw_y),
           "own_proc_gap": _rel_gap(ref_out.proc_y, out.proc_y),
           "own_bpm_gap": _max_gap(ref_out.bpm.float(), out.bpm.float())}
    if cfg.signal.num_pairs:
        res["own_ptt_gap"] = _max_gap(ref_out.ptt.float(), out.ptt.float())
    return res


def worst(readings: list[dict]) -> dict:
    """The largest reading of each number over the checked calls."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -INF), v)
    return out


def verdict(worst_: dict, limits: dict) -> tuple[bool, list[str]]:
    """(correct, lines 'name value limit'): correct when every number is
    finite and within its limit and every limited number was read."""
    ok, lines = True, []
    for name, limit in limits.items():
        v = worst_.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok &= good
        lines.append(f"{name} {v!r} limit {limit!r}"
                     f"{'' if good else ' FAILED'}")
    return ok, lines
