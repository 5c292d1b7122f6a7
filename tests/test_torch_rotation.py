"""The port's rotation modes (``models/warp`` rotated crops and the
runner's ``exact``, ``shear`` and ``hybrid`` modes) against the reference
package on the same numpy inputs and weights.

Crops: the exact gather and the shear crop are compared with the
reference at atol 1e-3 on the 0-255 range (measured: the exact gather is
bit-equal, the shear crop within 1.3e-4 with either method: f32 FFTs
summed in another order).  Runner landmarks are integer pixels (clip and
floor): a coordinate within roundoff of an integer may land one pixel
apart, so points are held at atol 1 px and a mean difference below 0.05
px.  The port's ``shear`` is held to the reference's ``shear`` (the
reference's own shear-vs-exact runner test is a known red).  The batched
``hybrid`` runs K1's plain version here and the reference's Pallas
kernels in interpret mode.  Clips: BPM equal from ``SETTLED``, PTT and
``curr_fs`` on every row (``test_torch_streams.assert_clip_equal``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu import config as jconfig
from bp_from_video_tpu.models import runner as jrunner
from bp_from_video_tpu.models import warp as jwarp
from bp_from_video_tpu.parallel import MultiStreamEngine as JMultiStream
from bp_from_video_tpu_torch import config as tconfig
from bp_from_video_tpu_torch import convert
from bp_from_video_tpu_torch.models import runner as trunner
from bp_from_video_tpu_torch.models import warp
from bp_from_video_tpu_torch.parallel import ClipOutputs, MultiStreamEngine
from test_torch_multistream import _params as template_params
from test_torch_streams import (H, NO_FILES, S, T, W, _clip,
                                assert_clip_equal, lock_on, np_tree,
                                tiny_config)

CROP_ATOL = 1e-3
FUSED = dict(use_pallas=True, fused_stem=True, fused_trunk=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(a, np.float32)


def _smooth_frames(n, h=120, w=160):
    """Smooth content (the reference's shear test frame) plus a little
    seeded noise, one frame a crop: f32 [n, H, W, 3] on 0-255."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 80 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
                     128 + 60 * np.cos(xx / 9.0 + yy / 31.0),
                     128 + 90 * np.sin((xx + yy) / 41.0)], -1)
    noise = np.random.default_rng(3).normal(0, 4, (n, h, w, 3))
    return (base + noise).astype(np.float32)


@pytest.mark.parametrize("method", ["fft", "dft"])
def test_fract_shift_matches_reference(method):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 255, (5, 3, 64)).astype(np.float32)
    sh = rng.uniform(-5, 5, (5, 3)).astype(np.float32)
    want = jwarp.fract_shift(jnp.asarray(x), jnp.asarray(sh), axis=2,
                             method="fft")
    got = warp.fract_shift(torch.from_numpy(x), torch.from_numpy(sh), 2,
                           method)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=CROP_ATOL,
                               rtol=0)
    x2 = rng.uniform(0, 255, (48, 7)).astype(np.float32)
    sh2 = rng.uniform(-3, 3, (7,)).astype(np.float32)
    want = jwarp.fract_shift(jnp.asarray(x2), jnp.asarray(sh2), axis=0,
                             method="fft")
    got = warp.fract_shift(torch.from_numpy(x2), torch.from_numpy(sh2), 0,
                           method)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=CROP_ATOL,
                               rtol=0)


# The reference's shear-crop angles (test_shear_crop.py: any angle, and
# the quarter turns), then an anisotropic rect and a rect partly off the
# frame.
DEGS = (15, 30, -25, 60, 100, 135, 179, -135, -179, 90, -90, 180)
RECTS = ([(80.0, 60.0, 64.0, 64.0, d) for d in DEGS]
         + [(80.0, 60.0, 60.0, 44.0, 20.0), (20.0, 110.0, 70.0, 70.0, 35.0)])


def _rects():
    r = np.array(RECTS, np.float32)
    r[:, 4] = np.deg2rad(r[:, 4])
    return r


def test_bilinear_sample_and_exact_crop_match_reference():
    frames, rects = _smooth_frames(len(RECTS)), _rects()
    want = jax.vmap(lambda f, r: jwarp.crop_rect(
        f, jwarp.Rect(*r), 48, exact_rotation=True))(
            jnp.asarray(frames), jnp.asarray(rects))
    got = warp.crop_rect(torch.from_numpy(frames),
                         warp.arr_rect(torch.from_numpy(rects)), 48,
                         exact_rotation=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=CROP_ATOL,
                               rtol=0)
    rng = np.random.default_rng(4)
    xs = rng.uniform(-3, 163, (len(RECTS), 9, 11)).astype(np.float32)
    ys = rng.uniform(-3, 123, (len(RECTS), 9, 11)).astype(np.float32)
    want = jax.vmap(jwarp.bilinear_sample)(jnp.asarray(frames),
                                           jnp.asarray(xs), jnp.asarray(ys))
    got = warp.bilinear_sample(torch.from_numpy(frames), torch.from_numpy(xs),
                               torch.from_numpy(ys))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=CROP_ATOL,
                               rtol=0)


@pytest.mark.parametrize("method", ["fft", "dft"])
def test_crop_rect_shear_matches_reference(method):
    """All the rects in one batched call (each its own quarter-turn fold)
    against the reference's per-rect crop (its CPU method, fft)."""
    frames, rects = _smooth_frames(len(RECTS)), _rects()
    want = jax.vmap(lambda f, r: jwarp.crop_rect_shear(
        f, jwarp.Rect(*r), 48))(jnp.asarray(frames), jnp.asarray(rects))
    got = warp.crop_rect_shear(torch.from_numpy(frames),
                               warp.arr_rect(torch.from_numpy(rects)), 48,
                               method=method)
    assert tuple(got.shape) == (len(RECTS), 48, 48, 3)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=CROP_ATOL,
                               rtol=0)


def test_pow2_ladder_matches_reference():
    for m in (1, 2, 3, 4, 5, 8, 64, 128):
        assert trunner._pow2_ladder(m) == jrunner._pow2_ladder(m)
    assert trunner._pow2_ladder(5) == [1, 2, 4, 5]


# -- the runner --------------------------------------------------------------

RH = RW = 128


def _runner_pair(**kw):
    """Both packages' runners (face and hand landmarkers, VIDEO mode,
    random-init stand-ins) and the reference's params, fetched and
    converted."""
    jkw = dict(kw)
    if jkw.get("use_pallas"):
        jkw["pallas_interpret"] = True
    common = dict(face_landmarker=True, hand_landmarker=True, **NO_FILES)
    common.pop("use_pallas")
    jr = jrunner.InferenceRunner(jconfig.InferenceConfig(
        running_mode=jconfig.RunningMode.VIDEO, **common, **jkw), RH, RW)
    tr = trunner.InferenceRunner(tconfig.InferenceConfig(
        running_mode=tconfig.RunningMode.VIDEO, **common, **kw), RH, RW,
        device="cpu")
    return jr, tr, convert.params_from_jax(jax.tree.map(np.asarray,
                                                        jr.params))


def _predict_both(monkeypatch, kw, tilts, tracking=None, det_age=None):
    """One ``predict_batch`` of both packages on the same frames from a
    tracked state whose face rect of stream i has tilt ``tilts[i]``
    (degrees; its hands 5 degrees more).  Presence is forced open (random
    nets), so the landmarks of every crop are compared."""
    monkeypatch.setattr(jrunner, "PRESENCE_THRESHOLD", -1e9)
    monkeypatch.setattr(trunner, "PRESENCE_THRESHOLD", -1e9)
    jr, tr, params = _runner_pair(**kw)
    s = len(tilts)
    rad = np.deg2rad(np.array(tilts, np.float32))
    face = np.stack([np.full(s, RW / 2), np.full(s, RH / 2), np.full(s, 64.0),
                     np.full(s, 64.0), rad], -1).astype(np.float32)
    hands = np.stack([face + [[-8, 4, -16, -16, 0.087]],
                      face + [[8, 6, -20, -20, 0.087]]], 1
                     ).astype(np.float32)
    tracking = np.ones(s, bool) if tracking is None else np.array(tracking)
    age = np.zeros(s, np.int32) if det_age is None else np.array(
        det_age, np.int32)
    track = dict(face_rect=face, face_tracking=tracking, hand_rects=hands,
                 hand_tracking=np.stack([tracking, tracking], 1),
                 face_det_age=age)
    js = jax.tree.map(lambda x: jnp.broadcast_to(x, (s,) + x.shape),
                      jr.init_state())._replace(
        **{k: jnp.asarray(v) for k, v in track.items()})
    ts = tr.init_state(s)._replace(
        **{k: torch.from_numpy(v) for k, v in track.items()})
    frames = np.random.default_rng(7).integers(0, 256, (s, 3, RH, RW),
                                               dtype=np.uint8)
    jst, jres = jax.jit(jr.predict_batch)(jr.params, js, jnp.asarray(frames))
    tst, tres = tr.predict_batch(params, ts, torch.from_numpy(frames))
    for det in ("face_landmarker", "hand_landmarker"):
        t, j = getattr(tres, det), getattr(jres, det)
        np.testing.assert_array_equal(_np(t.count), _np(j.count), det)
        tp, jp = _np(t.points), _np(j.points)
        np.testing.assert_allclose(tp, jp, atol=1, rtol=0, equal_nan=True,
                                   err_msg=det)
        assert np.nanmean(np.abs(tp - jp)) < 0.05, det
    for name in ("face_rect", "hand_rects"):
        np.testing.assert_allclose(_np(getattr(tst, name)),
                                   _np(getattr(jst, name)), rtol=1e-3,
                                   atol=0.05, equal_nan=True, err_msg=name)
    return tres


@pytest.mark.parametrize("mode", ["exact", "shear", "hybrid"])
def test_per_crop_modes_match_reference(monkeypatch, mode):
    """The per-crop path (no K1): stream 0 upright, stream 1 at 25
    degrees; under ``hybrid`` stream 0 takes the cover crop, stream 1 the
    shear crop."""
    _predict_both(monkeypatch, dict(rotation_mode=mode), (0.0, 25.0))


def test_exact_rotation_flag_is_exact_mode(monkeypatch):
    _predict_both(monkeypatch, dict(exact_rotation=True), (0.0, -30.0))


@pytest.mark.parametrize("kw,tilts,tracking,age", [
    (dict(), (0.0, 8.0), None, None),                    # upright: K1 alone
    (dict(), (0.0, 30.0), None, None),                   # sub-batch of 1
    (dict(shear_subbatch=1), (25.0, 30.0), None, None),  # overflow
    (dict(shear_subbatch=0), (0.0, 30.0), None, None),   # any gated: all
    # Stream 1 lost tracking with a stale 30-degree rect and is not served
    # by the detector sub-batch (stream 2 is more starved): its tilt must
    # not count toward the gate.
    (dict(detector_subbatch=1), (0.0, 30.0, 10.0), (True, False, False),
     (0, 0, 5)),
], ids=["upright", "subbatch", "overflow", "subbatch0", "stale"])
def test_batched_hybrid_matches_reference(monkeypatch, kw, tilts, tracking,
                                          age):
    _predict_both(monkeypatch, dict(FUSED, rotation_mode="hybrid", **kw),
                  tilts, tracking, age)


# -- clips -------------------------------------------------------------------


def _tilted(state, to, deg):
    """``lock_on``'s tracked start with every rect tilted by ``deg``."""
    st = lock_on(state, H, to)

    def tilt(r):
        a = np.array(r, np.float32)
        a[..., 4] = np.deg2rad(deg)
        return to(a)
    return st._replace(track=st.track._replace(
        face_rect=tilt(st.track.face_rect),
        hand_rects=tilt(st.track.hand_rects)))


def _pinned_clip(step, params, state, to, deg):
    """``step`` over the 40-frame clip with every stream's rects pinned at
    ``deg`` degrees and tracking before each step (as the reference's
    bench pins them: a tilted track grows by the cover of its landmarks
    each step) -> numpy ClipOutputs."""
    clip, ts = _clip()
    pinned = _tilted(state, to, deg).track
    rows = []
    for i in range(T):
        state, out = step(params, state._replace(track=pinned),
                          to(clip[i]), to(ts[i]))
        rows.append([np.array(getattr(out, f), np.float32)
                     for f in ClipOutputs._fields])
    return ClipOutputs(*(np.stack(f) for f in zip(*rows)))


@pytest.mark.parametrize("infer", [
    dict(rotation_mode="exact"), dict(rotation_mode="shear"),
    dict(rotation_mode="hybrid"),
    dict(FUSED, rotation_mode="hybrid")],
    ids=["exact", "shear", "hybrid", "hybrid-batched"])
def test_clip_under_each_mode_matches_reference(infer):
    """Engine steps over 40 frames with every rect pinned at 25 degrees
    (template heads), on the per-crop path and (``hybrid-batched``) through
    K1's plain version with the shear sub-batch: BPM equal from
    ``SETTLED``, PTT and ``curr_fs`` on every row."""
    def cfg(mod):
        c = tiny_config(mod, frame_height=H, frame_width=W, num_streams=S)
        return dataclasses.replace(c, inference=dataclasses.replace(
            c.inference, **infer))
    jkw = dict(infer, pallas_interpret=True) if "use_pallas" in infer \
        else infer
    jms = JMultiStream(dataclasses.replace(
        cfg(jconfig), inference=dataclasses.replace(
            cfg(jconfig).inference, **jkw)))
    tms = MultiStreamEngine(cfg(tconfig), device="cpu")
    jparams, tparams = template_params(jms)
    jout = _pinned_clip(jax.jit(jms.engine.batch_step), jparams,
                        jms.init_states(), jnp.asarray, 25.0)
    tout = _pinned_clip(tms.step, tparams, tms.init_states(),
                        torch.from_numpy, 25.0)
    assert tout.bpm.shape == (T, S, 2)
    assert_clip_equal(tout, jout)
    assert np.isfinite(tout.bpm[-1]).all()
