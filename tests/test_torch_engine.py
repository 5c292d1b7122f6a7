"""The port's runner and engine (``predict_batch``, ``Engine.batch_step``)
against the reference package's, on the same frames and weights.

The reference runs its Pallas kernels in interpret mode
(``use_pallas=True, pallas_interpret=True``); the port runs the plain
versions of its kernels (CPU tensors).  Weights are the reference runner's
params fetched as numpy and converted with ``convert.params_from_jax``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.config import EngineConfig as JEngineConfig
from bp_from_video_tpu.config import InferenceConfig as JInferenceConfig
from bp_from_video_tpu.config import SignalConfig as JSignalConfig
from bp_from_video_tpu.runtime.engine import Engine as JEngine
from bp_from_video_tpu_torch import convert
from bp_from_video_tpu_torch.config import (EngineConfig, InferenceConfig,
                                            SignalConfig, flagship_config)
from bp_from_video_tpu_torch.models.runner import TrackState, map_leaves
from bp_from_video_tpu_torch.runtime.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, H, W = 2, 96, 128
FUSED = dict(use_pallas=True, fused_stem=True, fused_trunk=True,
             hand_lm_standin_path=None, palm_det_standin_path=None)


def _pair(infer=FUSED, signal=None):
    signal = signal or {}
    jkw = dict(infer)
    if jkw.get("use_pallas"):
        jkw["pallas_interpret"] = True
    je = JEngine(JEngineConfig(signal=JSignalConfig(**signal),
                               inference=JInferenceConfig(**jkw),
                               frame_height=H, frame_width=W,
                               num_streams=S))
    te = Engine(EngineConfig(signal=SignalConfig(**signal),
                             inference=InferenceConfig(**infer),
                             frame_height=H, frame_width=W, num_streams=S),
                device="cpu")
    return je, te


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(a, np.float32)


def _jstate(je, track=None):
    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                      je.init_state())
    if track is not None:
        st = st._replace(track=st.track._replace(**track))
    return st


def _frames(seed, n=1):
    return np.random.default_rng(seed).integers(0, 256, (n, S, 3, H, W),
                                                dtype=np.uint8)


@pytest.mark.parametrize("infer", [
    FUSED,
    dict(FUSED, detector_subbatch=1),        # bounded sub-batch (k < S)
    dict(use_pallas=False, hand_lm_standin_path=None,
         palm_det_standin_path=None)],        # plain crops + plain nets
    ids=["fused", "fused-subbatch", "plain"])
def test_predict_batch_matches_reference(infer):
    je, te = _pair(infer)
    params = convert.params_from_jax(jax.tree.map(np.asarray, je.params))
    jstate = _jstate(je).track
    tstate = te.init_state().track
    predict = jax.jit(je.runner.predict_batch)
    for i, frames in enumerate(_frames(1, 3)):
        jst, jres = predict(je.params, jstate, jnp.asarray(frames))
        tst, tres = te.runner.predict_batch(params, tstate,
                                            torch.from_numpy(frames))
        for name in ("face_tracking", "hand_tracking", "face_det_age",
                     "hand_det_age"):
            np.testing.assert_array_equal(_np(getattr(tst, name)),
                                          _np(getattr(jst, name)), name)
        # Rects come from detection or from landmarks through the nets:
        # f32 roundoff in another order (crop coordinates, conv sums).
        np.testing.assert_allclose(_np(tst.face_rect), _np(jst.face_rect),
                                   rtol=1e-3, atol=0.05)
        np.testing.assert_allclose(_np(tst.hand_rects), _np(jst.hand_rects),
                                   rtol=1e-3, atol=0.05, equal_nan=True)
        for det in ("face_landmarker", "hand_landmarker"):
            t, j = getattr(tres, det), getattr(jres, det)
            np.testing.assert_array_equal(_np(t.count), _np(j.count))
            # Integer pixels (clip + floor): a value within roundoff of an
            # integer may land one pixel apart.
            np.testing.assert_allclose(_np(t.points), _np(j.points), atol=1,
                                       rtol=0, equal_nan=True)
        # Feed both the reference's state, so every step checks one step.
        jstate = jst
        tstate = TrackState(*[torch.from_numpy(np.array(x)) for x in jst])


def _logit(p):
    return np.log(p / (1.0 - p)).astype(np.float32)


def _template_heads(params):
    """Landmark heads that put every landmark at a fixed place in its crop
    (zero readout weights, the place in the bias) and report presence: the
    tracking rects then hold still, so the clip's ROIs and samples do not
    depend on roundoff in the nets.  Face: a grid over the middle 2/3 of
    the crop with the eye corners level; hand: wrist low, middle-finger
    knuckle high, spanning half the crop."""
    rng = np.random.default_rng(11)
    for key, n, lo, hi, fixed in (
            ("flm_lm", 478, (1 / 6, 1 / 6), (5 / 6, 5 / 6),
             {33: (0.3, 0.4), 263: (0.7, 0.4), 151: (0.5, 0.3)}),
            ("hand_lm", 21, (0.25, 0.3), (0.75, 0.8),
             {0: (0.5, 0.8), 9: (0.5, 0.3)})):
        pts = np.stack([rng.uniform(lo[0], hi[0], n),
                        rng.uniform(lo[1], hi[1], n), np.full(n, 0.5)], -1)
        pts[-2, :2], pts[-1, :2] = lo, hi        # the bbox corners
        for i, xy in fixed.items():
            pts[i, :2] = xy
        p = params[key]
        p["head_lm"]["w"] = np.zeros_like(p["head_lm"]["w"])
        p["head_lm"]["b"] = _logit(pts.reshape(-1)).astype(
            p["head_lm"]["b"].dtype)
        p["head_presence"]["w"] = np.zeros_like(p["head_presence"]["w"])
        p["head_presence"]["b"] = np.full_like(p["head_presence"]["b"], 8.0)
    return params


def _pulse_clip(steps, hz=1.2, delay_frames=3, seed=5):
    """Textured frames whose green channel pulses at ``hz``: rows < 60
    (the face) in phase, rows >= 60 (the hands) ``delay_frames`` later."""
    rng = np.random.default_rng(seed)
    base = rng.integers(60, 180, (S, 3, H // 8, W // 8))
    base = np.repeat(np.repeat(base, 8, 2), 8, 3).astype(np.float32)
    t = np.arange(steps) / 30.0
    rows = np.arange(H)[:, None]
    out = np.empty((steps, S, 3, H, W), np.uint8)
    for i in range(steps):
        ph = np.where(rows < 60, t[i], t[i] - delay_frames / 30.0)
        f = base.copy()
        f[:, 1] += 6.0 * np.sin(2 * np.pi * hz * ph)
        out[i] = np.clip(np.round(f + rng.normal(0, 0.5, f.shape)), 0, 255)
    return out


def test_batch_step_clip_matches_reference():
    """Engine.batch_step over a pulsing clip that fills a 64-sample ring:
    BPM and PTT equal the reference's, float outputs within roundoff."""
    signal = dict(signal_max_samples=64, peak_max_samples=8)
    je, te = _pair(FUSED, signal)
    jparams = _template_heads(jax.tree.map(np.array, je.params))
    tparams = convert.params_from_jax(jparams)
    jparams = jax.tree.map(jnp.asarray, jparams)
    track = dict(
        face_rect=jnp.asarray([[64, 40, 56, 56, 0]] * S, jnp.float32),
        face_tracking=jnp.ones((S,), bool),
        hand_rects=jnp.asarray([[[30, 72, 40, 40, 0], [98, 72, 40, 40, 0]]]
                               * S, jnp.float32),
        hand_tracking=jnp.ones((S, 2), bool))
    jst = _jstate(je, track)
    tst = te.init_state()
    tst = tst._replace(track=TrackState(
        *[torch.from_numpy(np.array(x)) for x in jst.track]))
    step = jax.jit(je.batch_step)
    steps = 80
    clip = _pulse_clip(steps)
    for i in range(steps):
        ts = np.full((S,), (i + 1) / 30.0, np.float32)
        jst, jo = step(jparams, jst, jnp.asarray(clip[i]), jnp.asarray(ts))
        tst, to = te.batch_step(tparams, tst, torch.from_numpy(clip[i]),
                                torch.from_numpy(ts))
        np.testing.assert_array_equal(_np(to.rois), _np(jo.rois))
        if i >= steps - 10:
            np.testing.assert_array_equal(_np(to.bpm), _np(jo.bpm))
            np.testing.assert_array_equal(_np(to.ptt), _np(jo.ptt))
    assert np.isfinite(_np(to.bpm)).all() and np.isfinite(_np(to.ptt)).all()
    # Both ROIs see the 1.2 Hz pulse: 72 BPM within the 64-sample
    # spectrum's ~3 BPM bins; the palm lags the forehead by the clip's 3
    # frames (100 ms), within one sample period.
    assert np.all(np.abs(_np(to.bpm) - 72) <= 6)
    assert np.all(np.abs(_np(to.ptt) + 100) <= 1000 / 30)
    # Same ROIs and frames: identical integer sums.
    np.testing.assert_array_equal(_np(to.raw_y), _np(jo.raw_y))
    # Butterworth chain: f32 roundoff against a 6-unit pulse.
    np.testing.assert_allclose(_np(to.proc_y), _np(jo.proc_y), atol=2e-3,
                               rtol=0, equal_nan=True)
    np.testing.assert_allclose(_np(to.spec_y), _np(jo.spec_y), atol=1e-3,
                               rtol=0, equal_nan=True)
    np.testing.assert_allclose(_np(to.corr_y), _np(jo.corr_y), atol=1e-4,
                               rtol=0, equal_nan=True)
    np.testing.assert_allclose(_np(to.corr_x), _np(jo.corr_x), atol=1e-5,
                               rtol=0, equal_nan=True)
    for name in ("curr_fs", "mean_fs", "proc_range", "spec_range",
                 "corr_range"):
        np.testing.assert_allclose(_np(getattr(to, name)),
                                   _np(getattr(jo, name)), rtol=1e-3,
                                   atol=1e-3, equal_nan=True, err_msg=name)


def test_step_matches_reference():
    """``Engine.step`` (one stream, no stream axis in its state) against the
    reference's ``Engine.step`` on the first frames of the pulsing clip."""
    signal = dict(signal_max_samples=16, peak_max_samples=4)
    je, te = _pair(FUSED, signal)
    jparams = _template_heads(jax.tree.map(np.array, je.params))
    tparams = convert.params_from_jax(jparams)
    jparams = jax.tree.map(jnp.asarray, jparams)
    jst = je.init_state()
    jst = jst._replace(track=jst.track._replace(
        face_rect=jnp.asarray([64, 40, 56, 56, 0], jnp.float32),
        face_tracking=jnp.asarray(True),
        hand_rects=jnp.asarray([[30, 72, 40, 40, 0], [98, 72, 40, 40, 0]],
                               jnp.float32),
        hand_tracking=jnp.ones((2,), bool)))
    tst = map_leaves(lambda x: x[0], te.init_state(1))
    tst = tst._replace(track=TrackState(
        *[torch.from_numpy(np.array(x)) for x in jst.track]))
    step = jax.jit(je.step)
    # NHWC frames: the reference's per-stream step samples NHWC pixels.
    clip = np.ascontiguousarray(_pulse_clip(4)[:, 0].transpose(0, 2, 3, 1))
    for i, frame in enumerate(clip):
        ts = np.float32((i + 1) / 30.0)
        jst, jo = step(jparams, jst, jnp.asarray(frame), jnp.asarray(ts))
        tst, to = te.step(tparams, tst, torch.from_numpy(frame),
                          torch.tensor(ts))
        assert tuple(to.rois.shape) == jo.rois.shape == (2, 6)
        np.testing.assert_array_equal(_np(to.rois), _np(jo.rois))
        np.testing.assert_array_equal(_np(to.raw_y), _np(jo.raw_y))
        for name in ("face_tracking", "hand_tracking"):
            np.testing.assert_array_equal(_np(getattr(tst.track, name)),
                                          _np(getattr(jst.track, name)))


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EngineConfig(inference=InferenceConfig(**FUSED), frame_height=H,
                       frame_width=W)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, device="cuda")
    assert Engine(cfg, device="cpu").device.type == "cpu"


def test_flagship_config_matches_bench():
    sys.path.insert(0, REPO)
    import bench
    want, _ = bench.build_config(None, 64, 480, 640, on_tpu=True)
    got = flagship_config()
    assert repr(got) == repr(want).replace("bp_from_video_tpu.",
                                           "bp_from_video_tpu_torch.")


def test_unported_paths_raise():
    for kw in (dict(person_segmenter=True), dict(face_detector=True),
               dict(rotation_mode="shear"),
               dict(fused_trunk=False)):      # the fused stem alone (K2)
        cfg = EngineConfig(inference=InferenceConfig(**dict(FUSED, **kw)),
                           frame_height=H, frame_width=W)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Engine(cfg, device="cpu")


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import bp_from_video_tpu_torch.runtime.engine\n"
            "import bp_from_video_tpu_torch.convert\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bp_from_video_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
