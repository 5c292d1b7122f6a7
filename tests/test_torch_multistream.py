"""The ``multistream`` preset in the port against the reference package: the
standalone face detector, ``Engine.batch_step`` with every model and the
renderer, and ``Engine.batch_step_lagged`` (S = 2, 96x128, f32).

The reference runs its Pallas kernels in interpret mode; the port runs the
plain versions of its kernels (CPU tensors), with the reference's weights
(``convert.params_from_jax``).  Tolerances: detection counts equal, boxes
and keypoints within 1 px (integer pixels from f32 convolutions summed in
another order); ROI rings, raw timestamps and BPM equal, the skin-weighted
samples within 1e-5 of themselves; composed frames as in
``test_torch_render`` (at most 0.1 % of pixels off by 1) where the two
packages' drawings agree (their hand landmarks may lie a pixel apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.config import preset_configs as jpreset_configs
from bp_from_video_tpu.render.drawer import Drawer as JDrawer
from bp_from_video_tpu.runtime.engine import Engine as JEngine
from bp_from_video_tpu_torch import convert
from bp_from_video_tpu_torch.config import preset_configs
from bp_from_video_tpu_torch.models.runner import TrackState
from bp_from_video_tpu_torch.render import overlay
from bp_from_video_tpu_torch.render.drawer import Drawer
from bp_from_video_tpu_torch.runtime.engine import Engine
from chip_smoke import pulse_clip, template_heads, tracked_state
from test_torch_render import _t, _to_port, assert_images_close


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, H, W = 2, 96, 128
STANDINS = ("hand_lm_standin_path", "palm_det_standin_path",
            "seg_standin_path")


def _cfg(base, interpret, trained):
    infer = dict(use_pallas=True, fused_stem=True, fused_trunk=True)
    if not trained:
        infer.update({k: None for k in STANDINS})
    if interpret:
        infer["pallas_interpret"] = True
    return dataclasses.replace(
        base, frame_height=H, frame_width=W, num_streams=S,
        signal=dataclasses.replace(base.signal, signal_max_samples=64,
                                   peak_max_samples=8),
        inference=dataclasses.replace(base.inference, **infer))


def _pair(trained=False):
    je = JEngine(_cfg(jpreset_configs()["multistream"], True, trained))
    te = Engine(_cfg(preset_configs()["multistream"], False, trained),
                device="cpu")
    return je, te


def _params(je):
    """Both packages' params with template landmark heads (the trackers
    hold still on the clip)."""
    tparams = template_heads(convert.params_from_jax(
        jax.tree.map(np.array, je.params)))
    jparams = jax.tree.map(np.array, je.params)
    for key in ("flm_lm", "hand_lm"):
        for head in ("head_lm", "head_presence"):
            for k in ("w", "b"):
                jparams[key][head][k] = tparams[key][head][k].to(
                    torch.float32).numpy().astype(jparams[key][head][k].dtype)
    return jax.tree.map(jnp.asarray, jparams), tparams


def _tracked(je, te):
    """Both packages' states with every stream locked on the clip's face
    box and hand boxes."""
    k = H / 96.0
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                       je.init_state())
    jst = jst._replace(track=jst.track._replace(
        face_rect=jnp.asarray([[64 * k, 40 * k, 56 * k, 56 * k, 0]] * S,
                              jnp.float32),
        face_tracking=jnp.ones((S,), bool),
        hand_rects=jnp.asarray([[[30 * k, 72 * k, 40 * k, 40 * k, 0],
                                 [98 * k, 72 * k, 40 * k, 40 * k, 0]]] * S,
                               jnp.float32),
        hand_tracking=jnp.ones((S, 2), bool)))
    tst = te.init_state()._replace(track=TrackState(
        *[torch.from_numpy(np.array(x)) for x in jst.track]))
    return jst, tst


def _clip(steps):
    """Person scenes pulsing at 72 BPM, the lower part 3 frames late."""
    return pulse_clip(steps, S, H, W, split=60, seed=6, device="cpu",
                      person=True).numpy()


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(a, np.float32)


def test_face_detector_matches_reference():
    """The standalone detector on every frame (tracked streams too): the
    detections, largest first, of the reference's ``predict_batch``."""
    je, te = _pair()
    params = convert.params_from_jax(jax.tree.map(np.asarray, je.params))
    jst, tst = _tracked(je, te)
    clip = np.concatenate([_clip(2), np.random.default_rng(1).integers(
        0, 256, (2, S, 3, H, W), dtype=np.uint8)])
    predict = jax.jit(je.runner.predict_batch)
    counts = []
    for frames in clip:
        _, jres = predict(je.params, jst.track, jnp.asarray(frames))
        _, tres = te.runner.predict_batch(params, tst.track,
                                          torch.from_numpy(frames))
        t, j = tres.face_detector, jres.face_detector
        assert tuple(t.bbox.shape) == (S, 4, 4)
        assert tuple(t.points.shape) == (S, 4, 6, 2)
        np.testing.assert_array_equal(_np(t.count), _np(j.count))
        np.testing.assert_allclose(_np(t.bbox), _np(j.bbox), atol=1, rtol=0,
                                   equal_nan=True)
        np.testing.assert_allclose(_np(t.points), _np(j.points), atol=1,
                                   rtol=0, equal_nan=True)
        counts += _np(t.count).tolist()
    assert 0 < sum(counts)


@pytest.mark.trained_standins
def test_multistream_clip_matches_reference():
    """``batch_step`` and ``Drawer.compose`` of every stream over a clip of
    person scenes that fills a 64-sample ring: ROI rings and BPM equal,
    the composed frames within the renderer's tolerance."""
    je, te = _pair(trained=True)
    jparams, tparams = _params(je)
    jst, tst = _tracked(je, te)
    step = jax.jit(je.batch_step)
    jd = JDrawer(je.config, show=False)
    compose = jax.jit(jax.vmap(jd._compose_fn))
    td = Drawer(te.config, show=False, device="cpu")
    steps = 70
    clip = _clip(steps)
    for i in range(steps):
        ts = np.full((S,), (i + 1) / 30.0, np.float32)
        jst, jo = step(jparams, jst, jnp.asarray(clip[i]), jnp.asarray(ts))
        tst, to = te.batch_step(tparams, tst, torch.from_numpy(clip[i]),
                                torch.from_numpy(ts))
        np.testing.assert_array_equal(_np(tst.signals.roi_y),
                                      _np(jst.signals.roi_y))
        if i >= steps - 5:
            np.testing.assert_array_equal(_np(to.bpm), _np(jo.bpm))
    assert np.all(np.abs(_np(to.bpm)[:, 0] - 72) <= 6)
    np.testing.assert_array_equal(_np(to.models.face_detector.count),
                                  _np(jo.models.face_detector.count))
    nhwc = np.ascontiguousarray(clip[-1].transpose(0, 2, 3, 1))
    frames = torch.from_numpy(clip[-1])
    jf, _, jk = compose(jnp.asarray(nhwc), jo)
    # The port's compose of the reference's outputs: the renderer's
    # tolerance, packed vectors equal.
    tf, tp, tk = td.compose(frames, _to_port(jax.tree.map(np.asarray, jo)))
    assert tuple(tp.shape) == (S, 720, 640, 3) and tk.shape[0] == S
    assert_images_close(tf.numpy(), jf)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    # Each package's compose of its own outputs: the same frames, except
    # where a hand landmark or box lies one pixel apart (integer pixels of
    # f32 rects in another rounding, above); the segmenter's confidences
    # differ by a bf16 ulp at a few pixels (within the tolerance).
    own, _, _ = td.compose(frames, to)
    hands = [overlay.compose_overlay(
        torch.zeros((S, H, W, 3), dtype=torch.uint8),
        [(_t(d.bbox), _t(d.points), (255, 255, 255))],
        torch.full((S, 0, 6), float("nan")), [], None, 1.0)[..., 0] > 0
        for d in (to.models.hand_landmarker, jo.models.hand_landmarker)]
    moved = (hands[0] ^ hands[1]).numpy()
    d = np.abs(own.numpy().astype(np.int32) - np.asarray(jf).astype(np.int32))
    assert_images_close(np.where(moved[..., None], 0, d), np.zeros_like(d))
    assert moved.sum() <= 1e-2 * moved.size


def test_batch_step_lagged_matches_reference():
    """Windows of F = 4 frames a stream: ROI rings and raw timestamps equal
    after every window, raw samples within 1e-5 of themselves, BPM
    equal over the last windows."""
    je, te = _pair()
    jparams, tparams = _params(je)
    jst, tst = _tracked(je, te)
    step = jax.jit(je.batch_step_lagged)
    f_n, windows = 4, 18
    clip = _clip(f_n * windows).reshape(windows, f_n, S, 3, H, W)
    for i in range(windows):
        ts = ((np.arange(f_n) + i * f_n + 1) / 30.0).astype(np.float32)
        ts = np.repeat(ts[:, None], S, 1)
        jst, jo = step(jparams, jst, jnp.asarray(clip[i]), jnp.asarray(ts))
        tst, to = te.batch_step_lagged(tparams, tst,
                                       torch.from_numpy(clip[i]),
                                       torch.from_numpy(ts))
        for name in ("roi_y", "raw_x", "bpm_x"):
            np.testing.assert_array_equal(_np(getattr(tst.signals, name)),
                                          _np(getattr(jst.signals, name)),
                                          name)
        # Skin-weighted samples: a few upsampled confidences differ by a
        # bf16 ulp (``test_torch_segmenter``); the weighted means move by
        # about 1e-6 of themselves (K4's weighted tolerance is 1e-5).
        np.testing.assert_allclose(_np(tst.signals.raw_y),
                                   _np(jst.signals.raw_y), atol=0, rtol=1e-5,
                                   equal_nan=True)
        for name in ("face_rect", "hand_rects"):
            np.testing.assert_allclose(_np(getattr(tst.track, name)),
                                       _np(getattr(jst.track, name)),
                                       rtol=1e-3, atol=0.05, equal_nan=True)
        if i >= windows - 3:
            np.testing.assert_array_equal(_np(to.bpm), _np(jo.bpm))
    assert np.isfinite(_np(to.bpm)[:, 0]).all()
    assert tuple(to.models.face_detector.bbox.shape) == (S, 4, 4)


def test_batch_step_lagged_single_frame_is_batch_step():
    """F = 1: the lagged step is ``batch_step`` bit for bit."""
    te = Engine(_cfg(preset_configs()["multistream"], False, False),
                device="cpu")
    params = template_heads(te.params)
    a = b = tracked_state(te, H, W, torch.ones(S, dtype=torch.bool))
    for i, frames in enumerate(_clip(6)):
        ts = torch.full((S,), (i + 1) / 30.0)
        a, oa = te.batch_step(params, a, torch.from_numpy(frames), ts)
        b, ob = te.batch_step_lagged(params, b,
                                     torch.from_numpy(frames)[None], ts[None])
        for x, y in zip(list(a.signals) + list(a.track),
                        list(b.signals) + list(b.track)):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
        for name in ("bpm", "ptt", "rois", "proc_y", "spec_y"):
            torch.testing.assert_close(getattr(oa, name), getattr(ob, name),
                                       rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", sorted(preset_configs()))
def test_every_preset_builds_and_steps(name):
    """Each BASELINE preset at its measured settings (bf16, the fused
    kernels' plain versions on the CPU), 2 streams of 48x64: a plain step
    and a lagged step of 2 frames give outputs of the preset's shapes."""
    from bp_from_video_tpu_torch.config import preset_config
    te = Engine(preset_config(name, S, 48, 64), device="cpu")
    ns = te.config.signal.num_signals
    frames = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, S, 3, 48, 64), dtype=np.uint8))
    st, out = te.batch_step(te.params, te.init_state(), frames[0],
                            torch.full((S,), 1 / 30.0))
    st, lag = te.batch_step_lagged(te.params, st, frames,
                                   torch.tensor([[2 / 30.0] * S,
                                                 [3 / 30.0] * S]))
    for o in (out, lag):
        assert tuple(o.rois.shape) == (S, ns, 6)
        assert tuple(o.raw_y.shape) == (S, ns, te.config.signal
                                        .signal_max_samples)
        assert tuple(o.models.face_detector.bbox.shape) == (S, 4, 4)
    assert torch.isfinite(st.signals.raw_x[:, -3:]).all()
