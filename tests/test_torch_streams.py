"""The port's ``MultiStreamEngine`` (``parallel/streams.py``, one card)
against the reference package's with ``mesh=None``: ``run_clip``,
``run_clip_lagged`` (F = 4) and ``make_display_step`` on the same clip,
the same tracked start and the same weights (``convert.params_from_jax``),
at S = 2, 96x128, f32, a 32-sample signal ring.

The reference runs with ``use_pallas=False`` (its XLA crop and ROI paths;
these modules hold no kernel, and the kernels' parity is held by
``test_torch_engine`` and ``test_torch_multistream``), and so does the port
(its plain versions, CPU tensors).  Tolerances: PTT and ``curr_fs``
equal, NaN pattern included, on every frame; BPM equal from the frame on
which the ring holds ``SETTLED`` samples (over the first few samples the
periodogram is nearly flat and roundoff in another summation order picks
its peak: the two packages read 240 and 48 BPM from two samples; as in
``test_torch_engine``, which holds BPM once the ring is full); composed
images within ``test_torch_render.assert_images_close``, packed vectors
equal.

Helpers here (tiny configs in both packages, template heads, tracked
starts, engines built with them, video files written with
``cv2.VideoWriter``) are shared with ``test_torch_drivers``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu import config as jconfig
from bp_from_video_tpu.parallel import MultiStreamEngine as JMultiStream
from bp_from_video_tpu.render.drawer import Drawer as JDrawer
from bp_from_video_tpu_torch import config as tconfig
from bp_from_video_tpu_torch import convert
from bp_from_video_tpu_torch.models.runner import TrackState, map_leaves
from bp_from_video_tpu_torch.parallel import ClipOutputs, MultiStreamEngine
from bp_from_video_tpu_torch.render.drawer import Drawer
from chip_smoke import pulse_clip
from test_torch_multistream import _params as template_params
from test_torch_render import assert_images_close

S, H, W, T, F = 2, 96, 128, 40, 4
SETTLED = 10
NO_FILES = dict(face_detector_path=None, face_landmarker_path=None,
                hand_landmarker_path=None, person_segmenter_path=None,
                hand_lm_standin_path=None, palm_det_standin_path=None,
                seg_standin_path=None, use_pallas=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config(mod, **kw):
    """The JAX ``test_drivers.tiny_engine_config`` shape in package ``mod``
    (``jconfig`` or ``tconfig``): random-init stand-ins (no model files,
    no trained stand-ins), no kernels, a 32-sample ring."""
    return mod.EngineConfig(
        signal=mod.SignalConfig(signal_max_samples=32, peak_max_samples=8),
        inference=mod.InferenceConfig(**NO_FILES), **kw)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def lock_on(state, h: int, to):
    """``state`` (either package, leading [S] or none) with every stream
    tracking the clip's face box and hand boxes (``chip_smoke
    .tracked_state``'s rects); ``to`` turns numpy into the package's
    arrays."""
    k = h / 96.0
    tr = state.track
    lead = tuple(tr.face_tracking.shape)
    rects = dict(
        face_rect=np.array([64 * k, 40 * k, 56 * k, 56 * k, 0], np.float32),
        face_tracking=np.array(True),
        hand_rects=np.array([[30 * k, 72 * k, 40 * k, 40 * k, 0],
                             [98 * k, 72 * k, 40 * k, 40 * k, 0]],
                            np.float32),
        hand_tracking=np.ones(2, bool))
    return state._replace(track=tr._replace(**{
        n: to(np.array(np.broadcast_to(v, lead + v.shape)))
        for n, v in rects.items()}))


def locked(cls, params, h: int):
    """``cls`` (either package's ``MultiStreamEngine`` or ``Engine``) built
    as usual, then computing with ``params`` (the reference's, numpy;
    converted for the port) from a start tracking the clip's face and
    hands: how the parity tests reach engines that a driver builds
    inside."""
    port = cls.__module__.startswith("bp_from_video_tpu_torch")
    to = torch.from_numpy if port else jnp.asarray

    class Locked(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.params = (convert.params_from_jax(params, self.device)
                           if port else jax.tree.map(jnp.asarray, params))
            if hasattr(self, "engine"):
                self.engine.params = self.params

        if hasattr(cls, "init_states"):
            def init_states(self):
                return lock_on(super().init_states(), h, to)
        else:
            def init_state(self, *a):
                return lock_on(super().init_state(*a), h, to)
    return Locked


def write_video(path: str, frames_bgr: np.ndarray, fps: float = 30.0):
    """uint8 [T, H, W, 3] BGR -> an MJPG ``.avi`` (decoded alike by both
    packages: one OpenCV)."""
    import cv2
    wr = cv2.VideoWriter(path, cv2.VideoWriter.fourcc(*"MJPG"), fps,
                         (frames_bgr.shape[2], frames_bgr.shape[1]))
    assert wr.isOpened()
    for f in frames_bgr:
        wr.write(np.ascontiguousarray(f))
    wr.release()
    return path


def assert_clip_equal(got, want, settled=SETTLED):
    """ClipOutputs equal field for field, NaN pattern included; BPM from
    row ``settled`` on."""
    for f in ClipOutputs._fields:
        rows = slice(settled if f == "bpm" else 0, None)
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[rows],
                                      np.asarray(getattr(want, f))[rows],
                                      err_msg=f)


@pytest.fixture(scope="module")
def pair():
    """Both packages' multi-stream engines on the tiny config, the
    reference's params with template landmark heads (jnp) and the same
    params converted (``test_torch_multistream._params``), and both
    tracked starts."""
    jms = JMultiStream(tiny_config(jconfig, frame_height=H, frame_width=W,
                                   num_streams=S))
    tms = MultiStreamEngine(tiny_config(tconfig, frame_height=H,
                                        frame_width=W, num_streams=S),
                            device="cpu")
    jparams, tparams = template_params(jms)
    return (jms, tms, jparams, tparams,
            lock_on(jms.init_states(), H, jnp.asarray),
            lock_on(tms.init_states(), H, torch.from_numpy))


def _clip():
    """uint8 [T, S, 3, H, W] texture pulsing at 72 BPM, and timestamps."""
    clip = pulse_clip(T, S, H, W, split=60, seed=6, device="cpu").numpy()
    ts = np.repeat(((np.arange(T) + 1) / 30.0).astype(np.float32)[:, None],
                   S, 1)
    return clip, ts


def test_run_clip_matches_reference(pair):
    """``run_clip`` over 40 frames: PTT and ``curr_fs`` of every frame and
    the settled BPM equal to the reference's scan; outputs stacked on the
    device."""
    jms, tms, jparams, tparams, jst, tst = pair
    clip, ts = _clip()
    _, jout = jax.jit(jms.run_clip)(jparams, jst, jnp.asarray(clip),
                                    jnp.asarray(ts))
    _, tout = tms.run_clip(tparams, tst, torch.from_numpy(clip),
                           torch.from_numpy(ts))
    assert all(isinstance(a, torch.Tensor) for a in tout)
    assert tuple(tout.bpm.shape) == (T, S, 2)
    assert tuple(tout.ptt.shape) == (T, S, 1)
    assert tuple(tout.curr_fs.shape) == (T, S)
    assert_clip_equal(ClipOutputs(*(a.numpy() for a in tout)),
                      np_tree(jout))
    assert np.isfinite(tout.bpm[-1].numpy()).all()


def test_run_clip_lagged_matches_reference(pair):
    """``run_clip_lagged`` over 10 windows of F = 4 frames: the
    per-window outputs equal to the reference's scan, BPM from the first
    window on (the first window already holds 4 samples)."""
    jms, tms, jparams, tparams, jst, tst = pair
    clip, ts = _clip()
    clip = clip.reshape((T // F, F) + clip.shape[1:])
    ts = ts.reshape(T // F, F, S)
    _, jout = jax.jit(jms.run_clip_lagged)(jparams, jst, jnp.asarray(clip),
                                           jnp.asarray(ts))
    _, tout = tms.run_clip_lagged(tparams, tst, torch.from_numpy(clip),
                                  torch.from_numpy(ts))
    assert tuple(tout.bpm.shape) == (T // F, S, 2)
    assert_clip_equal(ClipOutputs(*(a.numpy() for a in tout)),
                      np_tree(jout), settled=0)
    assert np.isfinite(tout.bpm[-1].numpy()).all()


def test_make_display_step_matches_reference(pair):
    """``make_display_step`` for stream 1 over planar batches: the step's
    ROIs on every batch, and its BPM and PTT once settled, equal to the
    reference's display step; the displayed images and packed vector
    equal to the reference's compose (``_compose_fn``) of the same
    displayed outputs.  Host text (``device_text=False``): the reference
    places some device-text tick labels a column off its own ticks, a
    divergence ``test_torch_render`` holds apart.  (Each package's images
    of its own outputs differ where roundoff moves a landmark dot a
    pixel.)"""
    jms, tms, jparams, tparams, jst, tst = pair
    clip, ts = _clip()

    def host_text(cfg):
        return dataclasses.replace(cfg, draw=dataclasses.replace(
            cfg.draw, device_text=False))
    jd = JDrawer(host_text(jms.config), show=False)
    jstep = jms.make_display_step(jd._compose_fn, display_stream=1)
    tstep = tms.make_display_step(Drawer(host_text(tms.config), show=False,
                                         device="cpu"), display_stream=1)
    for i in range(SETTLED + 1):
        jst, jout, *_ = jstep(jparams, jst, jnp.asarray(clip[i]),
                              jnp.asarray(ts[i]))
        tst, tout, tf, tp, tk = tstep(tparams, tst, torch.from_numpy(clip[i]),
                                      torch.from_numpy(ts[i]))
        np.testing.assert_array_equal(tout.rois.numpy(), np.asarray(jout.rois))
    for f in ("bpm", "ptt"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                      np.asarray(getattr(jout, f)))
    assert tuple(tf.shape) == (H, W, 3) and tf.dtype == torch.uint8
    assert tuple(tp.shape) == (720, 640, 3)
    frame = np.ascontiguousarray(clip[SETTLED][1].transpose(1, 2, 0))
    jf, jp, jk = jax.jit(jd._compose_fn)(
        jnp.asarray(frame), map_leaves(lambda a: jnp.asarray(a[1].numpy()),
                                       tout))
    assert_images_close(tf.numpy(), jf)
    assert_images_close(tp.numpy(), jp)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


def test_default_device_is_cuda():
    """``device=None`` means CUDA: without a card it raises."""
    cfg = tiny_config(tconfig, frame_height=H, frame_width=W, num_streams=S)
    if torch.cuda.is_available():
        assert MultiStreamEngine(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            MultiStreamEngine(cfg)


def test_init_states_and_shard_identities():
    """``init_states`` is ``Engine.init_state(S)``; the ``shard_*``
    methods are identities on one device, ``shard_frames`` turning numpy
    into a tensor on the engine's device."""
    cfg = tiny_config(tconfig, frame_height=H, frame_width=W, num_streams=S)
    ms = MultiStreamEngine(cfg, device="cpu")
    st = ms.init_states()
    assert tuple(st.signals.raw_x.shape) == (S, 32)
    assert isinstance(st.track, TrackState)
    assert ms.shard_state(st) is st and ms.shard_params(ms.params) is ms.params
    frames = np.zeros((S, 3, H, W), np.uint8)
    t = ms.shard_frames(frames)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    assert ms.shard_frames(t) is t
