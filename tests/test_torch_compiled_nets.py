"""The port's runner and engine with compiled TFLite detectors and a
compiled segmenter, against the reference package on the same frames and
weights; and the numpy-only ``twin_graphs`` builders against the parse of
the TensorFlow-built twins.

Nets: the standalone face detector is a faithful BlazeFace-shaped twin
built here (``build_face_detector``: the palm twin's architecture at
128x128 with six keypoints; ``hot`` adds a constant to one anchor's
logit and box so that it detects); the face landmarker bundle holds that
detector and the reduced face mesh of ``test_torch_tflite.py``; the hand
bundle is ``tflite_fixtures.build_faithful_hand_task_bundle`` (palm
detector and hand landmarker, random weights); the segmenter
``build_faithful_segmenter``.  The reference runs its Pallas kernels in
interpret mode where ``use_pallas`` is on, the port the plain versions of
its kernels (CPU tensors); the port computes with the reference's params
(``convert.params_from_jax``).
"""

import dataclasses
import functools
import io
import os
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tflite_fixtures as fx  # noqa: E402
from test_torch_engine import H, S, W, _np, _pulse_clip  # noqa: E402
from test_torch_graphnet import _template  # noqa: E402
from test_torch_segmenter import _hold_conf  # noqa: E402
from test_torch_streams import SETTLED  # noqa: E402
from test_torch_tflite import _mesh_blob, build_face_mesh  # noqa: E402

from bp_from_video_tpu import config as jconfig  # noqa: E402
from bp_from_video_tpu.models import runner as jrunner  # noqa: E402
from bp_from_video_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from bp_from_video_tpu_torch import config as tconfig  # noqa: E402
from bp_from_video_tpu_torch import convert  # noqa: E402
from bp_from_video_tpu_torch.models import runner as trunner  # noqa: E402
from bp_from_video_tpu_torch.models import tflite_compiler as ttc  # noqa: E402
from bp_from_video_tpu_torch.models import twin_graphs  # noqa: E402
from bp_from_video_tpu_torch.models.runner import TrackState  # noqa: E402
from bp_from_video_tpu_torch.runtime.engine import Engine  # noqa: E402

# The anchor the ``hot`` face detector fires on: stride-8 cell (8, 8) of
# the 16x16 grid, anchor 0 (center (8.5/16, 8.5/16) of the 128 input), a
# 40-pixel box with level eyes.
FACE_HOT = (8 * 16 + 8) * 2


def build_face_detector(hot: bool = False) -> bytes:
    """BlazeFace-shaped 128x128 twin of ``fx.build_faithful_palm_detector``:
    the same dw-separable hard-swish trunk to strides 8 and 16 and
    two-scale 1x1 heads, reshaped and concatenated to regressors
    [1, 896, 16] and logits [1, 896, 1] (six keypoints)."""
    import tensorflow as tf

    rng = np.random.RandomState(109)
    box, g8, g16 = 16, 16, 8
    a = g8 * g8 * 2 + g16 * g16 * 6
    stem_k = tf.constant(fx._he(rng, 3, 3, 3, 16))
    trunk8 = fx._make_trunk_ops(tf, rng, [16, (24, 2), (24, 1), (48, 2)])
    trunk16 = fx._make_trunk_ops(tf, rng, [48, (64, 2)])
    h8_reg = tf.constant(fx._he(rng, 1, 1, 48, 2 * box))
    h16_reg = tf.constant(fx._he(rng, 1, 1, 64, 6 * box))
    h8_log = (tf.constant(fx._he(rng, 1, 1, 48, 2)),
              tf.constant(np.float32(-3.0)))
    h16_log = (tf.constant(fx._he(rng, 1, 1, 64, 6)),
               tf.constant(np.float32(-3.0)))
    reg_hot = np.zeros((1, a, box), np.float32)
    reg_hot[0, FACE_HOT, 2:8] = (40.0, 40.0, -10.0, -5.0, 10.0, -5.0)
    log_hot = np.zeros((1, a, 1), np.float32)
    log_hot[0, FACE_HOT] = 12.0

    class M(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([1, 128, 128, 3],
                                                    tf.float32)])
        def __call__(self, x):
            y = fx._hswish(tf, tf.nn.conv2d(x, stem_k, 2, "SAME"))
            f8 = fx._run_trunk(tf, y, trunk8)
            f16 = fx._run_trunk(tf, f8, trunk16)
            reg = tf.concat([
                tf.reshape(tf.nn.conv2d(f8, h8_reg, 1, "SAME"),
                           [1, g8 * g8 * 2, box]),
                tf.reshape(tf.nn.conv2d(f16, h16_reg, 1, "SAME"),
                           [1, g16 * g16 * 6, box])], axis=1)
            log = tf.concat([
                tf.reshape(tf.nn.conv2d(f8, h8_log[0], 1, "SAME")
                           + h8_log[1], [1, g8 * g8 * 2, 1]),
                tf.reshape(tf.nn.conv2d(f16, h16_log[0], 1, "SAME")
                           + h16_log[1], [1, g16 * g16 * 6, 1])], axis=1)
            if hot:
                reg, log = reg + tf.constant(reg_hot), log + tf.constant(
                    log_hot)
            return reg, log

    m = M()
    return fx._faithful_convert(m, m.__call__)


@functools.lru_cache(maxsize=None)
def _blobs(template: bool = False) -> dict:
    """{asset name: bytes} of every compiled net (module-cached: the
    converter takes seconds a net)."""
    face_det = build_face_detector(hot=True)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("face_detector.tflite", face_det)
        z.writestr("face_landmarks_detector.tflite",
                   build_face_mesh(template=_template()) if template
                   else _mesh_blob())
    return {"face_detector.tflite": face_det,
            "face_landmarker.task": buf.getvalue(),
            "hand_landmarker.task": fx.build_faithful_hand_task_bundle(),
            "selfie_multiclass.tflite": fx.build_faithful_segmenter()}


def _paths(tmp_path, template=False) -> dict:
    names = dict(face_detector_path="face_detector.tflite",
                 face_landmarker_path="face_landmarker.task",
                 hand_landmarker_path="hand_landmarker.task",
                 person_segmenter_path="selfie_multiclass.tflite")
    out = {}
    for key, name in names.items():
        path = tmp_path / name
        path.write_bytes(_blobs(template)[name])
        out[key] = str(path)
    return out


FUSED = dict(use_pallas=True, fused_stem=True, fused_trunk=True)
CASES = {
    "fused": FUSED,
    "plain": dict(use_pallas=False),
    # The detectors, the segmenter and the hand net rewritten by both
    # passes; K1 packs the crops of the packed-input landmark graphs.
    "fuse_dw_pw-pack_s2d": dict(use_pallas=True, fuse_dw_pw=True,
                                pack_s2d=32),
}


def _infer(tmp_path, case, template=False) -> dict:
    return dict(face_detector=True, face_landmarker=True,
                hand_landmarker=True, person_segmenter=True,
                hand_lm_standin_path=None, palm_det_standin_path=None,
                seg_standin_path=None, **_paths(tmp_path, template),
                **CASES[case])


def _interp(kw):
    return dict(kw, pallas_interpret=True) if kw.get("use_pallas") else kw


def _start(s, hands_on=(True, False)):
    """Faces untracked (the face detectors run); stream 0's hands tracked
    on the frame's lower half, stream 1's lost (the palm detector runs)."""
    on = np.array(hands_on[:s])
    return dict(
        face_rect=np.tile(np.float32([[W / 2, H / 2, W, H, 0]]), (s, 1)),
        face_tracking=np.zeros(s, bool),
        hand_rects=np.tile(np.float32([[[30, 72, 40, 40, 0],
                                        [98, 72, 40, 40, 0]]]), (s, 1, 1)),
        hand_tracking=np.stack([on, on], 1))


def _hold_results(tres, jres):
    for det in ("face_detector", "face_landmarker", "hand_landmarker"):
        t, j = getattr(tres, det), getattr(jres, det)
        np.testing.assert_array_equal(_np(t.count), _np(j.count), det)
        # Integer pixels (clip + floor, or rounded boxes): a value within
        # roundoff of an integer may land one pixel apart.
        np.testing.assert_allclose(_np(t.points), _np(j.points), atol=1,
                                   rtol=0, equal_nan=True, err_msg=det)
        np.testing.assert_allclose(_np(t.bbox), _np(j.bbox), atol=1,
                                   rtol=0, equal_nan=True, err_msg=det)
    _hold_conf(tres.seg_conf.numpy(), np.asarray(jres.seg_conf))
    tc, jc = tres.seg_class.numpy(), np.asarray(jres.seg_class)
    assert (tc != jc).mean() < 1e-3


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_batch_matches_reference(tmp_path, case):
    """Three ``predict_batch`` steps of both packages from ``_start``: the
    face detector fires on its hot anchor in both, the face mesh tracks
    it, the hand net runs on stream 0's hands and the palm detector for
    stream 1; every compiled net ran.  Detections, landmarks and tracking
    state within roundoff, the segmenter's confidences within one bf16
    ulp of the upsample."""
    infer = _infer(tmp_path, case)
    jr = jrunner.InferenceRunner(jconfig.InferenceConfig(**_interp(infer)),
                                 H, W)
    tr = trunner.InferenceRunner(tconfig.InferenceConfig(**infer), H, W,
                                 device="cpu")
    keys = ("face_det", "flm_det", "flm_lm", "palm_det", "hand_lm", "seg")
    assert tr.real_weights == jr.real_weights == dict.fromkeys(keys, True)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jr.params))
    for key in keys:
        assert set(params[key]) == set(tr.params[key]), key
    track = _start(S)
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                       jr.init_state())._replace(
        **{k: jnp.asarray(v) for k, v in track.items()})
    tst = tr.init_state(S)._replace(
        **{k: torch.from_numpy(v) for k, v in track.items()})
    predict = jax.jit(jr.predict_batch)
    frames = np.random.default_rng(2).integers(0, 256, (3, S, 3, H, W),
                                               dtype=np.uint8)
    for i, f in enumerate(frames):
        with pltpu.force_tpu_interpret_mode():
            jst, jres = predict(jr.params, jst, jnp.asarray(f))
        tst, tres = tr.predict_batch(params, tst, torch.from_numpy(f))
        for name in ("face_tracking", "hand_tracking", "face_det_age",
                     "hand_det_age"):
            np.testing.assert_array_equal(_np(getattr(tst, name)),
                                          _np(getattr(jst, name)), name)
        np.testing.assert_allclose(_np(tst.face_rect), _np(jst.face_rect),
                                   rtol=1e-3, atol=0.05)
        np.testing.assert_allclose(_np(tst.hand_rects), _np(jst.hand_rects),
                                   rtol=1e-3, atol=0.05, equal_nan=True)
        _hold_results(tres, jres)
        if i == 0:
            # The hot anchor: one face a frame, from both face detectors.
            assert _np(tres.face_detector.count).tolist() == [1] * S
            assert bool(tst.face_tracking.all())
        tst = TrackState(*[torch.from_numpy(np.array(x)) for x in jst])
    assert set(tr.graph_calls) == set(keys)


def test_batch_step_clip_matches_reference(tmp_path):
    """``Engine.batch_step`` over a pulsing clip with every net compiled
    (the face mesh with a template head), the tracked rects pinned before
    each step, K4 weighted by the compiled segmenter's skin confidence:
    ROIs within a pixel, BPM equal from row ``SETTLED``, PTT within one
    sample period."""
    infer = _infer(tmp_path, "plain", template=True)
    signal = dict(signal_max_samples=16, peak_max_samples=4)
    kw = dict(frame_height=H, frame_width=W, num_streams=S)
    je = JEngine(jconfig.EngineConfig(
        signal=jconfig.SignalConfig(**signal),
        inference=jconfig.InferenceConfig(**infer), **kw))
    te = Engine(tconfig.EngineConfig(
        signal=tconfig.SignalConfig(**signal),
        inference=tconfig.InferenceConfig(**infer), **kw), device="cpu")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, je.params))
    track = _start(S, (True, True))
    track.update(face_rect=np.tile(np.float32([[64, 40, 56, 56, 0]]),
                                   (S, 1)), face_tracking=np.ones(S, bool))
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                       je.init_state())
    jpin = jst.track._replace(**{k: jnp.asarray(v)
                                 for k, v in track.items()})
    tst = te.init_state()
    tpin = tst.track._replace(**{k: torch.from_numpy(v)
                                 for k, v in track.items()})
    step = jax.jit(je.batch_step)
    steps = 20
    clip = _pulse_clip(steps)
    rows = []
    for i in range(steps):
        ts = np.full((S,), (i + 1) / 30.0, np.float32)
        jst, jo = step(je.params, jst._replace(track=jpin),
                       jnp.asarray(clip[i]), jnp.asarray(ts))
        tst, to = te.batch_step(tparams, tst._replace(track=tpin),
                                torch.from_numpy(clip[i]),
                                torch.from_numpy(ts))
        np.testing.assert_allclose(_np(to.rois), _np(jo.rois), atol=1,
                                   rtol=0)
        rows.append((_np(to.bpm), _np(jo.bpm), _np(to.ptt), _np(jo.ptt)))
    tb, jb, tp, jp = (np.stack(r) for r in zip(*rows))
    np.testing.assert_array_equal(tb[SETTLED:], jb[SETTLED:])
    assert np.all((np.abs(tp - jp) <= 1000.0 / 30.0)
                  | (np.isnan(tp) & np.isnan(jp)))
    assert np.isfinite(tb[-1]).all()
    assert set(te.runner.graph_calls) == {"face_det", "flm_lm", "hand_lm",
                                          "seg"}


def test_faithful_bundle_full_predict_path(tmp_path):
    """The reference's drop-in contract (``test_faithful_twins.py``) on
    the port: the faithful hand bundle and segmenter resolve from their
    paths, compile in construction and run through ``predict``; the six
    confidences sum to 1 within 2e-2 at every pixel."""
    task = tmp_path / "hand_landmarker.task"
    task.write_bytes(fx.build_faithful_hand_task_bundle())
    seg = tmp_path / "selfie_multiclass_256x256.tflite"
    seg.write_bytes(fx.build_faithful_segmenter())
    cfg = tconfig.InferenceConfig(
        face_detector=False, face_landmarker=False, hand_landmarker=True,
        person_segmenter=True, hand_landmarker_path=str(task),
        person_segmenter_path=str(seg))
    runner = trunner.InferenceRunner(cfg, 192, 192, device="cpu")
    assert runner.real_weights == {"palm_det": True, "hand_lm": True,
                                   "seg": True}
    rng = np.random.RandomState(43)
    frame = torch.from_numpy(rng.randint(0, 255, (192, 192, 3)).astype(
        np.uint8))
    state = runner.init_state(1)
    state = trunner.map_leaves(lambda x: x[0], state)
    state, res = runner.predict(runner.params, state, frame)
    assert bool(res.seg_valid)
    conf = res.seg_conf.to(torch.float64).numpy()
    assert conf.shape == (6, 192, 192)
    np.testing.assert_allclose(conf.sum(axis=0), 1.0, atol=2e-2)
    assert int(res.hand_landmarker.count) >= 0
    state, res2 = runner.predict(runner.params, state, frame)
    assert tuple(res2.seg_conf.shape) == (6, 192, 192)
    assert runner.graph_calls["palm_det"] == 2
    assert runner.graph_calls["seg"] == 2


def _same_architecture(got, want):
    """Two graphs equal op for op: opcodes, options, tensor shapes and
    dtypes, which inputs are constants; activations wired one to one (the
    converter shares identical constants between ops, so constants are
    held by shape only); graph outputs as a set."""
    assert len(got.ops) == len(want.ops)
    fwd: dict[int, int] = {}

    def same(a: int, b: int) -> bool:
        ta, tb = got.tensors[a], want.tensors[b]
        ok = (tuple(ta.shape) == tuple(tb.shape)
              and np.dtype(ta.dtype) == np.dtype(tb.dtype)
              and (ta.data is None) == (tb.data is None))
        return ok and (ta.data is not None or fwd.setdefault(a, b) == b)

    assert same(got.inputs[0], want.inputs[0])
    for i, (a, b) in enumerate(zip(got.ops, want.ops)):
        assert (a.opcode, a.options) == (b.opcode, b.options), i
        assert len(a.inputs) == len(b.inputs), i
        assert all(map(same, a.inputs + a.outputs, b.inputs + b.outputs)), (
            i, a.opcode)
    assert len(set(fwd.values())) == len(fwd)
    assert {fwd[t] for t in got.outputs} == set(want.outputs)


@pytest.mark.parametrize("name", ["palm", "face", "face-hot", "segmenter"])
def test_twin_graphs_match_the_parsed_models(name):
    """``detector_graph`` at (192, (2, 6), 7) is the parsed palm twin, at
    (128, (2, 6), 6) the parsed face twin of ``build_face_detector`` (with
    ``hot_anchor``, its ``hot`` twin); ``segmenter_graph`` the parsed
    segmenter twin; each compiles and runs to outputs of the parsed
    model's shapes."""
    if name == "palm":
        got = twin_graphs.detector_graph(3, 192, (2, 6), 7)
        want = ttc.parse_tflite(fx.build_faithful_palm_detector())
    elif name == "face":
        got = twin_graphs.detector_graph(3, 128, (2, 6), 6)
        want = ttc.parse_tflite(build_face_detector())
    elif name == "face-hot":
        got = twin_graphs.detector_graph(3, 128, (2, 6), 6,
                                         hot_anchor=FACE_HOT)
        want = ttc.parse_tflite(_blobs()["face_detector.tflite"])
    else:
        got = twin_graphs.segmenter_graph(3, 256, 6)
        want = ttc.parse_tflite(fx.build_faithful_segmenter())
    _same_architecture(got, want)
    fn, p = ttc.compile_graph(got, layout="NCHW", planar_inputs=True,
                              batch_flexible=True, device="cpu")
    n, h, w, c = fn.input_shapes[0]
    outs = fn(p, torch.rand((2, c, h, w), generator=torch.Generator()
                            .manual_seed(0)))
    assert [tuple(o.shape[1:]) for o in outs] == [
        tuple(got.tensors[t].shape[1:]) for t in got.outputs]
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    if name in ("palm", "face"):
        # The logits' -3 bias keeps random-weight detections sparse.
        assert float(torch.sigmoid(outs[0]).max()) < 0.5
    elif name == "face-hot":
        score = torch.sigmoid(outs[0][..., 0])
        assert bool((score.argmax(1) == FACE_HOT).all())
        assert float(score[:, FACE_HOT].min()) > 0.99


def test_graphs_keyword_takes_every_compiled_net():
    """``graphs`` hands the runner a parsed graph for each of the six
    nets: each compiles, runs and is counted, and ``real_weights`` says
    so."""
    from bp_from_video_tpu_torch.models.mesh_graph import face_mesh_graph
    graphs = {"face_det": twin_graphs.detector_graph(1, 128, (2, 6), 6),
              "flm_det": twin_graphs.detector_graph(2, 128, (2, 6), 6),
              "flm_lm": face_mesh_graph(3, 64, ((16, 8), (32, 16),
                                                (64, 32))),
              "palm_det": twin_graphs.detector_graph(4, 192, (2, 6), 7),
              "hand_lm": ttc.parse_tflite(fx.build_faithful_hand_landmarker()),
              "seg": twin_graphs.segmenter_graph(5, 256, 6)}
    cfg = tconfig.InferenceConfig(face_detector=True, person_segmenter=True,
                                  **FUSED)
    tr = trunner.InferenceRunner(cfg, H, W, device="cpu", graphs=graphs)
    assert tr.real_weights == dict.fromkeys(graphs, True)
    st = tr.init_state(S)
    frames = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (S, 3, H, W), dtype=np.uint8))
    _, res = tr.predict_batch(tr.params, st, frames)
    assert dict(tr.graph_calls) == dict.fromkeys(graphs, 1)
    assert tuple(res.seg_conf.shape) == (S, 6, H, W)
    assert tuple(res.face_detector.bbox.shape) == (S, 4, 4)
    with pytest.raises(ValueError, match="not enabled"):
        trunner.InferenceRunner(dataclasses.replace(cfg,
                                                    person_segmenter=False),
                                H, W, device="cpu",
                                graphs={"seg": graphs["seg"]})
