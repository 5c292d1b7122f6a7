"""The port's runner and engine with a compiled TFLite face-landmark graph,
and with the fused stem alone (kernel K2's path), against the reference
package on the same frames and weights.

The face net is the TensorFlow-built face mesh of reduced size from
``test_torch_tflite.py``, written to a temporary ``.task`` bundle that both
packages resolve through ``asset_dir``.  The reference runs its Pallas
kernels in interpret mode; the port runs the plain versions of its kernels
(CPU tensors).  Weights are the reference runner's params converted with
``convert.params_from_jax``.
"""

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
from test_torch_engine import (FUSED, H, S, W, _frames, _jstate,  # noqa: E402
                               _np, _pulse_clip, _template_heads)
from test_torch_tflite import (MESH_LANDMARKS, MESH_SIZE,  # noqa: E402
                               build_face_mesh)

from bp_from_video_tpu.config import EngineConfig as JEngineConfig  # noqa: E402
from bp_from_video_tpu.config import InferenceConfig as JInferenceConfig  # noqa: E402
from bp_from_video_tpu.config import SignalConfig as JSignalConfig  # noqa: E402
from bp_from_video_tpu.runtime.engine import Engine as JEngine  # noqa: E402
from bp_from_video_tpu_torch import convert  # noqa: E402
from bp_from_video_tpu_torch.config import (EngineConfig,  # noqa: E402
                                            InferenceConfig, SignalConfig)
from bp_from_video_tpu_torch.models import tflite_compiler as ttc  # noqa: E402
from bp_from_video_tpu_torch.models.runner import TrackState  # noqa: E402
from bp_from_video_tpu_torch.runtime.engine import Engine  # noqa: E402

STEM_ONLY = dict(FUSED, fused_trunk=False)
# fused_bn_min_hw=24 fuses only the mesh's first stage (32x32 at this size),
# like the default gate on the full-size net; 0 fuses all three.
CASES = {
    "graph-fused": (True, dict(FUSED, fused_bn_min_hw=24)),
    "graph-fused-all-stages": (True, dict(FUSED, fused_bn_min_hw=0)),
    "graph-stem-only": (True, STEM_ONLY),
    "graph-plain": (True, dict(FUSED, use_pallas=False)),
    "standin-stem-only": (False, STEM_ONLY),
}


def _template() -> np.ndarray:
    """Fixed face landmarks in crop pixels: a grid over the middle 2/3 of
    the crop with the eye corners level (as the stand-in template heads of
    ``test_torch_engine.py``)."""
    rng = np.random.default_rng(11)
    n = MESH_LANDMARKS
    pts = np.stack([rng.uniform(1 / 6, 5 / 6, n), rng.uniform(1 / 6, 5 / 6, n),
                    np.full(n, 0.5)], -1)
    pts[-2, :2], pts[-1, :2] = (1 / 6, 1 / 6), (5 / 6, 5 / 6)
    for i, xy in {33: (0.3, 0.4), 263: (0.7, 0.4), 151: (0.5, 0.3)}.items():
        pts[i, :2] = xy
    return pts * MESH_SIZE


@functools.lru_cache(maxsize=None)
def _bundle(template: bool) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("face_landmarks_detector.tflite", build_face_mesh(
            template=_template() if template else None))
    return buf.getvalue()


def _pair(tmp_path, graph: bool, infer: dict, signal=None, template=False):
    """(reference engine, port engine) for one configuration; with
    ``graph`` the face landmark net is the compiled bundle."""
    signal = signal or {}
    if graph:
        os.makedirs(tmp_path / "models", exist_ok=True)
        (tmp_path / "models" / "face_landmarker.task").write_bytes(
            _bundle(template))
    jkw = dict(infer)
    if jkw.get("use_pallas"):
        jkw["pallas_interpret"] = True
    je = JEngine(JEngineConfig(signal=JSignalConfig(**signal),
                               inference=JInferenceConfig(**jkw),
                               frame_height=H, frame_width=W,
                               num_streams=S), asset_dir=str(tmp_path))
    te = Engine(EngineConfig(signal=SignalConfig(**signal),
                             inference=InferenceConfig(**infer),
                             frame_height=H, frame_width=W, num_streams=S),
                asset_dir=str(tmp_path), device="cpu")
    assert te.runner.real_weights["flm_lm"] == graph
    assert je.runner.real_weights["flm_lm"] == graph
    return je, te


def _eq_params(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _eq_params(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _eq_params(u, v, f"{path}/{i}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_batch_matches_reference(tmp_path, case):
    graph, infer = CASES[case]
    je, te = _pair(tmp_path, graph, infer)
    params = convert.params_from_jax(jax.tree.map(np.asarray, je.params))
    # The reference's params carry across key for key and equal what the
    # port builds itself from the same bundle and seeds.
    _eq_params(params, te.params)
    if graph and infer.get("use_pallas"):
        assert "__stem__:w" in params["flm_lm"]
        assert ("__stem_wmat__" in params["flm_lm"]) == infer["fused_trunk"]
        ops = [op.opcode for op in te.runner._graph_fns["flm_lm"].graph.ops]
        want = {24: 1, 0: 3}.get(infer["fused_bn_min_hw"], 0) \
            if infer["fused_trunk"] else 0
        assert ops.count("PALLAS_BN_CHAIN") == want
    jstate = _jstate(je).track
    tstate = te.init_state().track
    predict = jax.jit(je.runner.predict_batch)
    for frames in _frames(1, 3):
        with pltpu.force_tpu_interpret_mode():
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
        # The compiled net reports a face; a random stand-in need not.
        assert not graph or _np(tres.face_landmarker.count).sum() > 0
        # Feed both the reference's state, so every step checks one step.
        jstate = jst
        tstate = TrackState(*[torch.from_numpy(np.array(x)) for x in jst])


def _template_hand_heads(params):
    """Hand heads that put every landmark at a fixed place in its crop
    (wrist low, middle-finger knuckle high) and report presence."""
    rng = np.random.default_rng(12)
    pts = np.stack([rng.uniform(0.25, 0.75, 21), rng.uniform(0.3, 0.8, 21),
                    np.full(21, 0.5)], -1)
    pts[-2, :2], pts[-1, :2] = (0.25, 0.3), (0.75, 0.8)
    pts[0, :2], pts[9, :2] = (0.5, 0.8), (0.5, 0.3)
    p = params["hand_lm"]
    p["head_lm"]["w"] = np.zeros_like(p["head_lm"]["w"])
    p["head_lm"]["b"] = np.log(pts.reshape(-1) / (1 - pts.reshape(-1))
                               ).astype(p["head_lm"]["b"].dtype)
    p["head_presence"]["w"] = np.zeros_like(p["head_presence"]["w"])
    p["head_presence"]["b"] = np.full_like(p["head_presence"]["b"], 8.0)
    return params


@pytest.mark.parametrize("case", ["graph-fused", "graph-stem-only",
                                  "standin-stem-only"])
def test_batch_step_clip_matches_reference(tmp_path, case):
    """Engine.batch_step over a pulsing clip that fills a 16-sample ring
    (short: every reference step runs its Pallas kernels in interpret
    mode, seconds a step): BPM and PTT finite and equal to the
    reference's."""
    graph, infer = CASES[case]
    signal = dict(signal_max_samples=16, peak_max_samples=4)
    je, te = _pair(tmp_path, graph, infer, signal, template=True)
    jparams = jax.tree.map(np.array, je.params)
    # Template heads: the tracking rects hold still, so the clip's ROIs and
    # samples do not depend on roundoff in the nets.  The compiled face net
    # carries its template in the bundle.
    jparams = (_template_hand_heads(jparams) if graph
               else _template_heads(jparams))
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
    steps = 20
    clip = _pulse_clip(steps)
    for i in range(steps):
        ts = np.full((S,), (i + 1) / 30.0, np.float32)
        with pltpu.force_tpu_interpret_mode():
            jst, jo = step(jparams, jst, jnp.asarray(clip[i]),
                           jnp.asarray(ts))
        tst, to = te.batch_step(tparams, tst, torch.from_numpy(clip[i]),
                                torch.from_numpy(ts))
        np.testing.assert_array_equal(_np(to.rois), _np(jo.rois))
        if i >= steps - 4:
            np.testing.assert_array_equal(_np(to.bpm), _np(jo.bpm))
            np.testing.assert_array_equal(_np(to.ptt), _np(jo.ptt))
    assert np.isfinite(_np(to.bpm)).all() and np.isfinite(_np(to.ptt)).all()
    assert bool(tst.track.face_tracking.all())
    assert bool(tst.track.hand_tracking.all())
    np.testing.assert_array_equal(_np(to.raw_y), _np(jo.raw_y))


def test_runner_takes_a_parsed_graph_for_a_landmark_key(tmp_path):
    """``graphs={"flm_lm": Graph}`` equals resolving the same model from
    its bundle, and a key whose model is off is refused."""
    graph, infer = CASES["graph-fused"]
    _, te = _pair(tmp_path, graph, infer)
    cfg = te.config
    parsed = ttc.parse_tflite(build_face_mesh())
    te2 = Engine(cfg, device="cpu", graphs={"flm_lm": parsed})
    _eq_params(te2.params, te.params)
    st = te.init_state().track
    frames = torch.from_numpy(_frames(2, 1)[0])
    a = te.runner.predict_batch(te.params, st, frames)[1]
    b = te2.runner.predict_batch(te2.params, st, frames)[1]
    assert torch.allclose(a.face_landmarker.points,
                          b.face_landmarker.points, equal_nan=True)
    with pytest.raises(ValueError, match="not enabled"):
        Engine(EngineConfig(inference=InferenceConfig(
            **dict(FUSED, hand_landmarker=False)), frame_height=H,
            frame_width=W), device="cpu", graphs={"hand_lm": parsed})


@pytest.mark.parametrize("fused_trunk", [True, False])
def test_float_frames_run_the_stems_as_plain_convs(fused_trunk):
    """Float frames get no packed crops: a stand-in runs whole as plain
    convolutions and a compiled graph's split-off stem as a plain conv in
    front of it — the same landmarks as from the uint8 frames, within a
    pixel (crops resampled and rounded in another order)."""
    from bp_from_video_tpu_torch.models.mesh_graph import face_mesh_graph
    cfg = EngineConfig(inference=InferenceConfig(
        **dict(FUSED, fused_trunk=fused_trunk, fused_bn_min_hw=0)),
        frame_height=H, frame_width=W, num_streams=S)
    te = Engine(cfg, device="cpu", graphs={"flm_lm": face_mesh_graph(
        3, MESH_SIZE, ((16, 8), (32, 16), (64, 32)))})
    st = te.init_state().track
    st = st._replace(
        face_rect=torch.tensor([[64., 40, 56, 56, 0]] * S),
        face_tracking=torch.ones(S, dtype=torch.bool),
        hand_rects=torch.tensor([[[30., 72, 40, 40, 0],
                                  [98, 72, 40, 40, 0]]] * S),
        hand_tracking=torch.ones((S, 2), dtype=torch.bool))
    frames = torch.from_numpy(_frames(4, 1)[0])
    _, a = te.runner.predict_batch(te.params, st, frames)
    _, b = te.runner.predict_batch(te.params, st, frames.to(torch.float32))
    assert int(a.face_landmarker.count.sum()) == S
    for det in ("face_landmarker", "hand_landmarker"):
        assert torch.equal(getattr(a, det).count, getattr(b, det).count)
        np.testing.assert_allclose(_np(getattr(a, det).points),
                                   _np(getattr(b, det).points), atol=1,
                                   rtol=0, equal_nan=True)
