"""The packed path of the port's runner (``pack_s2d`` with ``fuse_dw_pw``)
against the reference package: stand-in landmark nets fed K1's packed
crops run their packed stem twin ``stem_p``; a compiled face mesh is
compiled to take its crop packed (``packed_inputs``); ``hybrid``'s shear
sub-batch packs its crops as K1 does; the per-crop ``exact`` path packs
its plain crops in the graph; and with the fused stem on, the fused stem
keeps precedence.  K1 runs its plain version here, the reference's Pallas
kernels run in interpret mode.  Presence is forced open (random nets), so
the landmarks of every crop are compared: within 1 px (integer pixels
from f32 coordinates summed in another order), a mean below 0.05 px.
"""

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
from test_torch_streams import NO_FILES  # noqa: E402
from test_torch_tflite import _mesh_blob  # noqa: E402

from bp_from_video_tpu import config as jconfig  # noqa: E402
from bp_from_video_tpu.models import runner as jrunner  # noqa: E402
from bp_from_video_tpu_torch import config as tconfig  # noqa: E402
from bp_from_video_tpu_torch import convert  # noqa: E402
from bp_from_video_tpu_torch.models import blaze  # noqa: E402
from bp_from_video_tpu_torch.models import runner as trunner  # noqa: E402

RH = RW = 128
PACKED = dict(use_pallas=True, fused_stem=False, fused_trunk=False,
              fuse_dw_pw=True, pack_s2d=16)
# (config, face net a compiled mesh, tilts of the streams' face rects)
CASES = {
    "standins-cover": (PACKED, False, (0.0, 8.0)),
    "standins-hybrid-subbatch": (dict(PACKED, rotation_mode="hybrid"),
                                 False, (0.0, 30.0)),
    "standins-exact": (dict(PACKED, rotation_mode="exact"), False,
                       (0.0, 25.0)),
    "standins-fused-stem": (dict(PACKED, fused_stem=True, fused_trunk=True),
                            False, (0.0, 8.0)),
    "mesh-cover": (PACKED, True, (0.0, 8.0)),
    "mesh-hybrid-subbatch": (dict(PACKED, rotation_mode="hybrid"), True,
                             (0.0, 30.0)),
    "mesh-fused-stem": (dict(PACKED, fused_stem=True, fused_trunk=True,
                             fused_bn_min_hw=0), True, (0.0, 8.0)),
}


def _bundle(tmp_path) -> str:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("face_landmarks_detector.tflite", _mesh_blob())
    path = tmp_path / "face_landmarker.task"
    path.write_bytes(buf.getvalue())
    return str(path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_runner_matches_reference(monkeypatch, tmp_path, case):
    kw, mesh, tilts = CASES[case]
    monkeypatch.setattr(jrunner, "PRESENCE_THRESHOLD", -1e9)
    monkeypatch.setattr(trunner, "PRESENCE_THRESHOLD", -1e9)
    common = dict(NO_FILES, face_landmarker=True, hand_landmarker=True)
    common.pop("use_pallas")
    if mesh:
        common["face_landmarker_path"] = _bundle(tmp_path)
    jr = jrunner.InferenceRunner(jconfig.InferenceConfig(
        **common, **kw, pallas_interpret=True), RH, RW)
    tr = trunner.InferenceRunner(tconfig.InferenceConfig(**common, **kw),
                                 RH, RW, device="cpu")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jr.params))
    # Both nets take packed crops; the fused stem wherever it is on.
    assert tr._packed_in == {"flm_lm": True, "hand_lm": True}
    assert set(tr._stem_src) == ({"flm_lm", "hand_lm"} if kw["fused_stem"]
                                 else set())
    if mesh and not kw["fused_stem"]:
        g = tr._graph_fns["flm_lm"].graph
        assert g.tensors[g.inputs[0]].shape == (1, 32, 32, 12)
        assert tr.sizes["flm_lm"] == 64
        assert "DEPTHWISE_CONV_2D" not in [o.opcode for o in g.ops]
    if not mesh:
        np.testing.assert_array_equal(
            tr.params["flm_lm"]["stem_p"]["w"].numpy(),
            blaze._pack_stem(blaze.init_blaze_landmark(
                trunner._seed("flm_lm"), 256, 478)["stem"], 3, 256)["w"])
    s = len(tilts)
    rad = np.deg2rad(np.array(tilts, np.float32))
    face = np.stack([np.full(s, RW / 2), np.full(s, RH / 2), np.full(s, 64.0),
                     np.full(s, 64.0), rad], -1).astype(np.float32)
    hands = np.stack([face + [[-8, 4, -16, -16, 0.087]],
                      face + [[8, 6, -20, -20, 0.087]]], 1
                     ).astype(np.float32)
    track = dict(face_rect=face, face_tracking=np.ones(s, bool),
                 hand_rects=hands, hand_tracking=np.ones((s, 2), bool))
    js = jax.tree.map(lambda x: jnp.broadcast_to(x, (s,) + x.shape),
                      jr.init_state())._replace(
        **{k: jnp.asarray(v) for k, v in track.items()})
    ts = tr.init_state(s)._replace(
        **{k: torch.from_numpy(v) for k, v in track.items()})
    frames = np.random.default_rng(7).integers(0, 256, (s, 3, RH, RW),
                                               dtype=np.uint8)
    with pltpu.force_tpu_interpret_mode():
        jst, jres = jax.jit(jr.predict_batch)(jr.params, js,
                                              jnp.asarray(frames))
    tst, tres = tr.predict_batch(params, ts, torch.from_numpy(frames))
    for det in ("face_landmarker", "hand_landmarker"):
        t, j = getattr(tres, det), getattr(jres, det)
        np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
        tp, jp = t.points.numpy(), np.asarray(j.points, np.float32)
        np.testing.assert_allclose(tp, jp, atol=1, rtol=0, equal_nan=True,
                                   err_msg=det)
        assert np.nanmean(np.abs(tp - jp)) < 0.05, det
    for name in ("face_rect", "hand_rects"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)), rtol=1e-3,
                                   atol=0.05, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_stem_twin_equals_the_stem(dtype):
    """The stand-in's packed stem on K1's packing of a crop computes the
    plain stem: the same landmarks (f32 within 1e-4 of the crop size;
    bf16 within its rounding) as the plain crop through the plain stem,
    and the reference's packed branch on the same weights."""
    from bp_from_video_tpu.models import blaze as jblaze
    from bp_from_video_tpu_torch.kernels import warp as warp_kernel
    p = blaze.init_blaze_landmark(5, 64, 21)
    tp = convert.params_from_jax(p)
    td = getattr(torch, dtype)
    tp = jax.tree.map(lambda a: a.to(td), tp)
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    xt = torch.from_numpy(x).to(td)
    plain = blaze.blaze_landmark_apply(tp, xt, 64)
    packed = blaze.blaze_landmark_apply(tp, warp_kernel.pack_s2d(xt), 64)
    jp = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), p)
    xp = np.asarray(warp_kernel.pack_s2d(torch.from_numpy(x)).numpy())
    ref = jax.vmap(lambda a: jblaze.blaze_landmark_apply(
        jp, a[None].astype(getattr(jnp, dtype)), 64))(jnp.asarray(xp))
    tol = 1e-4 if dtype == "float32" else 3e-2
    for i, (a, b) in enumerate(zip(packed, plain)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=tol * 64, rtol=0)
        r = np.asarray(ref[i], np.float32).reshape(a.shape)
        np.testing.assert_allclose(a.float().numpy(), r, atol=tol * 64,
                                   rtol=0)
