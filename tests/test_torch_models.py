"""The port's vision models (models/warp, detection, blaze, convert)
against the reference package on the same numpy inputs and weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.models import blaze as jblaze
from bp_from_video_tpu.models import detection as jdet
from bp_from_video_tpu.models import warp as jwarp
from bp_from_video_tpu_torch import convert
from bp_from_video_tpu_torch.models import blaze, detection, warp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(a, np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(_np(got), _np(want), equal_nan=True, **kw)


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)


def _to_t(tree):
    return convert.params_from_jax(tree)


def test_standin_init_draws_match_reference():
    _tree_equal(blaze.init_blaze_detector(7, 128, 896, 6),
                jblaze.init_blaze_detector(7, 128, 896, 6))
    want = jblaze.init_blaze_landmark(9, 64, 21)
    want.pop("stem_p")                 # the unfused packed path only
    _tree_equal(blaze.init_blaze_landmark(9, 64, 21), want)


def test_load_standin_npz_matches_reference():
    path = os.path.join(REPO, "models", "hand_lm_standin_synth.npz")
    got, meta = blaze.load_standin_npz(path, return_meta=True)
    want, jmeta = jblaze.load_standin_npz(path, return_meta=True)
    assert meta == jmeta and meta["input_size"] == 224
    _tree_equal(got, want)


def test_detector_net_matches_reference():
    p = jblaze.init_blaze_detector(3, 64, 224, 7)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 3, 64, 64)
                                         ).astype(np.float32)
    jr, jl = jax.vmap(lambda a: jblaze.blaze_detector_apply(p, a[None], 7))(
        jnp.asarray(x))
    tr, tl = blaze.blaze_detector_apply(_to_t(p), torch.from_numpy(x), 7)
    assert tuple(tr.shape) == (2, 224, 18) and tuple(tl.shape) == (2, 224, 1)
    # f32 convolutions in another summation order, 8 layers deep.
    _close(tr, jr[:, 0], rtol=1e-4, atol=1e-4)
    _close(tl, jl[:, 0], rtol=1e-4, atol=1e-4)


def test_landmark_net_and_heads_match_reference():
    p = jblaze.init_blaze_landmark(4, 64, 21)
    x = np.random.default_rng(1).uniform(0, 1, (2, 3, 64, 64)
                                         ).astype(np.float32)
    want = jax.vmap(lambda a: jblaze.blaze_landmark_apply(p, a[None], 64))(
        jnp.asarray(x))
    tp = _to_t(p)
    got = blaze.blaze_landmark_apply(tp, torch.from_numpy(x), 64)
    for g, w in zip(got, want):
        _close(g, w[:, 0], rtol=1e-4, atol=1e-3)
    feats = np.random.default_rng(2).uniform(0, 2, (3, 192, 2, 2)
                                             ).astype(np.float32)
    want = jblaze.landmark_heads(p, jnp.asarray(feats), 64)
    got = blaze.landmark_heads(tp, torch.from_numpy(feats), 64)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-4)


def test_decode_nms_and_area_sort_match_reference():
    rng = np.random.default_rng(5)
    anchors = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    reg = rng.normal(0, 6, (3, 64, 18)).astype(np.float32)
    reg[..., 2:4] = rng.uniform(5, 40, (3, 64, 2))
    logits = rng.normal(0, 2, (3, 64, 1)).astype(np.float32)
    logits[2] = -10.0                            # nothing above min_score
    cfg = detection.PALM_DECODE
    jcfg = jdet.PALM_DECODE

    def jrun(r, lg):
        raw = jdet.decode(jcfg, r, lg, jnp.asarray(anchors))
        nms = jdet.weighted_nms(jcfg, raw, 3)
        return raw, nms, jdet.sort_by_area_desc(nms)

    jraw, jnms, jsorted = jax.vmap(jrun)(jnp.asarray(reg),
                                         jnp.asarray(logits))
    raw = detection.decode(cfg, torch.from_numpy(reg),
                           torch.from_numpy(logits),
                           torch.from_numpy(anchors))
    nms = detection.weighted_nms(cfg, raw, 3)
    srt = detection.sort_by_area_desc(nms)
    for g, w in zip(raw, jraw):
        _close(g, w, rtol=1e-6, atol=1e-7)
    for got, want in ((nms, jnms), (srt, jsorted)):
        np.testing.assert_array_equal(got.count.numpy(),
                                      np.asarray(want.count))
        for g, w in zip(got[:3], want[:3]):
            # Score-weighted blends summed in another order.
            _close(g, w, rtol=1e-5, atol=1e-6)


def test_rect_geometry_and_crops_match_reference():
    rng = np.random.default_rng(6)
    box = np.array([[30, 20, 70, 64], [5, 8, 40, 30]], np.float32)
    kps = rng.uniform(0, 90, (2, 7, 2)).astype(np.float32)
    pts = rng.uniform(10, 80, (2, 21, 2)).astype(np.float32)

    def jgeo(b, k, p):
        r1 = jwarp.rect_transform(
            jwarp.detection_to_rect(b, k, 0, 2, np.pi / 2), 2.6,
            shift_y=-0.5)
        r2 = jwarp.rect_transform(jwarp.landmarks_to_rect(p, 0, 9, 0.0),
                                  1.5)
        return r1, r2, jwarp.axis_aligned_cover(r1)

    jr1, jr2, jcov = jax.vmap(jgeo)(jnp.asarray(box), jnp.asarray(kps),
                                    jnp.asarray(pts))
    r1 = warp.rect_transform(warp.detection_to_rect(
        torch.from_numpy(box), torch.from_numpy(kps), 0, 2, np.pi / 2), 2.6,
        shift_y=-0.5)
    r2 = warp.rect_transform(warp.landmarks_to_rect(torch.from_numpy(pts), 0,
                                                    9, 0.0), 1.5)
    cov = warp.axis_aligned_cover(r1)
    for got, want in ((r1, jr1), (r2, jr2), (cov, jcov)):
        for g, w in zip(got, want):
            _close(g, w, rtol=1e-5, atol=1e-5)

    frames = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    rect = np.array([[30, 20, 40, 36, 0], [10, 40, 50, 30, 0]], np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = jax.vmap(lambda f, r: jwarp.crop_rect(
            f, jwarp.Rect(*r), 24, exact_rotation=False, dtype=jdt))(
                jnp.asarray(frames), jnp.asarray(rect))
        got = warp.crop_rect(torch.from_numpy(frames),
                             warp.arr_rect(torch.from_numpy(rect)), 24,
                             dtype=dt)
        # One coordinate ulp (possible FMA contraction on the reference
        # side) moves a weight by ~1e-5 of 255-scale pixels; in bf16 it
        # may flip one weight rounding (2^-8 of a 255 pixel).
        _close(got, want, atol=5e-3 if dt == torch.float32 else 2.0,
               rtol=0)
    with pytest.raises(NotImplementedError):
        warp.crop_rect(torch.from_numpy(frames),
                       warp.arr_rect(torch.from_numpy(rect)), 24,
                       exact_rotation=True)

    jlb = jax.vmap(lambda f: jwarp.letterbox(f, 32))(jnp.asarray(frames))
    lb = warp.letterbox(torch.from_numpy(frames), 32)
    _close(lb.image, jlb.image, atol=5e-3, rtol=0)
    _close(lb.scale, jlb.scale[0], rtol=0)
    _close(lb.pad_y, jlb.pad_y[0], rtol=0)
    norm = rng.uniform(0, 1, (2, 5, 2)).astype(np.float32)
    _close(warp.unletterbox_points(torch.from_numpy(norm), lb, 32),
           jax.vmap(lambda p, l_: jwarp.unletterbox_points(p, l_, 32))(
               jnp.asarray(norm), jlb), rtol=1e-6)
    proj = warp.project_landmarks(torch.from_numpy(norm), r1)
    jproj = jax.vmap(jwarp.project_landmarks)(jnp.asarray(norm), jr1)
    _close(proj, jproj, rtol=1e-5, atol=1e-4)
    img = rng.uniform(0, 1, (2, 20, 30, 3)).astype(np.float32)
    _close(warp.resize_bilinear(torch.from_numpy(img), 7, 11),
           jax.vmap(lambda a: jwarp.resize_bilinear(a, 7, 11))(
               jnp.asarray(img)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_equal_port_construction(dtype):
    """The JAX runner's params (fetched as numpy) convert to exactly the
    params the port builds itself from the same seeds, packed kernel
    weights included."""
    from bp_from_video_tpu.config import InferenceConfig as JIC
    from bp_from_video_tpu.models.runner import InferenceRunner as JRunner
    from bp_from_video_tpu_torch.config import InferenceConfig
    from bp_from_video_tpu_torch.models.runner import InferenceRunner

    kw = dict(use_pallas=True, fused_stem=True, fused_trunk=True,
              hand_lm_standin_path=None, palm_det_standin_path=None)
    jr = JRunner(JIC(**kw), 48, 64, dtype=getattr(jnp, dtype))
    tr = InferenceRunner(InferenceConfig(**kw), 48, 64,
                         dtype=getattr(torch, dtype), device="cpu")
    got = convert.params_from_jax(jax.tree.map(np.asarray, jr.params))

    def eq(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), (path, set(a) ^ set(b))
            for k in a:
                eq(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b)
            for i, (u, v) in enumerate(zip(a, b)):
                eq(u, v, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path
    eq(got, tr.params)
    assert tr.params["hand_lm"]["stem_wmat"].dtype == torch.bfloat16
    assert tr.params["hand_lm"]["trunk"][0]["b"].dtype == torch.float32
