"""Kernels K1 (multi_crop), K3 (dense_s2_block / trunk_apply) and K4
(roi_sums) of the PyTorch port against the reference package's Pallas
kernels run in interpret mode, on the same numpy inputs.

On the CPU a wrapper takes its kernel's plain version, so these tests hold
the plain versions to the TPU kernels' semantics; ``test_torch_cuda.py``
holds the CUDA kernels to the plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.pallas import block_kernel as jbk
from bp_from_video_tpu.pallas import roi_kernel as jrk
from bp_from_video_tpu.pallas import warp_kernel as jwk
from bp_from_video_tpu_torch.kernels import block as tbk
from bp_from_video_tpu_torch.kernels import roi as trk
from bp_from_video_tpu_torch.kernels import warp as twk

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.array(a, np.float32)


def _crop_inputs(seed=0, s=2, h=40, w=56, c=3):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (s, 3, h, w), dtype=np.uint8)
    rects = np.stack([rng.uniform(5, w - 5, (s, c)),
                      rng.uniform(5, h - 5, (s, c)),
                      rng.uniform(10, 60, (s, c)),
                      rng.uniform(10, 60, (s, c))], -1).astype(np.float32)
    return frames, rects


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("pack", [1, 2])
def test_multi_crop_matches_pallas(dt, pack):
    frames, rects = _crop_inputs()
    rects[1, 2] = np.nan                         # NaN rect -> zero crop
    sizes = (16, 12, 12)
    jd, td = _DT[dt]
    want = jwk.multi_crop(jnp.asarray(frames), jnp.asarray(rects), sizes,
                          interpret=True, dtype=jd, out_dtype=jd,
                          scale=1.0 / 255.0, pack=pack)
    got = twk.multi_crop(torch.from_numpy(frames), torch.from_numpy(rects),
                         sizes, dtype=td, out_dtype=td, scale=1.0 / 255.0,
                         pack=pack)
    for g, t in zip(got, want):
        assert tuple(g.shape) == t.shape and g.dtype == td
        g, t = _f32(g), _f32(t)
        if dt == "float32":
            # One f32 ulp of the sample coordinate (XLA may contract
            # center + u*extent into an FMA, the port rounds each op)
            # moves a weight by ~1e-5: <= 3e-5 after the 1/255 scale.
            np.testing.assert_allclose(g, t, atol=3e-5, rtol=0)
        else:
            # The same coordinate ulp can flip one bf16 weight rounding:
            # one bf16 ulp at 1.0 (2^-8) on a small share of pixels.
            np.testing.assert_allclose(g, t, atol=2.0 ** -8, rtol=0)
            assert np.mean(g != t) < 0.01
    np.testing.assert_array_equal(_f32(got[2])[1], 0.0)


def _block_case(seed, cin, cout, hw, dt):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4 * cin, hw, hw)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
         ).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    alpha = rng.uniform(0, 0.3, cout).astype(np.float32)
    wmat, wspec = tbk.pack_block_weights(w, cin=cin)
    jw, jspec = jbk.pack_block_weights(w, cin=cin)
    assert wspec == jspec
    np.testing.assert_array_equal(_f32(jw), _f32(torch.from_numpy(wmat).to(
        torch.bfloat16)))
    jd, td = _DT[dt]
    xj = jnp.asarray(x).astype(jd)
    xt = torch.from_numpy(_f32(xj)).to(td)
    return xj, xt, jw, torch.from_numpy(wmat).to(torch.bfloat16), wspec, b, \
        alpha


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout,resid", [(8, 16, True), (3, 24, False),
                                            (8, 8, False), (3, 8, True)])
def test_dense_s2_block_matches_pallas(cin, cout, resid, dt):
    xj, xt, jw, tw, wspec, b, alpha = _block_case(1, cin, cout, 7, dt)
    al = None if resid else alpha
    want = jbk.dense_s2_block(xj, jw, wspec, jnp.asarray(b),
                              None if al is None else jnp.asarray(al),
                              cin=cin, resid=resid, interpret=True)
    got = tbk.dense_s2_block(xt, tw, wspec, torch.from_numpy(b),
                             None if al is None else torch.from_numpy(al),
                             cin=cin, resid=resid)
    assert tuple(got.shape) == want.shape and got.dtype == xt.dtype
    g, t = _f32(got), _f32(want)
    if dt == "float32":
        # Same bf16 windows and weights: products are exact in f32, only
        # the summation order differs.
        np.testing.assert_allclose(g, t, atol=1e-5, rtol=1e-5)
    else:
        # The f32 sums round to bf16: at most one bf16 ulp apart.
        np.testing.assert_allclose(g, t, atol=1e-2, rtol=2.0 ** -7)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_trunk_apply_matches_pallas(dt):
    from bp_from_video_tpu.models import blaze as jblaze
    params = jblaze.init_blaze_landmark(5, 64, 21)
    arrays, specs = tbk.prepare_trunk(params)
    jarrays, jspecs = jbk.prepare_trunk(params)
    assert specs == jspecs
    rng = np.random.default_rng(2)
    stems = np.maximum(rng.standard_normal((2, 24, 32, 32)), 0
                       ).astype(np.float32)
    jd, td = _DT[dt]
    sj = jnp.asarray(stems).astype(jd)
    want = jbk.trunk_apply(jarrays, jspecs, sj, interpret=True)
    tarrays = [{"wmat": torch.from_numpy(a["wmat"]).to(torch.bfloat16),
                "b": torch.from_numpy(a["b"])} for a in arrays]
    got = tbk.trunk_apply(tarrays, specs, torch.from_numpy(_f32(sj)).to(td))
    assert tuple(got.shape) == want.shape == (2, 192, 2, 2)
    g, t = _f32(got), _f32(want)
    # Every block re-rounds its windows to bf16, so a summation-order
    # difference that flips one rounding carries through as ~one bf16 ulp
    # of the activation scale.
    np.testing.assert_allclose(g, t, atol=2.0 ** -7 * np.abs(t).max(),
                               rtol=0)


def _roi_inputs(seed=3, s=2, h=24, w=32, r=8):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (s, 3, h, w), dtype=np.uint8)
    rois = np.zeros((s, r, 6), np.float32)
    rois[..., 2] = rng.integers(0, w - 4, (s, r))
    rois[..., 3] = rng.integers(0, h - 4, (s, r))
    rois[..., 4] = rois[..., 2] + rng.integers(1, 12, (s, r))
    rois[..., 5] = rois[..., 3] + rng.integers(1, 12, (s, r))
    rois[0, 1, 2:] = (-6, -8, -1, -2)            # negative bounds wrap
    rois[0, 2, 2:] = (5, 5, 5, 9)                # empty span
    rois[1, 3, 2:] = (-100, 2, 100, 50)          # clamped past both ends
    weights = rng.uniform(0, 1, (s, h, w)).astype(np.float32)
    return frames, rois, weights


def _slice_sums(frames, rois, weights=None):
    """Independent oracle: numpy slicing (Python slice semantics)."""
    s, r = rois.shape[:2]
    sums = np.zeros((s, r, 3))
    den = np.zeros((s, r))
    for i in range(s):
        for j in range(r):
            x0, y0, x1, y1 = (int(v) for v in rois[i, j, 2:])
            f = frames[i, :, y0:y1, x0:x1].astype(np.float64)
            if weights is None:
                sums[i, j] = f.sum((1, 2))
                den[i, j] = f.shape[1] * f.shape[2]
            else:
                wm = weights[i, y0:y1, x0:x1].astype(np.float64)
                sums[i, j] = (f * wm).sum((1, 2))
                den[i, j] = wm.sum()
    return sums, den


@pytest.mark.parametrize("weighted", [False, True])
def test_roi_sums_matches_pallas(weighted):
    frames, rois, weights = _roi_inputs()
    wj = jnp.asarray(weights) if weighted else None
    wt = torch.from_numpy(weights) if weighted else None
    js, jd = jrk.roi_sums(jnp.asarray(frames), jnp.asarray(rois), wj,
                          interpret=True)
    ts, td = trk.roi_sums(torch.from_numpy(frames), torch.from_numpy(rois),
                          wt)
    os_, od = _slice_sums(frames, rois, weights if weighted else None)
    if weighted:
        # f32 products pixel * weight summed in another order: rtol 1e-5.
        np.testing.assert_allclose(_f32(ts), _f32(js), rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(_f32(td), _f32(jd), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_f32(ts), os_, rtol=1e-5, atol=1e-3)
    else:
        # Integer sums far below 2^24: exact in f32.
        np.testing.assert_array_equal(_f32(ts), _f32(js))
        np.testing.assert_array_equal(_f32(td), _f32(jd))
        np.testing.assert_array_equal(_f32(ts), os_)
        np.testing.assert_array_equal(_f32(td), od)


def test_roi_sums_rejects_more_than_eight_rois():
    frames, rois, _ = _roi_inputs(r=8)
    with pytest.raises(ValueError):
        trk.roi_sums(torch.from_numpy(frames),
                     torch.from_numpy(np.concatenate([rois, rois[:, :1]], 1)))


def test_wrappers_take_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and launches nothing."""
    frames, rects = _crop_inputs()
    n1, n3, n4 = (twk.multi_crop.launches, tbk.dense_s2_block.launches,
                  trk.roi_sums.launches)
    twk.multi_crop(torch.from_numpy(frames), torch.from_numpy(rects),
                   (8, 8, 8))
    xj, xt, jw, tw, wspec, b, _ = _block_case(0, 3, 8, 4, "float32")
    tbk.dense_s2_block(xt, tw, wspec, torch.from_numpy(b), None, cin=3,
                       resid=False)
    fr, rois, _ = _roi_inputs()
    trk.roi_sums(torch.from_numpy(fr), torch.from_numpy(rois))
    assert (twk.multi_crop.launches, tbk.dense_s2_block.launches,
            trk.roi_sums.launches) == (n1, n3, n4)
