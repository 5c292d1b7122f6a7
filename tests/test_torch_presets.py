"""The ``butter_welch_face`` and ``segmenter_fir`` presets through the port's
``Engine.batch_step`` against the reference package's, on the same pulsing
clip, frames and weights (S = 2, 96x128, f32).

The reference runs its Pallas kernels in interpret mode; the port runs the
plain versions of its kernels (CPU tensors).  BPM must be equal; PTT is NaN
on both (one ROI); the ROI rings equal; the sampled signal equal
unweighted and, weighted by the segmenter's skin confidence, within 1e-4
(a few upsampled confidences differ by a bf16 ulp, see
``test_torch_segmenter``); the processed signal within the chain's own
tolerances (Butterworth 2e-3 as in ``test_torch_engine``, FIR 2e-3 of a
6-unit pulse).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.config import preset_configs as jpreset_configs
from bp_from_video_tpu.runtime.engine import Engine as JEngine
from bp_from_video_tpu_torch import convert
from bp_from_video_tpu_torch.config import preset_configs
from bp_from_video_tpu_torch.models.runner import TrackState
from bp_from_video_tpu_torch.runtime.engine import Engine


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


def _cfg(base, ring, interpret, standin):
    infer = dict(use_pallas=True, fused_stem=True, fused_trunk=True,
                 seg_standin_path=standin)
    if interpret:
        infer["pallas_interpret"] = True
    return dataclasses.replace(
        base, frame_height=H, frame_width=W, num_streams=S,
        signal=dataclasses.replace(base.signal, signal_max_samples=ring,
                                   peak_max_samples=8),
        inference=dataclasses.replace(base.inference, **infer))


def _face_template(params):
    """Face landmark heads with every landmark at a fixed place in the crop
    (zero readout, the place in the bias) and presence on: the tracking
    rect holds still on the clip."""
    rng = np.random.default_rng(11)
    n = 478
    pts = np.stack([rng.uniform(1 / 6, 5 / 6, n), rng.uniform(1 / 6, 5 / 6, n),
                    np.full(n, 0.5)], -1)
    pts[-2, :2], pts[-1, :2] = (1 / 6, 1 / 6), (5 / 6, 5 / 6)
    for i, xy in {33: (0.3, 0.4), 263: (0.7, 0.4), 151: (0.5, 0.3)}.items():
        pts[i, :2] = xy
    p = params["flm_lm"]
    p["head_lm"]["w"] = np.zeros_like(p["head_lm"]["w"])
    p["head_lm"]["b"] = np.log(pts / (1 - pts)).reshape(-1).astype(
        p["head_lm"]["b"].dtype)
    p["head_presence"]["w"] = np.zeros_like(p["head_presence"]["w"])
    p["head_presence"]["b"] = np.full_like(p["head_presence"]["b"], 8.0)
    return params


def _pulse_clip(steps, hz=1.2, seed=5):
    """Textured frames whose green channel pulses at ``hz``."""
    rng = np.random.default_rng(seed)
    base = rng.integers(60, 180, (S, 3, H // 8, W // 8))
    base = np.repeat(np.repeat(base, 8, 2), 8, 3).astype(np.float32)
    out = np.empty((steps, S, 3, H, W), np.uint8)
    for i in range(steps):
        f = base.copy()
        f[:, 1] += 6.0 * np.sin(2 * np.pi * hz * i / 30.0)
        out[i] = np.clip(np.round(f + rng.normal(0, 0.5, f.shape)), 0, 255)
    return out


def _run(name, ring, steps, standin):
    je = JEngine(_cfg(jpreset_configs()[name], ring, True, standin))
    te = Engine(_cfg(preset_configs()[name], ring, False, standin),
                device="cpu")
    jparams = _face_template(jax.tree.map(np.array, je.params))
    tparams = convert.params_from_jax(jparams)
    jparams = jax.tree.map(jnp.asarray, jparams)
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                       je.init_state())
    jst = jst._replace(track=jst.track._replace(
        face_rect=jnp.asarray([[64, 40, 56, 56, 0]] * S, jnp.float32),
        face_tracking=jnp.ones((S,), bool)))
    tst = te.init_state()._replace(track=TrackState(
        *[torch.from_numpy(np.array(x)) for x in jst.track]))
    step = jax.jit(je.batch_step)
    clip = _pulse_clip(steps)
    for i in range(steps):
        ts = np.full((S,), (i + 1) / 30.0, np.float32)
        jst, jo = step(jparams, jst, jnp.asarray(clip[i]), jnp.asarray(ts))
        tst, to = te.batch_step(tparams, tst, torch.from_numpy(clip[i]),
                                torch.from_numpy(ts))
        np.testing.assert_array_equal(to.rois.numpy(), np.asarray(jo.rois))
        if i >= steps - 5:
            np.testing.assert_array_equal(to.bpm.numpy(), np.asarray(jo.bpm))
    assert np.isnan(to.ptt.numpy()).all() and np.isnan(np.asarray(jo.ptt)).all()
    return to, jo


def test_butter_welch_face_clip_matches_reference():
    """A 100-sample ring at 30 fps: a Welch bin is 0.3 Hz, so the clip's
    1.2 Hz is bin 4 exactly, 72 BPM."""
    to, jo = _run("butter_welch_face", 100, 106, None)
    assert np.all(to.bpm.numpy() == 72)
    np.testing.assert_array_equal(to.raw_y.numpy(), np.asarray(jo.raw_y))
    np.testing.assert_allclose(to.proc_y.numpy(), np.asarray(jo.proc_y),
                               atol=2e-3, rtol=0, equal_nan=True)
    np.testing.assert_allclose(to.spec_x.numpy(), np.asarray(jo.spec_x),
                               rtol=1e-6, equal_nan=True)


@pytest.mark.trained_standins
def test_segmenter_fir_clip_matches_reference():
    """The trained segmenter stand-in in both packages: skin-weighted
    samples, cubic interpolation, linear detrend, FIR, Lomb-Scargle."""
    to, jo = _run("segmenter_fir", 64, 70, "models/seg_standin_synth.npz")
    assert np.all(np.abs(to.bpm.numpy() - 72) <= 6)
    np.testing.assert_allclose(to.raw_y.numpy(), np.asarray(jo.raw_y),
                               atol=1e-4, rtol=0, equal_nan=True)
    np.testing.assert_allclose(to.proc_x.numpy(), np.asarray(jo.proc_x),
                               rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(to.proc_y.numpy(), np.asarray(jo.proc_y),
                               atol=2e-3, rtol=0, equal_nan=True)
