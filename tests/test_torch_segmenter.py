"""The port's person segmenter (``blaze.segmenter_apply``, the runner's
segmenter branch, ``skin_confidence``) against the reference package on the
same frames and weights (the reference runner's params converted with
``convert.params_from_jax``), f32.

Tolerances: the net's confidences atol 1e-5 (f32 convolutions summed in
another order, then a softmax); the runner's class maps equal and its
confidences within 1e-5.  Both runners upsample the model-resolution
confidences to the frame with bf16 operands, so a confidence that lies
within f32 roundoff of a bf16 rounding boundary may round to neighbouring
bf16 values in the two packages (40 of 147,456 values on these frames);
the test requires such values to be fewer than 1 in 1,000 and within one
bf16 ulp of a confidence (2^-8), and every other value within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.config import InferenceConfig as JInferenceConfig
from bp_from_video_tpu.models import blaze as jblaze
from bp_from_video_tpu.models import runner as jrunner
from bp_from_video_tpu_torch import convert
from bp_from_video_tpu_torch.config import InferenceConfig
from bp_from_video_tpu_torch.models import blaze, runner


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


def test_segmenter_apply_matches_reference():
    size = 64
    jp = jblaze.init_segmenter(7, size)
    tp = convert.params_from_jax(jp)
    x = np.random.default_rng(0).uniform(0, 1, (2, 3, size, size)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, v: jblaze.segmenter_apply(
        p, v, size))(jp, jnp.asarray(x)))
    got = blaze.segmenter_apply(tp, torch.from_numpy(x), size).numpy()
    assert got.shape == (2, 6, size, size)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    feats = blaze.segmenter_features(tp, torch.from_numpy(x), size)
    assert tuple(feats.shape) == (2, 12, size // 2, size // 2)


def _runners(full_masks, standin):
    kw = dict(face_landmarker=False, hand_landmarker=False,
              person_segmenter=True, seg_full_masks=full_masks,
              seg_standin_path=standin)
    jr = jrunner.InferenceRunner(JInferenceConfig(**kw), H, W)
    tr = runner.InferenceRunner(InferenceConfig(**kw), H, W, device="cpu")
    return jr, tr


def _frames(seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 220, (S, 3, H // 8, W // 8))
    f = np.repeat(np.repeat(base, 8, 2), 8, 3) + rng.normal(0, 3, (S, 3, H, W))
    return np.clip(np.round(f), 0, 255).astype(np.uint8)


def _hold_conf(got, want):
    """Within 1e-5, but for the few pixels where a bf16 upsample operand
    rounded to a neighbouring value: there by at most one bf16 ulp of a
    confidence below 1 (2^-8)."""
    d = np.abs(got - want)
    off = d > 1e-5
    assert off.mean() < 1e-3, (int(off.sum()), float(d.max()))
    assert d.max() <= 2.0 ** -8


@pytest.mark.parametrize("full_masks", [True, False],
                         ids=["full_masks", "skin_only"])
def test_predict_batch_segmenter_matches_reference(full_masks):
    jr, tr = _runners(full_masks, None)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jr.params))
    frames = _frames()
    jst = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                       jr.init_state())
    _, jres = jax.jit(jr.predict_batch)(jr.params, jst, jnp.asarray(frames))
    _, tres = tr.predict_batch(params, tr.init_state(S),
                               torch.from_numpy(frames))
    c = 6 if full_masks else 1
    assert tuple(tres.seg_conf.shape) == (S, c, H, W)
    cls_shape = (S, H, W) if full_masks else (S, 256, 256)
    assert tuple(tres.seg_class.shape) == cls_shape
    assert tres.seg_class.dtype == torch.int32
    assert bool(tres.seg_valid.all())
    want = np.asarray(jres.seg_conf)
    got = tres.seg_conf.numpy()
    _hold_conf(got, want)
    np.testing.assert_array_equal(tres.seg_class.numpy(),
                                  np.asarray(jres.seg_class))
    np.testing.assert_array_equal(
        runner.skin_confidence(tres.seg_conf).numpy(),
        got[:, 3 if full_masks else 0])


@pytest.mark.trained_standins
def test_trained_segmenter_loads_in_both_packages():
    jr, tr = _runners(True, "models/seg_standin_synth.npz")
    assert jr.trained_standin.get("seg") and tr.trained_standin.get("seg")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jr.params))
    for k, v in params["seg"]["head"].items():
        np.testing.assert_array_equal(tr.params["seg"]["head"][k].numpy(),
                                      v.numpy())


def test_skin_confidence_layouts_and_rejects():
    conf6 = torch.arange(2 * 6 * 4 * 5, dtype=torch.float32).reshape(
        2, 6, 4, 5)
    skin = runner.skin_confidence(conf6)
    assert torch.equal(skin, conf6[:, 3])
    assert skin.data_ptr() == conf6[:, 3].data_ptr()       # a view
    assert skin.stride(0) == 6 * 4 * 5
    conf1 = conf6[:, 3:4].clone()
    assert torch.equal(runner.skin_confidence(conf1), conf6[:, 3])
    assert torch.equal(runner.skin_confidence(conf6[0]), conf6[0, 3])
    for c in (2, 3, 7):
        with pytest.raises(ValueError, match="channels"):
            runner.skin_confidence(torch.zeros((2, c, 4, 5)))
    j6 = np.asarray(jrunner.skin_confidence(jnp.asarray(conf6.numpy())))
    np.testing.assert_array_equal(skin.numpy(), j6)


def test_compiled_segmenter_blob_raises(tmp_path):
    """A compiled segmenter (ported: it raised before) loads from its blob
    and runs, ``real_weights["seg"]`` set; a junk blob raises a parse
    error."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import tflite_fixtures as fx
    blob = tmp_path / "seg.tflite"
    blob.write_bytes(fx.build_segmenter())
    cfg = InferenceConfig(face_landmarker=False, hand_landmarker=False,
                          person_segmenter=True,
                          person_segmenter_path=str(blob))
    tr = runner.InferenceRunner(cfg, H, W, device="cpu")
    assert tr.real_weights == {"seg": True}
    _, res = tr.predict_batch(tr.params, tr.init_state(S),
                              torch.from_numpy(_frames()))
    # The fixture's logits are constant: class 2 everywhere.
    assert tuple(res.seg_conf.shape) == (S, 6, H, W)
    assert bool((res.seg_class == 2).all())
    blob.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="not a TFLite flatbuffer"):
        runner.InferenceRunner(cfg, H, W, device="cpu")
