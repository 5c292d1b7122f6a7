"""K4's sample entry (``kernels/roi.roi_samples``) and the port's
``ops/roi.sample_rois_batch`` kernel route against the reference package's
``sample_rois_batch(..., use_pallas=True)`` with its Pallas kernel in
interpret mode, on the same numpy inputs.

On the CPU ``roi_samples`` takes its plain version (``roi_samples_plain``);
``test_torch_cuda.py`` holds the CUDA kernel to it on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.config import SignalColorChannel as JChannel
from bp_from_video_tpu.ops import roi as jroi
from bp_from_video_tpu_torch.config import SignalColorChannel
from bp_from_video_tpu_torch.kernels import roi as trk
from bp_from_video_tpu_torch.ops import roi as troi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=5, s=3, h=24, w=36, r=8):
    """Planar u8 frames, ROIs with every kind of row the sample entry
    meets, and a weight map."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (s, 3, h, w), dtype=np.uint8)
    rois = np.zeros((s, r, 6), np.float32)
    rois[..., 2] = rng.integers(0, w - 4, (s, r))
    rois[..., 3] = rng.integers(0, h - 4, (s, r))
    rois[..., 4] = rois[..., 2] + rng.integers(1, 14, (s, r))
    rois[..., 5] = rois[..., 3] + rng.integers(1, 14, (s, r))
    rois[..., 0] = (rois[..., 2] + rois[..., 4]) // 2
    rois[..., 1] = (rois[..., 3] + rois[..., 5]) // 2
    rois[0, 1] = np.nan                          # a lost detection
    rois[0, 2, 0] = np.nan                       # one non-finite entry
    rois[1, 0, 4] = np.inf                       # an infinite bound
    rois[1, 1, 2:] = (-np.inf, 3, 9, 9)
    rois[1, 2, 2:] = (7, 7, 7, 15)               # empty span
    rois[2, 0, 2:] = (-6, -8, -1, -2)            # negative bounds wrap
    rois[2, 1, 2:] = (-100, 2, 100, 50)          # clamped past both ends
    rois[2, 2, 2:] = (5, 9, 6, 10)               # one pixel
    rois[2, 3, 2:] = (3, 4, 30, 5)               # one row
    rois[2, 4, 2:] = (11, 2, 12, 20)             # one column
    weights = rng.uniform(0, 1, (s, h, w)).astype(np.float32)
    weights[0, :, :5] = 0.0                      # zero weight: den may be 0
    rois[0, 3, 2:] = (0, 0, 5, 10)               # all-zero weights there
    return frames, rois, weights


@pytest.mark.parametrize("layout", ["planar", "nhwc"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("channel", ["GREEN", "CHROM_GREEN"])
def test_roi_samples_match_pallas(channel, weighted, layout):
    frames, rois, weights = _inputs()
    fr = frames if layout == "planar" else frames.transpose(0, 2, 3, 1).copy()
    wj = jnp.asarray(weights) if weighted else None
    wt = torch.from_numpy(weights) if weighted else None
    want = np.asarray(jroi.sample_rois_batch(
        jnp.asarray(fr), jnp.asarray(rois), JChannel[channel], wj,
        use_pallas=True, interpret=True))
    ch = SignalColorChannel[channel]
    got = troi.sample_rois_batch(torch.from_numpy(fr), torch.from_numpy(rois),
                                 ch, wt, use_pallas=True).numpy()
    plain = trk.roi_samples_plain(torch.from_numpy(frames),
                                  torch.from_numpy(rois), ch, wt).numpy()
    nan = np.isnan(want)
    # Every non-finite row, the empty span and the zero-weight rect (when
    # weighted) give NaN; every other row a value.
    assert nan[0, 1] and nan[0, 2] and nan[1, 0] and nan[1, 1] and nan[1, 2]
    assert nan[0, 3] == weighted and nan.sum() == 5 + weighted
    for out in (got, plain):
        assert out.dtype == np.float32 and out.shape == want.shape
        np.testing.assert_array_equal(np.isnan(out), nan)
        if weighted:
            # f32 products pixel * weight summed in another order.
            np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
        else:
            # Integer sums below 2^24, one IEEE division each side, the
            # same mix: bit-equal.
            np.testing.assert_array_equal(out, want)


def test_roi_samples_kernel_route_is_the_plain_version_on_cpu():
    """The kernel route of ``sample_rois_batch`` on a CPU tensor gives the
    plain composition's bits and launches nothing."""
    frames, rois, _ = _inputs(seed=8)
    f, r = torch.from_numpy(frames), torch.from_numpy(rois)
    n = (trk.roi_samples.launches, trk.roi_sums.launches)
    got = troi.sample_rois_batch(f, r, SignalColorChannel.CHROM_GREEN,
                                 use_pallas=True)
    want = trk.roi_samples_plain(f, r, SignalColorChannel.CHROM_GREEN)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    trk.roi_samples(f, r, SignalColorChannel.GREEN)
    assert (trk.roi_samples.launches, trk.roi_sums.launches) == n


def test_roi_samples_rejects_what_the_kernel_does_not_take():
    frames, rois, _ = _inputs(r=8)
    f, r = torch.from_numpy(frames), torch.from_numpy(rois)
    with pytest.raises(ValueError):
        trk.roi_samples(f, torch.cat([r, r[:, :1]], 1),
                        SignalColorChannel.GREEN)
    with pytest.raises(ValueError):
        trk.roi_samples(f.float(), r, SignalColorChannel.GREEN)
    with pytest.raises(ValueError):
        trk.roi_samples(f, r.double(), SignalColorChannel.GREEN)
    with pytest.raises(ValueError):
        trk.roi_samples(f, r, SignalColorChannel.GREEN,
                        torch.zeros((3, 24, 35)))


@pytest.mark.parametrize("w,offset,woffset,word", [
    (36, 0, 0, True),            # the flagship case: whole buffers, w % 4 = 0
    (30, 0, 0, False),           # a width that is not a multiple of 4
    (36, 1, 0, False),           # frames at an odd address
    (36, 4, 0, True),            # frames 4-byte aligned in their buffer
    (36, 0, 1, False),           # weights 4- but not 16-byte aligned
    (36, 0, 4, True),            # weights 16-byte aligned in their buffer
])
def test_word_route_is_taken_only_where_words_are_aligned(w, offset, woffset,
                                                          word):
    s, h = 2, 8
    buf = torch.zeros(s * 3 * h * w + offset, dtype=torch.uint8)
    frames = buf[offset:].view(s, 3, h, w)
    wbuf = torch.zeros(s * h * w + woffset)
    weights = wbuf[woffset:].view(s, h, w) if woffset else None
    assert trk.word_route(frames, weights) == word
    if woffset == 0:
        assert trk.word_route(frames, wbuf.view(s, h, w)) == word
    # Streams whose maps are not a whole number of 16-byte vectors apart.
    assert not trk.word_route(frames, wbuf[woffset:].view(s, h, w),
                              wstride=h * w + 2)
