"""The port's CUDA kernels K1 (multi_crop), K3 (dense_s2_block) and K4
(roi_sums) against their plain PyTorch versions on the card.

Every test here needs an NVIDIA card: it carries the ``cuda`` marker and
skips elsewhere.  The file imports neither JAX nor the reference package
(the machine with the card need not have them), so it runs alone with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bp_from_video_tpu_torch.kernels import block as tbk
from bp_from_video_tpu_torch.kernels import roi as trk
from bp_from_video_tpu_torch.kernels import warp as twk

pytestmark = pytest.mark.cuda

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _crop_inputs(seed=0, s=3, h=120, w=160, c=3):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (s, 3, h, w), dtype=np.uint8)
    rects = np.stack([rng.uniform(5, w - 5, (s, c)),
                      rng.uniform(5, h - 5, (s, c)),
                      rng.uniform(10, 60, (s, c)),
                      rng.uniform(10, 60, (s, c))], -1).astype(np.float32)
    return frames, rects


def _block_case(seed, cin, cout, hw, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4 * cin, hw, hw)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
         ).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    alpha = rng.uniform(0, 0.3, cout).astype(np.float32)
    wmat, wspec = tbk.pack_block_weights(w, cin=cin)
    t = lambda a: torch.from_numpy(a).to(device)            # noqa: E731
    return (t(x).to(torch.bfloat16), t(wmat).to(torch.bfloat16), wspec,
            t(b), t(alpha))


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


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_multi_crop_matches_plain(cuda_device, dt):
    frames, rects = _crop_inputs()
    rects[0, 1] = np.nan
    td = _DT[dt]
    f = torch.from_numpy(frames).to(cuda_device)
    r = torch.from_numpy(rects).to(cuda_device)
    kw = dict(dtype=td, out_dtype=td, scale=1 / 255.0, pack=(2, 2, 1))
    got = twk.multi_crop(f, r, (32, 24, 24), **kw)
    want = twk.multi_crop_plain(f, r, (32, 24, 24), **kw)
    torch.cuda.synchronize()
    for g, t in zip(got, want):
        # Both round every op (no contraction) and sum only exact
        # products in bf16: equal up to the last rounding of the two-tap
        # sums in f32, one bf16 ulp at the crops' [0, 1) scale.
        torch.testing.assert_close(g.float(), t.float(), atol=2.0 ** -8,
                                   rtol=0)
    assert torch.equal(got[1][0], torch.zeros_like(got[1][0]))


@pytest.mark.parametrize("cin,cout,resid,hw", [(3, 24, False, 16),
                                               (24, 48, True, 8),
                                               (96, 192, True, 7)])
def test_cuda_dense_s2_block_matches_plain(cuda_device, cin, cout, resid,
                                           hw):
    x, wmat, wspec, b, alpha = _block_case(4, cin, cout, hw, cuda_device)
    args = (x, wmat, wspec, b, None if resid else alpha)
    got = tbk.dense_s2_block(*args, cin=cin, resid=resid)
    want = tbk.dense_s2_block_plain(*args, cin=cin, resid=resid)
    torch.cuda.synchronize()
    # f32 sums of exact bf16 products in another order, rounded to bf16:
    # at most one bf16 ulp apart.
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=2.0 ** -7)


@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_roi_sums_matches_plain(cuda_device, weighted):
    frames, rois, weights = _roi_inputs()
    f = torch.from_numpy(frames).to(cuda_device)
    r = torch.from_numpy(rois).to(cuda_device)
    w = torch.from_numpy(weights).to(cuda_device) if weighted else None
    gs, gd = trk.roi_sums(f, r, w)
    ws, wd = trk.roi_sums_plain(f, r, w)
    torch.cuda.synchronize()
    if weighted:
        # f32 products pixel * weight summed in another order.
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
    else:
        # Integer sums far below 2^24: exact.
        assert torch.equal(gs, ws) and torch.equal(gd, wd)


def test_cuda_wrappers_count_each_launch(cuda_device):
    frames, rects = _crop_inputs()
    fr, rois, _ = _roi_inputs()
    x, wmat, wspec, b, _ = _block_case(0, 3, 8, 4, cuda_device)
    n = (twk.multi_crop.launches, tbk.dense_s2_block.launches,
         trk.roi_sums.launches)
    twk.multi_crop(torch.from_numpy(frames).to(cuda_device),
                   torch.from_numpy(rects).to(cuda_device), (8, 8, 8))
    tbk.dense_s2_block(x, wmat, wspec, b, None, cin=3, resid=False)
    trk.roi_sums(torch.from_numpy(fr).to(cuda_device),
                 torch.from_numpy(rois).to(cuda_device))
    torch.cuda.synchronize()
    assert (twk.multi_crop.launches, tbk.dense_s2_block.launches,
            trk.roi_sums.launches) == tuple(k + 1 for k in n)


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x, wmat, wspec, b, _ = _block_case(0, 3, 8, 4, cuda_device)
    with pytest.raises(ValueError):           # weights must be bf16
        tbk.dense_s2_block(x, wmat.float(), wspec, b, None, cin=3,
                           resid=False)
    with pytest.raises(ValueError):           # operands on two devices
        tbk.dense_s2_block(x, wmat.cpu(), wspec, b, None, cin=3,
                           resid=False)
