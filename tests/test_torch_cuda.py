"""The port's CUDA kernels K1 (multi_crop), K2 (stem_packed), K3
(dense_s2_block), K4 (roi_sums and roi_samples), K5 (bottleneck_s1), K6
(bottleneck_chain), K7 (pf_stem, with PhysFormer on it against the
published net) and K8 (clip_standardise, and the engine's route to it)
against their plain PyTorch versions on the card, the
device feeder's pinned, asynchronous uploads against its CPU batches, the
rotated crops (shear, both methods, and exact) card against CPU, the
hybrid rotation gate's one host sync a step, the gates' sync counters
against the syncs CUDA sees, and the signal half's analysis replayed as a
CUDA graph against the eager analysis.

Every test here needs an NVIDIA card: it carries the ``cuda`` marker and
skips elsewhere.  The file imports neither JAX nor the reference package
(the machine with the card need not have them), so it runs alone with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from bp_from_video_tpu_torch.config import (PhysFormerConfig,
                                            SignalColorChannel)
from bp_from_video_tpu_torch.kernels import block as tbk
from bp_from_video_tpu_torch.kernels import bottleneck as tbn
from bp_from_video_tpu_torch.kernels import clip_standardise as tcs
from bp_from_video_tpu_torch.kernels import pf_stem as tps
from bp_from_video_tpu_torch.kernels import roi as trk
from bp_from_video_tpu_torch.kernels import stem as tsk
from bp_from_video_tpu_torch.kernels import warp as twk
from bp_from_video_tpu_torch.models import physformer as tpf
from bp_from_video_tpu_torch.models import physformer_ref as tpf_ref
from bp_from_video_tpu_torch.models.runner import map_leaves

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


def _block_case(seed, cin, cout, hw, device, bsz=2, w=None,
                dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, 4 * cin, hw, w or hw)).astype(np.float32)
    wd = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
          ).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    alpha = rng.uniform(0, 0.3, cout).astype(np.float32)
    wmat, wspec = tbk.pack_block_weights(wd, cin=cin)
    t = lambda a: torch.from_numpy(a).to(device)            # noqa: E731
    return (t(x).to(dtype), t(wmat).to(torch.bfloat16), wspec, t(b),
            t(alpha))


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


@pytest.mark.parametrize("dt,out_dt", [("float32", "float32"),
                                       ("bfloat16", "bfloat16"),
                                       ("bfloat16", "float32")])
@pytest.mark.parametrize("sizes,packs", [
    ((24, 26, 40, 18), (2, 2, 2, 1)),    # packed sides 12, 13, 20, 18
    ((32, 25, 64, 20), (2, 1, 2, 2)),    # 16, 25, 32, 10: odd offsets
])
def test_cuda_multi_crop_runs_match_plain(cuda_device, sizes, packs, dt,
                                          out_dt):
    """Odd packed sides (a ragged run of 2 outputs), even ones at an odd
    element offset after them (scalar stores), mixed packs, crops across
    and wholly past the frame's edges, a NaN rect, S = 3, scale != 1."""
    frames, rects = _crop_inputs(seed=5, s=3, h=40, w=56, c=len(sizes))
    rects[0, 0, :2] = (-4.0, 30.0)        # across the left edge
    rects[1, 1, :2] = (50.0, 38.0)        # across the bottom-right corner
    rects[2, 2, :2] = (120.0, -90.0)      # wholly off the frame
    rects[2, 3] = np.nan
    f = torch.from_numpy(frames).to(cuda_device)
    r = torch.from_numpy(rects).to(cuda_device)
    kw = dict(dtype=_DT[dt], out_dtype=_DT[out_dt], scale=0.5 / 255.0,
              pack=packs)
    got = twk.multi_crop(f, r, sizes, **kw)
    want = twk.multi_crop_plain(f, r, sizes, **kw)
    torch.cuda.synchronize()
    for g, t in zip(got, want):
        assert g.shape == t.shape and g.dtype == t.dtype
        # As above: one bf16 ulp at the crops' [0, 1) scale.
        torch.testing.assert_close(g.float(), t.float(), atol=2.0 ** -8,
                                   rtol=0)
    assert not got[2][2].any()
    assert not got[3][2].any()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,h,w,cin,cout,resid,act", [
    (2, 16, 16, 3, 24, False, "prelu"),    # stand-in stem, cout 24 ragged
    (3, 16, 16, 3, 16, False, "prelu"),    # the mesh stem: cout 16, PReLU
    (3, 16, 16, 3, 24, False, "relu"),     # alpha None: ReLU
    (2, 8, 8, 24, 48, True, None),
    (3, 14, 14, 96, 96, True, None),       # 4 bands of 4, 4, 4, 2 rows
    (3, 14, 14, 24, 24, True, None),       # cout 24 against the M-tile
    (2, 7, 7, 96, 192, True, None),        # 7x7: one crop, odd width
    (3, 12, 12, 48, 96, True, None),       # 8-byte row loads
    (3, 11, 9, 8, 16, True, None),         # odd h and w, one k-group/tap
    (2, 6, 6, 5, 8, False, "prelu")])      # expanded with cin 5
def test_cuda_dense_s2_block_matches_plain(cuda_device, bsz, h, w, cin, cout,
                                           resid, act, dt):
    x, wmat, wspec, b, alpha = _block_case(4, cin, cout, h, cuda_device,
                                           bsz=bsz, w=w, dtype=_DT[dt])
    args = (x, wmat, wspec, b, alpha if act == "prelu" else None)
    got = tbk.dense_s2_block(*args, cin=cin, resid=resid)
    want = tbk.dense_s2_block_plain(*args, cin=cin, resid=resid)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype
    # f32 sums of exact bf16 products in another order, rounded to bf16:
    # at most one bf16 ulp apart.  An f32 input's residual is the unrounded
    # parity-plane max on both sides.
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=2.0 ** -7)


def test_cuda_dense_s2_block_plans_as_block_plan(cuda_device):
    """The C entry's launch plan equals ``block_plan`` at the 11 flagship
    shapes (the wrapper checks it once per shape it launches)."""
    import ctypes

    from bp_from_video_tpu_torch.kernels import build
    fn = build.load("dense_s2_block").dense_s2_block_plan
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    for bsz, hw, cin, cout, spec in (
            (64, 128, 3, 24, "expanded"), (64, 64, 24, 48, "sliced"),
            (64, 32, 48, 96, "sliced"), (64, 16, 96, 96, "sliced"),
            (64, 8, 96, 192, "sliced"), (128, 112, 3, 24, "expanded"),
            (128, 56, 24, 48, "sliced"), (128, 28, 48, 96, "sliced"),
            (128, 14, 96, 96, "sliced"), (128, 7, 96, 192, "sliced"),
            (64, 128, 3, 16, "expanded")):
        got = (ctypes.c_int * 9)()
        assert fn(bsz, hw, hw, cin, cout, tbk._kdim(spec, cin),
                  int(spec == "expanded"), got) == 0
        assert tuple(got) == tuple(tbk.block_plan(bsz, hw, hw, cin, cout,
                                                  spec))


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


def _edge_rois(h, w):
    """[5, 8, 6] ROIs: x0 and x1 at every residue modulo 4 (across words and
    inside one word), one-row, one-column, empty, wrapping and clamped
    rects, the whole frame, and rows with NaN and inf entries."""
    rects = [(8 + a, 3, 20 + b, 17) for a in range(4) for b in range(4)]
    rects += [(4 + a, 5 + a, 5 + b, 9) for a in range(4)
              for b in range(a, 4)]
    rects += [(3, 7, 41, 8), (13, 2, 14, 33), (9, 9, 9, 30), (6, 12, 30, 12),
              (-9, -11, -1, -3), (-200, 5, 200, 39), (0, 0, w, h),
              (1, 1, 2, 2)]
    rois = np.zeros((40, 6), np.float32)
    rois[:len(rects), 2:] = rects
    rois[:, :2] = rois[:, 2:4]
    rois[len(rects)] = np.nan
    rois[len(rects) + 1, 5] = np.inf
    rois[len(rects) + 2, 0] = np.nan
    rois[len(rects) + 3, 2] = -np.inf
    return rois.reshape(5, 8, 6)


def _same_samples(got, want):
    """NaN exactly where the plain version has NaN, bit-equal elsewhere."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got.masked_fill(nan, 0.0), want.masked_fill(nan, 0.0))


_ROI_ROUTES = [(r, False) for r in ("word", "odd_width", "frames_offset")] + [
    (r, True) for r in ("word", "odd_width", "frames_offset",
                        "weights_offset")]


@pytest.mark.parametrize("channel", ["GREEN", "CHROM_GREEN"])
@pytest.mark.parametrize("route,weighted", _ROI_ROUTES)
def test_cuda_roi_entries_match_plain_on_both_routes(cuda_device, route,
                                                     weighted, channel):
    """Both K4 entries against their plain versions at every word residue
    of the rect's edges, on the word route (w % 4 == 0, aligned operands)
    and the byte route (an odd width, or a frame or weight view at an
    address off the word grid)."""
    h, w = 40, 62 if route == "odd_width" else 64
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(rng.integers(0, 256, (5, 3, h, w),
                                           dtype=np.uint8)).to(cuda_device)
    if route == "frames_offset":
        buf = torch.empty(frames.numel() + 1, dtype=torch.uint8,
                          device=cuda_device)
        frames = buf[1:].view(frames.shape).copy_(frames)
    wts = None
    if weighted:
        wts = torch.from_numpy(rng.uniform(0, 1, (5, h, w)).astype(
            np.float32)).to(cuda_device)
        if route == "weights_offset":
            buf = torch.empty(wts.numel() + 1, device=cuda_device)
            wts = buf[1:].view(wts.shape).copy_(wts)
    assert trk.word_route(frames, wts) == (route == "word")
    rois = torch.from_numpy(_edge_rois(h, w)).to(cuda_device)
    ch = SignalColorChannel[channel]
    got = trk.roi_samples(frames, rois, ch, wts)
    want = trk.roi_samples_plain(frames, rois, ch, wts)
    safe = torch.where(torch.isfinite(rois).all(-1, keepdim=True), rois, 0.0)
    gs, gd = trk.roi_sums(frames, safe, wts)
    ws, wd = trk.roi_sums_plain(frames, safe, wts)
    torch.cuda.synchronize()
    if weighted:
        # f32 products pixel * weight summed in another order.
        torch.testing.assert_close(gs, ws, rtol=1e-5, atol=1e-3)
        torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
        # Each mean within rtol 1e-5 as the sample mixes it: CHROM_GREEN's
        # g/2 - b/4 - r/4 cancels to about 0.5, so the error is set against
        # the terms' magnitudes.
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        m = ws / torch.where(wd > 0, wd, 1.0)[..., None]
        terms = (m[..., 1] / 2 + m[..., 2] / 4 + m[..., 0] / 4
                 if ch is SignalColorChannel.CHROM_GREEN else m[..., 1])
        d = (got.masked_fill(nan, 0.0) - want.masked_fill(nan, 0.0)).abs()
        assert bool((d <= 1e-5 * terms).all())
    else:
        # Integer sums far below 2^24: exact, and the sample bit-equal.
        assert torch.equal(gs, ws) and torch.equal(gd, wd)
        _same_samples(got, want)
    # Two empty spans, two all-zero rows and four non-finite rows.
    assert int(torch.isnan(want).sum()) == 8


def test_cuda_roi_entries_past_2_24(cuda_device):
    """Sums past 2^24 (4e7-7.8e7): a whole 480x640 frame of 255s, a whole
    random frame, and a rect with edges off the word grid on each.  The
    kernel's integer sums round once to f32: equal to the exact sums so
    rounded, and the samples bit-equal to the plain composition applied to
    those.  The plain version's f32 partial sums round on the way: on the
    whole frames rtol 1e-6 between the two, on the sums and on each channel
    mean as the sample mixes it (CHROM_GREEN's g/2 - b/4 - r/4 cancels to
    about 0.5, so its error is set against the terms' magnitudes).  The
    plain version's rounding on the offset rect of 255s reaches 2e-6 of the
    sum on the CPU, so that rect is held to the exact sums only."""
    h, w = 480, 640
    rng = np.random.default_rng(12)
    frames = np.full((2, 3, h, w), 255, np.uint8)
    frames[1] = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
    rois = np.array([[[0, 0, 0, 0, w, h], [0, 0, 3, 1, 637, 479]]] * 2,
                    np.float32)
    f = torch.from_numpy(frames).to(cuda_device)
    r = torch.from_numpy(rois).to(cuda_device)
    exact = torch.from_numpy(np.stack([[
        frames[i, :, y0:y1, x0:x1].astype(np.int64).sum((1, 2))
        for (_, _, x0, y0, x1, y1) in rois[i].astype(int)]
        for i in range(2)])).float().to(cuda_device)
    gs, gd = trk.roi_sums(f, r)
    ws, wd = trk.roi_sums_plain(f, r)
    torch.cuda.synchronize()
    assert torch.equal(gs, exact) and torch.equal(gd, wd)
    torch.testing.assert_close(gs[:, 0], ws[:, 0], rtol=1e-6, atol=0)
    for ch in SignalColorChannel:
        got = trk.roi_samples(f, r, ch)
        want = trk.roi_samples_plain(f, r, ch)
        means = exact / gd[..., None]
        from_exact = trk.mix_channel(means, ch)
        torch.cuda.synchronize()
        _same_samples(got, from_exact)
        terms = (means[..., 1] / 2 + means[..., 2] / 4 + means[..., 0] / 4
                 if ch is SignalColorChannel.CHROM_GREEN else means[..., 1])
        assert bool(((got - want).abs() <= 1e-6 * terms)[:, 0].all())
    assert torch.equal(trk.roi_samples(f, r, SignalColorChannel.GREEN)[0, 0],
                       torch.tensor(255.0, device=cuda_device))


def test_cuda_roi_word_route_refuses_unaligned_operands(cuda_device):
    """The C entry checks the word route's alignment itself: asked for words
    of frames at an odd address, it returns an error and launches
    nothing."""
    import ctypes

    from bp_from_video_tpu_torch.kernels import build
    lib = build.load("roi_sums")
    fn = lib.roi_samples_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    buf = torch.zeros(2 * 3 * 8 * 8 + 1, dtype=torch.uint8,
                      device=cuda_device)
    wbuf = torch.zeros(2 * 6 * 8 * 8 + 4, device=cuda_device)
    rois = torch.zeros((2, 1, 6), device=cuda_device)
    out = torch.zeros((2, 1), device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    w0 = wbuf.data_ptr()
    for ptr, wp, ws, vec, channel in (
            (buf.data_ptr() + 1, None, 0, 4, 1),
            (buf.data_ptr(), None, 0, 4, 0),
            (buf.data_ptr(), None, 0, 2, 1),
            (buf.data_ptr(), w0 + 4, 64, 4, 1),     # weights off 16 bytes
            (buf.data_ptr(), w0, 66, 4, 1),         # a stream off 16 bytes
            (buf.data_ptr(), w0, 63, 1, 1)):        # streams overlap
        assert fn(ptr, rois.data_ptr(), wp, ws, out.data_ptr(), 2, 1, 8, 8,
                  vec, channel, stream) != 0
    for wp, ws in ((None, 0), (w0, 384), (w0 + 4, 65)):
        assert fn(buf.data_ptr(), rois.data_ptr(), wp, ws, out.data_ptr(),
                  2, 1, 8, 8, 4 if ws % 4 == 0 else 1, 1, stream) == 0
    torch.cuda.synchronize()
    assert bool(torch.isnan(out).all())         # empty rects


@pytest.mark.parametrize("channel", ["GREEN", "CHROM_GREEN"])
@pytest.mark.parametrize("layout", ["full_masks", "skin_only"])
def test_cuda_roi_reads_a_strided_weight_view_in_place(cuda_device, layout,
                                                       channel):
    """The segmenter's skin view, as the engine passes it: with the full
    masks a channel of [S, 6, H, W] (stream stride 6 H W), read in place on
    the word route; skin-only, [S, 1, H, W].  Bit-equal to the same launch
    on a contiguous copy, and the view is not copied."""
    from bp_from_video_tpu_torch.models.runner import skin_confidence
    rng = np.random.default_rng(13)
    s, h, w = 3, 48, 64
    c = 6 if layout == "full_masks" else 1
    conf = torch.from_numpy(rng.uniform(0, 1, (s, c, h, w)).astype(
        np.float32)).to(cuda_device)
    frames = torch.from_numpy(rng.integers(0, 256, (s, 3, h, w),
                                           dtype=np.uint8)).to(cuda_device)
    rois = torch.from_numpy(_edge_rois(h, w)[:s]).to(cuda_device)
    view = skin_confidence(conf)
    assert trk.weights_in_place(view) and trk.word_route(frames, view)
    assert view.stride(0) == c * h * w
    ch = SignalColorChannel[channel]
    got = trk.roi_samples(frames, rois, ch, view)
    want = trk.roi_samples(frames, rois, ch, view.contiguous())
    gs, gd = trk.roi_sums(frames, rois.nan_to_num(), view)
    ws, wd = trk.roi_sums(frames, rois.nan_to_num(), view.contiguous())
    torch.cuda.synchronize()
    _same_samples(got, want)
    assert torch.equal(gs, ws) and torch.equal(gd, wd)
    plain = trk.roi_samples_plain(frames, rois, ch, view)
    assert torch.equal(torch.isnan(plain), torch.isnan(got))


def _bn_units(seed, units, c, d, cout, dtype, device):
    """Stacked packed operands of ``units`` bottleneck units."""
    rng = np.random.default_rng(seed)
    wds, wus = zip(*(tbn.pack_bottleneck_weights(
        rng.normal(0, 0.3, (1, 1, c, d)), rng.normal(0, 0.3, (3, 3, 1, d)),
        rng.normal(0, 0.3, (1, 1, d, cout))) for _ in range(units)))
    t = lambda a, dt=torch.float32: torch.from_numpy(       # noqa: E731
        np.asarray(a, np.float32)).to(device).to(dt)
    return (t(np.stack(wds), dtype), t(rng.normal(0, 0.1, (units, d))),
            t(rng.uniform(0.1, 0.5, (units, d))), t(np.stack(wus), dtype),
            t(rng.normal(0, 0.1, (units, cout))),
            t(rng.uniform(0.1, 0.5, (units, cout))))


def _ulp_tol(want, n=1):
    """n bf16 ulps of the output's largest value."""
    return n * 2.0 ** -8 * float(want.float().abs().max())


@pytest.mark.parametrize("c,d,cout,h,w,last_act", [
    (16, 8, 16, 40, 40, "prelu"), (16, 8, 24, 19, 23, "prelu"),
    (128, 64, 128, 16, 16, "relu"), (128, 64, 128, 2, 2, "none")])
def test_cuda_bottleneck_s1_matches_plain(cuda_device, c, d, cout, h, w,
                                          last_act):
    td = torch.bfloat16
    ops = [o[0] for o in _bn_units(5, 1, c, d, cout, td, cuda_device)]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((3, c, h, w)).astype(
        np.float32)).to(cuda_device).to(td)
    r = x if cout == c else torch.from_numpy(rng.standard_normal(
        (3, cout, h, w)).astype(np.float32)).to(cuda_device).to(td)
    if last_act != "prelu":
        ops[5] = None
    got = tbn.bottleneck_s1(x, r, *ops, last_act=last_act)
    want = tbn.bottleneck_s1_plain(x, r, *ops, last_act=last_act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_ulp_tol(want))


@pytest.mark.parametrize("c,d,h,w,units", [(16, 8, 40, 40, 4),
                                           (16, 8, 17, 21, 3),
                                           (64, 32, 32, 32, 4),
                                           (128, 64, 16, 16, 4),
                                           (128, 64, 2, 2, 4)])
def test_cuda_bottleneck_chain_matches_plain(cuda_device, c, d, h, w, units):
    td = torch.bfloat16
    ops = _bn_units(7, units, c, d, c, td, cuda_device)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((3, c, h, w)).astype(
        np.float32)).to(cuda_device).to(td)
    got = tbn.bottleneck_chain(x, *ops, last_act="prelu")
    want = tbn.bottleneck_chain_plain(x, *ops, last_act="prelu")
    torch.cuda.synchronize()
    # A rounding that lands on the neighbouring value in one unit is
    # carried through the units after it: one ulp per unit.
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_ulp_tol(want, units))


@pytest.mark.parametrize("bsz,c,d,cout,h,w,units,last_act,self_res", [
    (5, 128, 64, 128, 2, 2, 1, "prelu", True),    # G > 1, B % G != 0
    (7, 128, 64, 128, 4, 4, 3, "prelu", True),    # G > 1, channels split
    (65, 128, 64, 128, 2, 2, 2, "none", True),    # 9 groups, last of 1
    (2, 16, 8, 16, 128, 128, 2, "prelu", True),   # a 128^2 crop, 128 bands
    (3, 16, 8, 24, 19, 23, 1, "prelu", False),    # C' = 24, ragged band
    (2, 16, 8, 32, 12, 12, 1, "relu", False),     # C' != C, r not x
    (3, 24, 16, 24, 17, 21, 1, "prelu", True),    # C % 16 = 8, odd w
    (4, 32, 16, 32, 64, 64, 4, "prelu", True)])
def test_cuda_bottleneck_bf16_plans_match_plain(cuda_device, bsz, c, d, cout,
                                                h, w, units, last_act,
                                                self_res):
    """The bf16 (tensor-core) route at shapes that stress its launch plan,
    K5 for one unit and K6 for more."""
    ops = _bn_units(11, units, c, d, cout, torch.bfloat16, cuda_device)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((bsz, c, h, w)).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16)
    if units == 1:
        one = [o[0] for o in ops]
        if last_act != "prelu":
            one[5] = None
        r = x if self_res else torch.from_numpy(rng.standard_normal(
            (bsz, cout, h, w)).astype(np.float32)).to(cuda_device).to(
                torch.bfloat16)
        got = tbn.bottleneck_s1(x, r, *one, last_act=last_act)
        want = tbn.bottleneck_s1_plain(x, r, *one, last_act=last_act)
    else:
        got = tbn.bottleneck_chain(x, *ops, last_act=last_act)
        want = tbn.bottleneck_chain_plain(x, *ops, last_act=last_act)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_ulp_tol(want, units))


def test_cuda_bottleneck_bf16_takes_unaligned_views(cuda_device):
    """Operands that are views off 16-byte alignment (a residual at an odd
    element offset, unit 1's biases of a stack with C' = 10) give what the
    plain version gives."""
    ops = _bn_units(13, 2, 16, 8, 10, torch.bfloat16, cuda_device)
    one = [o[1] for o in ops]
    assert one[4].data_ptr() % 16 != 0
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 16, 6, 6)).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16)
    flat = torch.from_numpy(rng.standard_normal(1 + 2 * 10 * 36).astype(
        np.float32)).to(cuda_device).to(torch.bfloat16)
    r = flat[1:].view(2, 10, 6, 6)
    assert r.is_contiguous() and r.data_ptr() % 4 != 0
    got = tbn.bottleneck_s1(x, r, *one)
    want = tbn.bottleneck_s1_plain(x, r, *one)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_ulp_tol(want))


def test_cuda_bottleneck_plans_as_bottleneck_plan(cuda_device):
    """The C entry's bf16 launch plan equals ``bottleneck_plan`` at the
    seven face-mesh stages (B 64 and 65) and K5's extra shape."""
    import ctypes
    lib = tbn._lib()
    shapes = [(b, hw, hw, c, d, c) for b in (64, 65) for hw, c, d in (
        (128, 16, 8), (64, 32, 16), (32, 64, 32), (16, 128, 64),
        (8, 128, 64), (4, 128, 64), (2, 128, 64))]
    for shape in shapes + [(64, 128, 128, 16, 8, 32)]:
        got = (ctypes.c_int * len(tbn.BottleneckPlan._fields))()
        assert lib.bottleneck_plan(*shape, got) == 0
        assert tuple(got) == tuple(tbn.bottleneck_plan(*shape))


def test_cuda_bottleneck_bf16_without_a_plan_raises(cuda_device):
    """A shape the kernel has no launch plan for raises before a launch:
    there is no other route to fall back to."""
    ops = [o[0] for o in _bn_units(2, 1, 12, 8, 12, torch.bfloat16,
                                   cuda_device)]
    x = torch.zeros((1, 12, 6, 6), device=cuda_device, dtype=torch.bfloat16)
    n = tbn.bottleneck_s1.launches
    with pytest.raises(ValueError):
        tbn.bottleneck_s1(x, x, *ops)
    assert tbn.bottleneck_s1.launches == n


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("cout,half,with_alpha", [(24, 56, False),
                                                  (16, 64, True),
                                                  (8, 7, True)])
def test_cuda_stem_packed_matches_plain(cuda_device, cout, half, with_alpha,
                                        dt):
    td = _DT[dt]
    rng = np.random.default_rng(9)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        cuda_device)
    crops = t(rng.uniform(0, 1, (3, 12, half, half))).to(td)
    w = t(rng.normal(0, 0.2, (3, 3, 3, cout))).to(td)
    b = t(rng.normal(0, 0.1, (cout,)))
    alpha = t(rng.uniform(0.05, 0.5, (cout,))) if with_alpha else None
    got = tsk.stem_packed(crops, w, b, alpha)
    want = tsk.stem_packed_plain(crops, w, b, alpha)
    torch.cuda.synchronize()
    # Both take the 27 taps in one order with every multiply and add
    # rounded on its own: equal bit for bit.
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,cin", [(1, 1), (1, 3), (2, 1), (2, 3), (3, 1),
                                   (3, 3)])
@pytest.mark.parametrize("half,cout", [(7, 8), (13, 12), (57, 16),
                                       (128, 24)])
def test_cuda_stem_packed_tiles_match_plain(cuda_device, half, cout, k, cin,
                                            dt):
    """Runs of 8 pixels with a ragged tail (7, 13, 57) or 16-byte rows
    (128), channel tiles of 8 with a partial one (12), every stem width."""
    td = _DT[dt]
    rng = np.random.default_rng(half * 100 + cout + 10 * k + cin)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        cuda_device)
    crops = t(rng.uniform(-1, 1, (2, 4 * cin, half, half))).to(td)
    w = t(rng.normal(0, 0.3, (k, k, cin, cout))).to(td)
    b = t(rng.normal(0, 0.1, (cout,)))
    alpha = t(rng.uniform(0.05, 0.5, (cout,))) if cout % 8 else None
    got = tsk.stem_packed(crops, w, b, alpha)
    want = tsk.stem_packed_plain(crops, w, b, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_cuda_stem_packed_takes_unaligned_views(cuda_device, dt):
    """A crop view one element off 16-byte alignment takes the scalar
    loads and stays bit-equal."""
    td = _DT[dt]
    rng = np.random.default_rng(4)
    n = 2 * 12 * 16 * 16
    flat = torch.from_numpy(rng.uniform(0, 1, n + 1).astype(np.float32)).to(
        cuda_device).to(td)
    crops = flat[1:].view(2, 12, 16, 16)
    assert crops.is_contiguous() and crops.data_ptr() % 16 != 0
    w = torch.from_numpy(rng.normal(0, 0.2, (3, 3, 3, 16)).astype(
        np.float32)).to(cuda_device).to(td)
    b = torch.zeros(16, device=cuda_device)
    got = tsk.stem_packed(crops, w, b)
    want = tsk.stem_packed_plain(crops, w, b)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_cuda_division_by_a_tensor_matches_the_cpu(cuda_device):
    """The port divides by a tensor (IEEE f32) where card and CPU must
    agree: CUDA PyTorch turns a division by a Python scalar into a
    multiplication by its reciprocal.  Held at the detector decode, whose
    boxes and keypoints are one division and one addition per value."""
    from bp_from_video_tpu_torch.models import anchors, detection
    cfg = detection.PALM_DECODE
    anc = torch.from_numpy(anchors.generate_anchors(anchors.PALM))
    rng = np.random.default_rng(2)
    reg = torch.from_numpy(rng.uniform(-200, 200, (2, anc.shape[0], 18)
                                       ).astype(np.float32))
    log = torch.zeros((2, anc.shape[0], 1))
    cpu = detection.decode(cfg, reg, log, anc)
    gpu = detection.decode(cfg, reg.to(cuda_device), log.to(cuda_device),
                           anc.to(cuda_device))
    assert torch.equal(gpu.boxes.cpu(), cpu.boxes)
    assert torch.equal(gpu.kps.cpu(), cpu.kps)


def test_cuda_wrappers_count_each_launch(cuda_device):
    frames, rects = _crop_inputs()
    fr, rois, _ = _roi_inputs()
    x, wmat, wspec, b, _ = _block_case(0, 3, 8, 4, cuda_device)
    ops = _bn_units(1, 2, 16, 8, 16, torch.bfloat16, cuda_device)
    xb = torch.zeros((1, 16, 6, 6), device=cuda_device, dtype=torch.bfloat16)
    fns = (twk.multi_crop, tbk.dense_s2_block, trk.roi_sums, trk.roi_samples,
           tsk.stem_packed, tbn.bottleneck_s1, tbn.bottleneck_chain,
           tps.pf_stem)
    n = [f.launches for f in fns]
    net = _pf_net(cuda_device)
    clip = torch.zeros((1, 8, 128, 128, 3), dtype=torch.bfloat16,
                       device=cuda_device)
    twk.multi_crop(torch.from_numpy(frames).to(cuda_device),
                   torch.from_numpy(rects).to(cuda_device), (8, 8, 8))
    tbk.dense_s2_block(x, wmat, wspec, b, None, cin=3, resid=False)
    trk.roi_sums(torch.from_numpy(fr).to(cuda_device),
                 torch.from_numpy(rois).to(cuda_device))
    trk.roi_samples(torch.from_numpy(fr).to(cuda_device),
                    torch.from_numpy(rois).to(cuda_device),
                    SignalColorChannel.GREEN)
    tsk.stem_packed(x.float(), torch.zeros((3, 3, 3, 8), device=cuda_device),
                    b)
    tbn.bottleneck_s1(xb, xb, *(o[0] for o in ops))
    tbn.bottleneck_chain(xb, *ops)
    tps.pf_stem(clip, *net.stem_k7[0])
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [k + 1 for k in n]
    # A chain launches one kernel per unit but counts one call.
    opb = _bn_units(1, 3, 16, 8, 16, torch.bfloat16, cuda_device)
    tbn.bottleneck_chain(xb, *opb)
    n[fns.index(tbn.bottleneck_chain)] += 1
    assert [f.launches for f in fns] == [k + 1 for k in n]
    # The plain versions launch no kernel and count nothing.
    tbn.bottleneck_chain_plain(xb, *ops)
    tsk.stem_packed_plain(x.float(), torch.zeros((3, 3, 3, 8),
                                                 device=cuda_device), b)
    trk.roi_samples_plain(torch.from_numpy(fr).to(cuda_device),
                          torch.from_numpy(rois).to(cuda_device),
                          SignalColorChannel.GREEN)
    tps.pf_stem_plain(clip, *net.stem[0])
    assert [f.launches for f in fns] == [k + 1 for k in n]
    # A PhysFormer call on the card launches K7 once a stem layer.
    net(clip)
    n[fns.index(tps.pf_stem)] += 3
    assert [f.launches for f in fns] == [k + 1 for k in n]


def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    x, wmat, wspec, b, _ = _block_case(0, 3, 8, 4, cuda_device)
    with pytest.raises(ValueError):           # weights must be bf16
        tbk.dense_s2_block(x, wmat.float(), wspec, b, None, cin=3,
                           resid=False)
    with pytest.raises(ValueError):           # operands on two devices
        tbk.dense_s2_block(x, wmat.cpu(), wspec, b, None, cin=3,
                           resid=False)
    bf16 = torch.bfloat16
    ops = _bn_units(1, 2, 16, 8, 16, bf16, cuda_device)
    xb = torch.zeros((1, 16, 6, 6), device=cuda_device, dtype=bf16)
    with pytest.raises(ValueError):           # operands on two devices
        tbn.bottleneck_chain(xb, ops[0].cpu(), *ops[1:])
    # K5/K6 take bf16 x, residual and weights alone: float32, or bf16 x
    # with float32 weights, raises before a launch.
    opf = _bn_units(1, 2, 16, 8, 16, torch.float32, cuda_device)
    n = (tbn.bottleneck_s1.launches, tbn.bottleneck_chain.launches)
    for x_, w_ in ((xb.float(), opf), (xb, opf)):
        with pytest.raises(ValueError, match="bfloat16 alone"):
            tbn.bottleneck_s1(x_, x_, *(o[0] for o in w_))
        with pytest.raises(ValueError, match="bfloat16 alone"):
            tbn.bottleneck_chain(x_, *w_)
    assert (tbn.bottleneck_s1.launches, tbn.bottleneck_chain.launches) == n
    with pytest.raises(ValueError):           # more taps than the kernel holds
        tsk.stem_packed(torch.zeros((1, 16, 4, 4), device=cuda_device),
                        torch.zeros((3, 3, 4, 8), device=cuda_device),
                        torch.zeros(8, device=cuda_device))
    with pytest.raises(ValueError):           # a frame under 2x2 pixels
        twk.multi_crop(torch.zeros((1, 3, 1, 8), dtype=torch.uint8,
                                   device=cuda_device),
                       torch.zeros((1, 1, 4), device=cuda_device), (4,))


@pytest.mark.parametrize("case", ["float32 x", "non-contiguous x",
                                  "another frame", "weights on the CPU"])
def test_cuda_pf_stem_rejects_what_the_kernel_does_not_take(cuda_device,
                                                           case):
    net = _pf_net(cuda_device)
    x = torch.zeros((1, 2, 128, 128, 3), dtype=torch.bfloat16,
                    device=cuda_device)
    wk, bk = net.stem_k7[0]
    if case == "float32 x":
        x = x.float()
    elif case == "non-contiguous x":
        x = torch.zeros((1, 2, 128, 128, 4), dtype=torch.bfloat16,
                        device=cuda_device)[..., :3]
    elif case == "another frame":
        x = x[:, :, :96, :96].contiguous()
    else:
        wk = wk.cpu()
    with pytest.raises(ValueError):
        tps.pf_stem(x, wk, bk)


def _pf_net(device, layers=1, frames=8):
    """The published PhysFormer at crop 128 in bf16 with K7's weights."""
    cfg = PhysFormerConfig(num_layers=layers, clip_frames=frames, hop=frames)
    return tpf.PhysFormer(cfg, tpf.init_params(cfg, 3), torch.bfloat16,
                          device, use_kernel=True)


def _pf_ulp(want) -> float:
    """One bf16 ulp of the largest |value|."""
    return 2.0 ** (math.floor(math.log2(float(want.float().abs().max()))) - 7)


@pytest.mark.parametrize("layer", [0, 1, 2])
@pytest.mark.parametrize("bsz,t", [(3, 5), (1, 1), (2, 41)])
def test_cuda_pf_stem_matches_plain(cuda_device, layer, bsz, t):
    """Each stem layer at its published widths: odd batches, clips of one
    frame (both taps past the ends), of 5, and of 41 (a unit of 40 frames
    and one more): within one bf16 ulp of the largest output of the plain
    layer, which rounds the conv to bf16 before the bias where K7 rounds
    once."""
    net = _pf_net(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(bsz * 100 + t)
    x = torch.randn((bsz, t, 128, 128, 3), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    for w, b in net.stem[:layer]:
        x = tps.pf_stem_plain(x, w, b)
    want = tps.pf_stem_plain(x, *net.stem[layer])
    got = tps.pf_stem(x, *net.stem_k7[layer])
    gemm = tps.pf_stem_gemm(x, *net.stem_k7[layer])
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(
        got.float()).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=_pf_ulp(want))
    # Against the same products summed in f32 in another order: the same
    # bf16 value but where the sums straddle a rounding boundary.
    torch.testing.assert_close(got.float(), gemm.float(), rtol=0,
                               atol=_pf_ulp(gemm))
    assert float((got != gemm).float().mean()) < 1e-3


def test_cuda_physformer_on_k7_is_within_bf16_rounding(cuda_device):
    """PhysFormer with its stem on K7 against the published net in f32 (TF32
    off), as the CPU's bf16 test holds the plain net: the largest gap
    within 3 % of the largest output."""
    cfg = PhysFormerConfig(num_layers=2, clip_frames=32, hop=32)
    params = tpf.init_params(cfg, 4)
    net = tpf.PhysFormer(cfg, params, torch.bfloat16, cuda_device,
                         use_kernel=True)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = tpf_ref.standardise(torch.rand((2, 32, 128, 128, 3), generator=g,
                                       device=cuda_device))
    n = tps.pf_stem.launches
    got = net(x.to(torch.bfloat16))
    assert tps.pf_stem.launches == n + 3
    want = tpf_ref.forward(map_leaves(lambda a: a.to(cuda_device), params),
                           x.permute(0, 4, 1, 2, 3), cfg.num_heads,
                           cfg.theta, cfg.gra_sharp)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) < 0.03


@pytest.mark.parametrize("bsz,t,seed", [(64, 160, 11), (64, 160, 12),
                                        (63, 160, 13), (61, 157, 14)])
def test_cuda_pf_stem_at_the_cell_shape_matches_plain(cuda_device, bsz, t,
                                                      seed):
    """The three layers at the ``physformer.chunk160`` cell's 64 clips of
    160 frames, on other seeds, and on 63 and 61 clips (and 157 frames: a
    short last unit) so that each block of the persistent grid walks other
    units, bands and column slices: every output within one bf16 ulp of the
    plain layer's largest."""
    net = _pf_net(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    x = torch.randn((bsz, t, 128, 128, 3), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    for layer in range(3):
        want = tps.pf_stem_plain(x, *net.stem[layer])
        got = tps.pf_stem(x, *net.stem_k7[layer])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=_pf_ulp(want))
        x = want
        del got


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_physformer_engine_takes_k7_for_bf16_alone(cuda_device, dtype):
    """``physformer_config`` on the card with ``use_pallas``: a bf16 engine
    runs its stem on K7 (three launches a call), a float32 one keeps the
    plain stem (K7 takes bf16 alone; the route is chosen when the net is
    built), and both give the published net's BVP of the crops in the clip
    ring: float32 within 1e-4, bf16 within the bf16 test's 3 %."""
    import dataclasses

    from bp_from_video_tpu_torch.config import physformer_config
    from bp_from_video_tpu_torch.models.runner import _seed
    from bp_from_video_tpu_torch.runtime.engine import Engine
    net = PhysFormerConfig(num_layers=1, clip_frames=8, hop=8)
    cfg = physformer_config(2, 96, 128, net)
    no_files = dict(face_detector_path=None, face_landmarker_path=None,
                    hand_landmarker_path=None, person_segmenter_path=None,
                    hand_lm_standin_path=None, palm_det_standin_path=None,
                    seg_standin_path=None)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype,
                              inference=dataclasses.replace(cfg.inference,
                                                            **no_files))
    assert cfg.inference.use_pallas
    eng = Engine(cfg, device=cuda_device)
    assert (eng.rppg.stem_k7 is not None) == (dtype == "bfloat16")
    st = eng.init_state()
    rect = torch.tensor([[64.0, 48.0, 60.0, 60.0, 0.0],
                         [60.0, 44.0, 56.0, 48.0, 0.3]], device=cuda_device)
    st = st._replace(track=st.track._replace(
        face_rect=rect, face_tracking=torch.ones(2, dtype=torch.bool,
                                                 device=cuda_device)))
    g = torch.Generator(device=cuda_device).manual_seed(6)
    frames = torch.randint(0, 256, (8, 2, 3, 96, 128), dtype=torch.uint8,
                           generator=g, device=cuda_device)
    ts = ((torch.arange(8, dtype=torch.float32, device=cuda_device) + 1)
          / 30.0)[:, None].repeat(1, 2)
    n = tps.pf_stem.launches
    st, _ = eng.batch_step_lagged(eng.params, st, frames, ts)
    torch.cuda.synchronize()
    assert tps.pf_stem.launches == n + (3 if dtype == "bfloat16" else 0)
    params = map_leaves(lambda a: a.to(cuda_device),
                        tpf.init_params(net, _seed("rppg")))
    want = tpf_ref.forward(params, tpf_ref.standardise(
        st.clip.ordered().float()).permute(0, 4, 1, 2, 3), net.num_heads,
        net.theta, net.gra_sharp)
    got = st.signals.raw_y[:, 0]
    assert bool(torch.isfinite(got).all())
    tol = 1e-4 if dtype == "float32" else 0.03
    assert float((got - want).abs().max() / want.abs().max()) < tol


def _clip_ring(device, s, t, c, seed):
    """A bf16 ring of ``s`` streams of ``t`` crops of c x c x 3 values
    k / 255 as K1 writes them, each stream at a level and contrast of its
    own, heads rotated, the spare slot T NaN (never to be read)."""
    g = torch.Generator(device=device).manual_seed(seed)
    u8 = torch.randint(0, 256, (s, t + 1, c, c, 3), dtype=torch.uint8,
                       generator=g, device=device)
    keep = torch.randint(16, 256, (s, 1, 1, 1, 1), generator=g,
                         device=device)
    crops = ((u8 * keep // 255 + torch.randint(0, 256 - 16, (s, 1, 1, 1, 1),
                                               generator=g, device=device))
             .clamp_(max=255).to(torch.bfloat16) / 255.0)
    crops[:, t] = float("nan")
    head = torch.randint(0, t, (s,), generator=g, device=device)
    return crops, head


def _std_tol(want):
    """One bf16 ulp of each plain value, counting |values| under 2^-6 as
    2^-6: the two routes sum the f32 statistics in other orders, which
    moves a value by ~1e-6, more than a bf16 ulp only that close to 0."""
    mag = want.float().abs().clamp_min(2.0 ** -6)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.parametrize("s,t,c,rows,seed", [
    (64, 160, 128, None, 21),           # physformer.chunk160
    (4, 160, 128, [2], 22),              # B = 1
    (5, 160, 128, [4, 0, 2], 23),        # B = 3
    (11, 160, 128, [9, 1, 3, 4, 6, 7, 10, 0], 24),   # B = 8
    (3, 7, 4, [2, 0], 25),              # frames of 48 values (16-byte loads)
    (5, 9, 6, None, 26),                # frames of 108 values (one a load)
])
def test_cuda_clip_standardise_matches_plain(cuda_device, s, t, c, rows,
                                             seed):
    """K8 against the plain route (gather, f32 standardisation) on rings
    with rotated heads and a NaN spare slot, every stream or a subset of
    rows: every element within one bf16 ulp of the plain's value there
    (``_std_tol``), few elements apart at all, none of the spare slot
    read."""
    crops, head = _clip_ring(cuda_device, s, t, c, seed)
    r = None if rows is None else torch.tensor(rows, device=cuda_device)
    want = tcs.clip_standardise_plain(crops, head, r)
    got = tcs.clip_standardise(crops, head, r)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous() and bool(torch.isfinite(got.float()).all())
    gap = (got.float() - want.float()).abs()
    assert int((gap > _std_tol(want)).sum()) == 0, float(gap.max())
    assert float((got != want).float().mean()) < 1e-2


def test_cuda_clip_standardise_is_deterministic_and_zero_on_a_flat_clip(
        cuda_device):
    """A constant clip gives exact zeros; two launches on the same ring give
    the same bits (no atomics in K8's statistics)."""
    crops, head = _clip_ring(cuda_device, 8, 160, 128, 27)
    crops[3, :160] = 0.5
    rows = torch.tensor([3, 5, 0, 7], device=cuda_device)
    a = tcs.clip_standardise(crops, head, rows)
    b = tcs.clip_standardise(crops, head, rows)
    full = tcs.clip_standardise(crops, head)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert not bool(a[0].any()) and not bool(full[3].any())


@pytest.mark.parametrize("case", ["float32 ring", "ring on the CPU",
                                  "head on the CPU", "int32 rows"])
def test_cuda_clip_standardise_rejects_what_the_kernel_does_not_take(
        cuda_device, case):
    crops, head = _clip_ring(cuda_device, 2, 8, 8, 28)
    rows = None
    if case == "float32 ring":
        crops = crops.float()
    elif case == "ring on the CPU":
        crops = crops.cpu()
    elif case == "head on the CPU":
        head = head.cpu()
    else:
        rows = torch.tensor([1], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        tcs.clip_standardise(crops, head, rows)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_physformer_engine_takes_k8_for_bf16_alone(cuda_device, dtype):
    """``physformer_config`` on the card with ``use_pallas``: a bf16 engine
    binds K8 when it is built and launches it twice a call in which clips
    fall due (``clip_std.launches``); a float32 one binds the plain route
    and launches none."""
    import dataclasses

    from bp_from_video_tpu_torch.config import physformer_config
    from bp_from_video_tpu_torch.runtime.engine import Engine
    from bp_from_video_tpu_torch.utils import profiling
    net = PhysFormerConfig(num_layers=1, clip_frames=8, hop=8)
    cfg = physformer_config(2, 96, 128, net)
    no_files = dict(face_detector_path=None, face_landmarker_path=None,
                    hand_landmarker_path=None, person_segmenter_path=None,
                    hand_lm_standin_path=None, palm_det_standin_path=None,
                    seg_standin_path=None)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype,
                              inference=dataclasses.replace(cfg.inference,
                                                            **no_files))
    eng = Engine(cfg, device=cuda_device)
    bf16 = dtype == "bfloat16"
    assert eng.standardise_clips is (tcs.clip_standardise if bf16 else
                                     tcs.clip_standardise_plain)
    st = eng.init_state()
    rect = torch.tensor([[64.0, 48.0, 60.0, 60.0, 0.0],
                         [60.0, 44.0, 56.0, 48.0, 0.3]], device=cuda_device)
    st = st._replace(track=st.track._replace(
        face_rect=rect, face_tracking=torch.ones(2, dtype=torch.bool,
                                                 device=cuda_device)))
    g = torch.Generator(device=cuda_device).manual_seed(6)
    frames = torch.randint(0, 256, (8, 2, 3, 96, 128), dtype=torch.uint8,
                           generator=g, device=cuda_device)
    ts = ((torch.arange(8, dtype=torch.float32, device=cuda_device) + 1)
          / 30.0)[:, None].repeat(1, 2)
    counts = profiling.profiler.counts
    n, runs = counts.get("clip_std.launches", 0), counts.get("clip.runs", 0)
    st, _ = eng.batch_step_lagged(eng.params, st, frames, ts)
    torch.cuda.synchronize()
    assert counts.get("clip.runs", 0) == runs + 2
    assert counts.get("clip_std.launches", 0) == n + (2 if bf16 else 0)
    assert bool(torch.isfinite(st.signals.raw_y[:, 0]).all())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_mesh_graph_takes_k5_k6_for_bf16_alone(cuda_device, dtype):
    """A face mesh compiled with ``fuse_bn`` on the card: a bf16 graph runs
    its lone unit on K5 and its chains on K6, a float32 one launches
    neither (K5/K6 take bf16 alone; the plain units are bound when the
    graph compiles) and gives the CPU graph's outputs: landmarks within
    1 px, as the packed path's test holds them, the scores within 2^-8."""
    from bp_from_video_tpu_torch.models import mesh_graph
    from bp_from_video_tpu_torch.models import tflite_compiler as ttc
    graph = mesh_graph.face_mesh_graph(5, 64, ((16, 8), (32, 16), (64, 32)),
                                       (1, 4, 4))
    x = torch.rand((4, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    kw = dict(layout="NCHW", fuse_bn=True, fuse_bn_min_hw=0,
              batch_flexible=True)
    fn, p = ttc.compile_graph(graph, _DT[dtype], device=cuda_device, **kw)
    ops = [op.opcode for op in fn.graph.ops]
    units = (ops.count("PALLAS_BN"), ops.count("PALLAS_BN_CHAIN"))
    assert units == (1, 2)
    n = (tbn.bottleneck_s1.launches, tbn.bottleneck_chain.launches)
    got = fn(p, x.to(cuda_device))
    torch.cuda.synchronize()
    ran = (tbn.bottleneck_s1.launches - n[0],
           tbn.bottleneck_chain.launches - n[1])
    assert ran == (units if dtype == "bfloat16" else (0, 0))
    if dtype == "float32":
        cpu_fn, cpu_p = ttc.compile_graph(graph, torch.float32, device="cpu",
                                          **kw)
        want = cpu_fn(cpu_p, x)
        assert float((got[0].cpu() - want[0]).abs().max()) <= 1.0
        for g, w in zip(got[1:], want[1:]):
            assert float((g.cpu() - w).abs().max()) <= 2.0 ** -8


def test_cuda_chain_and_welch_timestamps_do_not_depend_on_tf32(cuda_device):
    """The ``segmenter_fir`` chain (cubic interpolation, linear detrend,
    FIR) and Welch on the card with TF32 matmuls allowed and then not:
    the interpolation grid, the timestamps its brackets select and the
    Welch frequencies are equal in both runs (selection is a gather, the
    grid elementwise), and the chain's values stay finite where valid."""
    from bp_from_video_tpu_torch.config import (SignalConfig,
                                                SignalProcessingMethod as M,
                                                SignalSpectrumTransform as T)
    from bp_from_video_tpu_torch.ops import chain, spectrum
    from bp_from_video_tpu_torch.ops import signal as sig
    rng = np.random.default_rng(14)
    s, n = 8, 250
    # Seconds since start near a minute, where a TF32 product of a
    # timestamp would be off by more than a frame.
    t = 60.0 + (np.arange(n) + rng.uniform(-0.2, 0.2, (s, n))) / 30.0
    y = 120 + 3 * np.sin(2 * np.pi * 1.2 * t) + rng.normal(0, 0.5, (s, n))
    y[:, [7, 8, 100, 200]] = np.nan
    x = torch.from_numpy(t.astype(np.float32)).to(cuda_device)
    yy = torch.from_numpy(y.astype(np.float32)).to(cuda_device)
    cfg = SignalConfig(processing_methods=(M.INTERP_CUBIC, M.DETREND_LINEAR,
                                           M.FILTER_FIR),
                       spectrum_transform=T.PGRAM_WELCH)
    st = chain.ChainState(x, yy, sig.valid_y(yy), sig.valid_x(x),
                          sig.mean_fs(x))
    runs = []
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            grid, _, _ = chain._block_grid(st)
            cx = sig.compact(st.valid, st.x)
            m, x0s, x1s = sig.bracket_matrix(cx.values, cx.count, grid)
            sel = sig.select_rows(m)
            px, py = chain.process_signal(cfg, x, yy)
            sx, sy = spectrum.transform_signal(cfg, px, py)
            runs.append((grid, sig.selmm(sel, sig.zero_infs(x0s)),
                         sig.selmm(sel, sig.zero_infs(x1s)), px, sx, py))
            torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(runs[0][:5], runs[1][:5]):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    # The selected bracket ends are ring timestamps, exactly.
    sel = runs[1][1]
    has = sel != 0
    assert bool(torch.isin(sel[has], x).all())
    assert bool(torch.isfinite(runs[1][5]).all())


def test_cuda_device_feeder_matches_cpu(cuda_device):
    """The feeder on the card (pinned host buffers filled in turn, copies
    without a host wait, each buffer refilled only after its copy's event)
    gives the batches it gives on the CPU: two streams released a frame at a
    time, the second skipping every third batch from the third on (it
    keeps its last frame).
    Every batch is kept on the card until the end, so a refilled buffer
    that tore an earlier batch would show."""
    import threading
    import time

    from bp_from_video_tpu_torch.exceptions import CaptureError
    from bp_from_video_tpu_torch.runtime.capture import FrameData
    from bp_from_video_tpu_torch.runtime.feeder import DeviceFeeder

    h, w, n = 48, 64, 12
    frames = np.random.default_rng(3).integers(0, 256, (2, n, h, w, 3),
                                               dtype=np.uint8)

    class Paced:
        def __init__(self, f):
            self.f, self.i, self.gate = f, 0, threading.Semaphore(0)

        def read_frame(self):
            if self.i == len(self.f):
                raise CaptureError("eof")
            if not self.gate.acquire(timeout=10.0):
                raise TimeoutError("never released")
            self.i += 1
            return FrameData(self.f[self.i - 1], self.i / 30.0, 30.0, False)

        def cleanup(self):
            pass

    out = {}
    for dev in ("cuda", "cpu"):
        readers = [Paced(frames[0]), Paced(frames[1])]
        feeder = DeviceFeeder(readers, (h, w, 3), device=dev)
        got, want = [], [0, 0]
        try:
            for k in range(n):
                for i, go in enumerate((True, k % 3 != 2)):
                    if go:
                        readers[i].gate.release()
                        want[i] += 1
                deadline = time.time() + 10.0
                while any(f.slot.latest_seq() < c
                          for f, c in zip(feeder.feeds, want)):
                    assert time.time() < deadline
                    time.sleep(0.001)
                got.append(feeder.get_batch())
        finally:
            feeder.cleanup()
        if dev == "cuda":
            assert all(t.is_cuda for t in got[0])
            assert all(b.frames.is_pinned() and b.ts.is_pinned()
                       for b in feeder._bufs)
        out[dev] = [[t.cpu() for t in b] for b in got]
    for a, b in zip(out["cuda"], out["cpu"]):
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    # Batch 2 repeats stream 1's frame of batch 1; channels flipped to RGB.
    torch.testing.assert_close(out["cpu"][2][0][1], out["cpu"][1][0][1])
    torch.testing.assert_close(out["cpu"][1][0][0], torch.from_numpy(
        frames[0, 1]).permute(2, 0, 1).flip(0))


@pytest.mark.parametrize("kind", ["shear-fft", "shear-dft", "exact"])
def test_cuda_rotated_crops_match_cpu(cuda_device, kind):
    """The rotated crops of 8 rects (quarter turns and an off-frame rect
    among them) on the card against the CPU, 0-255 pixels, within 1e-2:
    the card contracts the grid's coordinate products into FMAs, which
    moves a coordinate near 160 px by an f32 ulp (1.5e-5 px), and a sample
    by up to 255 times that; cuFFT and the matmuls sum in another order
    (measured on the H100: 3.6e-3 for all three kinds)."""
    from bp_from_video_tpu_torch.models import warp
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.uniform(0, 255, (8, 120, 160, 3))
                              .astype(np.float32))
    deg = np.array([0, 25, -40, 90, 135, 180, -170, 35], np.float32)
    rects = np.stack([np.full(8, 80.0), np.full(8, 60.0), np.full(8, 64.0),
                      np.full(8, 64.0), np.deg2rad(deg)], -1
                     ).astype(np.float32)
    rects[-1, :2] = (10.0, 110.0)
    r = torch.from_numpy(rects)

    def crop(f, rr):
        if kind == "exact":
            return warp.crop_rect(f, warp.arr_rect(rr), 48,
                                  exact_rotation=True)
        return warp.crop_rect_shear(f, warp.arr_rect(rr), 48,
                                    method=kind.split("-")[1])
    got = crop(frames.to(cuda_device), r.to(cuda_device))
    want = crop(frames, r)
    torch.cuda.synchronize()
    assert float((got.cpu() - want).abs().max()) <= 1e-2


def _gate_runner(device, mode, subbatch=8, lost=()):
    """A runner of 2 streams at 96x128 on the K1 path, both landmarkers
    tracking (one stream tilted), except the streams in ``lost``; its
    start state and frames."""
    from bp_from_video_tpu_torch.config import InferenceConfig, RunningMode
    from bp_from_video_tpu_torch.models.runner import InferenceRunner
    cfg = InferenceConfig(
        face_landmarker=True, hand_landmarker=True,
        running_mode=RunningMode.VIDEO, use_pallas=True,
        fused_stem=True, fused_trunk=True, rotation_mode=mode,
        detector_subbatch=subbatch,
        face_detector_path=None, face_landmarker_path=None,
        hand_landmarker_path=None, person_segmenter_path=None,
        hand_lm_standin_path=None, palm_det_standin_path=None,
        seg_standin_path=None)
    run = InferenceRunner(cfg, 96, 128, device=device)
    face = torch.tensor([[64.0, 48.0, 48.0, 48.0, 0.0],
                         [64.0, 48.0, 48.0, 48.0, 0.5]], device=device)
    ok = torch.ones(2, dtype=torch.bool, device=device)
    ok[list(lost)] = False
    st = run.init_state(2)._replace(
        face_rect=face, face_tracking=ok,
        hand_rects=face[:, None].expand(2, 2, 5).clone(),
        hand_tracking=ok[:, None].expand(2, 2).clone())
    frames = torch.randint(0, 256, (2, 3, 96, 128), dtype=torch.uint8,
                           device=device)
    return run, st, frames


def _syncs(fn) -> int:
    """Host syncs ``fn()`` makes, as CUDA sync debug mode reports them."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def test_cuda_hybrid_gate_syncs_once_a_step(cuda_device):
    """``hybrid`` on the K1 path with one tilted stream (the shear
    sub-batch) reads its gate in one host sync a step: one more than
    ``cover`` on the same step, and K1 launches once."""
    def syncs(mode):
        run, st, frames = _gate_runner(cuda_device, mode)
        run.predict_batch(run.params, st, frames)        # warm: builds
        torch.cuda.synchronize()
        n = twk.multi_crop.launches
        got = _syncs(lambda: run.predict_batch(run.params, st, frames))
        assert twk.multi_crop.launches == n + 1
        return got
    assert syncs("hybrid") == syncs("cover") + 1


@pytest.mark.parametrize("mode", ["cover", "hybrid"])
@pytest.mark.parametrize("subbatch", [1, 0], ids=["subbatch1", "whole"])
@pytest.mark.parametrize("lost", [(), (1,)], ids=["tracked", "one-lost"])
def test_cuda_gate_counters_count_every_sync(cuda_device, mode, subbatch,
                                             lost):
    """Every host sync of a runner call is a gate's, and each is counted:
    the ``sync.*`` counters advance by the syncs CUDA sees (two gates,
    the hybrid gate's read besides), detectors running or not."""
    from bp_from_video_tpu_torch.utils import profiling
    run, st, frames = _gate_runner(cuda_device, mode, subbatch, lost)
    run.predict_batch(run.params, st, frames)            # warm: builds
    before = dict(profiling.profiler.counts)
    got = _syncs(lambda: run.predict_batch(run.params, st, frames))
    counted = sum(v - before.get(k, 0)
                  for k, v in profiling.profiler.counts.items()
                  if k.startswith("sync."))
    assert got == counted == (3 if mode == "hybrid" else 2)


# -- compiled detectors and segmenter, the packed path (card against CPU) ----


def _compiled_pair(graph, device, **kw):
    """One numpy-built graph compiled f32 for the card and for the CPU."""
    from bp_from_video_tpu_torch.models import tflite_compiler as ttc
    kw = dict(layout="NCHW", planar_inputs=True, batch_flexible=True, **kw)
    return (ttc.compile_graph(graph, device=device, **kw),
            ttc.compile_graph(graph, device="cpu", **kw))


def _hold_outputs(got, want, tol=1e-4):
    for g, w in zip(got, want):
        g = g.float().cpu()
        assert g.shape == w.shape
        assert float((g - w.float()).abs().max()) <= tol * float(
            w.float().abs().max()) + 1e-6


@pytest.mark.parametrize("passes", [{}, dict(fuse_dw_pw=True, pack_s2d=32)],
                         ids=["plain", "fuse_dw_pw-pack_s2d"])
@pytest.mark.parametrize("net", ["face_det", "palm_det", "seg"])
def test_cuda_compiled_detector_and_segmenter_match_cpu(cuda_device, net,
                                                        passes):
    """The numpy-built detectors and segmenter compiled for the card (cuDNN
    convolutions, the graph passes' packed ops) against the same graphs on
    the CPU: f32 outputs within 1e-4 of their scale."""
    from bp_from_video_tpu_torch.models import twin_graphs as tg
    graph = {"face_det": lambda: tg.detector_graph(1, 128, (2, 6), 6),
             "palm_det": lambda: tg.detector_graph(2, 192, (2, 6), 7),
             "seg": lambda: tg.segmenter_graph(3, 256, 6)}[net]()
    (fa, pa), (fb, pb) = _compiled_pair(graph, cuda_device, **passes)
    n, h, w, c = fa.input_shapes[0]
    x = torch.rand((3, c, h, w), generator=torch.Generator().manual_seed(1))
    _hold_outputs(fa(pa, x.to(cuda_device)), fb(pb, x))


def _runner_landmarks(device, infer, graphs, frames, track):
    from bp_from_video_tpu_torch.config import InferenceConfig
    from bp_from_video_tpu_torch.kernels import warp as twk_
    from bp_from_video_tpu_torch.models.runner import InferenceRunner
    r = InferenceRunner(InferenceConfig(**infer), 96, 128, device=device,
                        graphs=graphs() if graphs else None)
    st = r.init_state(frames.shape[0])._replace(
        **{k: v.to(device) for k, v in track.items()})
    twk_.multi_crop.launches = 0
    _, res = r.predict_batch(r.params, st, frames.to(device))
    return res, twk_.multi_crop.launches, r


@pytest.mark.parametrize("mesh", [False, True], ids=["standins", "mesh"])
def test_cuda_packed_path_matches_cpu(cuda_device, mesh):
    """3m's path (the fused stem and trunk off, ``fuse_dw_pw``,
    ``pack_s2d``): K1 packs the crops on the card (one launch) for the
    stand-ins' packed stems or the packed-input mesh graph; landmarks
    within 1 px of the CPU's, compiled detectors and segmenter included."""
    from bp_from_video_tpu_torch.models import mesh_graph, twin_graphs as tg

    def graphs():
        g = {"seg": tg.segmenter_graph(3, 256, 6),
             "palm_det": tg.detector_graph(2, 192, (2, 6), 7)}
        if mesh:
            g["flm_lm"] = mesh_graph.face_mesh_graph(
                5, 64, ((16, 8), (32, 16), (64, 32)))
        return g
    infer = dict(use_pallas=True, fused_stem=False, fused_trunk=False,
                 fuse_dw_pw=True, pack_s2d=16, person_segmenter=True,
                 hand_lm_standin_path=None, palm_det_standin_path=None)
    s = 2
    frames = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (s, 3, 96, 128), dtype=np.uint8))
    track = dict(
        face_rect=torch.tensor([[64., 40, 56, 56, 0]] * s),
        face_tracking=torch.ones(s, dtype=torch.bool),
        hand_rects=torch.tensor([[[30., 72, 40, 40, 0],
                                  [98, 72, 40, 40, 0]]] * s),
        hand_tracking=torch.ones((s, 2), dtype=torch.bool))
    a, k1, run = _runner_landmarks(cuda_device, infer, graphs, frames, track)
    b, _, _ = _runner_landmarks("cpu", infer, graphs, frames, track)
    assert k1 == 1 and run._packed_in == {"flm_lm": True, "hand_lm": True}
    for det in ("face_landmarker", "hand_landmarker"):
        pa = getattr(a, det).points.cpu()
        pb = getattr(b, det).points
        assert torch.equal(pa.isnan(), pb.isnan())
        assert float((pa - pb).abs().nan_to_num(0).max()) <= 1.0
    d = (a.seg_conf.cpu() - b.seg_conf).abs()
    assert float((d > 1e-4).float().mean()) <= 1e-3
    assert float(d.max()) <= 2.0 ** -8


# -- the signal half's analysis replayed as a CUDA graph ----------------------


def _flagship_engine(device, s=64):
    """The flagship engine (stand-in nets) of ``s`` streams, every stream
    tracking a face and two hands from the start, with NaN rings; its
    state and a looped clip of 24 pulsing 480x640 frames."""
    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.runtime.engine import Engine
    eng = Engine(flagship_config(s), device=device)
    st = eng.init_state(s)
    k = 480 / 96.0
    on = torch.ones(s, dtype=torch.bool, device=device)
    face = torch.tensor([64 * k, 40 * k, 56 * k, 56 * k, 0.0], device=device)
    hands = torch.tensor([[30 * k, 72 * k, 40 * k, 40 * k, 0.0],
                          [98 * k, 72 * k, 40 * k, 40 * k, 0.0]],
                         device=device)
    st = st._replace(track=st.track._replace(
        face_rect=face.expand(s, 5).clone(), face_tracking=on,
        hand_rects=hands.expand(s, 2, 5).clone(),
        hand_tracking=on[:, None].expand(s, 2).clone()))
    gen = torch.Generator(device=device).manual_seed(5)
    base = torch.randint(60, 180, (s, 3, 60, 80), generator=gen,
                         device=device).float()
    base = base.repeat_interleave(8, 2).repeat_interleave(8, 3)
    clip = []
    for i in range(24):
        f = base.clone()
        f[:, 1] += 6.0 * math.sin(2 * math.pi * 1.2 * i / 30.0)
        clip.append(torch.clamp(f.round(), 0, 255).to(torch.uint8))
    return eng, st, torch.stack(clip)


def _call_timestamps(s, call, device, f=1):
    """[f, S] timestamps of call ``call``: 30 fps, except stream 3 stale
    on odd calls (its last frame's timestamp the ring's tail: not fresh)
    and stream 7's last frame NaN on every third call."""
    n = torch.arange(call * f, call * f + f, dtype=torch.float32,
                     device=device)
    ts = ((n + 1) / 30.0)[:, None].expand(f, s).clone()
    if call % 2 == 1:
        ts[:, 3] = call * f / 30.0
    if call % 3 == 2:
        ts[-1, 7] = float("nan")
    return ts


def _same_bits(a, b):
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _analysis_args(st, ts, fresh):
    return (st.raw_x, st.raw_y, st.bpm_x, st.bpm_y, st.ptt_x, st.ptt_y, ts,
            fresh)


def _checked_analysis(eng):
    """Wraps ``eng.signal_analyze``: each call also runs the eager
    analysis on the same inputs first and records whether every output
    is bit-equal; returns that record."""
    real, record = eng.signal_analyze, []

    def wrapped(st, rois, models, ts, fresh):
        want = eng._analyze(*_analysis_args(st, ts, fresh))
        new, out = real(st, rois, models, ts, fresh)
        got = tuple(new[4:]) + tuple(out[4:])
        record.append([_same_bits(g, w) for g, w in zip(got, want)])
        return new, out
    eng.signal_analyze = wrapped
    return record


def _graph_counts():
    from bp_from_video_tpu_torch.utils import profiling
    c = profiling.profiler.counts
    return (c.get("signal_graph.captures", 0),
            c.get("signal_graph.replays", 0))


def test_cuda_signal_graph_replays_bit_equal_over_batch_steps(cuda_device):
    """Ten ``batch_step``s of the 64-stream flagship from NaN rings, with
    stale and NaN timestamps: the first call eager, the second captures,
    every replay bit-equal to the eager analysis on the same inputs."""
    eng, state, clip = _flagship_engine(cuda_device)
    record = _checked_analysis(eng)
    c0, r0 = _graph_counts()
    for call in range(10):
        ts = _call_timestamps(64, call, cuda_device)[0]
        state, out = eng.batch_step(eng.params, state, clip[call], ts)
    c1, r1 = _graph_counts()
    assert (c1 - c0, r1 - r0) == (1, 9)
    assert all(all(r) for r in record), record
    assert torch.isfinite(out.proc_y).any() and torch.isfinite(out.bpm).any()


def test_cuda_signal_graph_replays_bit_equal_over_lagged_steps(cuda_device):
    """The same over four ``batch_step_lagged`` calls of F = 4."""
    eng, state, clip = _flagship_engine(cuda_device)
    record = _checked_analysis(eng)
    c0, r0 = _graph_counts()
    for call in range(4):
        ts = _call_timestamps(64, call, cuda_device, f=4)
        state, out = eng.batch_step_lagged(eng.params, state,
                                           clip[4 * call:4 * call + 4], ts)
    c1, r1 = _graph_counts()
    assert (c1 - c0, r1 - r0) == (1, 3)
    assert all(all(r) for r in record), record


def _pulse_rings(eng, s, call, device):
    """A signal state whose raw rings hold a 1.2 Hz pulse plus noise up
    to ``call``, its peak rings NaN, and its analysis's timestamps and
    fresh mask (stream 1 stale)."""
    st = eng.init_signal_state(s)
    n = st.raw_x.shape[-1]
    t = (torch.arange(n, dtype=torch.float32, device=device) + call) / 30.0
    gen = torch.Generator(device=device).manual_seed(call)
    raw_y = (torch.sin(2 * math.pi * 1.2 * t) * 3.0
             + torch.randn((s,) + st.raw_y.shape[1:], generator=gen,
                           device=device))
    st = st._replace(raw_x=t.expand(s, n).contiguous(), raw_y=raw_y)
    fresh = torch.ones(s, dtype=torch.bool, device=device)
    fresh[1] = False
    return st, st.raw_x[:, -1].clone(), fresh


def test_cuda_signal_graph_single_stream_step_has_its_own(cuda_device):
    """``Engine.step`` (S = 1) captures a graph of its own beside the
    64-stream one, and its replays are bit-equal too."""
    eng, state, clip = _flagship_engine(cuda_device)
    for call in range(2):
        st, ts, fresh = _pulse_rings(eng, 64, call, cuda_device)
        eng.signal_analyze(st, None, None, ts, fresh)
    record = _checked_analysis(eng)
    one = map_leaves(lambda x: x[0], eng.init_state(1))
    one = one._replace(track=map_leaves(lambda x: x[0], state.track))
    c0, _ = _graph_counts()
    for call in range(4):
        ts = torch.tensor((call + 1) / 30.0, device=cuda_device)
        one, out = eng.step(eng.params, one, clip[call, 0], ts)
    assert _graph_counts()[0] - c0 == 1
    assert len(eng._analysis.graphs) == 2
    assert all(all(r) for r in record), record


def test_cuda_signal_graph_keeps_each_calls_outputs(cuda_device):
    """Call t's state and outputs are unchanged after call t + 1 replays:
    each call's outputs own their storage."""
    eng, _, _ = _flagship_engine(cuda_device, s=8)
    kept = []
    for call in range(5):
        st, ts, fresh = _pulse_rings(eng, 8, call, cuda_device)
        new, out = eng.signal_analyze(st, None, None, ts, fresh)
        fields = list(new) + list(out[2:])
        kept.append((fields, [f.clone() for f in fields]))
    for fields, copies in kept:
        assert all(_same_bits(f, c) for f, c in zip(fields, copies))
    a = {f.untyped_storage().data_ptr() for f in kept[-2][0][4:]}
    b = {f.untyped_storage().data_ptr() for f in kept[-1][0][4:]}
    assert a.isdisjoint(b)


def test_cuda_signal_graph_stays_eager_under_autograd(cuda_device):
    """With grad enabled and an input that requires grad, every call runs
    eagerly: nothing is captured."""
    eng, _, _ = _flagship_engine(cuda_device, s=8)
    c0, r0 = _graph_counts()
    with torch.enable_grad():
        for call in range(3):
            st, ts, fresh = _pulse_rings(eng, 8, call, cuda_device)
            st = st._replace(raw_y=st.raw_y.requires_grad_())
            new, out = eng.signal_analyze(st, None, None, ts, fresh)
    assert _graph_counts() == (c0, r0)
    assert eng._analysis.graphs == {}


def test_cuda_signal_graph_recaptures_when_tf32_changes(cuda_device):
    """A change of ``allow_tf32`` between calls is a new key: a new
    capture (after one eager call), never the old graph; each graph's
    replays are bit-equal to the eager analysis under its setting."""
    eng, _, _ = _flagship_engine(cuda_device, s=8)
    record = _checked_analysis(eng)
    c0, _ = _graph_counts()
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            for call in range(3):
                st, ts, fresh = _pulse_rings(eng, 8, call, cuda_device)
                eng.signal_analyze(st, None, None, ts, fresh)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert _graph_counts()[0] - c0 == 2
    assert len(eng._analysis.graphs) == 2
    assert all(all(r) for r in record), record
