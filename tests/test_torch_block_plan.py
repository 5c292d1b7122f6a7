"""K3's launch plan and k-group tap table (``kernels/block.py``
``block_plan`` / ``k_group_taps``), which the CUDA kernel
(``csrc/dense_s2_block.cu``) follows: a block = one crop x a band of whole
output rows x an M-tile of channels, its input loaded once as a bf16
pixel-major tile with a zero halo, the window rows read at pixel + shift.

Here on the CPU: every output pixel and channel is covered exactly once at
the flagship shapes and the small test shapes, the shared bytes fit a
Hopper block, the tap table maps each k-group to the (shift, channel) that
``pack_block_weights`` put there, and a numpy emulation of the kernel's
per-tile shifted reads equals ``dense_s2_block_plain``.
"""

import numpy as np
import pytest
import torch

from bp_from_video_tpu_torch.kernels import block as tbk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The 11 K3 launch shapes of the flagship paths: (B, h = w, cin, cout,
# wspec) of the face stand-in (B = 64), the hand stand-in (B = 128) and the
# compiled face mesh's stem (cout 16, PReLU).
FLAGSHIP = [(64, 128, 3, 24, "expanded"), (64, 64, 24, 48, "sliced"),
            (64, 32, 48, 96, "sliced"), (64, 16, 96, 96, "sliced"),
            (64, 8, 96, 192, "sliced"), (128, 112, 3, 24, "expanded"),
            (128, 56, 24, 48, "sliced"), (128, 28, 48, 96, "sliced"),
            (128, 14, 96, 96, "sliced"), (128, 7, 96, 192, "sliced"),
            (64, 128, 3, 16, "expanded")]
# The card tests' shapes: (B, h, w, cin, cout, wspec).
SMALL = [(2, 16, 16, 3, 24, "expanded"), (2, 8, 8, 24, 48, "sliced"),
         (2, 7, 7, 96, 192, "sliced"), (3, 16, 16, 3, 16, "expanded"),
         (3, 14, 14, 96, 96, "sliced"), (3, 14, 14, 24, 24, "sliced"),
         (3, 11, 9, 8, 16, "sliced"), (2, 5, 6, 5, 8, "expanded")]


def _coverage(bsz, h, w, cin, cout, wspec):
    """[cout, h, w] count of the (block, warp slot, channel) that store
    each output of one crop, following the plan as the kernel does."""
    p = tbk.block_plan(bsz, h, w, cin, cout, wspec)
    count = np.zeros((cout, h, w), np.int64)
    n = np.arange(p.warps * p.nf * 8)
    for band in range(p.bands):
        r0 = band * p.rows
        ok = n < min(p.rows, h - r0) * w
        ys, xs = r0 + n[ok] // w, n[ok] % w
        for t in range(p.m_tiles):
            co = np.arange(t * 16 * p.mf, min(cout, (t + 1) * 16 * p.mf))
            np.add.at(count, (co[:, None], ys[None], xs[None]), 1)
    return p, count


@pytest.mark.parametrize("shape", [(b, hw, hw, cin, cout, spec) for
                                   b, hw, cin, cout, spec in FLAGSHIP]
                         + SMALL)
def test_block_plan_covers_every_output_once(shape):
    p, count = _coverage(*shape)
    bsz, h, w = shape[:3]
    assert (count == 1).all()
    assert p.warps * p.nf * 8 >= p.rows * w        # the band fits the warps
    assert 1 <= p.warps <= 8 and p.nf in (2, 4) and 1 <= p.mf <= 4
    assert p.rows * w <= tbk.PLAN_PIXELS
    assert p.smem <= tbk.SMEM_MAX == 232448
    assert p.pitch >= p.c4p and p.pitch % 8 == 0 and (p.pitch // 8) % 2 == 1


def test_block_plan_flagship_grids_fill_the_card():
    for b, hw, cin, cout, spec in FLAGSHIP:
        p = tbk.block_plan(b, hw, hw, cin, cout, spec)
        assert b * p.bands * p.m_tiles >= tbk.TARGET_BLOCKS
        # Whole crops at 8x8 and 7x7; 56-256 pixels elsewhere.
        assert p.bands == 1 if hw <= 8 else 56 <= p.rows * hw <= 256


def test_block_plan_rejects_what_a_block_cannot_hold():
    with pytest.raises(ValueError):
        tbk.block_plan(1, 4, 257, 3, 8, "expanded")       # a row > 256 px
    with pytest.raises(ValueError):
        tbk.block_plan(1, 128, 256, 96, 8, "sliced")       # tile > 227 KB


@pytest.mark.parametrize("wspec,cin", [("sliced", 8), ("sliced", 24),
                                       ("sliced", 96), ("expanded", 3),
                                       ("expanded", 5)])
def test_k_group_taps_match_pack_block_weights(wspec, cin):
    """Tag every dense weight (dy, dx, c) with its own id, pack it, and read
    back which (shift, channel) each window row of each k-group reads."""
    ids = np.arange(1, 9 * cin + 1, dtype=np.float32).reshape(3, 3, cin, 1)
    wmat, spec = tbk.pack_block_weights(ids, cin=cin)
    assert spec == wspec
    taps = tbk.k_group_taps(wspec, cin)
    assert taps.shape == (wmat.shape[1] // 8, 3)
    for g, (sy, sx, ch) in enumerate(taps):
        for j in range(8):
            tag = int(wmat[0, 8 * g + j])
            if ch + j >= 4 * cin:        # a zero channel of the tile pixel
                assert tag == 0
            if tag == 0:                 # a zero weight row: reads anything
                continue
            dy, dx, c = np.unravel_index(tag - 1, (3, 3, cin))
            assert (sy, sx) == (dy // 2, dx // 2)
            assert ch + j == ((dy % 2) * 2 + dx % 2) * cin + c


def _emulate(x, wmat, wspec, b, alpha, cin, resid):
    """K3 as the kernel computes it, block by block from the plan: a bf16
    tile of (rows+1) x (w+1) pixels (zero past the image), window rows read
    at tile[pixel + shift, channel] through the tap table, f64 sums, the
    epilogue on the block's stored pixels.  Returns the output and how
    often each output was stored."""
    bsz, c4, h, w = x.shape
    cout = wmat.shape[0]
    p = tbk.block_plan(bsz, h, w, cin, cout, wspec)
    taps = tbk.k_group_taps(wspec, cin)
    xf = x.to(torch.float64).numpy()
    xr = x.to(torch.bfloat16).to(torch.float64).numpy()
    wm = wmat.to(torch.float64).numpy()
    bias = b.to(torch.float64).numpy()
    al = None if alpha is None else alpha.to(torch.float64).numpy()
    out = np.zeros((bsz, cout, h, w))
    count = np.zeros((bsz, cout, h, w), np.int64)
    n = np.arange(p.warps * p.nf * 8)
    inb = n < p.rows * w
    py, px = np.where(inb, n // w, 0), np.where(inb, n % w, 0)
    for bi in range(bsz):
        for band in range(p.bands):
            r0 = band * p.rows
            tile = np.zeros((p.rows + 1, w + 1, p.c4p))
            rr = min(h - r0, p.rows + 1)
            tile[:rr, :w, :c4] = xr[bi, :, r0:r0 + rr].transpose(1, 2, 0)
            win = np.concatenate([tile[py + sy, px + sx, ch:ch + 8].T
                                  for sy, sx, ch in taps])   # [K, slots]
            ok = n < min(p.rows, h - r0) * w
            ys, xs = r0 + n[ok] // w, n[ok] % w
            for t in range(p.m_tiles):
                co = np.arange(t * 16 * p.mf, min(cout, (t + 1) * 16 * p.mf))
                v = wm[co] @ win[:, ok] + bias[co, None]
                if resid:
                    r = co[co < cin]
                    pooled = np.max([xf[bi, q * cin + r][:, ys, xs]
                                     for q in range(4)], 0)
                    v[:len(r)] += pooled
                    v = np.maximum(v, 0.0)
                else:
                    a = 0.0 if al is None else al[co, None]
                    v = np.where(v >= 0.0, v, v * a)
                out[bi][co[:, None], ys[None], xs[None]] = v
                count[bi][co[:, None], ys[None], xs[None]] += 1
    return torch.from_numpy(out).to(x.dtype), count


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,resid,prelu", [
    ((2, 16, 16, 3, 24, "expanded"), False, False),
    ((3, 16, 16, 3, 16, "expanded"), False, True),
    ((2, 8, 8, 24, 48, "sliced"), True, False),
    ((3, 14, 14, 24, 24, "sliced"), True, False),
    ((2, 7, 7, 96, 192, "sliced"), True, False),
    ((3, 11, 9, 8, 16, "sliced"), True, False),
    ((2, 5, 6, 5, 8, "expanded"), False, True)])
def test_tile_emulation_matches_plain(shape, resid, prelu, dt):
    bsz, h, w, cin, cout, wspec = shape
    rng = np.random.default_rng(cin * 100 + cout)
    x = torch.from_numpy(rng.standard_normal(
        (bsz, 4 * cin, h, w)).astype(np.float32)).to(dt)
    wd = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
          ).astype(np.float32)
    wmat, spec = tbk.pack_block_weights(wd, cin=cin)
    assert spec == wspec
    wmat = torch.from_numpy(wmat).to(torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    alpha = (torch.from_numpy(rng.uniform(0, 0.3, cout).astype(np.float32))
             if prelu else None)
    got, count = _emulate(x, wmat, wspec, b, alpha, cin, resid)
    want = tbk.dense_s2_block_plain(x, wmat, wspec, b, alpha, cin=cin,
                                    resid=resid)
    assert (count == 1).all()
    # Sums of exact bf16 products in another order (f64 here, f32 there),
    # rounded once to the output type: at most one bf16 ulp apart.
    tol = 2.0 ** -7 * float(want.float().abs().max()) + 1e-6
    assert float((got.float() - want.float()).abs().max()) <= tol
