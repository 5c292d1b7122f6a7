"""The bf16 route of K5/K6: its launch plan and tap table
(``kernels/bottleneck.py`` ``bottleneck_plan`` / ``tap_groups``), which the
CUDA kernel (``csrc/bottleneck.cu``) follows: one launch per unit, a block
= G crops x a band of R output rows x CB output channels, the x tile loaded
once as bf16 pixel-major with a one-pixel zero border, z computed on the
whole tile, the 3x3 product read at pixel + tap shift.

Here on the CPU: every output pixel and channel is stored exactly once at
the seven face-mesh stage shapes and the card tests' shapes, a block fits
in shared memory and in 8 warps, and a numpy emulation of the kernel's
per-block tiles and shifted reads equals ``bottleneck_s1_plain`` and
``bottleneck_chain_plain``.
"""

import numpy as np
import pytest
import torch

from bp_from_video_tpu_torch.kernels import bottleneck as tbn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# The face mesh's seven stages: (spatial size, C, D); C' = C.
MESH_STAGES = ((128, 16, 8), (64, 32, 16), (32, 64, 32), (16, 128, 64),
               (8, 128, 64), (4, 128, 64), (2, 128, 64))
# (B, h, w, C, D, C'): the stages at B 64, 3 and 65, K5's extra cases and
# the card tests' shapes.
SHAPES = ([(b, hw, hw, c, d, c) for hw, c, d in MESH_STAGES
           for b in (64, 3, 65)]
          + [(64, 128, 128, 16, 8, 32), (64, 64, 64, 32, 16, 32),
             (3, 19, 23, 16, 8, 24), (3, 40, 40, 16, 8, 16),
             (3, 17, 21, 16, 8, 16), (5, 2, 2, 128, 64, 128),
             (7, 4, 4, 128, 64, 128), (3, 12, 12, 16, 8, 32),
             (5, 7, 9, 8, 8, 8)])


def _coverage(bsz, h, w, c, d, cout):
    """[B, C', h, w] count of the blocks that store each output, following
    the plan's grid as the kernel does."""
    p = tbn.bottleneck_plan(bsz, h, w, c, d, cout)
    count = np.zeros((bsz, cout, h, w), np.int64)
    for j in range(p.nsplit):
        for band in range(p.bands):
            for grp in range(p.groups):
                b0, r0, n0 = grp * p.g, band * p.rows, j * p.cb
                count[b0:min(bsz, b0 + p.g), n0:min(cout, n0 + p.cb),
                      r0:min(h, r0 + p.rows)] += 1
    return p, count


@pytest.mark.parametrize("shape", SHAPES)
def test_bottleneck_plan_covers_every_output_once(shape):
    p, count = _coverage(*shape)
    bsz, h, w, c, d, cout = shape
    assert (count == 1).all()
    pix = p.g * p.rows * w
    assert p.wm * 32 >= pix and 1 <= p.wm * p.wn <= tbn.TC_MAX_WARPS
    assert p.cb == 8 * p.wn * p.nf and 1 <= p.nf <= 8
    assert p.g <= bsz and p.rows <= h
    assert p.smem <= tbn.TC_SMEM_BUDGET < tbn.SMEM_MAX == 232448
    for pitch, n in ((p.pitch_x, -(-c // 16) * 16), (p.pitch_z, d)):
        assert pitch >= n and pitch % 8 == 0 and (pitch // 8) % 2 == 1
    assert p.sp >= pix and p.sp % 16 == 4     # conflict-free f32 staging


def test_bottleneck_plan_flagship_stages():
    """The 128^2 stage: G 1, R 2, 4,096 blocks; 16^2 C128: R 8 with the
    channels split; the stages down to 16^2 fill the card twice over."""
    plans = {hw: tbn.bottleneck_plan(64, hw, hw, c, d, c)
             for hw, c, d in MESH_STAGES}
    p = plans[128]
    assert (p.g, p.rows, p.groups * p.bands * p.nsplit) == (1, 2, 4096)
    assert (plans[16].g, plans[16].rows, plans[16].nsplit) == (1, 8, 4)
    for hw in (128, 64, 32, 16):
        q = plans[hw]
        assert q.groups * q.bands * q.nsplit >= tbn.TC_TARGET_BLOCKS
    assert plans[2].g > 1 and plans[4].g > 1


def test_bottleneck_plan_rejects_what_a_block_cannot_hold():
    with pytest.raises(ValueError):
        tbn.bottleneck_plan(1, 4, 4, 12, 8, 12)          # C % 8 != 0
    with pytest.raises(ValueError):
        tbn.bottleneck_plan(1, 4, 4, 16, 4, 16)          # D % 8 != 0
    with pytest.raises(ValueError):
        tbn.bottleneck_plan(1, 4, 257, 16, 8, 16)        # a row > 256 px
    with pytest.raises(ValueError):
        tbn.bottleneck_plan(2, 256, 256, 128, 64, 128)   # tile > 113 KB


@pytest.mark.parametrize("d", [8, 16, 64])
def test_tap_groups_match_pack_bottleneck_weights(d):
    """Tag every (tap, mid channel) of the dw weight with its own id,
    pack it, and read back which tap and channel each K-group reads."""
    dw = np.arange(1, 9 * d + 1, dtype=np.float32).reshape(3, 3, d)
    _, wu = tbn.pack_bottleneck_weights(np.ones((1, 1, 8, d)), dw,
                                        np.ones((1, 1, d, 1)))
    taps = tbn.tap_groups(d)
    assert taps.shape == (wu.shape[1] // 8, 3)
    for g, (dy, dx, d0) in enumerate(taps):
        for j in range(8):
            tag = int(wu[0, 8 * g + j])
            assert tag - 1 == np.ravel_multi_index((dy, dx, d0 + j),
                                                   (3, 3, d))


def _bf16(a):
    """f64 numpy -> rounded to f32, then bf16 (as the kernel's f32 sums
    are), back to f64."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float64).numpy()


def _emulate_unit(x, r, wd, bd, ad, wu, bu, au, act):
    """One bf16 unit as the kernel computes it, block by block from the
    plan: a bf16 x tile of G x (R+2) x (w+2) pixels (zero past the image
    and past B, channels padded to 16), z on every tile pixel (+bd, PReLU,
    0 outside the image, bf16), the 3x3 product read at tile pixel + tap
    shift through ``tap_groups`` with K padded to 16 (pad groups read group
    0 against zero weights), f64 sums, +bu, the residual (the unit's input
    when ``r`` is None), the activation, bf16.  Returns the output and how often
    each output was stored."""
    bsz, c, h, w = x.shape
    d, cout = wd.shape[0], wu.shape[0]
    p = tbn.bottleneck_plan(bsz, h, w, c, d, cout)
    cp = -(-c // 16) * 16
    f64 = torch.float64
    xr = x.to(f64).numpy()
    rr = None if r is None else r.to(f64).numpy()
    wdm, wum = wd.to(f64).numpy(), wu.to(f64).numpy()
    bd, ad, bu = (t.to(f64).numpy() for t in (bd, ad, bu))
    au = None if au is None else au.to(f64).numpy()
    taps = tbn.tap_groups(d)
    ks2 = -(-9 * d // 16)
    taps = np.concatenate([taps, np.repeat(taps[:1], 2 * ks2 - len(taps),
                                           0)])
    wup = np.zeros((cout, 16 * ks2))
    wup[:, :9 * d] = wum
    twp, cs, rw = w + 2, (p.rows + 2) * (w + 2), p.rows * w
    out = np.zeros((bsz, cout, h, w))
    count = np.zeros((bsz, cout, h, w), np.int64)
    n = np.arange(p.g * rw)
    gi, ry, xx = n // rw, (n % rw) // w, n % w
    q = gi * cs + (ry + 1) * twp + xx + 1
    for grp in range(p.groups):
        b0 = grp * p.g
        for band in range(p.bands):
            r0 = band * p.rows
            tile = np.zeros((p.g, p.rows + 2, twp, cp))
            inside = np.zeros((p.g, p.rows + 2, twp), bool)
            for g in range(p.g):
                for yy in range(p.rows + 2):
                    gy = r0 - 1 + yy
                    if b0 + g < bsz and 0 <= gy < h:
                        tile[g, yy, 1:w + 1, :c] = xr[b0 + g, :, gy].T
                        inside[g, yy, 1:w + 1] = True
            flat = tile.reshape(-1, cp)
            z = flat[:, :c] @ wdm.T + bd
            z = np.where(z >= 0, z, z * ad)
            z = _bf16(np.where(inside.reshape(-1, 1), z, 0.0))
            win = np.concatenate([z[q + (dy - 1) * twp + (dx - 1),
                                    d0:d0 + 8] for dy, dx, d0 in taps], 1)
            ok = (b0 + gi < bsz) & (r0 + ry < h)
            bs, ys, xs = b0 + gi[ok], r0 + ry[ok], xx[ok]
            for j in range(p.nsplit):
                co = np.arange(j * p.cb, min(cout, (j + 1) * p.cb))
                v = win[ok] @ wup[co].T + bu[co]          # [pixels, co]
                v += (flat[q[ok]][:, co] if rr is None
                      else rr[bs[:, None], co[None], ys[:, None],
                              xs[:, None]])
                if act == "prelu":
                    v = np.where(v >= 0, v, v * au[co])
                elif act == "relu":
                    v = np.maximum(v, 0.0)
                idx = (bs[:, None], co[None], ys[:, None], xs[:, None])
                out[idx] = _bf16(v)
                count[idx] += 1
    return torch.from_numpy(out).to(torch.bfloat16), count


def _operands(rng, units, c, d, cout):
    raw = [(rng.normal(0, 0.3, (1, 1, c, d)), rng.normal(0, 0.3, (3, 3, 1, d)),
            rng.normal(0, 0.3, (1, 1, d, cout))) for _ in range(units)]
    wds, wus = zip(*(tbn.pack_bottleneck_weights(*r) for r in raw))

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt)
    return (t(np.stack(wds), torch.bfloat16),
            t(rng.normal(0, 0.1, (units, d))),
            t(rng.uniform(0.1, 0.5, (units, d))),
            t(np.stack(wus), torch.bfloat16),
            t(rng.normal(0, 0.1, (units, cout))),
            t(rng.uniform(0.1, 0.5, (units, cout))))


def _tol(want, units=1):
    # Sums of exact bf16 products in another order (f64 here, f32 in the
    # plain version), z and y each rounded once to bf16: at most one bf16
    # ulp (2^-7 of the largest value) apart per unit.
    return units * 2.0 ** -7 * float(want.float().abs().max()) + 1e-6


@pytest.mark.parametrize("shape,act,self_res", [
    ((3, 16, 16, 16, 8, 16), "prelu", True),      # D = 8: K padded 72 -> 80
    ((5, 2, 2, 128, 64, 128), "none", True),      # G > 1, B % G != 0
    ((7, 4, 4, 128, 64, 128), "prelu", True),     # G > 1, channels split
    ((3, 19, 23, 16, 8, 24), "prelu", False),     # C' = 24, ragged band
    ((2, 12, 12, 16, 8, 32), "relu", False),      # C' != C, r not x
    ((3, 17, 21, 24, 16, 24), "prelu", True),     # C % 16 = 8: zero channels
    ((5, 7, 9, 8, 8, 8), "prelu", True),          # odd w: scalar stores
    ((2, 8, 8, 128, 64, 128), "relu", True)])
def test_tile_emulation_matches_bottleneck_s1_plain(shape, act, self_res):
    bsz, h, w, c, d, cout = shape
    rng = np.random.default_rng(c * 100 + cout + h)
    ops = [o[0] for o in _operands(rng, 1, c, d, cout)]
    if act != "prelu":
        ops[5] = None
    x = torch.from_numpy(rng.standard_normal((bsz, c, h, w)).astype(
        np.float32)).to(torch.bfloat16)
    r = x if self_res else torch.from_numpy(rng.standard_normal(
        (bsz, cout, h, w)).astype(np.float32)).to(torch.bfloat16)
    got, count = _emulate_unit(x, None if self_res else r, *ops, act)
    want = tbn.bottleneck_s1_plain(x, r, *ops, last_act=act)
    assert (count == 1).all()
    assert float((got.float() - want.float()).abs().max()) <= _tol(want)


@pytest.mark.parametrize("shape,units", [((3, 16, 16, 32, 16), 3),
                                         ((65, 2, 2, 128, 64), 2)])
def test_tile_emulation_matches_bottleneck_chain_plain(shape, units):
    """U units, one emulated launch each, every residual the unit's own
    input (read from its x tile)."""
    bsz, h, w, c, d = shape
    rng = np.random.default_rng(units * 10 + c)
    ops = _operands(rng, units, c, d, c)
    x = torch.from_numpy(rng.standard_normal((bsz, c, h, w)).astype(
        np.float32)).to(torch.bfloat16)
    y = x
    for u in range(units):
        y, count = _emulate_unit(y, None, *(o[u] for o in ops), "prelu")
        assert (count == 1).all()
    want = tbn.bottleneck_chain_plain(x, *ops, last_act="prelu")
    # A rounding that lands on the neighbouring value in one unit is
    # carried through the units after it: one ulp per unit.
    assert float((y.float() - want.float()).abs().max()) <= _tol(want, units)
