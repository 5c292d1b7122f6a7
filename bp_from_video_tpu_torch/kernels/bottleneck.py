"""Kernels K5 and K6: the face-mesh bottleneck residual unit, alone
(``bottleneck_s1``) or as a chain of same-shape units (``bottleneck_chain``),
both in ``csrc/bottleneck.cu``.

Counterpart of ``bp_from_video_tpu/pallas/block_kernel.py``
``bottleneck_s1`` / ``bottleneck_chain`` and their host packing
``pack_bottleneck_weights`` (numpy in, numpy out, the same layout):

    z   = PReLU_ad(wd[D, C] . x + bd)        f32 accumulation, rounded to
                                             the weight dtype
    acc = wu[C', 9D] . win9(z) + bu + r      win9: the nine unit shifts of
                                             z, zero outside the image
    y   = act(acc)                           one rounding to x's dtype

``wu`` is the depthwise 3x3 composed with the 1x1 up-projection, rows in
(dy, dx)-major window order.  In a chain every unit's residual is its own
input and each unit rounds once.

The wrappers launch the CUDA kernel for a CUDA tensor and take the plain
versions for a CPU tensor (float32 or bfloat16).  The kernel runs on the
tensor cores and takes bf16 x, residual and weights only (one launch per
unit, planned by ``bottleneck_plan``); any other dtype, or a shape without
a plan, raises before a launch.  A graph compiled for the card in another
dtype calls the plain versions, chosen once when it is compiled
(``tflite_compiler.bottleneck_units``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch.kernels import build

Tensor = torch.Tensor

_ACTS = {"none": 0, "relu": 1, "prelu": 2}
_DTYPES = (torch.float32, torch.bfloat16)


def pack_bottleneck_weights(w_down, w_dw, w_up, dtype=np.float32
                            ) -> tuple[np.ndarray, np.ndarray]:
    """(1x1 down [1,1,C,D], dw [3,3,D] or [3,3,1,D], 1x1 up [1,1,D,C']) ->
    (wd [D, C], wu [C', 9D]) numpy in ``dtype``: ``wu`` is the dw-then-up
    dense composition in the kernel's (dy, dx)-major window order."""
    wd = np.asarray(w_down, np.float32)[0, 0].T                   # [D, C]
    dw = np.asarray(w_dw, np.float32)
    if dw.ndim == 4:
        dw = dw[:, :, 0, :] if dw.shape[2] == 1 else dw[0]
    up = np.asarray(w_up, np.float32)[0, 0]                       # [D, C']
    d = up.shape[0]
    rows = np.zeros((9 * d, up.shape[1]), np.float32)
    for t, (dy, dx) in enumerate((dy, dx) for dy in range(3)
                                 for dx in range(3)):
        # Tap (dy, dx) reads z at (y+dy-1, x+dx-1): window slot t.
        rows[t * d:(t + 1) * d] = dw[dy, dx][:, None] * up
    return wd.astype(dtype), np.ascontiguousarray(rows.T).astype(dtype)


def _act(acc: Tensor, au: Tensor | None, last_act: str) -> Tensor:
    if last_act == "prelu":
        return torch.where(acc >= 0.0, acc,
                           acc * au.to(torch.float32)[:, None, None])
    if last_act == "relu":
        return torch.clamp(acc, min=0.0)
    return acc


def bottleneck_s1_plain(x: Tensor, residual: Tensor, wd: Tensor, bd: Tensor,
                        ad: Tensor, wu: Tensor, bu: Tensor,
                        au: Tensor | None, *, last_act: str = "prelu"
                        ) -> Tensor:
    """Plain PyTorch version of K5: two f32 products around the nine
    zero-padded shifts of z, z rounded to the weight dtype."""
    f32 = torch.float32
    h, w = x.shape[2], x.shape[3]
    z = torch.einsum("dc,bchw->bdhw", wd.to(f32), x.to(f32))
    z = z + bd.to(f32)[:, None, None]
    z = torch.where(z >= 0.0, z, z * ad.to(f32)[:, None, None])
    zp = F.pad(z.to(wu.dtype).to(f32), (1, 1, 1, 1))
    win = torch.cat([zp[:, :, dy:dy + h, dx:dx + w]
                     for dy in range(3) for dx in range(3)], 1)
    acc = torch.einsum("ok,bkhw->bohw", wu.to(f32), win)
    acc = acc + bu.to(f32)[:, None, None]
    acc = acc + residual.to(f32)
    return _act(acc, au, last_act).to(x.dtype)


def bottleneck_chain_plain(x: Tensor, wd: Tensor, bd: Tensor, ad: Tensor,
                           wu: Tensor, bu: Tensor, au: Tensor, *,
                           last_act: str = "prelu") -> Tensor:
    """Plain PyTorch version of K6: the units one after another, each
    rounded once to x's dtype."""
    y = x
    for u in range(wd.shape[0]):
        y = bottleneck_s1_plain(y, y, wd[u], bd[u], ad[u], wu[u], bu[u],
                                au[u], last_act=last_act)
    return y


def _check(name, x, wd, bd, ad, wu, bu, au, lead, cout, last_act):
    """Shapes and dtypes shared by K5 and K6; ``lead`` is () or (U,)."""
    if last_act not in _ACTS:
        raise ValueError(f"{name}: last_act {last_act!r}")
    c = x.shape[1]
    d = wd.shape[-2]
    want = {"wd": lead + (d, c), "bd": lead + (d,), "ad": lead + (d,),
            "wu": lead + (cout, 9 * d), "bu": lead + (cout,)}
    got = {"wd": wd, "bd": bd, "ad": ad, "wu": wu, "bu": bu}
    if au is not None:
        want["au"], got["au"] = lead + (cout,), au
    elif last_act == "prelu":
        raise ValueError(f"{name}: last_act 'prelu' needs au")
    bad = {k: tuple(got[k].shape) for k in want
           if tuple(got[k].shape) != want[k]}
    if x.ndim != 4 or bad:
        raise ValueError(f"{name}: x {tuple(x.shape)}, mismatched {bad} "
                         f"(expected {want})")
    if (x.dtype not in _DTYPES or wd.dtype not in _DTYPES
            or wu.dtype != wd.dtype):
        raise ValueError(f"{name}: x {x.dtype}, wd {wd.dtype}, wu "
                         f"{wu.dtype}: float32 or bfloat16 expected")
    if x.is_cuda and (x.dtype, wd.dtype) != (torch.bfloat16,) * 2:
        raise ValueError(f"{name}: x {x.dtype}, wd {wd.dtype}: the kernel "
                         f"takes bfloat16 alone (another dtype runs "
                         f"{name}_plain)")


# -- the kernel's launch plan -------------------------------------------------
# The rule of `make_tc_plan` in csrc/bottleneck.cu, kept here so the CPU
# tests can check it; the wrapper holds the two against each other once per
# shape.

TC_PIXELS = 256              # output pixels a block aims at
TC_MIN_PIXELS = 64           # ... and the fewest it is cut down to
TC_MAX_WARPS = 8             # warps a block: 8 where the channels allow
TC_TARGET_BLOCKS = 2 * 132   # two blocks for each SM of an H100
TC_SMEM_BUDGET = 113 * 1024  # shared bytes a block: two blocks an SM
SMEM_MAX = 232448            # shared bytes a block can have on Hopper
WKC = 64                     # Wu K-chunk of one ring stage
WSTAGES = 3                  # ring stages: two chunks in flight
WKP = WKC + 8                # bf16 per Wu row in shared memory


class BottleneckPlan(NamedTuple):
    g: int          # crops a block
    rows: int       # output rows a block covers (a band)
    groups: int     # ceil(B / g)
    bands: int      # ceil(h / rows)
    nsplit: int     # blocks over the output channels
    cb: int         # output channels a block: 8 * wn * nf
    wn: int         # warps over the channels
    nf: int         # n8 tiles a warp
    wm: int         # warps over the pixels, 32 each
    pitch_x: int    # bf16 an x-tile pixel takes: an odd count of 16 bytes
    pitch_z: int    # the same for a z-tile pixel
    sp: int         # f32 a channel row of the staged sums takes
    wst: int        # Wu chunks in shared memory: all of them, or a ring
    smem: int       # dynamic shared bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _odd_units(n8: int) -> int:
    return 8 * (n8 + 1 if n8 % 2 == 0 else n8)


@functools.lru_cache(maxsize=None)
def bottleneck_plan(bsz: int, h: int, w: int, c: int, d: int,
                    cout: int) -> BottleneckPlan:
    """Launch plan of one bf16 unit for x [bsz, c, h, w], D = ``d`` and C'
    = ``cout``: one block = ``g`` crops x ``rows`` output rows x ``cb``
    channels; its x tile [g x (rows+2) x (w+2) pixels][pitch_x] bf16 is
    loaded once and z computed on all of it; ``wst`` of Wu's 64-deep
    K-chunks sit in shared memory at once."""
    if (c < 8 or c % 8 or d < 8 or d % 8 or cout < 1 or h < 1 or w < 1
            or w > TC_PIXELS or bsz < 1):
        raise ValueError(f"bottleneck: no bf16 launch plan for C {c}, D {d}, "
                         f"C' {cout}, {h}x{w} (C and D multiples of 8, rows "
                         f"of at most {TC_PIXELS} pixels)")
    cp = _cdiv(c, 16) * 16
    pitch_x, pitch_z = _odd_units(cp // 8), _odd_units(d // 8)
    nct = _cdiv(cout, 8)
    if h * w >= TC_PIXELS:
        g, rows = 1, min(h, TC_PIXELS // w)
    else:
        g, rows = min(bsz, TC_PIXELS // (h * w)), h
    nsplit = 1

    def shrink():
        nonlocal g, rows
        if g > 1:
            g = _cdiv(g, 2)
        elif rows > 1:
            rows = _cdiv(rows, 2)
        else:
            return False
        return True

    def fill():
        ntb = _cdiv(nct, nsplit)
        pix = g * rows * w
        wm = _cdiv(pix, 32)
        # 8 warps a block where the channels allow: few pixels take more
        # channel warps.
        wn = max(_cdiv(ntb, 8), min(_cdiv(TC_MAX_WARPS, wm), ntb))
        nf = _cdiv(ntb, wn)
        cb = 8 * wn * nf
        sp = _cdiv(pix, 16) * 16 + 4
        npz16 = _cdiv(g * (rows + 2) * (w + 2), 16) * 16
        tiles = npz16 * (pitch_x + pitch_z) * 2
        ks2 = _cdiv(9 * d, 16)
        nchunks = _cdiv(ks2, 4)
        rest = (d * (cp + 8) * 2 + (2 * d + 2 * cb) * 4 + _cdiv(2 * ks2, 4) * 16
                + 2 * _cdiv(pix, 4) * 16 + npz16 + max(tiles, cb * sp * 4))
        # All of Wu's chunks where they fit, else a ring of WSTAGES.
        chunk = cb * WKP * 2
        wst = nchunks
        if nchunks > WSTAGES and rest + nchunks * chunk > TC_SMEM_BUDGET:
            wst = WSTAGES
        return BottleneckPlan(g, rows, _cdiv(bsz, g), _cdiv(h, rows),
                              _cdiv(cout, cb), cb, wn, nf, wm, pitch_x,
                              pitch_z, sp, wst, rest + wst * chunk)
    # Fit a block, then fill the card: split the channels first (each split
    # recomputes z), then take fewer pixels a block.
    while True:
        q = fill()
        if q.wm * q.wn > TC_MAX_WARPS or q.smem > TC_SMEM_BUDGET:
            if q.cb > 32:
                nsplit *= 2
            elif not shrink():
                raise ValueError(f"bottleneck: no bf16 launch plan fits "
                                 f"shared memory for C {c}, D {d}, {h}x{w}")
        elif q.nsplit * q.groups * q.bands < TC_TARGET_BLOCKS:
            if q.cb > 32:
                nsplit *= 2
            elif not (g * rows * w > TC_MIN_PIXELS and shrink()):
                break
        else:
            break
    if q.smem > SMEM_MAX:
        raise ValueError(f"bottleneck: {q.smem} shared bytes")
    return q


def tap_groups(d: int) -> np.ndarray:
    """[9D/8, 3] int: for each group of 8 rows of ``wu``'s K (window) axis,
    (dy, dx, d0): the tap it reads z at (shift (dy-1, dx-1)) and its first
    mid channel — the kernel's per-block byte-offset table before scaling
    by the z tile's pitches."""
    out = np.zeros((9 * d // 8, 3), np.int64)
    for g in range(9 * d // 8):
        t, d0 = divmod(8 * g, d)
        out[g] = (t // 3, t % 3, d0)
    return out


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its entries' ctypes signatures, set once."""
    lib = build.load("bottleneck")
    lib.bottleneck_plan.argtypes = [_I] * 6 + [ctypes.POINTER(_I)]
    lib.bottleneck_plan.restype = _I
    lib.bottleneck_s1_launch.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    lib.bottleneck_s1_launch.restype = _I
    lib.bottleneck_chain_launch.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    lib.bottleneck_chain_launch.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _check_card_plan(bsz: int, h: int, w: int, c: int, d: int,
                     cout: int) -> None:
    """Raise unless the C entry plans this shape as ``bottleneck_plan``
    does (once per shape)."""
    plan = bottleneck_plan(bsz, h, w, c, d, cout)
    got = (ctypes.c_int * len(plan))()
    err = _lib().bottleneck_plan(bsz, h, w, c, d, cout, got)
    if err or tuple(got) != tuple(plan):
        raise RuntimeError(f"bottleneck: the kernel plans {tuple(got)} "
                           f"(error {err}), bottleneck_plan {plan}")


def _launch(entry: str, x, r, wd, bd, ad, wu, bu, au, units, cout,
            last_act) -> Tensor:
    dev = x.device
    ops = [t for t in (r, wd, bd, ad, wu, bu, au) if t is not None]
    if not x.is_cuda or any(t.device != dev for t in ops):
        raise ValueError(f"{entry}: all operands on one CUDA device")
    bsz, c, h, w = x.shape
    d = wd.shape[-2]
    f32 = torch.float32
    x, wd, wu = x.contiguous(), wd.contiguous(), wu.contiguous()
    bd, ad, bu = (t.to(f32).contiguous() for t in (bd, ad, bu))
    au = None if au is None else au.to(f32).contiguous()
    lib = _lib()
    if r is not None:
        r = r.contiguous()
    _check_card_plan(bsz, h, w, c, d, cout)
    # The kernel reads every operand in 16-byte pieces (cp.async, tile rows)
    # or pixel pairs: a view off that alignment is copied.
    x, r, wd, bd, ad, wu, bu, au = (
        t if t is None or t.data_ptr() % 16 == 0 else t.clone()
        for t in (x, r, wd, bd, ad, wu, bu, au))
    buf = None
    if units > 1:                       # ping-pong between units
        buf = torch.empty((bsz, cout, h, w), dtype=x.dtype, device=dev)
    out = torch.empty((bsz, cout, h, w), dtype=x.dtype, device=dev)
    tail = (_ACTS[last_act], torch.cuda.current_stream(dev).cuda_stream)
    ptr = [wd.data_ptr(), bd.data_ptr(), ad.data_ptr(), wu.data_ptr(),
           bu.data_ptr(), None if au is None else au.data_ptr()]
    if r is not None:
        err = lib.bottleneck_s1_launch(x.data_ptr(), r.data_ptr(), *ptr,
                                       out.data_ptr(), bsz, c, d, cout, h, w,
                                       *tail)
    else:
        err = lib.bottleneck_chain_launch(
            x.data_ptr(), *ptr, None if buf is None else buf.data_ptr(),
            out.data_ptr(), bsz, units, c, d, h, w, *tail)
    build.check(lib, err, entry)
    return out


def bottleneck_s1(x: Tensor, residual: Tensor, wd: Tensor, bd: Tensor,
                  ad: Tensor, wu: Tensor, bu: Tensor, au: Tensor | None, *,
                  last_act: str = "prelu") -> Tensor:
    """One fused bottleneck unit.  x: [B, C, h, w]; residual: [B, C', h, w]
    (the ADD's other operand: x itself, or the padded max-pool after a
    downsample), both float32 or both bfloat16; wd [D, C] / wu [C', 9D]
    from ``pack_bottleneck_weights`` in one dtype; bd/ad: [D]; bu/au: [C']
    (``au`` may be None unless ``last_act`` is "prelu").  On the card x
    and the weights must be bfloat16.  Returns [B, C', h, w] in x's
    dtype."""
    cout = wu.shape[0]
    _check("bottleneck_s1", x, wd, bd, ad, wu, bu, au, (), cout, last_act)
    if (tuple(residual.shape) != (x.shape[0], cout) + tuple(x.shape[2:])
            or residual.dtype != x.dtype):
        raise ValueError(f"bottleneck_s1: residual {tuple(residual.shape)} "
                         f"{residual.dtype} for x {tuple(x.shape)} {x.dtype}, "
                         f"C' {cout}")
    if x.device.type == "cpu":
        return bottleneck_s1_plain(x, residual, wd, bd, ad, wu, bu, au,
                                   last_act=last_act)
    out = _launch("bottleneck_s1_launch", x, residual, wd, bd, ad, wu, bu,
                  au, 1, cout, last_act)
    bottleneck_s1.launches += 1
    return out


bottleneck_s1.launches = 0


def bottleneck_chain(x: Tensor, wd: Tensor, bd: Tensor, ad: Tensor,
                     wu: Tensor, bu: Tensor, au: Tensor, *,
                     last_act: str = "prelu") -> Tensor:
    """U chained same-shape units: on the card one call makes U kernel
    launches, bfloat16 x and weights only.  x: [B, C, h, w]; wd: [U, D, C];
    wu: [U, C, 9D]; bd/ad: [U, D]; bu/au: [U, C].  Each unit's residual is
    its own input.  Returns [B, C, h, w] in x's dtype."""
    if wd.ndim != 3:
        raise ValueError(f"bottleneck_chain: wd {tuple(wd.shape)}")
    units = wd.shape[0]
    _check("bottleneck_chain", x, wd, bd, ad, wu, bu, au, (units,),
           x.shape[1], last_act)
    if x.device.type == "cpu":
        return bottleneck_chain_plain(x, wd, bd, ad, wu, bu, au,
                                      last_act=last_act)
    out = _launch("bottleneck_chain_launch", x, None, wd, bd, ad, wu, bu, au,
                  units, x.shape[1], last_act)
    bottleneck_chain.launches += 1
    return out


bottleneck_chain.launches = 0
