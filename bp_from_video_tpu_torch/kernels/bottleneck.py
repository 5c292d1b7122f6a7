"""Kernels K5 and K6: the face-mesh bottleneck residual unit, alone
(``bottleneck_s1``) or as a chain of same-shape units in one launch
(``bottleneck_chain``), both in ``csrc/bottleneck.cu``.

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
versions for a CPU tensor.
"""

from __future__ import annotations

import ctypes

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
    lib = build.load("bottleneck")
    lib.bottleneck_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.bottleneck_scratch_floats.restype = ctypes.c_int
    scratch = torch.empty(lib.bottleneck_scratch_floats(units, c, d, cout),
                          dtype=f32, device=dev)
    out = torch.empty((bsz, cout, h, w), dtype=x.dtype, device=dev)
    tail = (_ACTS[last_act], int(x.dtype == torch.bfloat16),
            int(wd.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    ptr = [wd.data_ptr(), bd.data_ptr(), ad.data_ptr(), wu.data_ptr(),
           bu.data_ptr(), None if au is None else au.data_ptr(),
           scratch.data_ptr(), out.data_ptr()]
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    if r is not None:
        r = r.contiguous()
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        err = fn(x.data_ptr(), r.data_ptr(), *ptr, bsz, c, d, cout, h, w,
                 *tail)
    else:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        err = fn(x.data_ptr(), *ptr, bsz, units, c, d, h, w, *tail)
    build.check(lib, err, entry)
    return out


def bottleneck_s1(x: Tensor, residual: Tensor, wd: Tensor, bd: Tensor,
                  ad: Tensor, wu: Tensor, bu: Tensor, au: Tensor | None, *,
                  last_act: str = "prelu") -> Tensor:
    """One fused bottleneck unit.  x: [B, C, h, w]; residual: [B, C', h, w]
    (the ADD's other operand: x itself, or the padded max-pool after a
    downsample), both float32 or both bfloat16; wd [D, C] / wu [C', 9D]
    from ``pack_bottleneck_weights`` in one dtype; bd/ad: [D]; bu/au: [C']
    (``au`` may be None unless ``last_act`` is "prelu").  Returns
    [B, C', h, w] in x's dtype."""
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
    """U chained same-shape units in one launch.  x: [B, C, h, w]; wd:
    [U, D, C]; wu: [U, C, 9D]; bd/ad: [U, D]; bu/au: [U, C].  Each unit's
    residual is its own input.  Returns [B, C, h, w] in x's dtype."""
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
