"""Kernel K3: a stride-2 blaze block (or the 3x3/2 stem) as one implicit
GEMM on 2x2 space-to-depth packed input (``csrc/dense_s2_block.cu``).

Counterpart of ``bp_from_video_tpu/pallas/block_kernel.py``
``dense_s2_block`` / ``trunk_apply`` and its host packing
(``pack_block_weights``, ``compose_block_params``, ``prepare_trunk``,
``_edge_masks`` — numpy in, numpy out, the same layouts):

    acc[O, h*w] = W'[O, K] @ windows[K, h*w]

where the windows are the packed planes shifted by (0,0)/(0,1)/(1,0)/(1,1)
(zero past the far edge: TFLite SAME pads lo=0, hi=1 at even sizes) in the
"sliced" (K = 9*cin, cin % 8 == 0) or "expanded" (K = 4*rup8(4*cin)) row
order.  Weights and windows are bf16 whatever the input type, accumulation
is f32, the output has the input's type.  Residual flavor: + max of the four
parity planes on the first cin channels, ReLU; stem flavor: [P]ReLU.

``dense_s2_block`` launches the CUDA kernel for a CUDA tensor and takes
``dense_s2_block_plain`` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bp_from_video_tpu_torch.kernels import build

Tensor = torch.Tensor


# -- host packing (numpy) -----------------------------------------------------


def pack_block_weights(w_dense, *, cin: int) -> tuple[np.ndarray, str]:
    """HWIO [3, 3, cin, cout] dense conv weight -> ([cout, K] f32 numpy in
    the kernel's window row order, wspec).  The kernel reads the matrix in
    bf16: callers store it with ``torch.bfloat16`` (round to nearest even,
    as the reference package's bf16 cast)."""
    wd = np.asarray(w_dense, np.float32)
    if wd.shape[:2] != (3, 3):
        raise ValueError(f"3x3 weight expected, got {wd.shape}")
    cout = wd.shape[3]
    if cin % 8 == 0:
        rows = np.zeros((9 * cin, cout), np.float32)
        for i, (dy, dx) in enumerate((dy, dx) for dy in range(3)
                                     for dx in range(3)):
            rows[i * cin:(i + 1) * cin] = wd[dy, dx]
        return np.ascontiguousarray(rows.T), "sliced"
    pad = -(-4 * cin // 8) * 8
    rows = np.zeros((4 * pad, cout), np.float32)
    for dy in range(3):
        for dx in range(3):
            blk = (dy // 2) * 2 + (dx // 2)
            p = (dy % 2) * 2 + (dx % 2)
            off = blk * pad + p * cin
            rows[off:off + cin] = wd[dy, dx]
    return np.ascontiguousarray(rows.T), "expanded"


@functools.lru_cache(maxsize=None)
def _edge_masks(h: int, w: int) -> np.ndarray:
    """[4, h*w] f32: row 0 ones, 1 = x-shift valid, 2 = y-shift valid,
    3 = both."""
    col = np.arange(h * w) % w
    rowi = np.arange(h * w) // w
    mx = (col < w - 1).astype(np.float32)
    my = (rowi < h - 1).astype(np.float32)
    return np.stack([np.ones(h * w, np.float32), mx, my, mx * my])


def compose_block_params(p: dict) -> tuple[np.ndarray, np.ndarray]:
    """dw+pw blaze-block params (numpy) -> the exact dense HWIO twin and
    its bias."""
    dw_w = np.asarray(p["dw"]["w"], np.float32)
    pw_w = np.asarray(p["pw"]["w"], np.float32)
    w = dw_w[:, :, 0, :, None] * pw_w[0, 0][None, None]
    b = (np.asarray(p["pw"]["b"], np.float32)
         + pw_w[0, 0].T @ np.asarray(p["dw"]["b"], np.float32))
    return w, b


def prepare_trunk(params: dict) -> tuple[list, tuple]:
    """Packed weights of a stand-in landmark trunk (numpy params of
    ``models/blaze.init_blaze_landmark``): ([{"wmat", "b"}] numpy per block,
    ((wspec, cin), ...))."""
    arrays, specs = [], []
    for name in ("b1", "b2", "b3", "b4"):
        w, b = compose_block_params(params[name])
        cin = w.shape[2]
        wmat, wspec = pack_block_weights(w, cin=cin)
        arrays.append({"wmat": wmat, "b": b})
        specs.append((wspec, cin))
    return arrays, tuple(specs)


def pack_s2d(x: Tensor) -> Tensor:
    """[B, C, H, W] -> [B, 4C, H/2, W/2], parity-major planes
    ((a*2+b)*C + c) — the multi_crop pack=2 channel order."""
    b, c, hh, ww = x.shape
    y = x.reshape(b, c, hh // 2, 2, ww // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(b, 4 * c, hh // 2, ww // 2)


# -- K3 -------------------------------------------------------------------------


def _kdim(wspec: str, cin: int) -> int:
    if wspec == "sliced":
        if cin % 8:
            raise ValueError(f"sliced layout needs cin % 8 == 0, got {cin}")
        return 9 * cin
    if wspec == "expanded":
        return 4 * (-(-4 * cin // 8) * 8)
    raise ValueError(f"unknown wspec {wspec!r}")


def dense_s2_block_plain(x_packed: Tensor, wmat: Tensor, wspec: str,
                         b: Tensor, alpha: Tensor | None, *, cin: int,
                         resid: bool) -> Tensor:
    """Plain PyTorch version of K3 (the TPU kernel's flat roll + edge-mask
    windows, bf16 rounding, f32 accumulation, fused epilogue)."""
    bsz, c4, h, w = x_packed.shape
    cout = wmat.shape[0]
    hw = h * w
    x = x_packed.reshape(bsz, c4, hw).to(torch.float32)
    m = torch.from_numpy(_edge_masks(h, w)).to(x.device)

    def shifted(k, row):
        return x if k == 0 else torch.roll(x, -k, dims=2) * m[row]
    shifts = (x, shifted(1, 1), shifted(w, 2), shifted(w + 1, 3))
    if wspec == "sliced":
        win = torch.cat([
            shifts[(dy // 2) * 2 + dx // 2][
                :, ((dy % 2) * 2 + dx % 2) * cin:
                ((dy % 2) * 2 + dx % 2 + 1) * cin]
            for dy in range(3) for dx in range(3)], 1)
    else:
        pad = -(-4 * cin // 8) * 8
        zeros = x.new_zeros((bsz, pad - 4 * cin, hw))
        win = torch.cat([t for s in shifts for t in (s, zeros)], 1)
    win = win.to(torch.bfloat16).to(torch.float32)
    acc = wmat.to(torch.float32) @ win                       # [B, O, hw]
    acc = acc + b.to(torch.float32)[:, None]
    if resid:
        pooled = torch.maximum(torch.maximum(x[:, 0:cin], x[:, cin:2 * cin]),
                               torch.maximum(x[:, 2 * cin:3 * cin],
                                             x[:, 3 * cin:4 * cin]))
        acc = torch.cat([acc[:, :cin] + pooled, acc[:, cin:]], 1)
        acc = torch.clamp(acc, min=0.0)
    else:
        a = (torch.zeros_like(acc[0, :, :1]) if alpha is None
             else alpha.to(torch.float32)[:, None])
        acc = torch.where(acc >= 0.0, acc, acc * a)
    return acc.to(x_packed.dtype).reshape(bsz, cout, h, w)


def dense_s2_block(x_packed: Tensor, wmat: Tensor, wspec: str, b: Tensor,
                   alpha: Tensor | None, *, cin: int, resid: bool) -> Tensor:
    """Packed input [B, 4*cin, h, w] -> [B, cout, h, w] (h, w are the
    OUTPUT resolution).  ``wmat`` bf16 [cout, K] from pack_block_weights;
    ``resid`` selects the blaze residual epilogue, else [P]ReLU
    (``alpha=None`` -> ReLU)."""
    bsz, c4, h, w = x_packed.shape
    cout = wmat.shape[0]
    kdim = _kdim(wspec, cin)
    if (c4 != 4 * cin or tuple(wmat.shape) != (cout, kdim)
            or tuple(b.shape) != (cout,)
            or (alpha is not None and tuple(alpha.shape) != (cout,))
            or (resid and cout < cin)):
        raise ValueError(f"dense_s2_block: x {tuple(x_packed.shape)}, cin "
                         f"{cin}, wmat {tuple(wmat.shape)} ({wspec}), b "
                         f"{tuple(b.shape)}")
    if x_packed.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dense_s2_block: input dtype {x_packed.dtype}")
    if x_packed.device.type == "cpu":
        return dense_s2_block_plain(x_packed, wmat, wspec, b, alpha,
                                    cin=cin, resid=resid)
    dev = x_packed.device
    if not x_packed.is_cuda or any(
            t.device != dev for t in (wmat, b, alpha) if t is not None):
        raise ValueError("dense_s2_block: all operands on one CUDA device")
    if wmat.dtype != torch.bfloat16:
        raise ValueError(f"dense_s2_block: wmat must be bf16, got "
                         f"{wmat.dtype}")
    x_packed = x_packed.contiguous()
    wmat = wmat.contiguous()
    bias = b.to(torch.float32).contiguous()
    al = None if alpha is None else alpha.to(torch.float32).contiguous()
    out = torch.empty((bsz, cout, h, w), dtype=x_packed.dtype, device=dev)
    lib = build.load("dense_s2_block")
    fn = lib.dense_s2_block_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x_packed.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
             None if al is None else al.data_ptr(), out.data_ptr(), bsz,
             cin, cout, h, w, kdim, int(wspec == "expanded"), int(resid),
             int(x_packed.dtype == torch.bfloat16),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "dense_s2_block")
    dense_s2_block.launches += 1
    return out


dense_s2_block.launches = 0


def trunk_apply(arrays: list, specs: tuple, stems: Tensor) -> Tensor:
    """Stem activations [B, 24, S/2, S/2] -> spatial trunk features
    [B, 192, S/32, S/32] (four K3 launches, 2x2 space-to-depth between)."""
    y = stems
    for blk, (wspec, cin) in zip(arrays, specs):
        y = dense_s2_block(pack_s2d(y).contiguous(), blk["wmat"], wspec,
                           blk["b"], None, cin=cin, resid=True)
    return y
