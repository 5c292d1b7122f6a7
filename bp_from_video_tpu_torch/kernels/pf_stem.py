"""Kernel K7: one layer of PhysFormer's stem -- the 3-D conv, its 1x2x2
max-pool, bias and ReLU -- as one implicit GEMM (``csrc/pf_stem.cu``).

Replaces no TPU kernel (the JAX package has no PhysFormer): it replaces the
composition ``pf_stem_plain`` runs (cuDNN conv, the temporal taps' copies,
pads and the pool over the full-resolution map).  A layer maps the
channels-last [B, T, H, W, C] bf16 map to [B, T, H/2, W/2, cout]:

- ``C == 3`` (stem0): the 5x5 conv on the clip, as a 3x3 conv over the
  2x2-packed frame whose output groups are the pool's four positions
  (``models/physformer._packed_stem0``);
- else (stem1, stem2): a 3x3x3 conv, the frames before and after read in
  place and zero past the clip's ends.

The kernel takes its own weight layout, ``kernel_weights`` of the plain
(w, b): ``wk`` bf16 [N, K], row n a product column, K in k-groups of 8
channels of one tap, the taps (dt, ky, kx) in order and channel-fastest
(stem0: packed channels 0-15 of tap (ky, kx); its column n = (oct*4 + pos)*8
+ i is pool position pos of channel oct*8 + i), K padded to a multiple of 16
with zeros; ``bias`` f32 [cout] (the plain's bf16 bias, exactly).  It sums in
f32, takes the 2x2 max, adds the bias, applies ReLU and rounds once.

``pf_stem`` launches the kernel for a CUDA tensor and runs ``pf_stem_gemm``
(the kernel's product in plain PyTorch, on its weight layout) for a CPU
tensor.  The kernel takes the published PhysFormer's three layers at crop
128 (3 -> 24 on 128x128, 24 -> 48 on 64x64, 48 -> 96 on 32x32) and raises on
any other shape.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch.kernels import build
from bp_from_video_tpu_torch.utils.profiling import count

Tensor = torch.Tensor

# (cin, cout) -> the frame (h, w) the kernel's layer takes.
LAYERS = {(3, 24): (128, 128), (24, 48): (64, 64), (48, 96): (32, 32)}


def _pool_bias_relu(y: Tensor, b: Tensor) -> Tensor:
    """Channels-last [N, C, H, W] -> 2x2 max-pooled, plus ``b``, ReLU:
    [N, H/2, W/2, C]."""
    n, c, h, w = y.shape
    v = y.permute(0, 2, 3, 1).reshape(n, h // 2, 2, w // 2, 2, c)
    return F.relu_(v.amax((2, 4)).add_(b))


def _pack(x: Tensor) -> Tensor:
    """Clip frames [N, H, W, 3] -> the 2x2-packed frames [N, H/2, W/2, 12],
    channel (p*2+q)*3 + c pixel (2i+p, 2j+q)'s channel c."""
    n, hh, ww, _ = x.shape
    return x.reshape(n, hh // 2, 2, ww // 2, 2, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(n, hh // 2, ww // 2, 12)


def pf_stem_plain(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """One stem layer as the composition PyTorch runs: x [B, T, H, W, C]
    -> [B, T, H/2, W/2, cout].  stem0 (C == 3): ``w`` [4 cout, 16, 3, 3] the
    packed conv, the 2x2-packed frame (padded to 16 channels) convolved,
    the max over its four output groups; else ``w`` [cout, 3C, 3, 3] over
    the frames with their temporal taps as channels, the 2x2 max-pool.  The
    conv output is rounded to the compute dtype, then the bias is added to
    the pooled map and ReLU applied (both commute with the max)."""
    # Imported here: the model module imports this one.
    from bp_from_video_tpu_torch.models.physformer import temporal_taps
    bsz, t, hh, ww, c = x.shape
    if c == 3:
        co = b.shape[0]
        packed = _pack(x.reshape(bsz * t, hh, ww, 3))
        y = F.conv2d(F.pad(packed, (0, 4)).permute(0, 3, 1, 2), w,
                     padding=1)                 # the 4 pool positions' maps
        m = F.relu_(y.permute(0, 2, 3, 1).unflatten(-1, (4, co)).amax(-2)
                    .add_(b))
    else:
        taps = temporal_taps(x).flatten(0, 1)
        m = _pool_bias_relu(F.conv2d(taps.permute(0, 3, 1, 2), w, padding=1),
                            b)
    return m.unflatten(0, (bsz, t))


def kernel_weights(w: Tensor, b: Tensor, packed: bool) -> tuple[Tensor,
                                                                  Tensor]:
    """The kernel's (wk bf16 [N, K], bias f32) from a plain layer's (w, b):
    stem0 (``packed``) w [4 cout, 16, 3, 3], else w [cout, 3 cin, 3, 3]
    (the frames' channels tap-major)."""
    co = b.shape[0]
    cin = 3 if packed else w.shape[1] // 3
    if (cin, co) not in LAYERS:
        raise ValueError(f"pf_stem takes (cin, cout) in {sorted(LAYERS)}, "
                         f"got {(cin, co)}")
    if packed:
        # [pos*co + oct*8 + i, c16, ky, kx] -> [(oct, pos, i), (ky, kx, c16)]
        wk = w.reshape(4, co // 8, 8, 16, 3, 3).permute(
            1, 0, 2, 4, 5, 3).reshape(4 * co, 144)
    else:
        # [n, dt*cin + c, ky, kx] -> [n, (dt, ky, kx, c)]
        wk = w.reshape(co, 3, cin, 3, 3).permute(0, 1, 3, 4, 2).reshape(
            co, 27 * cin)
    wk = F.pad(wk, (0, -wk.shape[1] % 16))
    return (wk.to(torch.bfloat16).contiguous(),
            b.to(torch.bfloat16).to(torch.float32).contiguous())


def _windows(x: Tensor) -> Tensor:
    """The product's A: [B, T, H', W', K'] windows of each output pixel
    (H' x W' the full-resolution output; stem0: of the packed frame) in
    the kernel's k order, K' before padding."""
    bsz, t, hh, ww, c = x.shape
    if c == 3:
        xp = F.pad(_pack(x.reshape(bsz * t, hh, ww, 3)), (0, 4, 1, 1, 1, 1))
        h2, w2 = hh // 2, ww // 2
        cols = [xp[:, ky:ky + h2, kx:kx + w2]
                for ky in range(3) for kx in range(3)]
        return torch.cat(cols, -1).unflatten(0, (bsz, t))
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1))
    cols = [xp[:, dt:dt + t, ky:ky + hh, kx:kx + ww]
            for dt in range(3) for ky in range(3) for kx in range(3)]
    return torch.cat(cols, -1)


def pf_stem_gemm(x: Tensor, wk: Tensor, bias: Tensor) -> Tensor:
    """K7's function in plain PyTorch on its weight layout: the same
    products summed in f32, the 2x2 max (stem0: over the four position
    groups), the f32 bias, ReLU, one rounding to x's dtype."""
    bsz, t, hh, ww, c = x.shape
    a = _windows(x).float()
    # wk's columns past the windows' K are zero weights.
    y = a @ wk[:, :a.shape[-1]].float().t()
    co = bias.shape[0]
    if c == 3:
        v = y.unflatten(-1, (co // 8, 4, 8)).amax(-2).flatten(-2)
    else:
        v = y.unflatten(3, (ww // 2, 2)).unflatten(2, (hh // 2, 2)).amax(
            (3, 5))
    return torch.relu(v + bias).to(x.dtype)


def _check(x: Tensor, wk: Tensor, bias: Tensor) -> tuple[int, int]:
    """(cin, cout) of a layer the kernel takes; raises otherwise."""
    if x.ndim != 5 or wk.ndim != 2 or bias.ndim != 1:
        raise ValueError(f"pf_stem: x {tuple(x.shape)}, wk "
                         f"{tuple(wk.shape)}, bias {tuple(bias.shape)}")
    cin, cout = x.shape[-1], bias.shape[0]
    hw = LAYERS.get((cin, cout))
    if hw is None or tuple(x.shape[2:4]) != hw:
        raise ValueError(f"pf_stem takes {sorted(LAYERS.items())} "
                         f"((cin, cout): (h, w)), got x {tuple(x.shape)}, "
                         f"cout {cout}")
    n = 4 * cout if cin == 3 else cout
    k = 144 if cin == 3 else -(-27 * cin // 16) * 16
    if tuple(wk.shape) != (n, k):
        raise ValueError(f"pf_stem: wk {tuple(wk.shape)}, want {(n, k)}")
    if x.dtype != torch.bfloat16 or wk.dtype != torch.bfloat16:
        raise ValueError(f"pf_stem takes bf16 x and wk, got {x.dtype}, "
                         f"{wk.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"pf_stem: bias {bias.dtype}, want float32")
    return cin, cout


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry's ctypes signature, set once."""
    lib = build.load("pf_stem")
    lib.pf_stem_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.pf_stem_launch.restype = ctypes.c_int
    return lib


def pf_stem(x: Tensor, wk: Tensor, bias: Tensor) -> Tensor:
    """One stem layer, x bf16 [B, T, H, W, C] contiguous -> bf16 [B, T, H/2,
    W/2, cout]; (wk, bias) from ``kernel_weights``."""
    cin, cout = _check(x, wk, bias)
    if x.device.type == "cpu":
        return pf_stem_gemm(x, wk, bias)
    dev = x.device
    if not x.is_cuda or wk.device != dev or bias.device != dev:
        raise ValueError("pf_stem: all operands on one CUDA device")
    if not (x.is_contiguous() and wk.is_contiguous()
            and bias.is_contiguous()):
        raise ValueError("pf_stem takes contiguous x, wk and bias")
    if x.data_ptr() % 16 or wk.data_ptr() % 16 or bias.data_ptr() % 8:
        raise ValueError("pf_stem: x and wk 16-byte aligned, bias 8")
    bsz, t, hh, ww, _ = x.shape
    out = torch.empty((bsz, t, hh // 2, ww // 2, cout), dtype=x.dtype,
                      device=dev)
    lib = _lib()
    err = lib.pf_stem_launch(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(),
        bsz * t, t, hh, ww, cin, cout,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "pf_stem")
    pf_stem.launches += 1
    count("pf_stem.launches")
    return out


pf_stem.launches = 0
