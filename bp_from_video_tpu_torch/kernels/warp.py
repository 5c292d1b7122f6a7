"""Kernel K1: fused multi-crop bilinear resampling (``csrc/multi_crop.cu``).

Counterpart of ``bp_from_video_tpu/pallas/warp_kernel.py`` ``multi_crop``:
every landmark crop of a frame (face 256^2, two hands 224^2 at the
flagship) in one launch, axis-aligned (cx, cy, w, h) rects, zero-pad
triangle weights, NaN rect -> zero crop, ``scale`` folded into the
epilogue, optional 2x2 space-to-depth output (``pack=2``, channel
``(a*2+b)*3 + ch``).

``multi_crop`` launches the CUDA kernel for a CUDA tensor and takes
``multi_crop_plain`` for a CPU tensor; the plain version rounds at the same
points as the TPU kernel (weights and the row-pass ``tmp`` in ``dtype``,
f32 accumulation, ``* scale``, cast to ``out_dtype``).
"""

from __future__ import annotations

import ctypes

import torch

from bp_from_video_tpu_torch.kernels import build

Tensor = torch.Tensor
_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def _round(x: Tensor, dtype) -> Tensor:
    """Round f32 values to ``dtype`` and back (the operand rounding of a
    ``dtype`` matmul with f32 accumulation)."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def _weights(n: int, off: int, step: int, size: int, center: Tensor,
             extent: Tensor, in_len: int, dtype) -> Tensor:
    """[S, n, in_len] bilinear rows for crop pixels off + step*i (the TPU
    kernel's ``weights``: NaN sample -> zero row)."""
    dev = center.device
    i = torch.arange(n, dtype=torch.float32, device=dev)
    # Divide by a tensor, not a Python number: on CUDA, PyTorch turns a
    # division by a scalar into a multiplication by its reciprocal, which
    # moves some samples by one f32 ulp and flips their bf16 weights.
    u = ((i * step + off) + 0.5) / torch.full_like(i, size) - 0.5
    s = center[:, None] + u * extent[:, None] - 0.5              # [S, n]
    g = torch.arange(in_len, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(s[..., None] - g), min=0.0)
    w = torch.where(torch.isnan(s)[..., None], 0.0, w)
    return _round(w, dtype)


def multi_crop_plain(frames_planar: Tensor, rects: Tensor,
                     sizes: tuple[int, ...], dtype=torch.float32,
                     out_dtype=torch.float32, scale: float = 1.0,
                     pack: int | tuple[int, ...] = 1) -> tuple[Tensor, ...]:
    """Plain PyTorch version of K1 (same signature and rounding)."""
    s, ch, h, w = frames_planar.shape
    packs = _packs(pack, len(sizes))
    f = frames_planar.to(torch.float32)                      # exact in bf16
    outs = []
    for c, (size, p) in enumerate(zip(sizes, packs)):
        cx, cy, rw, rh = (rects[:, c, k] for k in range(4))
        n2 = size // p
        planes = []
        tmps = [_round(_weights(n2, a, p, size, cy, rh, h, dtype)[:, None]
                       @ f, dtype) for a in range(p)]          # [S,3,n2,W]
        wxs = [_weights(n2, b, p, size, cx, rw, w, dtype) for b in range(p)]
        for a in range(p):
            for b in range(p):
                res = tmps[a] @ wxs[b][:, None].transpose(-1, -2)
                if scale != 1.0:
                    res = res * scale
                planes.append(res)                            # [S,3,n2,n2]
        outs.append(torch.cat(planes, 1).to(out_dtype))
    return tuple(outs)


def _packs(pack, n: int) -> tuple[int, ...]:
    packs = (pack,) * n if isinstance(pack, int) else tuple(pack)
    if len(packs) != n:
        raise ValueError(f"{len(packs)} packs for {n} crops")
    return packs


def multi_crop(frames_planar: Tensor, rects: Tensor,
               sizes: tuple[int, ...], dtype=torch.float32,
               out_dtype=torch.float32, scale: float = 1.0,
               pack: int | tuple[int, ...] = 1) -> tuple[Tensor, ...]:
    """Crop ``len(sizes)`` axis-aligned rects out of each stream's frame.

    frames_planar: uint8 [S, 3, H, W]; rects: f32 [S, C, 4] (cx, cy, w, h)
    pixel rects (NaN -> zero crop).  Returns one
    [S, 3*p*p, size/p, size/p] ``out_dtype`` tensor per crop."""
    s, ch, h, w = frames_planar.shape
    c = rects.shape[1]
    packs = _packs(pack, len(sizes))
    if (frames_planar.dtype != torch.uint8 or ch != 3
            or rects.dtype != torch.float32 or tuple(rects.shape) != (s, c, 4)
            or c != len(sizes)):
        raise ValueError(f"multi_crop: frames {frames_planar.dtype} "
                         f"{tuple(frames_planar.shape)}, rects {rects.dtype} "
                         f"{tuple(rects.shape)}, sizes {sizes}")
    if not all(p in (1, 2) and sz % p == 0 for p, sz in zip(packs, sizes)):
        raise ValueError(f"multi_crop: sizes {sizes} / packs {packs}")
    if dtype not in _FLOAT_TYPES or out_dtype not in _FLOAT_TYPES:
        raise ValueError(f"multi_crop: dtype {dtype} / out_dtype {out_dtype}")
    if frames_planar.device.type == "cpu":
        return multi_crop_plain(frames_planar, rects, sizes, dtype,
                                out_dtype, scale, packs)
    if not (frames_planar.is_cuda and rects.device == frames_planar.device):
        raise ValueError("multi_crop: frames and rects must share one "
                         "CUDA device")
    if c > 8:
        raise ValueError(f"multi_crop: at most 8 crops, got {c}")
    frames_planar = frames_planar.contiguous()
    rects = rects.contiguous()
    per = [3 * p * p * (sz // p) ** 2 for sz, p in zip(sizes, packs)]
    buf = torch.empty(s * sum(per), dtype=out_dtype,
                      device=frames_planar.device)
    lib = build.load("multi_crop")
    fn = lib.multi_crop_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p]
    fn.restype = ctypes.c_int
    c_sizes = (ctypes.c_int * c)(*sizes)
    c_packs = (ctypes.c_int * c)(*packs)
    err = fn(frames_planar.data_ptr(), rects.data_ptr(), buf.data_ptr(),
             c_sizes, c_packs, c, s, h, w, float(scale),
             int(dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
             torch.cuda.current_stream(frames_planar.device).cuda_stream)
    build.check(lib, err, "multi_crop")
    multi_crop.launches += 1
    outs, off = [], 0
    for sz, p, n in zip(sizes, packs, per):
        outs.append(buf[off:off + s * n].view(s, 3 * p * p, sz // p,
                                              sz // p))
        off += s * n
    return tuple(outs)


multi_crop.launches = 0
