"""Kernel K2: a landmark net's 3x3 stride-2 stem on 2x2 space-to-depth
packed crops (``csrc/stem_packed.cu``).

Counterpart of ``bp_from_video_tpu/pallas/stem_kernel.py`` ``stem_packed``.
Input: packed crops [B, 4*cin, S/2, S/2], channel order (a*2+b)*cin + c —
what ``kernels/warp.multi_crop(pack=2)`` emits, already scaled like the net
input.  A stride-2 tap (dy, dx) of the original image is the packed plane
(dy%2, dx%2) shifted by (dy//2, dx//2), zero past the far edge (TFLite SAME
at even sizes pads lo = 0, hi = 1).  Weights: plain HWIO [k, k, cin, cout],
k <= 3.  Taps are accumulated in f32 in (dy, dx, c) order, then bias and a
per-channel PReLU (alpha None or 0 = ReLU); the output
[B, cout, S/2, S/2] has the crops' dtype.

``stem_packed`` launches the CUDA kernel for a CUDA tensor and takes
``stem_packed_plain`` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch.kernels import build

Tensor = torch.Tensor

MAX_TAPS = 27


def _operands(crops_packed: Tensor, w: Tensor, b: Tensor,
              alpha: Tensor | None):
    """Validated (wmat f32 [cout, k*k*cin] in (dy, dx, c) tap order, bias
    f32, alpha f32, cin, cout, k, half)."""
    if crops_packed.ndim != 4 or w.ndim != 4:
        raise ValueError(f"stem_packed: crops {tuple(crops_packed.shape)}, "
                         f"w {tuple(w.shape)}")
    _, pc4, half, half2 = crops_packed.shape
    k, k2, cin, cout = w.shape
    if half != half2 or k != k2 or pc4 != 4 * cin:
        raise ValueError(f"stem_packed: crops {tuple(crops_packed.shape)}, "
                         f"w {tuple(w.shape)}")
    # Only the unit shifts a 3x3/2 window needs exist on the 2x2-packed
    # layout; k >= 5 would need a shift of 2.
    if k > 3:
        raise ValueError(f"stem_packed supports k<=3 stems, got k={k}")
    if tuple(b.shape) != (cout,) or (alpha is not None
                                     and tuple(alpha.shape) != (cout,)):
        raise ValueError(f"stem_packed: b {tuple(b.shape)} for cout {cout}")
    if crops_packed.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem_packed: crop dtype {crops_packed.dtype}")
    f32 = torch.float32
    wmat = w.reshape(k * k * cin, cout).t().to(f32).contiguous()
    bias = b.to(f32).contiguous()
    al = (torch.zeros_like(bias) if alpha is None
          else alpha.to(f32).contiguous())
    return wmat, bias, al, cin, cout, k, half


def stem_packed_plain(crops_packed: Tensor, w: Tensor, b: Tensor,
                      alpha: Tensor | None = None) -> Tensor:
    """Plain PyTorch version of K2, computed from the packed planes in the
    kernel's tap order (a separately rounded multiply and add per tap), so
    it rounds like the kernel."""
    wmat, bias, al, cin, cout, k, half = _operands(crops_packed, w, b, alpha)
    xp = F.pad(crops_packed.to(torch.float32), (0, 1, 0, 1))
    acc = torch.zeros((crops_packed.shape[0], cout, half, half),
                      dtype=torch.float32, device=crops_packed.device)
    t = 0
    for dy in range(k):
        for dx in range(k):
            for c in range(cin):
                pc = ((dy % 2) * 2 + dx % 2) * cin + c
                plane = xp[:, pc, dy // 2:dy // 2 + half,
                           dx // 2:dx // 2 + half]
                acc = acc + plane[:, None] * wmat[:, t][None, :, None, None]
                t += 1
    v = acc + bias[:, None, None]
    v = torch.where(v >= 0.0, v, v * al[:, None, None])
    return v.to(crops_packed.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entry's ctypes signature, set once."""
    lib = build.load("stem_packed")
    lib.stem_packed_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.stem_packed_launch.restype = ctypes.c_int
    return lib


def stem_packed(crops_packed: Tensor, w: Tensor, b: Tensor,
                alpha: Tensor | None = None) -> Tensor:
    """Fused stem over a batch of packed crops [B, 4*cin, S/2, S/2] ->
    [B, cout, S/2, S/2] in the crop dtype.  w: HWIO [k, k, cin, cout];
    b: [cout]; alpha: optional per-channel PReLU slopes [cout]."""
    wmat, bias, al, cin, cout, k, half = _operands(crops_packed, w, b, alpha)
    if crops_packed.device.type == "cpu":
        return stem_packed_plain(crops_packed, w, b, alpha)
    dev = crops_packed.device
    if not crops_packed.is_cuda or any(t.device != dev
                                       for t in (wmat, bias, al)):
        raise ValueError("stem_packed: all operands on one CUDA device")
    if k * k * cin > MAX_TAPS:
        raise ValueError(f"stem_packed: the kernel holds {MAX_TAPS} taps, "
                         f"got {k * k * cin}")
    crops_packed = crops_packed.contiguous()
    bsz = crops_packed.shape[0]
    out = torch.empty((bsz, cout, half, half), dtype=crops_packed.dtype,
                      device=dev)
    lib = _lib()
    err = lib.stem_packed_launch(
        crops_packed.data_ptr(), wmat.data_ptr(), bias.data_ptr(),
        al.data_ptr(), out.data_ptr(), bsz, cin, cout, k, half,
        int(crops_packed.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "stem_packed")
    stem_packed.launches += 1
    return out


stem_packed.launches = 0
