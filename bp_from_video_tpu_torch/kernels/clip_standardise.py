"""Kernel K8: PhysFormer's clip standardisation (``csrc/clip_standardise.cu``).

Replaces no TPU kernel (the JAX package has no PhysFormer): it replaces the
composition ``clip_standardise_plain`` runs, a gather of the due clips out
of the engine's ring of face crops and an f32 standardisation a few clips
at a time.  Both take the ring ``crops`` [S, T + 1, C, C, 3] (slot T a
spare never read), ``head`` int64 [S] (slot ``(head + t) % T`` holds the
t-th oldest crop) and ``rows`` int64 [B] (None: every stream in order), and
return the clips oldest first as a fresh contiguous [B, T, C, C, 3] tensor
in the ring's dtype: each clip's ``(x - mean) * rsqrt(var)`` over all its
values, mean and population variance in f32, 0 where the variance is 0.

``clip_standardise`` launches the kernel twice (the statistics, then the
output), reading the ring in place; it takes a bf16 ring on the card and
raises on anything else.  The engine picks one of the two when it is
built (``runtime/engine.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bp_from_video_tpu_torch.kernels import build
from bp_from_video_tpu_torch.utils.profiling import count

Tensor = torch.Tensor

# Clips the plain route standardises at a time (its f32 scratch).
PLAIN_ROWS = 8


def ring_slots(head: Tensor, t: int) -> Tensor:
    """[S, T] slots of a ring of ``t`` crops a stream, oldest first."""
    return (head[:, None] + torch.arange(t, device=head.device)) % t


def ordered_crops(crops: Tensor, head: Tensor,
                  rows: Tensor | None = None) -> Tensor:
    """The ring's crops oldest first, [S, T, ...] (of ``rows`` only when
    given), gathered."""
    slots = ring_slots(head, crops.shape[1] - 1)
    if rows is None:
        rows = torch.arange(slots.shape[0], device=slots.device)
    return crops[rows[:, None], slots[rows]]


def clip_standardise_plain(crops: Tensor, head: Tensor,
                           rows: Tensor | None = None) -> Tensor:
    """The clips gathered oldest first, then standardised in f32
    ``PLAIN_ROWS`` clips at a time (a whole batch in f32 would take 4x the
    ring's memory)."""
    x = ordered_crops(crops, head, rows)
    dims = tuple(range(1, x.ndim))
    for part in x.split(PLAIN_ROWS):
        # (x - mean) / population std in f32; a constant clip gives zeros.
        f = part.to(torch.float32)
        f -= f.mean(dims, keepdim=True)
        var = f.square().mean(dims, keepdim=True)
        part.copy_(f.mul_(torch.where(var > 0, torch.rsqrt(var), 0.0)))
    return x


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# The C entries' parameters, in order (each returns a CUDA error code).
ENTRIES = {
    "clip_standardise_plan": [_I32] * 4 + [_PTR],
    "clip_stats_launch": [_PTR] * 3 + [_I32] * 5 + [_PTR],
    "clip_apply_launch": [_PTR] * 5 + [_I32] * 6 + [_PTR],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its entries' ctypes signatures, set once."""
    lib = build.load("clip_standardise")
    for name, args in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def plan(device_index: int, b: int, t: int, frame: int,
         vec: int) -> tuple[int, int]:
    """Blocks a clip of the statistics launch and of the output launch for
    ``b`` clips of ``t`` frames of ``frame`` values read ``vec`` at a time
    on a card (from its SM count and the kernels' occupancy)."""
    lib = _lib()
    parts = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        build.check(lib, lib.clip_standardise_plan(b, t, frame, vec, parts),
                    "clip_standardise plan")
    return parts[0], parts[1]


def _check(crops: Tensor, head: Tensor, rows: Tensor | None) -> None:
    if crops.ndim < 3 or crops.shape[1] < 2 or head.shape != crops.shape[:1]:
        raise ValueError(f"clip_standardise: crops {tuple(crops.shape)} "
                         f"[S, T + 1, ...], head {tuple(head.shape)} [S]")
    if rows is not None and (rows.ndim != 1 or rows.shape[0] < 1):
        raise ValueError(f"clip_standardise: rows {tuple(rows.shape)} [B]")
    if crops.dtype != torch.bfloat16:
        raise ValueError(f"clip_standardise takes a bf16 ring, got "
                         f"{crops.dtype}")
    ints = (head,) if rows is None else (head, rows)
    if any(a.dtype != torch.int64 for a in ints):
        raise ValueError("clip_standardise takes int64 head and rows")
    dev = crops.device
    if not crops.is_cuda or any(a.device != dev for a in ints):
        raise ValueError("clip_standardise: all operands on one CUDA device")
    if not all(a.is_contiguous() for a in (crops,) + ints):
        raise ValueError("clip_standardise takes contiguous operands")


def clip_standardise(crops: Tensor, head: Tensor,
                     rows: Tensor | None = None) -> Tensor:
    """``clip_standardise_plain``'s function on K8, reading the ring in
    place: two launches on the current stream, no host sync."""
    _check(crops, head, rows)
    t = crops.shape[1] - 1
    frame = math.prod(crops.shape[2:])
    b = crops.shape[0] if rows is None else rows.shape[0]
    vec = 8 if frame % 8 == 0 and crops.data_ptr() % 16 == 0 else 1
    dev = crops.device
    nparts, napply = plan(dev.index, b, t, frame, vec)
    out = torch.empty((b, t) + crops.shape[2:], dtype=crops.dtype,
                      device=dev)
    parts = torch.empty((b, nparts, 2), dtype=torch.float32, device=dev)
    rows_ptr = None if rows is None else rows.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    build.check(lib, lib.clip_stats_launch(
        crops.data_ptr(), rows_ptr, parts.data_ptr(), b, t, frame, vec,
        nparts, stream), "clip_standardise (statistics)")
    count("clip_std.launches")
    build.check(lib, lib.clip_apply_launch(
        crops.data_ptr(), head.data_ptr(), rows_ptr, parts.data_ptr(),
        out.data_ptr(), b, t, frame, vec, nparts, napply, stream),
        "clip_standardise (output)")
    count("clip_std.launches")
    return out
