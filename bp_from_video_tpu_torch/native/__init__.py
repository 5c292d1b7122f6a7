"""Native host-runtime pieces (C++ through ctypes) — the counterpart of
``bp_from_video_tpu/native``: the lock-free latest-wins frame slot between
a capture thread and the device feeder (``framequeue.cpp``, a copy of the
JAX package's source).

The shared library is built with ``g++`` at first use into
``.torch_kernels_build/`` at the repository root (git-ignored, keyed by a
hash of the source and the flags), written under a per-process name and
moved into place, so a concurrent process never loads a half-written
library.  A failed build or load raises: there is no quiet fallback.
``FrameSlotPlain`` is the same slot in pure Python, the reference the
tests hold the native slot to; nothing on the driver path uses it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "framequeue.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)),
                          ".torch_kernels_build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()


def lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_ROOT,
                        f"framequeue-{digest.hexdigest()[:16]}.so")


def _build() -> str:
    out = lib_path()
    if not os.path.exists(out):
        os.makedirs(BUILD_ROOT, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for native/framequeue.cpp "
                               f"(rc={proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.fq_create.restype = ctypes.c_void_p
            lib.fq_create.argtypes = [ctypes.c_size_t]
            lib.fq_destroy.argtypes = [ctypes.c_void_p]
            lib.fq_put.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double,
                ctypes.c_double, ctypes.c_int32]
            lib.fq_put_planar.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                ctypes.c_double, ctypes.c_int32]
            lib.fq_get.restype = ctypes.c_int64
            lib.fq_get.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
            lib.fq_latest_seq.restype = ctypes.c_int64
            lib.fq_latest_seq.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def _shapes(frame_shape, planar: bool):
    """(frame shape, stored shape, frame bytes) of a slot."""
    frame_shape = tuple(frame_shape)
    if planar and len(frame_shape) != 3:
        raise ValueError(
            f"planar slots need a 3-D HWC frame shape, got {frame_shape} "
            "(single-channel planarize is the identity — use a plain slot)")
    h, w, c = frame_shape if len(frame_shape) == 3 else (*frame_shape, 1)
    return (frame_shape, (c, h, w) if planar else frame_shape,
            int(np.prod(frame_shape)))


def _check_frame(frame: np.ndarray, frame_shape) -> np.ndarray:
    frame = np.ascontiguousarray(frame, np.uint8)
    if frame.shape != frame_shape:
        # The native put copies frame_bytes: a smaller source would be an
        # out-of-bounds read, not just corrupt data.
        raise ValueError(
            f"frame shape {frame.shape} != slot shape {frame_shape}"
            " (all streams must share one resolution)")
    return frame


class FrameSlot:
    """Latest-wins frame hand-off between a capture thread and the device
    feeder (native triple buffer; reference pbp.py:24-30 drop-oldest
    semantics without pickling or a manager process).

    ``planar=True``: ``put`` takes interleaved HWC frames and the slot
    stores (and ``get`` returns) the planar [C, H, W] layout the engine's
    kernels consume; the transpose runs inside the native producer-side
    copy, with the GIL released, in each stream's capture thread."""

    native = True

    def __init__(self, frame_shape: tuple[int, int, int],
                 planar: bool = False):
        self.planar = planar
        self.frame_shape, self.out_shape, self.frame_bytes = _shapes(
            frame_shape, planar)
        self._lib = _load()
        q = self._lib.fq_create(self.frame_bytes)
        if not q:
            raise MemoryError(f"fq_create({self.frame_bytes}) failed")
        self._q = ctypes.c_void_p(q)
        self._consumed = 0

    def put(self, frame: np.ndarray, timestamp: float, fs: float,
            calibrating: bool) -> None:
        frame = _check_frame(frame, self.frame_shape)
        data = frame.ctypes.data_as(ctypes.c_char_p)
        if self.planar:
            h, w, c = frame.shape
            self._lib.fq_put_planar(self._q, data, h, w, c, float(timestamp),
                                    float(fs), int(calibrating))
        else:
            self._lib.fq_put(self._q, data, float(timestamp), float(fs),
                             int(calibrating))

    def get(self, require_fresh: bool = False, out: np.ndarray | None = None):
        """Newest (frame, timestamp, fs, calibrating, seq) or None.

        ``out``: optional preallocated C-contiguous uint8 array of
        ``out_shape`` the frame is written into (the feeder passes a row
        of its upload buffer)."""
        if (require_fresh
                and self._lib.fq_latest_seq(self._q) == self._consumed):
            return None
        if out is None:
            out = np.empty(self.out_shape, np.uint8)
        elif (out.shape != self.out_shape or out.dtype != np.uint8
              or not out.flags["C_CONTIGUOUS"]):
            # fq_get copies frame_bytes through this pointer: a smaller or
            # strided buffer would be an out-of-bounds native write.
            raise ValueError(
                f"out must be C-contiguous uint8 {self.out_shape}, "
                f"got {out.dtype} {out.shape}")
        ts, fs, cal = ctypes.c_double(), ctypes.c_double(), ctypes.c_int32()
        seq = self._lib.fq_get(self._q, out.ctypes.data_as(ctypes.c_char_p),
                               ctypes.byref(ts), ctypes.byref(fs),
                               ctypes.byref(cal), int(require_fresh))
        if seq == 0:
            return None
        self._consumed = int(seq)
        return out, ts.value, fs.value, bool(cal.value), int(seq)

    def latest_seq(self) -> int:
        return int(self._lib.fq_latest_seq(self._q))

    def __del__(self):
        q = getattr(self, "_q", None)
        if q:
            self._lib.fq_destroy(q)
            self._q = None


class FrameSlotPlain:
    """:class:`FrameSlot` in pure Python under a lock: the same contract,
    kept as the tests' reference for the native slot."""

    native = False

    def __init__(self, frame_shape: tuple[int, int, int],
                 planar: bool = False):
        self.planar = planar
        self.frame_shape, self.out_shape, self.frame_bytes = _shapes(
            frame_shape, planar)
        self._lock = threading.Lock()
        self._item = None
        self._seq = 0
        self._consumed = 0

    def put(self, frame: np.ndarray, timestamp: float, fs: float,
            calibrating: bool) -> None:
        frame = _check_frame(frame, self.frame_shape)
        stored = (np.ascontiguousarray(frame.transpose(2, 0, 1))
                  if self.planar else frame.copy())
        with self._lock:
            self._seq += 1
            self._item = (stored, float(timestamp), float(fs),
                          bool(calibrating), self._seq)

    def get(self, require_fresh: bool = False, out: np.ndarray | None = None):
        with self._lock:
            if self._item is None:
                return None
            frame, ts, fs, cal, seq = self._item
            if require_fresh and seq == self._consumed:
                return None
            self._consumed = seq
        if out is None:
            out = np.empty(self.out_shape, np.uint8)
        out[...] = frame
        return out, ts, fs, cal, seq

    def latest_seq(self) -> int:
        with self._lock:
            return self._seq
