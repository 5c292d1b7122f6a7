"""Host→device frame pipeline — the counterpart of
``bp_from_video_tpu/runtime/feeder.py``: capture threads feeding
latest-wins slots, a batched uint8 upload, BGR→RGB on the device.

The reference's pipeline transport is three depth-1 manager queues with
drop-oldest semantics (reference pbp.py:24-30, :64-68).  Here the one real
queue left is host→card: each stream has a capture thread publishing into a
lock-free native ``FrameSlot`` (drop-oldest, bounded latency; the slot
stores frames planar), and the feeder gathers the newest frame of every
stream into one [S, 3, H, W] uint8 host buffer (planar — the layout the
engine's crop and ROI kernels read; uint8 on the wire, 4× less PCIe
traffic than f32) and ships it with one copy.

On a CUDA device the host buffers are pinned and the copies asynchronous
(``non_blocking``).  Two buffers are filled in turn, each guarded by a CUDA
event recorded after its copy: a buffer is refilled only once its last copy
has finished, so a frame never tears, while the other buffer's copy may
still be in flight.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Sequence

import numpy as np
import torch

from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.exceptions import CaptureError
from bp_from_video_tpu_torch.native import FrameSlot
from bp_from_video_tpu_torch.runtime.capture import VideoReader


class StreamFeed:
    """One capture thread pumping a VideoReader into a FrameSlot."""

    def __init__(self, reader: VideoReader, frame_shape):
        self.reader = reader
        # planar=True: the native put transposes HWC->CHW inside this
        # stream's capture thread (GIL-released), so the feeder's batch
        # gather is a contiguous copy straight into the upload buffer.
        self.slot = FrameSlot(frame_shape, planar=True)
        self.error: BaseException | None = None
        self.done = threading.Event()
        self._release_lock = threading.Lock()
        self._released = False
        self._prop_keys: queue.SimpleQueue[int] = queue.SimpleQueue()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def request_prop(self, key: int) -> None:
        """Queue a camera-property keypress for the CAPTURE thread to apply
        between reads: cv2.VideoCapture is not thread-safe, so the driver
        must not call prop_control concurrently with cap.read()."""
        self._prop_keys.put(key)

    def _loop(self):
        try:
            while not self.done.is_set():
                while not self._prop_keys.empty():
                    self.reader.prop_control(self._prop_keys.get_nowait())
                fd = self.reader.read_frame()
                self.slot.put(fd.frame, fd.timestamp, fd.sampling_freq,
                              fd.calibrating)
        except Exception as e:  # CaptureError is the normal EOF
            self.error = e
        finally:
            self.done.set()
            # The reader is released by the thread that reads it:
            # cv2.VideoCapture is not thread-safe, and releasing from the
            # feeder's cleanup while this thread sits blocked inside
            # cap.read() (stalled webcam) is undefined behaviour.
            self._release_reader()

    def _release_reader(self):
        with self._release_lock:
            if not self._released:
                self._released = True
                try:
                    self.reader.cleanup()
                except Exception:  # release is best-effort
                    pass

    def stop(self):
        self.done.set()

    def join(self, timeout=None):
        self._thread.join(timeout)
        return not self._thread.is_alive()


class _Upload:
    """One host batch (frames, timestamps, sampling rates, calibrating
    flags), pinned on a CUDA device, and the event of its last copy."""

    def __init__(self, s: int, c: int, h: int, w: int, pin: bool):
        def empty(shape, dtype):
            t = torch.empty(shape, dtype=dtype, pin_memory=pin)
            if pin and not t.is_pinned():
                raise RuntimeError("the feeder's host buffer is not pinned")
            return t
        self.frames = empty((s, c, h, w), torch.uint8)
        self.ts = empty((s,), torch.float32)
        self.fs = empty((s,), torch.float32)
        self.cal = empty((s,), torch.bool)
        self.frames.zero_()
        self.event = None


class DeviceFeeder:
    """Batches the newest frame of every stream and ships it to the device
    (``device=None`` means ``"cuda"``; raises without CUDA unless
    ``device="cpu"``).

    ``get_batch()`` returns (frames_rgb uint8 [S, 3, H, W], timestamps
    [S], sampling_freqs [S], calibrating [S]), all on the device — always
    the newest available frame per stream (frames the engine missed are
    dropped, exactly the reference's latest-wins policy; ``dropped``
    counts them per stream).  Raises CaptureError when every stream has
    ended (EOF) — the drivers' clean-shutdown signal.
    """

    def __init__(self, readers: Sequence[VideoReader],
                 frame_shape: tuple[int, int, int], device=None):
        self.device = resolve_device(device)
        self.frame_shape = tuple(frame_shape)
        s = len(readers)
        h, w, c = self.frame_shape
        pin = self.device.type == "cuda"
        self._bufs = [_Upload(s, c, h, w, pin) for _ in range(2)]
        self._k = 0                     # the buffer the last batch used
        self._fs = np.full((s,), np.nan, np.float32)
        self._ts = np.zeros((s,), np.float32)
        self._cal = np.zeros((s,), bool)
        self._have = np.zeros((s,), bool)
        self._seq = np.zeros((s,), np.int64)
        self.dropped = np.zeros((s,), np.int64)
        self._warm = False
        self.feeds = [StreamFeed(r, frame_shape).start() for r in readers]

    def _poll(self, frames: np.ndarray, fresh: np.ndarray) -> None:
        """Take each stream's newest frame, if it has a fresh one, into its
        row of ``frames``; mark it in ``fresh``."""
        for i, feed in enumerate(self.feeds):
            item = feed.slot.get(require_fresh=True, out=frames[i])
            if item is not None:
                _, ts, fs, cal, seq = item
                self._ts[i], self._fs[i], self._cal[i] = ts, fs, cal
                self.dropped[i] += seq - self._seq[i] - 1
                self._seq[i] = seq
                self._have[i] = True
                fresh[i] = True

    def get_batch(self, block: bool = True):
        k = 1 - self._k
        buf, prev = self._bufs[k], self._bufs[self._k]
        if buf.event is not None:
            buf.event.synchronize()     # its last copy has left the buffer
        frames = buf.frames.numpy()
        fresh = np.zeros_like(self._have)
        # Warm-up barrier: the first batch must not ship a stream's initial
        # zero frame just because another stream produced first.  Wait until
        # every stream has published at least one frame (or ended) — the
        # analog of the reference pipeline's blocking first q_in.get()
        # (pbp.py:21: downstream stages idle until a real frame arrives).
        while block and not self._warm:
            self._poll(frames, fresh)
            if all(h or f.done.is_set()
                   for h, f in zip(self._have, self.feeds)):
                self._warm = True
                if self._have.any():
                    return self._ship(k)
            time.sleep(0.0005)
        while True:
            alive = False
            for feed in self.feeds:
                # Unexpected capture-thread failures propagate to the driver
                # (the reference's any-stage-dies-stops-all contract,
                # pbp.py:49-53); CaptureError is the normal EOF path and is
                # handled by the all-streams-ended checks below.
                if feed.error is not None and not isinstance(
                        feed.error, CaptureError):
                    raise feed.error
                if not feed.done.is_set():
                    alive = True
            self._poll(frames, fresh)
            got = bool(fresh.any())
            if not alive and not got and not self._have.any():
                raise CaptureError("all streams ended")
            if got or not block:
                break
            if not alive:
                raise CaptureError("all streams ended")
            time.sleep(0.0005)
        if not self._have.any():
            # Non-blocking call before any stream produced: no real frames
            # to ship (never hand the engine the zero-initialized buffer).
            return None
        # Streams without a fresh frame this call keep their last one: the
        # other buffer holds it (this buffer's row is two batches old).
        stale = ~fresh & self._have
        frames[stale] = prev.frames.numpy()[stale]
        return self._ship(k)

    def idle_batch(self):
        """The batch of a feeder whose streams have all ended: the last one
        shipped, again (each stream keeps its last frame and timestamp, as
        a stream that ends before the others does), or before any frame,
        zero frames with NaN timestamps (discarded by the NaN-masked
        rings)."""
        buf = self._bufs[self._k]
        if buf.event is not None:
            buf.event.synchronize()     # its last copy has left the buffer
        return self._ship(self._k)

    def _ship(self, k: int):
        buf = self._bufs[k]
        self._k = k
        # Streams that ended before producing anything keep NaN timestamps:
        # the NaN-masked rings discard their samples end-to-end.
        buf.ts.numpy()[:] = np.where(self._have, self._ts, np.nan)
        buf.fs.numpy()[:] = self._fs
        buf.cal.numpy()[:] = self._cal
        host = (buf.frames, buf.ts, buf.fs, buf.cal)
        if self.device.type == "cuda":
            out = [t.to(self.device, non_blocking=True) for t in host]
            buf.event = torch.cuda.Event()
            buf.event.record(torch.cuda.current_stream(self.device))
        else:   # a batch must never alias a buffer that is refilled later
            out = [t.clone() for t in host]
        # On-device channel flip (OpenCV frames are BGR; the engine consumes
        # RGB, reference inference_runner.py:171's cvtColor).
        out[0] = out[0].flip(1)
        return tuple(out)

    def prop_control(self, stream: int, key: int) -> None:
        """Thread-safe camera prop adjustment: routes the keypress to the
        stream's capture thread (StreamFeed.request_prop)."""
        if key is None or key < 0:
            return  # no key pressed this frame
        self.feeds[stream].request_prop(key)

    def cleanup(self):
        for feed in self.feeds:
            feed.stop()
        for feed in self.feeds:
            if feed.join(timeout=2.0):
                # Thread exited; its finally released the reader already
                # (idempotent).  A thread still blocked in cap.read() keeps
                # ownership and releases on return — releasing from here
                # concurrently is the undefined-behavior case.
                feed._release_reader()
