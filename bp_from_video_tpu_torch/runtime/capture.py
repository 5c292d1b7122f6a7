"""Host-side video capture — a copy of ``bp_from_video_tpu/runtime/capture.py``
(reference video_reader.py rebuilt), which imports no JAX.

Capabilities mirrored: webcam (int path) or file (str path); MJPG
negotiation and optional target resolution for webcams; timed auto-
calibration (autofocus / auto-white-balance / auto-exposure enabled then
locked, reference video_reader.py:60-61/:68-71/:106-108); runtime camera
property adjustment via numpad keys (:73-85); auto-orientation and optional
resize for files (:63, :95-96); sqrt(2) portrait center-crop (:97-101);
horizontal flip (:102-103); per-frame timestamps (wall-clock for cameras,
frame-index/FPS for files, :90-92); instantaneous sampling frequency
(:109); `CaptureError` on open/read failure (:51/:54/:105).

Deviation from the reference, made consciously (SURVEY.md §3.2 quirk): the
reference gates the default horizontal flip on ``crop_portrait is not None``
rather than on the source type; here the default is simply "flip webcams,
not files", and an explicit ``flip_horizontally`` always wins.

Device-facing contract: frames come out as contiguous uint8 BGR host arrays
(OpenCV-native); the feeder (runtime/feeder.py) ships them to the card and
the BGR->RGB flip happens there.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from bp_from_video_tpu_torch.exceptions import CaptureError

try:  # capture is optional at import time (headless CI, hosts without OpenCV)
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

CAP_CALIBRATION_TIME = 5.0  # seconds (reference video_reader.py:19)


def _adjustable_props():
    """(prop_id, increment, name) rows for runtime adjustment (reference
    video_reader.py:21-29's table: focus, WB temperature, brightness,
    contrast, saturation, exposure, gain)."""
    return [
        (cv2.CAP_PROP_FOCUS, 5, "CAP_PROP_FOCUS"),
        (cv2.CAP_PROP_WB_TEMPERATURE, 100, "CAP_PROP_WB_TEMPERATURE"),
        (cv2.CAP_PROP_BRIGHTNESS, 4, "CAP_PROP_BRIGHTNESS"),
        (cv2.CAP_PROP_CONTRAST, 4, "CAP_PROP_CONTRAST"),
        (cv2.CAP_PROP_SATURATION, 4, "CAP_PROP_SATURATION"),
        (cv2.CAP_PROP_EXPOSURE, 32, "CAP_PROP_EXPOSURE"),
        (cv2.CAP_PROP_GAIN, 4, "CAP_PROP_GAIN"),
    ]


@dataclasses.dataclass
class FrameData:
    """Per-frame capture record (reference video_reader.py:10-16)."""

    frame: np.ndarray       # uint8 BGR [H, W, 3]
    timestamp: float        # seconds
    sampling_freq: float    # instantaneous 1/dt (NaN on first frame)
    calibrating: bool


class VideoReader:
    """Webcam / video-file reader with camera calibration and control."""

    def __init__(self, path: int | str = 0,
                 target_res: tuple[int, int] | None = None, *,
                 crop_portrait: bool | None = None,
                 flip_horizontally: bool | None = None,
                 calibration_time: float = CAP_CALIBRATION_TIME,
                 adjustable_props=None):
        if cv2 is None:  # pragma: no cover
            raise CaptureError("OpenCV not available")
        self.path = path
        self.is_camera = isinstance(path, int)
        self.target_res = target_res
        self.crop_portrait = bool(crop_portrait)
        self.flip_horizontally = (flip_horizontally
                                  if flip_horizontally is not None
                                  else self.is_camera)
        self.calibration_time = calibration_time
        self.adjustable_props = (adjustable_props if adjustable_props
                                 is not None else _adjustable_props())
        self.prop_idx = 0

        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise CaptureError(f"cannot open video source {path!r}")
        ok, _ = self.cap.read()  # probe read (reference :52-54)
        if not ok:
            raise CaptureError(f"cannot read from video source {path!r}")

        if self.is_camera:
            self.cap.set(cv2.CAP_PROP_FOURCC,
                         cv2.VideoWriter.fourcc(*"MJPG"))
            if target_res is not None:
                self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, target_res[0])
                self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, target_res[1])
            self.set_prop_calibration(True)
            self.calibrating = True
        else:
            self.cap.set(cv2.CAP_PROP_ORIENTATION_AUTO, 1)
            # Rewind: the probe read consumed frame 0.  (The reference never
            # rewinds, silently dropping every file's first frame —
            # video_reader.py:52-54 + :92; a conscious fix, not a port.)
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            self.calibrating = False
        self.timestamp_ref = time.time()
        self.timestamp_prev = float("nan")

    @property
    def frame_shape(self) -> tuple[int, int, int]:
        """Processed (H, W, 3) of delivered frames WITHOUT consuming one
        (resolution probes must not eat frame 0 — see the rewind above)."""
        h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        if not self.is_camera:
            # FRAME_WIDTH/HEIGHT report the container's CODED dims; with
            # CAP_PROP_ORIENTATION_AUTO on (set above for files), a 90/270
            # rotation tag (phone portrait videos) swaps the delivered
            # frame's axes — advertise the post-rotation shape or every
            # fixed-size consumer (FrameSlot) rejects frame 0.
            rot = int(self.cap.get(cv2.CAP_PROP_ORIENTATION_META) or 0)
            if rot % 180 == 90:
                h, w = w, h
        if not self.is_camera and self.target_res is not None:
            h, w = self.target_res
        if self.crop_portrait and h < w:
            new_w = int(np.round(h / np.sqrt(2)))
            w = 2 * (new_w // 2)
        return (h, w, 3)

    # -- camera control -----------------------------------------------------

    def set_prop_calibration(self, enable: bool) -> None:
        """Toggle autofocus / auto-WB / auto-exposure (reference :68-71;
        the 2*x+1 encoding is the V4L2 auto-mode convention)."""
        self.cap.set(cv2.CAP_PROP_AUTOFOCUS, int(enable))
        self.cap.set(cv2.CAP_PROP_AUTO_WB, 2 * int(enable) + 1)
        self.cap.set(cv2.CAP_PROP_AUTO_EXPOSURE, 2 * int(enable) + 1)

    def prop_control(self, key: int) -> None:
        """Numpad camera control (reference :73-85): 8/2 = adjust the
        selected property up/down by its increment, 4/6 = cycle the selected
        property; prints the current value."""
        if not (ord("0") <= key <= ord("9")):
            return
        prop_id, inc, _ = self.adjustable_props[self.prop_idx]
        if key == ord("8"):
            self.cap.set(prop_id, self.cap.get(prop_id) + inc)
        elif key == ord("2"):
            self.cap.set(prop_id, self.cap.get(prop_id) - inc)
        elif key == ord("4"):
            self.prop_idx = (self.prop_idx - 1) % len(self.adjustable_props)
        elif key == ord("6"):
            self.prop_idx = (self.prop_idx + 1) % len(self.adjustable_props)
        prop_id, _, name = self.adjustable_props[self.prop_idx]
        print(f"{name}: {self.cap.get(prop_id)}")

    # -- frames ---------------------------------------------------------------

    def read_frame(self) -> FrameData:
        """Blocking read of the next frame (reference :87-111)."""
        if self.is_camera:
            timestamp = time.time() - self.timestamp_ref
        else:
            fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
            timestamp = self.cap.get(cv2.CAP_PROP_POS_FRAMES) / fps
        ok, frame = self.cap.read()
        if not ok:
            raise CaptureError("read failed (end of stream)")
        if not self.is_camera and self.target_res is not None:
            frame = cv2.resize(frame, self.target_res[::-1])
        if self.crop_portrait and frame.shape[0] < frame.shape[1]:
            new_w = int(np.round(frame.shape[0] / np.sqrt(2)))
            left = frame.shape[1] // 2 - new_w // 2
            frame = frame[:, left:left + 2 * (new_w // 2), :]
        if self.flip_horizontally:
            frame = cv2.flip(frame, 1)
        if self.calibrating and timestamp >= self.calibration_time:
            self.set_prop_calibration(False)
            self.calibrating = False
        dt = timestamp - self.timestamp_prev
        # Coarse clocks / buffered bursts can repeat a timestamp; NaN fs
        # (masked downstream) instead of ZeroDivisionError killing capture.
        fs = 1.0 / dt if dt != 0.0 else float("nan")
        self.timestamp_prev = timestamp
        return FrameData(np.ascontiguousarray(frame), timestamp, fs,
                         self.calibrating)

    run = read_frame  # uniform stage interface (reference video_reader.py:113)

    def cleanup(self) -> None:
        if self.is_camera:
            self.set_prop_calibration(True)
        self.cap.release()
