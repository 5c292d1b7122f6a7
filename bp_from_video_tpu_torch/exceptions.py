"""Framework exceptions — a copy of ``bp_from_video_tpu/exceptions.py``
(reference exceptions.py:1-2)."""


class CaptureError(RuntimeError):
    """Video open/read failure; also the normal end-of-file signal for
    recorded video, treated by drivers as clean shutdown (reference
    video_reader.py:51/:54/:105, bp.py:29)."""
