"""Sequential driver (reference bp.py) — the counterpart of
``bp_from_video_tpu/drivers/sequential.py``: capture → engine step →
display, one frame at a time, until EOF/'q'.

The reference's four stage calls (bp.py:23-26) become: one host capture
read, the engine step (inference and all DSP on the device) followed by
the on-device composition of the frame's overlays and plots, and one
display call.  Camera keyboard control is preserved (bp.py:27).
"""

from __future__ import annotations

import dataclasses

import torch

from bp_from_video_tpu_torch.config import CaptureConfig, EngineConfig
from bp_from_video_tpu_torch.exceptions import CaptureError
from bp_from_video_tpu_torch.models.runner import map_leaves
from bp_from_video_tpu_torch.render.drawer import Drawer
from bp_from_video_tpu_torch.runtime.capture import VideoReader
from bp_from_video_tpu_torch.runtime.engine import Engine
from bp_from_video_tpu_torch.utils.profiling import profiler


def run(config: EngineConfig | None = None,
        capture: CaptureConfig | None = None, *,
        asset_dir: str | None = None, show: bool = True,
        max_frames: int | None = None, print_profile: bool = True,
        recorder=None, bp_predictor=None, device=None):
    """The reference main loop (bp.py:9-37) on ``device`` (``None`` means
    ``"cuda"``; raises without CUDA unless ``device="cpu"``).  Returns the
    last StepOutputs (one stream: no stream axis)."""
    config = config or EngineConfig()
    capture = capture or CaptureConfig()

    reader = VideoReader(capture.path, capture.target_res,
                         crop_portrait=capture.crop_portrait,
                         flip_horizontally=capture.flip_horizontally,
                         calibration_time=capture.calibration_time)
    try:
        # Probe one frame to size the engine to the actual stream.
        fd = reader.read_frame()
        h, w = fd.frame.shape[:2]
        if (h, w) != (config.frame_height, config.frame_width):
            config = dataclasses.replace(config, frame_height=h,
                                         frame_width=w)
        engine = Engine(config, asset_dir=asset_dir, device=device)
        drawer = Drawer(config, show=show, bp_predictor=bp_predictor,
                        device=device)
    except BaseException:
        reader.cleanup()
        raise
    dev = engine.device

    def _device_step(params, state, frame_bgr, t):
        frame = frame_bgr.flip(-1)                       # BGR -> RGB
        state, out = engine.step(params, state, frame, t)
        frame_img, plot_img, packed = drawer.compose(
            frame[None], map_leaves(lambda a: a[None], out))
        return state, out, frame_img[0], plot_img[0], packed[0]

    step = profiler.timeit(_device_step, name="engine_step", fence=True)
    draw = profiler.timeit(drawer.present, name="draw_and_plot")
    read = profiler.timeit(reader.read_frame, name="read_frame")

    state = map_leaves(lambda x: x[0], engine.init_state(1))
    out = None
    n = 0
    try:
        while True:
            state, out, fimg, pimg, packed = step(
                engine.params, state, torch.from_numpy(fd.frame).to(dev),
                torch.tensor(fd.timestamp, dtype=torch.float32, device=dev))
            key = draw(fimg, pimg, packed, fd.calibrating)
            reader.prop_control(key)
            if recorder is not None:
                recorder.add(fd.timestamp, out)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
            fd = read()
    except (CaptureError, KeyboardInterrupt):
        pass
    finally:
        reader.cleanup()
        drawer.cleanup()
        if print_profile:
            profiler.printit()
    return out
