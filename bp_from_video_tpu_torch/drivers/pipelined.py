"""Pipelined multi-stream driver (reference pbp.py) — the counterpart of
``bp_from_video_tpu/drivers/pipelined.py``.

The reference pipelines its four stages across four processes linked by
depth-1 latest-wins queues (pbp.py:14-75).  Here the pipeline is: capture
THREADS (one per stream) publishing into lock-free native frame slots →
the device feeder batching the newest frame per stream → the multi-stream
step with the displayed stream's composition → display.  The
latest-wins/drop-oldest real-time policy survives (frames the device missed
are dropped, latency stays bounded); pickling, manager processes and
per-hop copies do not.

Improvement over the reference: camera keyboard control still works in
pipelined mode (the reference loses it, SURVEY.md §3.6 — there the key has
no back channel to the capture process; here capture objects live
in-process).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from bp_from_video_tpu_torch.config import CaptureConfig, EngineConfig
from bp_from_video_tpu_torch.exceptions import CaptureError
from bp_from_video_tpu_torch.parallel import MultiStreamEngine
from bp_from_video_tpu_torch.render.drawer import Drawer
from bp_from_video_tpu_torch.runtime.capture import VideoReader
from bp_from_video_tpu_torch.runtime.feeder import DeviceFeeder
from bp_from_video_tpu_torch.utils.profiling import profiler


def run(config: EngineConfig | None = None,
        captures: Sequence[CaptureConfig] | None = None, *,
        asset_dir: str | None = None, mesh=None, show: bool = True,
        display_stream: int = 0, max_frames: int | None = None,
        print_profile: bool = True, recorder=None, bp_predictor=None,
        device=None):
    """Pipelined capture → batched step → display on ``device`` (``None``
    means ``"cuda"``; raises without CUDA unless ``device="cpu"``).  Returns
    the last per-stream outputs.  ``mesh`` must be None (several cards are
    ROADMAP Queue 1 item 13b)."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh: several cards are not ported yet (ROADMAP Queue 1 item "
            "13b)")
    config = config or EngineConfig()
    captures = captures or [CaptureConfig()]

    readers = [VideoReader(c.path, c.target_res,
                           crop_portrait=c.crop_portrait,
                           flip_horizontally=c.flip_horizontally,
                           calibration_time=c.calibration_time)
               for c in captures]
    try:
        # Resolution probe WITHOUT consuming a frame (a read here would drop
        # each file's frame 0 that capture.py deliberately rewinds to keep).
        shapes = [r.frame_shape for r in readers]
        if len(set(shapes)) > 1:
            raise ValueError(
                f"streams must share one resolution, got {shapes}")
        h, w, _ = shapes[0]
        config = dataclasses.replace(config, frame_height=h, frame_width=w,
                                     num_streams=len(readers))
        ms = MultiStreamEngine(config, asset_dir=asset_dir, device=device)
        drawer = Drawer(config, show=show, bp_predictor=bp_predictor,
                        device=ms.device)
    except BaseException:
        for r in readers:
            r.cleanup()
        raise
    params = ms.shard_params(ms.params)
    states = ms.shard_state(ms.init_states())
    feeder = DeviceFeeder(readers, (h, w, 3), device=ms.device)
    # Step + displayed-stream composition (streams.make_display_step):
    # display raster cost O(1) in streams.
    step = profiler.timeit(ms.make_display_step(drawer, display_stream),
                           name="fused_step", fence=True)
    draw = profiler.timeit(drawer.present, name="draw_and_plot")

    out = None
    n = 0
    try:
        while True:
            frames, ts, fs, cal = feeder.get_batch()
            states, out, fimg, pimg, packed = step(
                params, states, ms.shard_frames(frames),
                ms.shard_frames(ts))
            s = display_stream
            key = draw(fimg, pimg, packed, bool(cal[s]))
            # Through the feeder, not readers[s] directly: the capture
            # thread owns the cv2.VideoCapture, and prop sets concurrent
            # with its cap.read() are undefined behavior.
            feeder.prop_control(s, key)
            if recorder is not None:
                recorder.add(ts, out)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
    except (CaptureError, KeyboardInterrupt):
        pass
    finally:
        feeder.cleanup()
        drawer.cleanup()
        if print_profile:
            profiler.printit()
    return out
