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

import torch
import torch.distributed as dist

from bp_from_video_tpu_torch.config import CaptureConfig, EngineConfig
from bp_from_video_tpu_torch.exceptions import CaptureError
from bp_from_video_tpu_torch.parallel import MultiStreamEngine
from bp_from_video_tpu_torch.parallel import mesh as mesh_lib
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
    means ``"cuda"``, or with a mesh its device type on this rank's card;
    raises without CUDA unless ``device="cpu"``).  Returns the last
    per-stream outputs.

    With ``mesh`` (``parallel.mesh``; every rank calls ``run`` with the
    same global ``captures``), each rank opens only the readers of its
    ``MultiStreamEngine.stream_slice`` (on a ``dp``-only mesh,
    ``distributed.local_stream_slice``), feeds that shard, so no frame
    crosses ranks, and the rank that composes ``display_stream`` presents
    it; a ``recorder`` records the rank's own streams.  The ranks step
    together and stop together (:func:`_agree`, one small all-reduce a
    step): when one asks to quit ('q' on the presenting rank), when
    ``max_frames`` is reached, or when every rank's streams have ended
    (until then a rank whose streams ended steps its last frames again,
    as an ended stream does in one process).  A rank that fails stops
    every rank: it raises its error, the others ``RuntimeError``.  The
    returned outputs are whole (gathered, a collective) on every rank."""
    config = config or EngineConfig()
    captures = captures or [CaptureConfig()]
    lo, hi = ((0, len(captures)) if mesh is None else
              mesh_lib.stream_slice(mesh, len(captures)))

    readers = [VideoReader(c.path, c.target_res,
                           crop_portrait=c.crop_portrait,
                           flip_horizontally=c.flip_horizontally,
                           calibration_time=c.calibration_time)
               for c in captures[lo:hi]]
    try:
        # Resolution probe WITHOUT consuming a frame (a read here would drop
        # each file's frame 0 that capture.py deliberately rewinds to keep).
        shapes = [r.frame_shape for r in readers]
        if len(set(shapes)) > 1:
            raise ValueError(
                f"streams must share one resolution, got {shapes}")
        h, w, _ = shapes[0]
        config = dataclasses.replace(config, frame_height=h, frame_width=w,
                                     num_streams=len(captures))
        ms = MultiStreamEngine(config, asset_dir=asset_dir, mesh=mesh,
                               device=device)
        presents = ms.displays(display_stream)
        drawer = Drawer(config, show=show and presents,
                        bp_predictor=bp_predictor, device=ms.device)
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
    batch = None
    ended = quit = False
    error = None
    try:
        while True:
            done = max_frames is not None and n >= max_frames
            if not (ended or done or quit) and error is None:
                try:
                    try:
                        batch = feeder.get_batch()
                    except CaptureError:    # this rank's streams ended
                        ended = True
                        batch = feeder.idle_batch()
                except Exception as e:
                    error = e
            if _agree(mesh, ms.device, quit or done, ended, error):
                break
            try:
                frames, ts, fs, cal = batch
                states, out, fimg, pimg, packed = step(params, states,
                                                       frames, ts)
                if presents:
                    s = display_stream - lo
                    try:
                        key = draw(fimg, pimg, packed, bool(cal[s]))
                    except KeyboardInterrupt:       # 'q'
                        quit, key = True, -1
                    # Through the feeder, not readers[s] directly: the
                    # capture thread owns the cv2.VideoCapture, and prop
                    # sets concurrent with its cap.read() are undefined
                    # behavior.
                    feeder.prop_control(s, key)
                if recorder is not None:
                    recorder.add(ts, out)
            except Exception as e:
                error = e
            n += 1
    except KeyboardInterrupt:
        if mesh is not None:    # a signal, not 'q': the ranks cannot agree
            raise
    finally:
        feeder.cleanup()
        drawer.cleanup()
        if print_profile:
            profiler.printit()
    return out if mesh is None or out is None else ms.gather(out)


def _agree(mesh, device, quit: bool, ended: bool, error) -> bool:
    """Whether the loop stops now.  One process: on 'q' or when its streams
    have ended; ``error`` raises.  With a mesh, a collective every rank
    makes once a step (an all-reduce of three flags over the world): all
    stop when one asked to quit or every rank's streams have ended; when
    one failed, it raises its error and every other rank
    ``RuntimeError``."""
    if mesh is None:
        if error is not None:
            raise error
        return quit or ended
    flags = torch.tensor([quit, ended, error is not None],
                         dtype=torch.float32, device=device)
    dist.all_reduce(flags)
    quits, ends, errors = flags.tolist()
    if error is not None:
        raise error
    if errors:
        raise RuntimeError(f"pipelined.run: {int(errors)} rank(s) of the "
                           "mesh failed")
    return quits > 0 or ends == dist.get_world_size()
