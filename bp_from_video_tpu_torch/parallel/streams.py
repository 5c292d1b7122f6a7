"""Multi-stream engine on one card — the counterpart of
``bp_from_video_tpu/parallel/streams.py`` with ``mesh=None``.

N independent streams run as one batched step: state, frames and
timestamps carry a leading ``[S]`` axis (``Engine.batch_step``).  Two
execution surfaces from the same step:

  * ``step``     — one frame per stream (live / low-latency path);
  * ``run_clip`` — the step over a time-major frame block (offline /
    throughput path), a Python loop over time where the JAX package scans;
    only the compact per-frame outputs (``ClipOutputs``) are kept, on the
    device; the rest of each step's outputs is dropped with the step.

Several cards (a mesh) are ROADMAP Queue 1 item 13b.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from bp_from_video_tpu_torch.config import EngineConfig
from bp_from_video_tpu_torch.models.runner import map_leaves
from bp_from_video_tpu_torch.runtime.engine import Engine, EngineState

Tensor = torch.Tensor


class ClipOutputs(NamedTuple):
    """Compact per-frame results stacked over a clip (time-major): the
    numbers a user of the offline/batch path consumes."""

    bpm: Tensor      # [T, S, num_signals] smoothed HR means
    ptt: Tensor      # [T, S, num_pairs]
    curr_fs: Tensor  # [T, S]


def _compact(out) -> ClipOutputs:
    """The numbers of one step that a clip keeps (the JAX scan body's
    ``ClipOutputs(out.bpm, out.ptt, out.curr_fs)``)."""
    return ClipOutputs(out.bpm, out.ptt, out.curr_fs)


def _stack(outs: list[ClipOutputs]) -> ClipOutputs:
    return ClipOutputs(*(torch.stack(f) for f in zip(*outs)))


class MultiStreamEngine:
    """N-stream wrapper around :class:`Engine` on one device;
    ``device=None`` means ``"cuda"`` (raises without CUDA unless
    ``device="cpu"``).  ``mesh`` must be None."""

    def __init__(self, config: EngineConfig, asset_dir: str | None = None,
                 mesh=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh: several cards are not ported yet (ROADMAP Queue 1 "
                "item 13b)")
        self.engine = Engine(config, asset_dir=asset_dir, device=device)
        self.config = config
        self.mesh = None
        self.device = self.engine.device
        self.params = self.engine.params
        self.num_streams = config.num_streams
        self.step = self.engine.batch_step

    # -- state ------------------------------------------------------------

    def init_states(self) -> EngineState:
        """Fresh state of every stream (leading [S])."""
        return self.engine.init_state(self.num_streams)

    # -- placement (one device: nothing to shard) -----------------------------

    def shard_state(self, state: EngineState) -> EngineState:
        return state

    def shard_params(self, params: Any) -> Any:
        return params

    def shard_frames(self, frames) -> Tensor:
        """A ``[S, ...]`` batch as a tensor on the engine's device (numpy
        arrays are copied there; tensors pass as they are)."""
        if isinstance(frames, np.ndarray):
            return torch.from_numpy(frames).to(self.device)
        return frames

    # -- live display path ---------------------------------------------------

    def make_display_step(self, drawer, display_stream: int = 0):
        """One function per displayed frame: the S-stream step, then
        ``drawer.compose`` (overlays, plots, on-card text, packed HUD
        vector) of the displayed stream alone, so the raster cost stays
        O(1) in the stream count.  Returns ``(state, out, frame_img
        [H, W, 3], plot_img, packed)``, the images and vector of that one
        stream.  Frames are planar ``[S, 3, H, W]`` (the feeder's layout)
        or NHWC ``[S, H, W, 3]``; the compose takes either."""
        d = display_stream

        def fn(params, state, frames, ts):
            state, out = self.step(params, state, frames, ts)
            frame_img, plot_img, packed = drawer.compose(
                frames[d:d + 1], map_leaves(lambda a: a[d:d + 1], out))
            return state, out, frame_img[0], plot_img[0], packed[0]
        return fn

    # -- offline / throughput path -----------------------------------------

    def run_clip(self, params, state: EngineState, frames: Tensor,
                 timestamps: Tensor) -> tuple[EngineState, ClipOutputs]:
        """The step over a time-major clip: frames uint8 ``[T, S, H, W, 3]``
        or planar ``[T, S, 3, H, W]``, timestamps ``[T, S]`` seconds.  The
        per-frame outputs stay on the device; nothing is read back."""
        outs = []
        for t in range(frames.shape[0]):
            state, out = self.step(params, state, frames[t], timestamps[t])
            outs.append(_compact(out))
        return state, _stack(outs)

    def run_clip_lagged(self, params, state: EngineState, frames: Tensor,
                        timestamps: Tensor
                        ) -> tuple[EngineState, ClipOutputs]:
        """The lagged micro-batch step over window-major frames ``[Tw, F,
        S, ...]`` with timestamps ``[Tw, F, S]``.  Outputs are per WINDOW
        (one analysis per F frames, ``Engine.batch_step_lagged``)."""
        outs = []
        for t in range(frames.shape[0]):
            state, out = self.engine.batch_step_lagged(
                params, state, frames[t], timestamps[t])
            outs.append(_compact(out))
        return state, _stack(outs)
