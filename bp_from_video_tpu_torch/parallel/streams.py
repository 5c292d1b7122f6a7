"""Multi-stream engine — the counterpart of
``bp_from_video_tpu/parallel/streams.py``.

N independent streams run as one batched step: state, frames and
timestamps carry a leading ``[S]`` axis (``Engine.batch_step``).  Two
execution surfaces from the same step:

  * ``step``     — one frame per stream (live / low-latency path);
  * ``run_clip`` — the step over a time-major frame block (offline /
    throughput path), a Python loop over time where the JAX package scans;
    only the compact per-frame outputs (``ClipOutputs``) are kept, on the
    device; the rest of each step's outputs is dropped with the step.

With a mesh (``parallel.mesh``: one rank a card) the streams are split
over its ``dp`` axis: each rank runs ``batch_step`` on its own streams, the
JAX package's ``shard_map`` over ``dp``, with no collective inside a step.
A step takes placed DTensors (``shard_state``, ``shard_frames``) or plain
tensors that are this rank's rows already, and returns this rank's rows
(state and outputs) as plain tensors, so steps chain with no wrapping;
``place_local`` views such rows as the global stream-split DTensors, and
``gather`` reads them whole on every rank (a collective).  An engine with
an rPPG net carries its clip ring in the state (``RppgEngineState``), so
the ring is initialised, placed and stepped as every other ring is.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from bp_from_video_tpu_torch.config import EngineConfig
from bp_from_video_tpu_torch.models.runner import map_leaves
from bp_from_video_tpu_torch.parallel import mesh as mesh_lib
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
    """N-stream wrapper around :class:`Engine`; ``device=None`` means
    ``"cuda"`` (raises without CUDA unless ``device="cpu"``), or with a
    mesh the mesh's device type on this rank's card.

    ``mesh=None`` runs every stream on one device.  With a mesh,
    ``num_streams`` must divide by its ``dp`` size (``ValueError``), and
    this rank steps the streams of ``stream_slice``: its steps take and
    return this rank's rows (``gather`` reads them whole).  The step on a
    shard
    is ``batch_step`` on the local batch, so ``detector_subbatch`` (8 by
    default) and the detector gates act per shard, as in the JAX
    ``shard_map`` body: at 64 streams and dp = 2 a step re-detects up to
    8 + 8 streams where one device re-detects 8.  A sharded run therefore
    equals the per-shard runs (an engine of S/dp streams on each part),
    and the unsharded run only where ``detector_subbatch`` >= S (>= F * S
    for ``run_clip_lagged``, whose detectors see F rows a stream).
    ``step`` is the mesh-spanning step (JAX's ``_vstep``), the one
    ``train.bp_regressor.make_e2e_train_step`` composes."""

    def __init__(self, config: EngineConfig, asset_dir: str | None = None,
                 mesh=None, device=None):
        self.config = config
        self.mesh = mesh
        self.num_streams = config.num_streams
        self.stream_slice = (0, config.num_streams)
        if mesh is not None:
            self.stream_slice = mesh_lib.stream_slice(mesh,
                                                      config.num_streams)
            device = device or mesh.device_type
        self.engine = Engine(config, asset_dir=asset_dir, device=device)
        self.device = self.engine.device
        self.params = self.engine.params
        self._params_local = (None, None)   # (placed tree, its local view)

    # -- state ------------------------------------------------------------

    def init_states(self) -> EngineState:
        """Fresh state of every stream (leading [S]), alike on every
        rank."""
        return self.engine.init_state(self.num_streams)

    # -- placement ----------------------------------------------------------

    def shard_state(self, state: EngineState) -> EngineState:
        if self.mesh is None:
            return state
        return mesh_lib.shard_streams(state, self.mesh)

    def shard_params(self, params: Any) -> Any:
        """Engine params are replicated across the mesh: each rank runs its
        streams whole, and channel-splitting small conv nets costs more in
        collectives than it saves.  ``tp`` is for the BP head
        (``mesh.shard_params``)."""
        if self.mesh is None:
            return params
        return mesh_lib.replicate(params, self.mesh)

    def shard_frames(self, frames, dim: int = 0) -> Tensor:
        """A batch with its stream axis ``dim`` (numpy or a tensor, alike
        on every rank) on the engine's device, stream-split over the mesh
        when there is one (numpy arrays are copied; a tensor on the
        device passes as it is without a mesh)."""
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(frames)
        if self.mesh is None:
            return frames.to(self.device)
        return mesh_lib.shard_streams(frames, self.mesh, dim=dim)

    def place_local(self, tree: Any, dim: int = 0) -> Any:
        """This rank's rows (its ``stream_slice`` on the stream axis
        ``dim``: what a step returns, or what a rank that captures only
        its streams holds) as the global stream-split DTensors, with no
        communication; without a mesh, the tree as it is."""
        if self.mesh is None:
            return tree
        with torch.no_grad():
            return mesh_lib.place_local(tree, self.mesh, dim=dim)

    def gather(self, tree: Any, dim: int = 0) -> Any:
        """This rank's rows (stream axis ``dim``), as a step returns them,
        read whole as plain tensors on every rank: a collective that every
        rank of the mesh makes, in the same order.  Without a mesh, the
        tree as it is."""
        if self.mesh is None:
            return tree
        return mesh_lib.gather(self.place_local(tree, dim))

    def _local(self, params, state, frames, timestamps, dim: int):
        """The step's inputs as this rank's local tensors: a DTensor's
        local shard (outside autograd, where it costs nothing), a plain
        tensor as it is (this rank's rows already).  The params' local
        view is resolved once per placed tree, by its identity: place a
        new tree (``shard_params``) to step with other weights."""
        if self.mesh is None:
            return params, state, frames, timestamps
        placed, local = self._params_local
        if placed is not params:
            with torch.no_grad():
                local = mesh_lib.to_local(params)
            self._params_local = (params, local)
        with torch.no_grad():
            state, frames, timestamps = mesh_lib.to_local(
                (state, frames, timestamps))
        lo, hi = self.stream_slice
        if frames.shape[dim] != hi - lo:
            raise ValueError(
                f"frames hold {frames.shape[dim]} streams on axis {dim}; "
                f"this rank steps {hi - lo} (place a global batch with "
                "shard_frames, a global state with shard_state)")
        return local, state, frames, timestamps

    def step(self, params, state: EngineState, frames, timestamps
             ) -> tuple[EngineState, Any]:
        """One frame per stream: frames ``[S, ...]`` (either layout),
        timestamps ``[S]``; with a mesh, this rank's rows in and out."""
        params, state, frames, timestamps = self._local(
            params, state, frames, timestamps, 0)
        return self.engine.batch_step(params, state, frames, timestamps)

    # -- live display path ---------------------------------------------------

    def displays(self, stream: int) -> bool:
        """Whether this rank composes ``stream``: it holds the stream and
        sits at coordinate 0 of every other mesh axis (always, without a
        mesh)."""
        lo, hi = self.stream_slice
        if self.mesh is None:
            return lo <= stream < hi
        coord = self.mesh.get_coordinate()
        return lo <= stream < hi and all(
            c == 0 for n, c in zip(self.mesh.mesh_dim_names, coord)
            if n != mesh_lib.STREAM_AXIS)

    def make_display_step(self, drawer, display_stream: int = 0):
        """One function per displayed frame: the S-stream step, then
        ``drawer.compose`` (overlays, plots, on-card text, packed HUD
        vector) of the displayed stream alone, so the raster cost stays
        O(1) in the stream count.  Returns ``(state, out, frame_img
        [H, W, 3], plot_img, packed)``, the images and vector of that one
        stream; on a rank that does not compose it (:meth:`displays`) the
        last three are None.  Frames are planar ``[S, 3, H, W]`` (the
        feeder's layout) or NHWC ``[S, H, W, 3]``; the compose takes
        either."""
        d = display_stream - self.stream_slice[0]
        composes = self.displays(display_stream)

        def fn(params, state, frames, ts):
            params, state, frames, ts = self._local(params, state, frames,
                                                    ts, 0)
            state, out = self.engine.batch_step(params, state, frames, ts)
            images = (None, None, None)
            if composes:
                frame_img, plot_img, packed = drawer.compose(
                    frames[d:d + 1], map_leaves(lambda a: a[d:d + 1], out))
                images = (frame_img[0], plot_img[0], packed[0])
            return (state, out, *images)
        return fn

    # -- offline / throughput path -----------------------------------------

    def run_clip(self, params, state: EngineState, frames, timestamps
                 ) -> tuple[EngineState, ClipOutputs]:
        """The step over a time-major clip: frames uint8 ``[T, S, H, W, 3]``
        or planar ``[T, S, 3, H, W]``, timestamps ``[T, S]`` seconds (with
        a mesh, this rank's rows on axis 1, and its rows out).  The
        per-frame outputs stay on the device; nothing is read back."""
        params, state, frames, timestamps = self._local(
            params, state, frames, timestamps, 1)
        outs = []
        for t in range(frames.shape[0]):
            state, out = self.engine.batch_step(params, state, frames[t],
                                                timestamps[t])
            outs.append(_compact(out))
        return state, _stack(outs)

    def run_clip_lagged(self, params, state: EngineState, frames,
                        timestamps) -> tuple[EngineState, ClipOutputs]:
        """The lagged micro-batch step over window-major frames ``[Tw, F,
        S, ...]`` with timestamps ``[Tw, F, S]`` (with a mesh, this rank's
        rows on axis 2).  Outputs are per WINDOW (one analysis per F
        frames, ``Engine.batch_step_lagged``), ``[Tw, S, ...]`` (with a
        mesh, this rank's rows on axis 1)."""
        params, state, frames, timestamps = self._local(
            params, state, frames, timestamps, 2)
        outs = []
        for t in range(frames.shape[0]):
            state, out = self.engine.batch_step_lagged(
                params, state, frames[t], timestamps[t])
            outs.append(_compact(out))
        return state, _stack(outs)
