"""Per-rank bodies of ``test_torch_parallel.py``'s spawned worlds
(``parallel.dryrun.spawn`` imports them by name in each child, so they
live in a module that imports no JAX).  Each returns numpy values (or
raises: the spawner names the rank and shows its traceback)."""

from __future__ import annotations

import contextlib
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from bp_from_video_tpu_torch.models.runner import map_leaves, tree_leaves
from bp_from_video_tpu_torch.parallel import distributed
from bp_from_video_tpu_torch.parallel import mesh as mesh_lib
from bp_from_video_tpu_torch.parallel.dryrun import tiny_config
from bp_from_video_tpu_torch.parallel.streams import MultiStreamEngine
from bp_from_video_tpu_torch.train import bp_regressor as bpr


def np_tree(tree):
    """Tensors (local shards of DTensors) as numpy."""
    return map_leaves(lambda x: x.detach().numpy() if isinstance(
        x, torch.Tensor) else x, mesh_lib.to_local(tree))


def leaves(tree) -> list:
    """The leaves of a numpy tree, in ``map_leaves`` order."""
    return tree_leaves(tree)


def torch_tree(tree):
    return map_leaves(lambda x: torch.from_numpy(x) if isinstance(
        x, np.ndarray) else x, tree)


def placements():
    """On a 2x2 world: stream and head placements, the mesh size check,
    ``local_stream_slice`` with and without a remainder, ``gather`` of
    split leaves and of a partial one."""
    mesh = distributed.global_mesh({"dp": 2, "tp": 2}, "cpu")
    rank = dist.get_rank()
    x = mesh_lib.shard_streams(torch.arange(40.0).reshape(8, 5), mesh)
    p = mesh_lib.shard_params({"w": torch.arange(48.0).reshape(3, 16),
                               "b": torch.zeros(3)}, mesh)
    try:
        mesh_lib.make_mesh({"dp": 8}, "cpu")
        too_big = None
    except ValueError as e:
        too_big = str(e)
    summed = DTensor.from_local(torch.ones(2), mesh,
                                (Partial(), Replicate()), run_check=False)
    try:
        mesh_lib.gather(summed)
        partial = None
    except ValueError as e:
        partial = str(e)
    whole = [a.numpy() for a in mesh_lib.gather((x, p["w"]))]
    return dict(whole=whole, partial=partial,
        x=(tuple(x.placements), x.to_local().numpy(), tuple(x.shape)),
        w=(tuple(p["w"].placements), p["w"].to_local().numpy()),
        b=tuple(p["b"].placements), too_big=too_big, rank=rank,
        coord=tuple(mesh.get_coordinate()),
        slices=(distributed.local_stream_slice(8),
                distributed.local_stream_slice(10)),
        stream_sharding=mesh_lib.stream_sharding(mesh, 3, dim=1))


def sharded_runs(axes: dict, cfg, clip, ts, lagged, lagged_ts):
    """``step`` over ``clip`` [T, S, ...], then ``run_clip_lagged`` over
    ``lagged`` [Tw, F, S, ...], from fresh states, on the mesh ``axes``;
    returns this rank's slice, state and outputs (local) and the gathered
    outputs of the last step.  Frames and timestamps are numpy."""
    mesh = distributed.global_mesh(axes, "cpu")
    ms = MultiStreamEngine(cfg, mesh=mesh)
    params = ms.shard_params(ms.params)
    state = ms.shard_state(ms.init_states())
    for t in range(clip.shape[0]):
        state, out = ms.step(params, state, ms.shard_frames(clip[t]),
                             ms.shard_frames(ts[t]))
    st_l, out_l = ms.run_clip_lagged(params, ms.shard_state(ms.init_states()),
                                     ms.shard_frames(lagged, dim=2),
                                     ms.shard_frames(lagged_ts, dim=2))
    bpm, bpm_l = ms.place_local(out.bpm), ms.place_local(out_l.bpm, dim=1)
    placed = (tuple(bpm.placements), tuple(bpm.shape),
              tuple(bpm_l.placements), tuple(bpm_l.shape))
    return dict(slice=ms.stream_slice, state=np_tree(state),
                out=np_tree(out), lagged_state=np_tree(st_l),
                lagged_out=np_tree(out_l), placed=placed,
                gathered=np_tree(ms.gather(out)))


def run_clip_locked(cfg, params, state, clip, ts):
    """``run_clip`` on a dp mesh over the world from the given (global)
    params and state; returns the gathered ClipOutputs."""
    mesh = distributed.global_mesh(None, "cpu")
    ms = MultiStreamEngine(cfg, mesh=mesh)
    _, out = ms.run_clip(ms.shard_params(torch_tree(params)),
                         ms.shard_state(torch_tree(state)),
                         ms.shard_frames(clip, dim=1),
                         ms.shard_frames(ts, dim=1))
    return np_tree(ms.gather(out, dim=1))


def pipelined_mesh(cfg, videos):
    """``pipelined.run`` over a dp mesh of the world, every rank given all
    ``videos``; returns the paths this rank opened and the shape of the
    returned BPM."""
    from bp_from_video_tpu_torch.config import CaptureConfig
    from bp_from_video_tpu_torch.drivers import pipelined
    opened = []
    reader = pipelined.VideoReader

    def spy(path, *a, **k):
        opened.append(path)
        return reader(path, *a, **k)
    pipelined.VideoReader = spy
    mesh = distributed.global_mesh(None, "cpu")
    out = pipelined.run(cfg, [CaptureConfig(path=v) for v in videos],
                        mesh=mesh, show=False, max_frames=6,
                        print_profile=False)
    return opened, tuple(out.bpm.shape), type(out.bpm).__name__


class Camera:
    """A live source in place of ``VideoReader``: ``frames`` frames of
    noise (``None``: no end), one every ``period`` seconds, then
    ``CaptureError``."""

    def __init__(self, frames, *_, period: float = 0.01, **__):
        self.frames, self.period, self.n = frames, period, 0
        self.frame_shape = (32, 32, 3)
        self.rng = np.random.default_rng(frames)

    def read_frame(self):
        from bp_from_video_tpu_torch.exceptions import CaptureError
        from bp_from_video_tpu_torch.runtime.capture import FrameData
        if self.n == self.frames:
            raise CaptureError("end of stream")
        time.sleep(self.period)
        self.n += 1
        return FrameData(self.rng.integers(0, 256, self.frame_shape,
                                           np.uint8), self.n / 30.0, 30.0,
                         False)

    def prop_control(self, key):
        pass

    def cleanup(self):
        pass


def pipelined_stop(cfg, frames, how: str):
    """``pipelined.run`` over a dp mesh of the world, rank r's one stream a
    :class:`Camera` of ``frames[r]`` frames, with no frame limit, stopped
    by ``how``: "ended" (every camera ends), "quit" ('q' at rank 0's
    second presented frame) or "error" (rank 1's recorder raises at its
    second step).  Returns the steps this rank ran, the frames its camera
    gave, whether its streams ended, the returned BPM (whole) and the
    error this rank raised, if any."""
    from bp_from_video_tpu_torch.config import CaptureConfig
    from bp_from_video_tpu_torch.drivers import pipelined
    from bp_from_video_tpu_torch.runtime.feeder import DeviceFeeder
    rank = dist.get_rank()
    cams, steps, idle = [], [], []
    pipelined.VideoReader = lambda path, *a, **k: (
        cams.append(Camera(path)) or cams[-1])
    idle_batch = DeviceFeeder.idle_batch
    DeviceFeeder.idle_batch = lambda self: (idle.append(1)
                                            or idle_batch(self))
    present = pipelined.Drawer.present

    def quit_at_second(self, *a, **k):
        if how == "quit" and len(steps) == 1:
            raise KeyboardInterrupt
        return present(self, *a, **k)
    pipelined.Drawer.present = quit_at_second

    class Recorder:
        def add(self, ts, out):
            steps.append(1)
            if how == "error" and rank == 1 and len(steps) == 2:
                raise ValueError("the recorder failed")

    mesh = distributed.global_mesh(None, "cpu")
    bpm = error = None
    try:
        out = pipelined.run(cfg, [CaptureConfig(path=n) for n in frames],
                            mesh=mesh, show=False, print_profile=False,
                            recorder=Recorder())
        bpm = out.bpm.numpy()
    except Exception as e:
        error = f"{type(e).__name__}: {e}"
    return dict(steps=len(steps), read=cams[0].n, ended=bool(idle),
                bpm=bpm, error=error)


def indivisible(what: str, videos):
    """Three streams on a dp = 2 mesh: the engine or the driver raises
    ``ValueError``; returns its message."""
    from bp_from_video_tpu_torch.config import CaptureConfig
    from bp_from_video_tpu_torch.drivers import pipelined
    mesh = distributed.global_mesh({"dp": 2}, "cpu")
    try:
        if what == "engine":
            MultiStreamEngine(tiny_config(3), mesh=mesh)
        else:
            pipelined.run(tiny_config(1), [CaptureConfig(path=v)
                                           for v in videos],
                          mesh=mesh, show=False, print_profile=False)
    except ValueError as e:
        return str(e)
    return None


def train(argv):
    """``python -m bp_from_video_tpu_torch.train`` ``main(argv)`` on this
    rank: its return code, printed lines and every step's loss (read
    whole)."""
    from bp_from_video_tpu_torch.train import __main__ as tmain
    losses = []
    orig = bpr.train_step

    def spy(*a, **k):
        st, loss = orig(*a, **k)
        losses.append(float(mesh_lib.gather(loss)))
        return st, loss
    bpr.train_step = spy
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = tmain.main(argv)
    finally:
        bpr.train_step = orig
    return rc, buf.getvalue(), losses


def e2e_dp_tp(clip, ts, labels, warm: int, replicate_last: bool):
    """A 2x2 world: ``warm`` engine steps of the S = 2 tiny engine, then
    one e2e step with the head split over ``tp`` (its last weight and
    bias replicated with ``replicate_last``); returns the loss and the
    updated head, whole."""
    mesh = distributed.global_mesh({"dp": 2, "tp": 2}, "cpu")
    ms = MultiStreamEngine(tiny_config(2), mesh=mesh)
    params = ms.shard_params(ms.params)
    state = ms.shard_state(ms.init_states())
    for t in range(warm):
        state, _ = ms.step(params, state, ms.shard_frames(clip[t]),
                           ms.shard_frames(ts[t]))
    tstate, _ = bpr.init_train_state(torch.Generator().manual_seed(3), 6)
    placed = mesh_lib.shard_params(tstate, mesh)
    if replicate_last:
        rep = mesh_lib.replicate(tstate, mesh)
        n = len(tstate.params.weights)

        def last(placed_seq, rep_seq, keep):
            return tuple(b if i in keep else a for i, (a, b) in
                         enumerate(zip(placed_seq, rep_seq)))
        head = placed.params._replace(
            weights=last(placed.params.weights, rep.params.weights, {n - 1}),
            biases=last(placed.params.biases, rep.params.biases, {n - 1}))
        moments = [last(a, b, {n - 1, 2 * n - 1}) for a, b in
                   zip(placed.opt_state, rep.opt_state)]
        placed = placed._replace(params=head,
                                 opt_state=type(placed.opt_state)(*moments))
    e2e = bpr.make_e2e_train_step(ms.step, bpr.make_optimizer(placed),
                                  mesh=mesh)
    _, placed, loss = e2e(params, state, placed, ms.shard_frames(clip[warm]),
                          ms.shard_frames(ts[warm]),
                          ms.shard_frames(torch.from_numpy(labels)))
    w = placed.params.weights
    return dict(loss=float(mesh_lib.gather(loss)),
                params=np_tree(mesh_lib.gather(placed.params)),
                step=int(placed.step),
                w_placements=[tuple(x.placements) for x in w])


def die_after_start(code: int):
    """Rank 1 exits with ``code`` once the world is up; rank 0 enters a
    collective that rank 1 never joins."""
    if dist.get_rank() == 1:
        os._exit(code)
    dist.all_reduce(torch.ones(1))
    return None
