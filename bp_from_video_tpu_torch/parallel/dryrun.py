"""Start a world of ranks on this host, and the end-to-end training step
over a ``dp`` x ``tp`` mesh — the counterpart of ``__graft_entry__.py``'s
``dryrun_multihost`` and ``_dryrun_impl``.

:func:`spawn` runs a function on N fresh processes that form one world
(the environment ``torchrun`` would give them, on a free local port) and
is their failure detector: a rank that dies mid-step leaves its peers
blocked in a collective, so the spawner polls the children and, when one
exits non-zero, kills the rest and raises naming it; a deadline bounds a
hang.  :func:`dryrun` spawns N ranks that each run one e2e step of a tiny
engine over the mesh the JAX package builds (``tp`` = 2 when N is even,
else 1; ``dp`` = N / ``tp`` streams), the BP head split over ``tp``.
"""

from __future__ import annotations

import math
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Callable

import torch


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank: int, n: int, port: int, local_rank: int,
               device: str, backend: str | None, results) -> None:
    """One child: torchrun's environment, one PyTorch thread, the process
    group, ``fn(*args)``; its value (or its traceback) goes to
    ``results``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(n), RANK=str(rank),
                      LOCAL_RANK=str(local_rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from bp_from_video_tpu_torch.parallel import distributed
    try:
        distributed.initialize(device=device, backend=backend)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, n_ranks: int, args: tuple = (), *,
          device: str = "cpu", backend: str | None = None,
          deadline: float = 120.0) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` new processes forming one world on
    ``device`` (``"cpu"``: gloo; ``"cuda"``: rank r on card r modulo the
    cards, nccl unless ``backend`` says otherwise: ranks that share a
    card need ``"gloo"``).  ``fn`` is importable (a module-level
    function) and returns a picklable value (numpy, not tensors).
    Returns the ranks' values in rank order.

    Raises ``RuntimeError`` when a rank exits non-zero, naming it (its
    return code and traceback) after killing the other ranks, or when
    ``deadline`` seconds pass; no child outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    cards = torch.cuda.device_count() if device == "cuda" else n_ranks
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, args, r, n_ranks, port, r % max(cards, 1), device, backend,
        results)) for r in range(n_ranks)]
    for p in procs:
        p.start()
    values, errors = {}, {}
    end = time.monotonic() + deadline
    try:
        while len(values) < n_ranks:
            try:
                rank, ok, value = results.get(timeout=0.1)
                (values if ok else errors)[rank] = value
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if p.exitcode not in (None, 0)]
            if dead:
                _drain(results, errors, values, dead)
                # A rank that died without a traceback (killed, exited)
                # comes before peers whose collectives broke on its
                # death; else the first traceback to arrive.
                silent = [r for r in dead if r not in errors]
                r = silent[0] if silent else next(
                    r for r in errors if r in dead)
                raise RuntimeError(
                    f"rank {r} died (rc={procs[r].exitcode}); the other "
                    f"ranks were killed:\n{errors.get(r, '')[-4000:]}")
            gone = [r for r, p in enumerate(procs)
                    if p.exitcode == 0 and r not in values]
            if gone and all(p.exitcode is not None for p in procs):
                raise RuntimeError(f"ranks {gone} exited without a result")
            if time.monotonic() > end:
                raise RuntimeError(
                    f"ranks {sorted(set(range(n_ranks)) - set(values))} "
                    f"did not finish within {deadline} s; all were killed")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        results.close()
    return [values[r] for r in range(n_ranks)]


def _drain(results, errors: dict, values: dict, dead: list) -> None:
    """Collect what is queued, waiting up to a second for the tracebacks
    of the ``dead`` ranks (a child puts its own just before it exits)."""
    end = time.monotonic() + 1.0
    while (any(r not in errors for r in dead)
           and time.monotonic() < end):
        try:
            r, ok, value = results.get(timeout=0.05)
            (values if ok else errors)[r] = value
        except queue.Empty:
            pass


def tiny_config(num_streams: int):
    """The JAX dryrun's engine: random-init nets (no model files), 32x32
    frames, a 16-sample signal ring."""
    from bp_from_video_tpu_torch.config import (EngineConfig,
                                                InferenceConfig,
                                                SignalConfig)
    return EngineConfig(
        signal=SignalConfig(signal_max_samples=16, peak_max_samples=4),
        inference=InferenceConfig(
            face_detector_path=None, face_landmarker_path=None,
            hand_landmarker_path=None, person_segmenter_path=None,
            hand_lm_standin_path=None, palm_det_standin_path=None,
            seg_standin_path=None),
        frame_height=32, frame_width=32, num_streams=num_streams)


def dryrun_rank(device_type: str) -> float:
    """One rank's part of :func:`dryrun`: the e2e step over the world's
    ``dp`` x ``tp`` mesh; returns the loss (every rank reads it whole)."""
    import torch.distributed as dist

    from bp_from_video_tpu_torch.parallel import distributed
    from bp_from_video_tpu_torch.parallel import mesh as mesh_lib
    from bp_from_video_tpu_torch.parallel.streams import MultiStreamEngine
    from bp_from_video_tpu_torch.train import bp_regressor as bpr

    n = dist.get_world_size()
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = distributed.global_mesh({mesh_lib.STREAM_AXIS: dp,
                                    mesh_lib.MODEL_AXIS: tp}, device_type)
    cfg = tiny_config(dp)
    ms = MultiStreamEngine(cfg, mesh=mesh)
    sig = cfg.signal
    tstate, _ = bpr.init_train_state(torch.Generator().manual_seed(0),
                                     2 * (sig.num_signals + sig.num_pairs),
                                     device=ms.device)
    tstate = mesh_lib.shard_params(tstate, mesh)
    e2e = bpr.make_e2e_train_step(ms.step, bpr.make_optimizer(tstate),
                                  mesh=mesh)
    frames = torch.zeros((dp, 32, 32, 3), dtype=torch.uint8)
    labels = torch.tensor([[120.0, 80.0]]).repeat(dp, 1)
    _, tstate, loss = e2e(
        ms.shard_params(ms.params), ms.shard_state(ms.init_states()),
        tstate, ms.shard_frames(frames),
        ms.shard_frames(torch.full((dp,), 1.0 / 30.0)),
        ms.shard_frames(labels))
    return float(mesh_lib.gather(loss))


def dryrun(n_ranks: int, device_type: str = "cpu") -> list[float]:
    """Spawn ``n_ranks`` ranks that each run one e2e step over the mesh;
    raises unless every rank reads the same finite loss.  Returns the
    losses."""
    losses = spawn(dryrun_rank, n_ranks, (device_type,), device=device_type)
    if not all(math.isfinite(x) and x == losses[0] for x in losses):
        raise RuntimeError(f"dryrun over {n_ranks} ranks: losses {losses}")
    return losses

