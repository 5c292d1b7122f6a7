"""Start-up of a world of ranks, one process a card — the counterpart of
``bp_from_video_tpu/parallel/distributed.py``.

A launcher (``torchrun --nproc-per-node N``, on one host or several) sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``; each rank then starts the process group from them and
builds the same named mesh over the world.  Streams stay split over
``dp``: each rank captures and uploads only its own, and the step moves
no frame between ranks.  One mechanism serves one host and many.

Usage (per rank):
    from bp_from_video_tpu_torch.parallel import distributed
    distributed.initialize()                # env-driven, idempotent
    mesh = distributed.global_mesh()        # dp over every rank
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.parallel import mesh as mesh_lib

# A lost peer fails a collective after this long instead of hanging it.
TIMEOUT = timedelta(seconds=120)


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for CUDA (``None`` means
    CUDA; raises without it), the CPU for ``"cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def _start(dev: torch.device, backend: str | None, **kw) -> None:
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        timeout=TIMEOUT, **kw)


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None, *,
               device=None, backend: str | None = None) -> bool:
    """Start the process group; the parameters default to torchrun's
    environment (``init_method`` ``env://`` reads ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The backend is ``nccl``
    for CUDA and ``gloo`` for ``device="cpu"`` unless ``backend`` says
    otherwise (gloo carries CUDA tensors too, for ranks that share a
    card).  Returns True once a group exists; a no-op returning False when
    unconfigured (no ``init_method``, no ``MASTER_ADDR``): one process."""
    if dist.is_initialized():
        return True
    if init_method is None and "MASTER_ADDR" not in os.environ:
        return False
    _start(local_device(device), backend, init_method=init_method,
           world_size=-1 if world_size is None else world_size,
           rank=-1 if rank is None else rank)
    return True


def global_mesh(axis_sizes=None, device_type: str | None = None):
    """A named mesh over every rank of the world (``mesh.make_mesh``).  In
    a plain process with no configuration it starts a world of one rank on
    a local store first, so the same code runs alone."""
    if not initialize(device=device_type):
        _start(local_device(device_type), None, store=dist.HashStore(),
               rank=0, world_size=1)
    return mesh_lib.make_mesh(axis_sizes, device_type)


def local_stream_slice(num_streams: int) -> tuple[int, int]:
    """[start, end) of the global stream batch this rank feeds: an equal
    share a rank, the last rank taking the remainder (one rank: all)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = num_streams // n
    return i * per, (i + 1) * per if i < n - 1 else num_streams
