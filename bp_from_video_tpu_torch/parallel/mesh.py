"""Device meshes and placements — the counterpart of
``bp_from_video_tpu/parallel/mesh.py``.

One process (rank) drives one card.  A mesh is a
``torch.distributed.DeviceMesh`` over the ranks of the world, with named
axes:

  * ``dp`` — data parallelism over independent video streams.  Stream
    state, frames and timestamps are split on their stream axis; the
    engine's step needs no collective, because streams are independent.
  * ``tp`` — tensor parallelism over weight channels, for the BP head
    (``train/bp_regressor.py``): a weight's last (output-channel) axis is
    split, and DTensor inserts the head's all-gathers and all-reduces.

A placed value is a ``DTensor``: ``Shard(d)`` / ``Replicate()`` per mesh
axis stand for the JAX package's ``NamedSharding(P(...))``.  Every tree
here is a nest that ``models.runner.map_leaves`` walks; leaves that are not
tensors pass unchanged.  Placing never compares values across ranks (the
signal rings are NaN-prefilled: NaN != NaN): each rank builds its own
shard from a value that every rank holds alike.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.models.runner import map_leaves

STREAM_AXIS = "dp"
MODEL_AXIS = "tp"


def make_mesh(axis_sizes: Mapping[str, int] | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A named mesh over the ranks of the (initialized) world, on
    ``device_type`` (``None`` means ``"cuda"``; raises without CUDA unless
    ``"cpu"``).

    With no sizes: a 1-D ``dp`` mesh over every rank.  The sizes must
    multiply to the world size: more raises ``ValueError``, and so does
    fewer (the JAX package leaves devices past a prefix idle; here a rank
    outside the mesh would hold no part of a step, so a mesh spans the
    world)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.initialize() or "
                           "global_mesh() first")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {STREAM_AXIS: world}
    names = tuple(axis_sizes)
    dims = tuple(int(axis_sizes[n]) for n in names)
    need = math.prod(dims)
    if need != world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {need} ranks, the "
                         f"world has {world}")
    return init_device_mesh(resolve_device(device_type).type, dims,
                            mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of ``axis`` (1 when the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def _coord(mesh: DeviceMesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.get_coordinate()[names.index(axis)] if axis in names else 0


def stream_sharding(mesh: DeviceMesh, ndim: int, axis: str = STREAM_AXIS,
                    dim: int = 0) -> tuple:
    """Placements of a stream-major array of ``ndim`` dims: its stream
    axis ``dim`` (the leading one by default) over the mesh axis ``axis``,
    replicated over the others."""
    if not 0 <= dim < ndim:
        raise ValueError(f"stream axis {dim} of a {ndim}-dim array")
    return tuple(Shard(dim) if n == axis else Replicate()
                 for n in mesh.mesh_dim_names)


def stream_slice(mesh: DeviceMesh, num_streams: int,
                 axis: str = STREAM_AXIS) -> tuple[int, int]:
    """[start, end) of the ``num_streams`` streams this rank holds: its
    coordinate's equal share along ``axis`` (``ValueError`` unless the
    axis size divides ``num_streams``)."""
    n = axis_size(mesh, axis)
    if num_streams % n:
        raise ValueError(f"num_streams={num_streams} not divisible by "
                         f"{axis}={n}")
    per = num_streams // n
    i = _coord(mesh, axis)
    return i * per, (i + 1) * per


def place_local(tree: Any, mesh: DeviceMesh, axis: str = STREAM_AXIS,
                dim: int = 0) -> Any:
    """Wrap this rank's own rows (its :func:`stream_slice` of the stream
    axis ``dim``) as the global stream-sharded DTensors they are part of,
    with no communication: what a rank that captured only its streams
    feeds."""
    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        return DTensor.from_local(x, mesh, stream_sharding(
            mesh, x.ndim, axis, dim), run_check=False)
    return map_leaves(place, tree)


def shard_streams(tree: Any, mesh: DeviceMesh, axis: str = STREAM_AXIS,
                  dim: int = 0) -> Any:
    """Place a stream-major tree that every rank holds alike (each leaf
    has the stream axis ``dim``, the leading one by default) so streams
    are split across ``axis``: each rank keeps its own rows, moved to the
    mesh's device."""
    def local(x):
        if not isinstance(x, torch.Tensor):
            return x
        lo, hi = stream_slice(mesh, x.shape[dim], axis)
        return x.narrow(dim, lo, hi - lo).to(mesh.device_type)
    return place_local(map_leaves(local, tree), mesh, axis, dim)


def shard_params(params: Any, mesh: DeviceMesh, axis: str = MODEL_AXIS
                 ) -> Any:
    """Tensor-parallel placement for weights that every rank holds alike:
    each leaf's last (output-channel) dimension split over ``axis`` when
    its size divides it and is at least the axis size; replicated
    otherwise (0-dim leaves too)."""
    size = axis_size(mesh, axis)
    i = _coord(mesh, axis)

    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().to(mesh.device_type)
        if x.ndim >= 1 and x.shape[-1] % size == 0 and x.shape[-1] >= size:
            per = x.shape[-1] // size
            return DTensor.from_local(
                x.narrow(-1, i * per, per).contiguous(), mesh,
                tuple(Shard(x.ndim - 1) if n == axis else Replicate()
                      for n in mesh.mesh_dim_names), run_check=False)
        return DTensor.from_local(x, mesh, (Replicate(),) * mesh.ndim,
                                  run_check=False)
    return map_leaves(place, params)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Fully replicate a tree that every rank holds alike."""
    def place(x):
        if not isinstance(x, torch.Tensor):
            return x
        return DTensor.from_local(x.detach().to(mesh.device_type), mesh,
                                  (Replicate(),) * mesh.ndim,
                                  run_check=False)
    return map_leaves(place, tree)


def to_local(tree: Any) -> Any:
    """Each DTensor leaf's local shard (of a replicated leaf: the whole
    value); plain leaves unchanged.  No communication."""
    return map_leaves(
        lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)


def gather(tree: Any) -> Any:
    """Each DTensor leaf whole, as a plain tensor on every rank (a
    collective: every rank of the mesh must call it, in the same order);
    plain leaves unchanged.  Split leaves are gathered with
    ``dist.all_gather`` over each splitting mesh axis, innermost first
    (DTensor's own ``full_tensor`` crashes with gloo on CUDA tensors in
    torch 2.11, the backend that ranks sharing one card need).  A leaf of
    partial sums raises ``ValueError``: redistribute it first."""
    def whole(x):
        if not isinstance(x, DTensor):
            return x
        if not all(isinstance(p, (Shard, Replicate)) for p in x.placements):
            raise ValueError(f"gather: placements {x.placements} hold "
                             "partial values; redistribute them first")
        t = x.to_local().contiguous()
        for i in reversed(range(len(x.placements))):
            p = x.placements[i]
            if isinstance(p, Shard):
                group = x.device_mesh.get_group(i)
                parts = [torch.empty_like(t)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, t, group=group)
                t = torch.cat(parts, p.dim)
        return t
    return map_leaves(whole, tree)
