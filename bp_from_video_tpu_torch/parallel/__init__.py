"""Stream and tensor parallelism: N independent streams as one batched
step (``MultiStreamEngine``), on one card or split over a mesh of ranks,
one a card (``mesh``: ``dp`` over streams, ``tp`` over the BP head's
channels; ``distributed``: start-up from a launcher's environment;
``dryrun``: a local world of ranks and its failure detector)."""

from bp_from_video_tpu_torch.parallel.mesh import (
    MODEL_AXIS, STREAM_AXIS, make_mesh, replicate, shard_params,
    shard_streams, stream_sharding)
from bp_from_video_tpu_torch.parallel.streams import (ClipOutputs,
                                                      MultiStreamEngine)

__all__ = [
    "MODEL_AXIS", "STREAM_AXIS", "make_mesh", "replicate", "shard_params",
    "shard_streams", "stream_sharding", "ClipOutputs", "MultiStreamEngine",
]
