"""Stream parallelism: N independent streams as one batched step on one
card (``MultiStreamEngine``).  Several cards are ROADMAP Queue 1 item
13b."""

from bp_from_video_tpu_torch.parallel.streams import (ClipOutputs,
                                                      MultiStreamEngine)

__all__ = ["ClipOutputs", "MultiStreamEngine"]
