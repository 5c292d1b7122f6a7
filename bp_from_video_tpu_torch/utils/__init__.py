"""Cross-cutting utilities: stage profiling."""

from bp_from_video_tpu_torch.utils.profiling import (StageProfiler, printit,
                                                     profiler, timeit)

__all__ = ["StageProfiler", "profiler", "printit", "timeit"]
