"""Cross-cutting utilities: stage profiling, spans and counters."""

from bp_from_video_tpu_torch.utils.profiling import (StageProfiler, count,
                                                     printit, profiler, span,
                                                     timeit)

__all__ = ["StageProfiler", "count", "profiler", "printit", "span", "timeit"]
