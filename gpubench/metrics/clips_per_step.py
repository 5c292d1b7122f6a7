"""Clips through the rPPG net per engine call, by the port's own counters
(``clip.runs`` over ``steps`` in ``utils/profiling.profiler.counts``, over
every call of the run)."""


def read(run):
    from bp_from_video_tpu_torch.utils import profiling
    counts = getattr(profiling.profiler, "counts", None)
    if not counts or not counts.get("steps") or "clip.runs" not in counts:
        return None
    return counts["clip.runs"] / counts["steps"]
