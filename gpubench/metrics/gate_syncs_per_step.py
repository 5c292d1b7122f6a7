"""Host syncs the port's detector and rotation gates make per engine call,
by the port's own counters (``sync.*`` over ``steps`` in
``utils/profiling.profiler.counts``, over every call of the run): the
readback of the numbers the user reads is not among them."""


def read(run):
    from bp_from_video_tpu_torch.utils import profiling
    counts = getattr(profiling.profiler, "counts", None)
    if not counts or not counts.get("steps"):
        return None
    syncs = sum(v for k, v in counts.items() if k.startswith("sync."))
    return syncs / counts["steps"]
