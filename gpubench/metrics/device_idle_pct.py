"""Share of an untraced call's time in which the card ran nothing: one
less the device's busy time a call (kernels, copies and memsets, their
union, read from the profiled slice's trace) over the mean call time of
the untraced window (the host clock).  The profiler slows the host, so the
slice's own idle share reads high; the device's busy time it records
does not move with it."""


def read(run):
    t, w = run.trace, run.window
    done = w.calls - w.failed_calls
    if not done or not t.calls:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.calls) / (w.window_s / done))
