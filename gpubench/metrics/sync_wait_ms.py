"""Host milliseconds a call spent in the gates' blocking reads (the
``bpv.sync.*`` spans) in the profiled slice."""


def read(run):
    sp = getattr(run.trace, "spans", None)
    if sp is None:
        return None
    waits = [v.host_s for k, v in sp.by_name.items()
             if k.startswith("bpv.sync.")]
    if not waits:
        return None
    return 1e3 * sum(waits) / run.trace.calls
