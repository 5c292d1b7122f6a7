"""Readers of the port's own spans in the profiled slice."""


def device_ms(run, span: str):
    """Device milliseconds a call launched inside the port's span ``span``
    (``Trace.by_range``), or None where the slice has none."""
    t = run.trace
    v = t.by_range.get(span)
    if not v or not t.calls:
        return None
    return 1e3 * v / t.calls


def roofline(run, kernel: str, span: str):
    """The least time of the launches the configuration lists under
    ``kernel``, times the profiled calls, over the device time launched in
    ``span``, in percent."""
    bound = run.kernel_bounds.get(kernel)
    t = run.trace.by_range.get(span)
    if not bound or not t:
        return None
    return 100.0 * bound * run.trace.calls / t
