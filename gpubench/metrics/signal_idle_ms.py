"""Milliseconds a call the card sits idle while the host is inside the
engine's signal half (``bpv.signal``): the span's share of the profiled
slice's idle time, times the untraced window's idle time a call
(``spans.idle_ms``)."""

from gpubench import spans


def read(run):
    return spans.idle_ms(run, "bpv.signal")
