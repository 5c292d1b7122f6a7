"""Device milliseconds a call launched inside ``bpv.net.physmamba`` (the
rPPG net: its stem, six blocks with their scans, laterals and head)."""

from gpubench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "bpv.net.physmamba")
