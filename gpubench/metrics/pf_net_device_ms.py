"""Device milliseconds a call launched inside ``bpv.net.physformer`` (the
rPPG net: its stem, patch embedding, blocks and head)."""

from gpubench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "bpv.net.physformer")
