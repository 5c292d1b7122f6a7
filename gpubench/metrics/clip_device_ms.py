"""Device milliseconds a call launched inside ``bpv.clip``: K1's crops at
the net's size, the push into the clip ring, the gathering and the
standardisation of the clips the net runs on."""

from gpubench.metrics import _spans


def read(run):
    return _spans.device_ms(run, "bpv.clip")
