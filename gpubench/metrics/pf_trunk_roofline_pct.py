"""PhysFormer's patch embedding, 12 blocks and head against their
roofline (``systems/physformer.trunk``), times the profiled calls, over
the device time launched inside ``bpv.pf.trunk``."""

from gpubench.metrics import _spans


def read(run):
    return _spans.roofline(run, "pf_trunk", "bpv.pf.trunk")
