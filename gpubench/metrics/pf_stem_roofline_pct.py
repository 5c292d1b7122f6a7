"""PhysFormer's three stem layers against their roofline: each listed
layer's least time (``systems/physformer.stem_layer``: ideal bytes or
operations, whichever bounds it) summed, times the profiled calls, over
the device time launched inside ``bpv.pf.stem``."""

from gpubench.metrics import _spans


def read(run):
    return _spans.roofline(run, "pf_stem", "bpv.pf.stem")
