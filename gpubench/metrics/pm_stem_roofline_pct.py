"""PhysMamba's three stem layers and the slow/fast split against their
roofline (``systems/physmamba.stem_layer``: ideal bytes or bf16
operations, whichever bounds each), times the profiled calls, over the
device time launched inside ``bpv.pm.stem``."""

from gpubench.metrics import _spans


def read(run):
    return _spans.roofline(run, "pm_stem", "bpv.pm.stem")
