"""PhysMamba's twelve selective scans against their roofline: each listed
block's least time (``systems/physmamba.scan``: bytes in and out at HBM
bandwidth, or its state updates at the float32 peak, whichever bounds it)
summed, times the profiled calls, over the device time launched inside
``bpv.pm.scan``."""

from gpubench.metrics import _spans


def read(run):
    return _spans.roofline(run, "pm_scan", "bpv.pm.scan")
