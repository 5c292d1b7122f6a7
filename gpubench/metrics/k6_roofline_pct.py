"""K6 (``bottleneck_chain``) against its roofline: the least time of the
chain calls the configuration lists (one pass over the stage), times the
profiled calls, over the device time of every bottleneck kernel in the
slice, the prep kernel included."""

from gpubench.metrics import _roofline


def read(run):
    return _roofline.share(run, "bottleneck_chain", ("bottleneck",))
