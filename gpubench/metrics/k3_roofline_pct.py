"""K3 (``dense_s2_block``) against its roofline: the least time of the
launches the configuration lists, times the profiled calls, over the
device time of every ``dense_s2_block`` kernel in the slice."""

from gpubench.metrics import _roofline


def read(run):
    return _roofline.share(run, "dense_s2_block", ("dense_s2_block",))
