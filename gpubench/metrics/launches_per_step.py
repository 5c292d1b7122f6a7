"""Kernels, copies and memsets on the card in the profiled slice, per
engine call."""


def read(run):
    return run.trace.launches / run.trace.calls
