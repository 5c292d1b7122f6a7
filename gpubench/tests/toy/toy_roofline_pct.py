"""The toy system's convolution against its roofline (a per-layer reader,
installed under ``gpubench/metrics/`` by copying)."""

from gpubench.metrics import _roofline


def read(run):
    return _roofline.share(run, "toy_conv", ("toy_conv",))
