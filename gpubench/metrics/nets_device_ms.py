"""Device milliseconds a call launched inside the port's landmark nets
(the ``bpv.net.*`` spans of ``InferenceRunner._landmarks``: the fused
stems and trunks, K3 and K6, and the mesh graph's own ops), read from the
profiled slice's device time by the range each launch was made in."""


def read(run):
    t = run.trace
    nets = [v for k, v in t.by_range.items() if k.startswith("bpv.net.")]
    if not nets or not t.calls:
        return None
    return 1e3 * sum(nets) / t.calls
