"""Device milliseconds a call launched inside the engine's signal half
(the ``bpv.signal`` span: ROI ring, K4 sampling, ring pushes, the DSP
chain, spectra, correlation, peaks and plot ranges), read from the
profiled slice's device time by the range each launch was made in."""


def read(run):
    t = run.trace
    if "bpv.signal" not in t.by_range or not t.calls:
        return None
    return 1e3 * t.by_range["bpv.signal"] / t.calls
