"""The profiled slice of a ``--trace 1`` run and its reduction.

A fixed number of calls run under ``torch.profiler`` (CPU and CUDA
activities) inside a ``gpubench.slice`` range, each call inside
``gpubench.step`` (``record_function`` ranges from the harness).  The Chrome trace is read
back and reduced to what the per-layer readers need: the device's busy
intervals (kernels, copies, memsets) inside the slice, launches, device
time by kernel name, device time launched from inside each harness range,
the idle gaps labelled by the innermost host operation running at
their start, and the port's own spans (``spans.reduce``).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclasses.dataclass
class Trace:
    calls: int
    window_s: float                      # the slice's host span
    busy_s: float                        # union of device intervals in it
    launches: int                        # device events in it
    by_name: dict                        # device seconds by event name
    by_range: dict                       # device seconds launched in range
    idle_gaps: list                      # [(label, seconds)] by label
    spans: object = None                 # spans.Spans of the port's spans


def profile_calls(drv, state, first_call: int, n: int, path: str):
    """Trace ``n`` calls of ``drv`` from ``first_call``; returns (Trace,
    state, next call).  The trace file is read back and deleted."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function("gpubench.slice"):
            for call in range(first_call, first_call + n):
                with record_function("gpubench.step"):
                    state = drv.call(state, call)[0]
            torch.cuda.synchronize()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return reduce(events, n), state, first_call + n


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events: list, calls: int) -> Trace:
    """Reduce a Chrome trace's events (times in microseconds)."""
    sl = [e for e in events if e.get("name") == "gpubench.slice"
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise RuntimeError("the trace has no gpubench.slice range")
    t0, t1 = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e.get("ph") == "X" and t0 <= e["ts"] < t1]
    if not dev:
        raise RuntimeError("the profiler recorded no device activity: "
                           "CUPTI tracing is not working")
    merged = _union([(e["ts"], min(e["ts"] + e["dur"], t1)) for e in dev])
    busy = sum(e - s for s, e in merged)
    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] / 1e6
    # Device time by the harness range its launch was made in.
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("ph") == "X"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    by_range = collections.Counter()
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for r in ranges:
            if r["ts"] <= ts <= r["ts"] + r["dur"]:
                by_range[r["name"]] += e["dur"] / 1e6
    # Idle gaps inside the slice, each labelled by the innermost host
    # operation running at its start.
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e.get("ph") == "X"
                  and e["ts"] < t1 and e["ts"] + e["dur"] > t0
                  and e["name"] != "gpubench.slice")
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    edges = [t0] + [x for s, e in merged for x in (s, e)] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        label, best = "host (no operation)", None
        i = bisect.bisect_right(starts, a)
        for s, e, name in reversed(host[max(0, i - 400):i]):
            if s <= a < e and (best is None or e - s < best):
                label, best = name, e - s
        gaps[label] += (b - a) / 1e6
    from gpubench import spans
    return Trace(calls=calls, window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6,
                 launches=len(dev), by_name=dict(by_name),
                 by_range=dict(by_range), idle_gaps=gaps.most_common(10),
                 spans=spans.reduce(events))


def count_syncs(fn) -> int:
    """Host syncs ``fn()`` makes (CUDA sync debug mode), a copy of
    ``chip_smoke.count_syncs``."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)
