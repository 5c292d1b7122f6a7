"""The port's own spans in a profiled slice: the ``bpv.*`` ranges that
``bp_from_video_tpu_torch/utils/profiling.span`` opens while the profiler
records (``bpv.step`` the root of each engine call, ``bpv.runner`` and
``bpv.signal`` under it, and their stages).

``reduce`` takes the slice's Chrome-trace events, as ``trace.reduce`` does,
and gives per span name, over the slice's calls:

- host seconds: the spans' durations;
- device seconds and launches: kernels, copies and memsets whose launch
  (matched by correlation id) falls inside a span of that name;
- idle seconds: the card's idle intervals in the slice, each split by
  overlap among the spans the host was inside, so a gap that runs across
  two stages is shared between them.

Idle time inside no ``bpv.step`` is ``OUTSIDE``: the harness's readback and
its loop between calls.
"""

from __future__ import annotations

import bisect
import dataclasses

from gpubench import trace as trace_mod

PREFIX = "bpv."
ROOT = "bpv.step"
OUTSIDE = "outside"


@dataclasses.dataclass
class Span:
    host_s: float = 0.0
    device_s: float = 0.0
    launches: int = 0
    idle_s: float = 0.0


@dataclasses.dataclass
class Spans:
    by_name: dict          # span name -> Span; OUTSIDE carries idle_s only
    idle_s: float          # the card's idle seconds in the slice


def _overlap(a: list, b: list) -> float:
    """Total overlap of two sorted lists of disjoint [start, end)."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def reduce(events: list) -> Spans | None:
    """The slice's ``bpv.*`` spans reduced (times in the trace's
    microseconds, results in seconds); None when the slice holds none."""
    sl = [e for e in events if e.get("name") == "gpubench.slice"
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise RuntimeError("the trace has no gpubench.slice range")
    t0, t1 = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"]
    raw: dict[str, list] = {}
    for e in events:
        if (e.get("cat") == "user_annotation" and e.get("ph") == "X"
                and e["name"].startswith(PREFIX)
                and e["ts"] < t1 and e["ts"] + e["dur"] > t0):
            raw.setdefault(e["name"], []).append(
                (max(e["ts"], t0), min(e["ts"] + e["dur"], t1)))
    if not raw:
        return None
    out = {n: Span(host_s=sum(b - a for a, b in iv) / 1e6)
           for n, iv in raw.items()}
    merged = {n: trace_mod._union(iv) for n, iv in raw.items()}
    starts = {n: [a for a, _ in iv] for n, iv in merged.items()}
    dev = [e for e in events if e.get("cat") in trace_mod.DEVICE_CATS
           and e.get("ph") == "X" and t0 <= e["ts"] < t1]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    for e in dev:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for n, iv in merged.items():
            i = bisect.bisect_right(starts[n], ts) - 1
            if i >= 0 and ts <= iv[i][1]:
                out[n].device_s += e["dur"] / 1e6
                out[n].launches += 1
    busy = trace_mod._union([(e["ts"], min(e["ts"] + e["dur"], t1))
                             for e in dev])
    edges = [t0] + [x for s, e in busy for x in (s, e)] + [t1]
    idle = [[a, b] for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    total = sum(b - a for a, b in idle)
    for n, iv in merged.items():
        out[n].idle_s = _overlap(idle, iv) / 1e6
    inside = out[ROOT].idle_s if ROOT in out else 0.0
    out[OUTSIDE] = Span(idle_s=total / 1e6 - inside)
    return Spans(by_name=out, idle_s=total / 1e6)


def untraced_idle_s(run) -> float | None:
    """The card's idle seconds a call in the untraced window: its mean
    call less the slice's device busy time a call (as ``device_idle_pct``
    reads it: the profiler slows the host, not the card)."""
    t, w = run.trace, run.window
    done = w.calls - w.failed_calls
    if not done or not t.calls:
        return None
    return w.window_s / done - t.busy_s / t.calls


def idle_ms(run, name: str) -> float | None:
    """Span ``name``'s share of the slice's idle time, times the untraced
    idle time a call, in ms; None without the port's spans."""
    sp = getattr(run.trace, "spans", None)
    idle = untraced_idle_s(run)
    if sp is None or idle is None or name not in sp.by_name or not sp.idle_s:
        return None
    return 1e3 * idle * sp.by_name[name].idle_s / sp.idle_s
