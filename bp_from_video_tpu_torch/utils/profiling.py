"""Stage-boundary profiler — the counterpart of
``bp_from_video_tpu/utils/profiling.py`` (reference profiler.py rebuilt for
an asynchronous device).

The reference wraps each stage method with a cProfile toggle (reference
profiler.py:17-32) and prints a filtered report after the loop (bp.py:37).
cProfile is wrong for a CUDA program — a launch returns before the card
finishes — so this profiler measures wall time per decorated call, with an
optional ``fence`` that waits for the card when the result holds a CUDA
tensor (device-inclusive timing), plus ``torch.profiler`` trace hooks for
deep dives.

Same usage shape: decorate stage boundaries with ``@profiler.timeit``, dump
with ``profiler.printit()``; the ``enabled`` toggle makes it free when off
(reference profiler.py:7, pbp.py:11).

Inside the engine step the port names its stages with :func:`span` (a
``torch.profiler`` range while a profiler records, so each stage lands on
the trace's timeline beside the kernels it launched, and nothing
otherwise) and counts host-side events with :func:`count` (syncs by site,
detector rows, steps), always on.  ``start_trace``/``stop_trace`` (or any
``torch.profiler.profile``) around a few steps shows the stages.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass, field

import torch


@dataclass
class _Stat:
    calls: int = 0
    total: float = 0.0
    best: float = field(default=float("inf"))
    worst: float = 0.0

    def add(self, dt: float):
        self.calls += 1
        self.total += dt
        self.best = min(self.best, dt)
        self.worst = max(self.worst, dt)


def cuda_device(tree):
    """The device of the first CUDA tensor in a (nested) tuple, list or
    dict result, or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device if tree.is_cuda else None
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for t in items:
        dev = cuda_device(t)
        if dev is not None:
            return dev
    return None


# The one context ``span`` hands out while no profiler records.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named stage of the step (names start with ``bpv.``): a
    ``torch.profiler.record_function`` range while a profiler records, else
    a shared no-op.  The check is a fraction of a microsecond; entering
    ``record_function`` costs about 13 us on a CPU even with no profiler,
    so it is never entered unconditionally."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StageProfiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stats: dict[str, _Stat] = {}
        # Host-side event counts by name (``count``), always on.
        self.counts: dict[str, int] = {}
        self._trace = None

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` (a host integer, never a device value) to counter
        ``name``."""
        self.counts[name] = self.counts.get(name, 0) + n

    def timeit(self, func=None, *, name: str | None = None,
               fence: bool = False):
        """Decorator recording wall time per call.  ``fence=True`` waits for
        the card (``torch.cuda.synchronize``) when the result holds a CUDA
        tensor, so its work is included (use on the outermost step only —
        fencing inner stages serializes the pipeline)."""
        if func is None:
            return lambda f: self.timeit(f, name=name, fence=fence)
        label = name or func.__name__

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if not self.enabled:
                return func(*args, **kwargs)
            t0 = time.perf_counter()
            out = func(*args, **kwargs)
            if fence:
                dev = cuda_device(out)
                if dev is not None:
                    torch.cuda.synchronize(dev)
            self.stats.setdefault(label, _Stat()).add(
                time.perf_counter() - t0)
            return out
        return wrapper

    def report(self) -> str:
        if not self.stats:
            return "(no profile data)"
        rows = ["stage                          calls   total ms    mean ms"
                "     min ms     max ms"]
        for name, s in sorted(self.stats.items(),
                              key=lambda kv: -kv[1].total):
            rows.append(f"{name:30s} {s.calls:5d} {s.total*1e3:10.2f} "
                        f"{s.total/s.calls*1e3:10.3f} {s.best*1e3:10.3f} "
                        f"{s.worst*1e3:10.3f}")
        return "\n".join(rows)

    def count_report(self) -> str:
        """The counters, each also per engine step (counter ``steps``)."""
        steps = self.counts.get("steps", 0)
        rows = ["counter                        total   per step"]
        for name, v in sorted(self.counts.items()):
            per = f"{v / steps:10.3f}" if steps else f"{'-':>10s}"
            rows.append(f"{name:30s} {v:5d} {per}")
        return "\n".join(rows)

    def printit(self, clear: bool = False) -> None:
        if self.enabled:
            print(self.report())
            if self.counts:
                print(self.count_report())
            if clear:
                self.clear()

    def clear(self) -> None:
        self.stats.clear()
        self.counts.clear()

    # Deep-dive hooks: wrap a region with a torch.profiler trace (CPU and
    # CUDA activity), written as a Chrome trace into ``logdir``.
    def start_trace(self, logdir: str) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._trace = (profile(activities=acts), logdir)
        self._trace[0].__enter__()

    def stop_trace(self) -> None:
        prof, logdir = self._trace
        self._trace = None
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


profiler = StageProfiler()
timeit = profiler.timeit
printit = profiler.printit
count = profiler.count
