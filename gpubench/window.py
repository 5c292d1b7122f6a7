"""The timed loop: a closed loop of the cell's calls, each timed on the
host clock from the call to the numbers a user reads on the host (the
system's readback)."""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from gpubench import check
from gpubench import traffic as traffic_mod

MAX_CALLS = 16384


@dataclasses.dataclass
class Driver:
    """One timed call of a cell: the system's ``call`` (the port's step,
    then the readback).  The state and outputs of call ``own_call`` are
    kept (``own``) for the reference's run of its own."""

    system: object             # the cell's module under gpubench.systems
    port: object
    traffic: traffic_mod.Traffic
    clip: torch.Tensor
    ts_table: torch.Tensor     # [MAX_CALLS, F, S] on the device
    own_call: int = -1
    own: tuple | None = None

    def inputs(self, call: int):
        frames = traffic_mod.call_frames(self.traffic, self.clip, call)
        ts = self.ts_table[call]
        return frames, (ts[0] if self.traffic.frames_per_call == 1 else ts)

    def call(self, state, call: int):
        """(new state, outputs, host readback)."""
        frames, ts = self.inputs(call)
        state, out, host = self.system.call(self.port, state, frames, ts)
        if call == self.own_call:
            self.own = (state, out)
        return state, out, host


def timestamp_table(t: traffic_mod.Traffic, s: int, device) -> torch.Tensor:
    """Every call's timestamps, made once: a per-call host-to-device copy
    would synchronize the stream inside the window."""
    f = t.frames_per_call
    n = torch.arange(MAX_CALLS * f, dtype=torch.float64)
    ts = ((n + 1) / traffic_mod.FPS).to(torch.float32).reshape(MAX_CALLS, f, 1)
    return ts.expand(MAX_CALLS, f, s).contiguous().to(device)


@dataclasses.dataclass
class WindowResult:
    step_s: list[float]
    window_s: float
    calls: int
    failed_calls: int
    checked: list[check.Checked]
    state: object
    next_call: int


def run_window(drv: Driver, state, first_call: int, seconds: float,
               check_at: set[int]) -> WindowResult:
    """Calls back to back until ``seconds`` have passed (the last call
    started before then finishes); keeps the calls in ``check_at``
    (counted from the window's first) and the last one for the check."""
    times, checked, failed = [], [], 0
    call = first_call
    last = None
    t0 = time.perf_counter()
    while True:
        i = call - first_call
        if call >= MAX_CALLS:
            raise RuntimeError(f"more than {MAX_CALLS} calls in a run")
        t = time.perf_counter()
        if t - t0 >= seconds:
            break
        before = state
        try:
            state, out, _ = drv.call(state, call)
        except Exception as e:                       # a failed call counts
            failed += 1
            print(f"call {call} failed: {type(e).__name__}: {e}", flush=True)
            call += 1
            continue
        times.append(time.perf_counter() - t)
        last = (call, before, out, state)
        if i in check_at:
            checked.append(_keep(drv, *last))
        call += 1
    window = time.perf_counter() - t0
    if last is not None and last[0] - first_call not in check_at:
        checked.append(_keep(drv, *last))
    return WindowResult(times, window, call - first_call, failed, checked,
                        state, call)


def _keep(drv: Driver, call, before, out, after) -> check.Checked:
    frames, ts = drv.inputs(call)
    return check.Checked(call, frames, ts, before, out, after)


def check_calls(seed: int, expected_calls: int, n: int) -> set[int]:
    """``n`` window call indices drawn from the seed among the calls the
    warm-up rate predicts."""
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2**63, 99]))
    hi = max(int(expected_calls), 1)
    return set(int(v) for v in rng.choice(hi, size=min(n, hi),
                                          replace=False))


def p95(values: list[float]) -> float:
    """The 95th percentile by nearest rank over every value."""
    if not values:
        return math.nan
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]
