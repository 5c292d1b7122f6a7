"""The port's ``bpv.*`` spans in a profiled slice (``gpubench/spans.py``)
and the per-layer readers of them, on a hand-made trace worked by hand.

Slice 0-10,000 us, two calls.  Call A: ``bpv.step`` 500-4,500 with
``bpv.runner`` 600-2,600 (``bpv.net.flm_lm`` 1,000-2,000,
``bpv.sync.face_gate`` 2,200-2,400) and ``bpv.signal`` 2,700-4,400; call B
the same 5,000 us later without the sync.  Device: k1 1,200-2,200
launched in A's net, k2 3,000-3,500 in A's signal half, k5 5,800-6,000 in
B's runner outside its net, k3 6,500-7,500 in B's net, the readback copy
9,600-9,800 outside any step.  Busy 2,900 us, idle 7,100 us.
"""

from __future__ import annotations

import pytest

from gpubench import run, spans, trace, window
from gpubench.metrics import (gate_syncs_per_step, nets_device_ms,
                              runner_idle_ms, signal_device_ms,
                              signal_idle_ms, sync_wait_ms)


def _x(name, cat, ts, dur, corr=None):
    e = {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _base() -> list:
    """The slice, the harness's ranges, kernels, a copy and launches."""
    ev = [_x("gpubench.slice", "user_annotation", 0, 10000),
          _x("gpubench.step", "user_annotation", 400, 4800),
          _x("gpubench.step", "user_annotation", 5400, 4500),
          _x("aten::add", "cpu_op", 1100, 20)]
    for corr, (launch, ts, dur) in enumerate(
            [(1100, 1200, 1000), (2800, 3000, 500), (5700, 5800, 200),
             (6100, 6500, 1000), (9550, 9600, 200)], 1):
        ev.append(_x("cudaLaunchKernel", "cuda_runtime", launch, 5, corr))
        cat = "gpu_memcpy" if corr == 5 else "kernel"
        ev.append(_x(f"k{corr}", cat, ts, dur, corr))
    return ev


def _with_spans() -> list:
    ev = _base()
    for off in (0, 5000):
        ev += [_x("bpv.step", "user_annotation", 500 + off, 4000),
               _x("bpv.runner", "user_annotation", 600 + off, 2000),
               _x("bpv.net.flm_lm", "user_annotation", 1000 + off, 1000),
               _x("bpv.signal", "user_annotation", 2700 + off, 1700)]
    ev.append(_x("bpv.sync.face_gate", "user_annotation", 2200, 200))
    return ev


def _run(ev) -> run.Run:
    """A run whose untraced window made 10 calls in 30 ms (3 ms a call:
    idle 3 - 1.45 = 1.55 ms a call), with the slice's spans attached."""
    t = trace.reduce(ev, 2)
    t.spans = spans.reduce(ev)
    res = window.WindowResult([0.003] * 10, 0.030, 10, 0, [], None, 0)
    return run.Run(None, res, trace=t)


def test_device_time_and_launches_by_span():
    sp = spans.reduce(_with_spans()).by_name
    assert sp["bpv.net.flm_lm"].device_s == pytest.approx(2000e-6)
    assert sp["bpv.net.flm_lm"].launches == 2
    assert sp["bpv.runner"].device_s == pytest.approx(2200e-6)
    assert sp["bpv.runner"].launches == 3
    assert sp["bpv.signal"].device_s == pytest.approx(500e-6)
    assert sp["bpv.signal"].launches == 1
    assert sp["bpv.step"].launches == 4          # the readback is outside
    assert sp["bpv.sync.face_gate"].host_s == pytest.approx(200e-6)
    assert sp["bpv.step"].host_s == pytest.approx(8000e-6)


def test_idle_split_by_overlap_and_outside():
    """The gap 2,200-3,000 runs from A's runner (400 us) through the step
    between its halves (100) into its signal half (300)."""
    got = spans.reduce(_with_spans())
    sp = got.by_name
    assert got.idle_s == pytest.approx(7100e-6)
    assert sp["bpv.runner"].idle_s == pytest.approx(1800e-6)
    assert sp["bpv.signal"].idle_s == pytest.approx(2900e-6)
    assert sp["bpv.step"].idle_s == pytest.approx(5300e-6)
    assert sp["bpv.net.flm_lm"].idle_s == pytest.approx(700e-6)
    assert sp["bpv.sync.face_gate"].idle_s == pytest.approx(200e-6)
    assert sp[spans.OUTSIDE].idle_s == pytest.approx(1800e-6)


def test_existing_trace_fields_unchanged_by_spans():
    """``trace.reduce`` reads the same busy time, window, launches and
    device time by kernel with the port's spans in the trace; its ranges
    gain the spans; the idle gaps sum to the same, only their labels
    name the port's stages."""
    a, b = trace.reduce(_base(), 2), trace.reduce(_with_spans(), 2)
    assert (a.calls, a.window_s, a.busy_s, a.launches, a.by_name) == (
        b.calls, b.window_s, b.busy_s, b.launches, b.by_name)
    assert {k: v for k, v in b.by_range.items()
            if not k.startswith("bpv.")} == a.by_range
    assert sum(v for _, v in a.idle_gaps) == pytest.approx(
        sum(v for _, v in b.idle_gaps))
    assert spans.reduce(_base()) is None


def test_readers_by_hand(monkeypatch):
    from bp_from_video_tpu_torch.utils import profiling
    r = _run(_with_spans())
    assert nets_device_ms.read(r) == pytest.approx(1.0)
    assert signal_device_ms.read(r) == pytest.approx(0.25)
    assert runner_idle_ms.read(r) == pytest.approx(1.55 * 1800 / 7100)
    assert signal_idle_ms.read(r) == pytest.approx(1.55 * 2900 / 7100)
    assert sync_wait_ms.read(r) == pytest.approx(0.1)
    monkeypatch.setattr(profiling.profiler, "counts", {
        "steps": 4, "sync.face_gate": 4, "sync.hand_gate": 4,
        "det.face.rows": 8})
    assert gate_syncs_per_step.read(r) == pytest.approx(2.0)


def test_readers_read_nothing_without_spans(monkeypatch):
    """A program without the spans and counters (the parent of the port's
    tracing): every new reader returns None, none raises."""
    from bp_from_video_tpu_torch.utils import profiling
    r = _run(_base())
    monkeypatch.delattr(profiling.profiler, "counts")
    for mod in (nets_device_ms, signal_device_ms, runner_idle_ms,
                signal_idle_ms, sync_wait_ms, gate_syncs_per_step):
        assert mod.read(r) is None, mod.__name__
    del r.trace.spans                       # a Trace with no such field
    for mod in (runner_idle_ms, signal_idle_ms, sync_wait_ms):
        assert mod.read(r) is None, mod.__name__
