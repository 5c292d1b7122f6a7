"""CPU tests of the seam between the harness and the systems it measures
(``gpubench/systems``): a toy system (``tests/toy/``) added to a checkout
as new files and entries only runs a cell end to end and is judged, and
the flagship reads through the seam what it read before it."""

from __future__ import annotations

import json
import math
import os
import shutil
import sys

import pytest
import torch

import gpubench.metrics
import gpubench.systems
from gpubench import check, run, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "toy")
SEED = 2147483701


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cpu_trace(monkeypatch):
    """The CPU has no device trace: the profiled slice runs its calls and
    reads as a hand-made trace, one ``toy_conv`` kernel of 1 us a 1 ms
    call; no host syncs."""
    def profile_calls(drv, state, first, n, path):
        ev = [{"name": "gpubench.slice", "cat": "user_annotation", "ph": "X",
               "ts": 0, "dur": 1000 * n}]
        for i in range(n):
            state = drv.call(state, first + i)[0]
            ev.append({"name": "toy_conv", "cat": "kernel", "ph": "X",
                       "ts": 1000 * i, "dur": 1})
        return trace.reduce(ev, n), state, first + n
    monkeypatch.setattr(trace, "profile_calls", profile_calls)
    monkeypatch.setattr(trace, "count_syncs", lambda fn: fn() or 0)


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """A checkout that holds the toy system under ``gpubench/systems/``, a
    reader under ``gpubench/metrics/``, a configuration, a traffic mix with
    the system's own key and a ``BENCHMARK.json``: new files only, found
    through the packages' search paths."""
    sysdir, metdir = (tmp_path / "gpubench" / "systems",
                      tmp_path / "gpubench" / "metrics")
    shutil.copytree(TOY, sysdir / "toy", ignore=shutil.ignore_patterns(
        "__pycache__", "toy_roofline_pct.py"))
    os.makedirs(metdir)
    shutil.copy(os.path.join(TOY, "toy_roofline_pct.py"), metdir)
    _write(tmp_path / "gpubench" / "configs" / "toy_small.json", {
        "name": "toy_small", "system": "toy",
        "engine": {"streams": 3, "height": 32, "width": 32, "channels": 4},
        "kernels": {"toy_conv": [{"net": "frames", "cin": 3, "cout": 4,
                                  "hw": 15}]},
        "limits": {"value_gap": 1e-4, "ring_gap": 1e-4, "mean_gap": 1e-4,
                   "own_ring_gap": 1e-4}})
    _write(tmp_path / "gpubench" / "traffic" / "ring8.json", {
        "scene": "texture", "clip_frames": 25, "pulse_hz": 1.2,
        "delay_frames": 3, "split_frac": 0.625, "tracked": 1.0,
        "frames_per_call": 1, "warmup_calls": 2, "check_calls": 2,
        "own_calls": 6, "profile_calls": 2, "sync_calls": 1,
        "ring_frames": 8})
    both = ["toy_small.ring8"]
    _write(tmp_path / "BENCHMARK.json", {
        "configs": [{"name": "toy_small", "file":
                     "gpubench/configs/toy_small.json"}],
        "workloads": [{"name": "toy_small.ring8", "config": "toy_small",
                       "traffic": "ring8", "chips": 1}],
        "end_to_end": [{"name": n, "unit": u} for n, u in (
            ("frames_per_s", "frames/s"), ("step_ms_p95", "ms"),
            ("setup_s", "s"))],
        "per_layer": [{"name": n, "unit": u, "workloads": both} for n, u in (
            ("step_mfu", "%"), ("toy_roofline_pct", "%"),
            ("launches_per_step", "launches"), ("device_idle_pct", "%"))]})
    for pkg, d in ((gpubench.systems, sysdir), (gpubench.metrics, metdir)):
        monkeypatch.setattr(pkg, "__path__", list(pkg.__path__) + [str(d)])
    yield str(tmp_path)
    for m in [m for m in sys.modules if m.startswith("gpubench.systems.toy")
              or m == "gpubench.metrics.toy_roofline_pct"]:
        del sys.modules[m]


def _toy(root, traced=False, control=False):
    return run.execute(root, "toy_small.ring8", SEED, 0.3, traced,
                       device="cpu", control=control)


@pytest.mark.parametrize("traced", [False, True])
def test_a_system_added_as_new_files_runs_and_is_judged(toy_root,
                                                        monkeypatch, traced):
    _cpu_trace(monkeypatch)
    cell = run.load_cell(toy_root, "toy_small.ring8")
    assert cell.traffic.params == {"ring_frames": 8}
    r = _toy(toy_root, traced, control=True)
    assert r["correct"], r["check_lines"]
    assert r["tracked_start"] == r["tracked_end"] == 3
    ok, lines = check.verdict(r["control_worst"], r["limits"])
    assert not ok, lines
    line = run.result_line(r, traced, {"platform": "gpu", "kind": "x",
                                       "count": 1})
    assert line["correct"] and line["attempted"] > 0
    want = ({m["name"] for m in cell.per_layer} if traced
            else {"frames_per_s", "step_ms_p95", "setup_s"})
    assert set(line["metrics"]) == want
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in line["metrics"].values()), line["metrics"]
    assert set(line["checks"]) == set(r["limits"])


def test_a_perturbed_toy_port_is_not_correct(toy_root, monkeypatch):
    from gpubench.systems.toy import port
    step = port.ToyPort.step

    def perturbed(self, state, frames):
        state, out = step(self, state, frames)
        return state, out._replace(value=out.value * 1.001)
    monkeypatch.setattr(port.ToyPort, "step", perturbed)
    r = _toy(toy_root)
    assert r["worst"]["value_gap"] > r["limits"]["value_gap"]
    assert not r["correct"]


def test_a_traffic_key_no_one_declares_is_refused(toy_root):
    path = os.path.join(toy_root, "gpubench", "traffic", "ring8.json")
    with open(path) as f:
        mix = json.load(f)
    _write(path, dict(mix, stride=2))
    with pytest.raises(ValueError, match="stride"):
        run.load_cell(toy_root, "toy_small.ring8")


# The flagship's numbers at test_correct's TINY (live) and LAGGED sizes,
# seed SEED, read on the CPU from the harness before it had systems.
PARENT = {
    "flagship_mesh.live": {
        "flops_per_call": 610527488.0,
        "kernel_bounds": {"dense_s2_block": 3.558743880597015e-06,
                          "bottleneck_chain": 6.270662686567164e-07},
        "own": {"own_raw_gap": 0.0, "own_proc_gap": 0.0, "own_bpm_gap": 0.0,
                "own_ptt_gap": 0.0},
        "control_own": {"own_raw_gap": 0.24003022165358798,
                        "own_proc_gap": 7.111417031859002,
                        "own_bpm_gap": 160.0, "own_ptt_gap": 12.0}},
    "flagship_mesh.lagged4": {
        "flops_per_call": 2442109952.0,
        "kernel_bounds": {"dense_s2_block": 1.4166314029850746e-05,
                          "bottleneck_chain": 2.5051128358208957e-06},
        "own": {"own_raw_gap": 0.0, "own_proc_gap": 0.0, "own_bpm_gap": 0.0,
                "own_ptt_gap": 0.0},
        "control_own": {"own_raw_gap": 0.1773693909552316,
                        "own_proc_gap": 45.55678557164157,
                        "own_bpm_gap": 178.0, "own_ptt_gap": 100.0}},
}
LIMITS = {"face_lm_gap_px": 6.5, "hand_lm_gap_px": 1.4, "rect_gap_px": 8.0,
          "roi_gap_px": 7.0, "sample_gap": 0.0001, "proc_gap": 5e-05,
          "spec_gap": 5e-05, "corr_gap": 5e-05, "bpm_gap": 0.1,
          "ptt_gap": 0.1, "own_raw_gap": 0.15}


@pytest.mark.parametrize("cell", list(PARENT))
def test_the_flagship_reads_through_the_seam_as_before(monkeypatch, cell):
    """The compared numbers and limits, the nets' operations a call, the
    K3 and K6 bounds, and the own run's readings of the port and of the
    control: equal to what the harness read before the seam."""
    from gpubench.tests import test_correct
    ov = test_correct.LAGGED if "lagged" in cell else test_correct.TINY
    _cpu_trace(monkeypatch)
    runs = []

    class Recorded(run.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)
    monkeypatch.setattr(run, "Run", Recorded)
    r = run.execute(ROOT, cell, SEED, 0.5, True, device="cpu", overrides=ov,
                    control=True)
    want = PARENT[cell]
    limits = dict(LIMITS, **({"frame_sample_gap": 0.015}
                             if "lagged" in cell else {}))
    assert run.numbers_for(run.load_cell(ROOT, cell, ov)) == limits
    assert r["correct"], r["check_lines"]
    assert runs[0].flops_per_call == want["flops_per_call"]
    assert runs[0].kernel_bounds == want["kernel_bounds"]
    assert {k: r["worst"][k] for k in want["own"]} == want["own"]
    assert {k: r["control_worst"][k] for k in want["control_own"]} == (
        want["control_own"])
    assert ("fault_worst" in r) == ("lagged" in cell)
