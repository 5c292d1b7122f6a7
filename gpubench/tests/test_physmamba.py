"""CPU tests of the physmamba system (``gpubench/systems/physmamba``) at a
tiny size: PhysMamba at its published widths on 16-frame clips of 32x32
crops, 2 streams of 96x128 in float32.  The cell is found by name, runs end
to end untraced and on a hand-made profiled slice and is judged correct;
its control is not; a stale ring and a scan with one direction dropped,
planted in the port, are not correct; the counts match the published
widths by hand; the system imports neither JAX nor the port."""

from __future__ import annotations

import math
import os
import subprocess
import sys

import pytest
import torch

from gpubench import check, counts, run, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2147483777
CELL = "physmamba.chunk128"
NET = {"slow_dim": 64, "fast_dim": 32, "d_state": 16, "d_conv": 4,
       "expand": 2, "reduction": 2, "head_dim": 48, "theta": 0.5,
       "clip_frames": 16, "crop": 32, "hop": 16}
# 64 frames are three periods of the mix's 1.40625 Hz pulse.
TINY = {"engine": {"streams": 2, "height": 96, "width": 128,
                   "compute_dtype": "float32"},
        "traffic": {"clip_frames": 64, "frames_per_call": 16,
                    "warmup_calls": 2, "check_calls": 2, "own_calls": 3,
                    "profile_calls": 2, "sync_calls": 1}}
SPANS = ("bpv.clip", "bpv.net.physmamba", "bpv.pm.stem", "bpv.pm.blocks",
         "bpv.pm.scan", "bpv.pm.head")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    """The cell with 16-frame clips of 32x32 crops (the harness overrides
    only the engine and the traffic), run in float32: the port's crops and
    BVP then agree with the reference's to about 1e-5, so the crop and BVP
    gaps are held to 1e-3 in place of the limits the configuration sets
    for bf16 on the card."""
    load = run.load_cell

    def small(root, name, overrides=None):
        cell = load(root, name, overrides)
        cell.spec["net"] = dict(NET)
        cell.spec["limits"] = dict(cell.spec["limits"], crop_gap=1e-3,
                                   bvp_gap=1e-3, own_crop_gap=1e-3)
        return cell
    monkeypatch.setattr(run, "load_cell", small)


def _cpu_trace(monkeypatch):
    """A hand-made slice: each 1 ms call opens the cell's spans, each with
    one 10 us kernel launched inside it (the ``bpv.pm.*`` spans nested in
    the net's)."""
    def profile_calls(drv, state, first, n, path):
        ev = [{"name": "gpubench.slice", "cat": "user_annotation",
               "ph": "X", "ts": 0, "dur": 1000 * n}]
        corr = 0
        for i in range(n):
            state = drv.call(state, first + i)[0]
            for j, name in enumerate(SPANS):
                t0 = 1000 * i + 150 * j
                ev.append({"name": name, "cat": "user_annotation", "ph": "X",
                           "ts": t0, "dur": 100})
                corr += 1
                ev.append({"name": "cudaLaunchKernel", "cat": "cuda_runtime",
                           "ph": "X", "ts": t0 + 10, "dur": 2,
                           "args": {"correlation": corr}})
                ev.append({"name": f"k{j}", "cat": "kernel", "ph": "X",
                           "ts": t0 + 20, "dur": 10,
                           "args": {"correlation": corr}})
        return trace.reduce(ev, n), state, first + n
    monkeypatch.setattr(trace, "profile_calls", profile_calls)
    monkeypatch.setattr(trace, "count_syncs", lambda fn: fn() or 0)


def _run(traced=False, control=False):
    return run.execute(ROOT, CELL, SEED, 0.3, traced, device="cpu",
                       overrides=TINY, control=control)


def test_the_cell_is_found_by_name():
    cell = run.load_cell(ROOT, CELL)
    assert cell.spec["system"] == "physmamba"
    assert cell.system.__name__ == "gpubench.systems.physmamba"
    assert cell.traffic.frames_per_call == cell.spec["net"]["hop"] == 128
    assert {m["name"] for m in cell.per_layer} == {
        "pm_net_device_ms", "pm_scan_roofline_pct", "pm_stem_roofline_pct",
        "pm_step_mfu"}
    assert {m["name"] for m in cell.end_to_end} == {
        "frames_per_s", "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("traced", [False, True])
def test_physmamba_runs_the_cell_and_is_judged(tiny, monkeypatch, traced):
    _cpu_trace(monkeypatch)
    r = _run(traced, control=not traced)
    assert r["correct"], r["check_lines"]
    assert r["worst"]["bvp_gap"] < 1e-4
    assert r["tracked_end"] == (2, 2)
    line = run.result_line(r, traced, {"platform": "gpu", "kind": "x",
                                       "count": 1})
    if traced:
        assert set(line["metrics"]) == {"pm_net_device_ms",
                                        "pm_scan_roofline_pct",
                                        "pm_stem_roofline_pct",
                                        "pm_step_mfu"}
        assert all(math.isfinite(m["value"]) and m["value"] > 0
                   for m in line["metrics"].values()), line["metrics"]
    else:
        ok, lines = check.verdict(r["control_worst"], r["limits"])
        assert not ok, lines
        assert r["fault_worst"]["crop_gap"] > r["limits"]["crop_gap"]


def _plant(monkeypatch, fault):
    from bp_from_video_tpu_torch.models import physmamba as pm
    from bp_from_video_tpu_torch.runtime.engine import Engine
    if fault == "stale_ring":
        crops = Engine._face_crops

        def last(self, frames, track):
            u = crops(self, frames, track).unflatten(0, (frames.shape[0],
                                                         -1))
            return u[-1:].expand_as(u).flatten(0, 1)
        monkeypatch.setattr(Engine, "_face_crops", last)
    else:
        scan = pm.selective_scan

        def forward_only(v, dt, bm, cm, a, d, budget=pm.SCAN_BYTES):
            v = torch.stack((v[0], torch.zeros_like(v[1])))
            return scan(v, dt, bm, cm, a, d, budget)
        monkeypatch.setattr(pm, "selective_scan", forward_only)


@pytest.mark.parametrize("fault, number", [("stale_ring", "crop_gap"),
                                           ("one_direction", "bvp_gap")])
def test_physmamba_faults_are_not_correct(tiny, monkeypatch, fault, number):
    """Frame F - 1's crop pushed for every frame of a call, or the scan's
    backward direction dropped: each planted in the port reaches a
    compared number."""
    _plant(monkeypatch, fault)
    r = _run()
    assert r["worst"][number] > r["limits"][number], r["check_lines"]
    assert not r["correct"]


def test_physmamba_counts_by_hand():
    """At the published widths for 64 clips: the stem and split 6.08 ms
    of least time (stem2's 3.71 TFLOP bound it), the scans 2.84 ms (bytes
    bound: 6 E + 4 N bf16 values a token), 6.46 TFLOP a call."""
    from gpubench.systems import physmamba as sysm
    cell = run.load_cell(ROOT, CELL)
    k = cell.spec["kernels"]
    stem = [sysm.stem_layer(64, **{a: v for a, v in s.items() if a != "net"})
            for s in k["pm_stem"]]
    assert round(stem[2][0] / 1e12, 2) == 3.71
    assert stem[2][0] == 2.0 * 64 * 128 * 64 * 64 * 64 * 32 * 27

    def bound(fn, launches):
        return counts.kernel_bound_s(fn, launches, lambda net: 64)
    assert round(1e3 * bound(sysm.stem_layer, k["pm_stem"]), 2) == 6.08
    scan = [sysm.scan(64, **{a: v for a, v in s.items() if a != "net"})
            for s in k["pm_scan"]]
    assert scan[0][1] == 64 * 32768 * (6 * 128 + 4 * 16) * 2
    assert all(b / counts.HBM_BYTES_PER_S > f / counts.BF16_TENSOR_FLOPS
               for f, b in scan)
    assert round(1e3 * bound(sysm.scan, k["pm_scan"]), 2) == 2.84
    assert round(64 * sysm.net_ops(cell.spec["net"]) / 1e12, 2) == 6.46


def test_physmamba_system_imports_neither_jax_nor_the_port():
    code = ("import sys; import gpubench.systems.physmamba as s; "
            "assert 'gpubench.systems.physmamba.ref' in sys.modules; "
            "from gpubench import guard; "
            "print(guard.loaded(guard.FORBIDDEN + (guard.PORT,)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_frozen_reference_draws_the_ports_weights():
    """The judge's ``init_params`` lays out the same weights as the
    port's, and its net is the port's reference op for op."""
    from bp_from_video_tpu_torch.config import PhysMambaConfig
    from bp_from_video_tpu_torch.models import physmamba as pm
    from bp_from_video_tpu_torch.models import physmamba_ref
    from gpubench.systems.physmamba import ref
    want = pm.init_params(PhysMambaConfig(**NET), 11)
    got = ref.init_params(NET, 11)
    flat_w, flat_g = [], []
    pm.map_params(flat_w.append, want)
    pm.map_params(flat_g.append, got)
    assert len(flat_w) == len(flat_g)
    assert all(torch.equal(a, b) for a, b in zip(flat_w, flat_g))
    x = torch.randn(1, 3, 16, 32, 32, generator=torch.Generator()
                    .manual_seed(2))
    assert torch.equal(ref.forward(got, x, 0.5),
                       physmamba_ref.forward(want, x, 0.5))
