"""CPU tests of the physformer system (``gpubench/systems/physformer``) at a
tiny size: a net of PhysFormer's shape at dim 24, 3 layers, 32-frame clips
of 64x64 crops, 2 streams of 96x128 in float32.  The cell runs end to end
untraced and on a hand-made profiled slice and is judged correct; its
control is not; each fault planted in the port reaches a compared number;
the counts match the published widths by hand; the system imports neither
JAX nor the port."""

from __future__ import annotations

import math
import os
import subprocess
import sys

import pytest
import torch

from gpubench import check, run, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2147483701


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PF_CELL = "physformer.chunk160"
PF_NET = {"dim": 24, "ff_dim": 36, "num_heads": 4, "num_layers": 3,
          "patch": 4, "theta": 0.7, "gra_sharp": 2.0, "clip_frames": 32,
          "crop": 64, "hop": 20}
PF_TINY = {"engine": {"streams": 2, "height": 96, "width": 128,
                      "compute_dtype": "float32"},
           "traffic": {"clip_frames": 40, "frames_per_call": 20,
                       "warmup_calls": 2, "check_calls": 2, "own_calls": 4,
                       "profile_calls": 2, "sync_calls": 1}}
PF_SPANS = ("bpv.clip", "bpv.net.physformer", "bpv.pf.stem", "bpv.pf.trunk")


@pytest.fixture
def pf_tiny(monkeypatch):
    """The physformer cell with a net of the published shape at a tiny
    width (the harness overrides only the engine and the traffic), run in
    float32: the port's crops and BVP then agree with the reference's to
    about 1e-6, so the crop and BVP gaps are held to 1e-3 in place of the
    limits the configuration sets for bf16 on the card."""
    load = run.load_cell

    def tiny(root, name, overrides=None):
        cell = load(root, name, overrides)
        cell.spec["net"] = dict(PF_NET)
        cell.spec["limits"] = dict(cell.spec["limits"], crop_gap=1e-3,
                                   bvp_gap=1e-3, own_crop_gap=1e-3)
        return cell
    monkeypatch.setattr(run, "load_cell", tiny)


def _pf_cpu_trace(monkeypatch):
    """A hand-made slice: each 1 ms call opens the physformer spans, each
    with one 10 us kernel launched inside it."""
    def profile_calls(drv, state, first, n, path):
        ev = [{"name": "gpubench.slice", "cat": "user_annotation",
               "ph": "X", "ts": 0, "dur": 1000 * n}]
        corr = 0
        for i in range(n):
            state = drv.call(state, first + i)[0]
            for j, name in enumerate(PF_SPANS):
                t0 = 1000 * i + 200 * j
                nest = 150 if name.startswith("bpv.pf.") else 0
                ev.append({"name": name, "cat": "user_annotation", "ph": "X",
                           "ts": t0 - nest, "dur": 100 + 2 * nest})
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


def _pf(traced=False, control=False):
    return run.execute(ROOT, PF_CELL, SEED, 0.3, traced, device="cpu",
                       overrides=PF_TINY, control=control)


@pytest.mark.parametrize("traced", [False, True])
def test_physformer_runs_a_cell_and_is_judged(pf_tiny, monkeypatch, traced):
    _pf_cpu_trace(monkeypatch)
    r = _pf(traced, control=not traced)
    assert r["correct"], r["check_lines"]
    assert set(r["limits"]) == {"face_lm_gap_px", "rect_gap_px", "crop_gap",
                                "bvp_gap", "proc_gap", "spec_gap",
                                "own_crop_gap"}
    assert r["tracked_end"] == (2, 2)
    line = run.result_line(r, traced, {"platform": "gpu", "kind": "x",
                                       "count": 1})
    if traced:
        want = {"pf_net_device_ms", "pf_stem_roofline_pct",
                "pf_trunk_roofline_pct", "clip_device_ms", "clips_per_step",
                "pf_step_mfu"}
        assert set(line["metrics"]) == want
        assert all(math.isfinite(m["value"]) and m["value"] > 0
                   for m in line["metrics"].values()), line["metrics"]
    else:
        ok, lines = check.verdict(r["control_worst"], r["limits"])
        assert not ok, lines
        assert r["fault_worst"]["crop_gap"] > r["limits"]["crop_gap"]


def _plant(monkeypatch, fault):
    import dataclasses

    from bp_from_video_tpu_torch.models import physformer as pf
    from bp_from_video_tpu_torch.runtime.engine import Engine
    if fault == "theta0":
        fold = pf.fold_cdc
        monkeypatch.setattr(pf, "fold_cdc", lambda w, theta: fold(w, 0.0))
    elif fault == "gra_sharp1":
        init = pf.PhysFormer.__init__

        def sharp1(self, *a, **k):
            init(self, *a, **k)
            self.cfg = dataclasses.replace(self.cfg, gra_sharp=1.0)
        monkeypatch.setattr(pf.PhysFormer, "__init__", sharp1)
    elif fault == "last_crop":
        crops = Engine._face_crops

        def last(self, frames, track):
            u = crops(self, frames, track).unflatten(0, (frames.shape[0],
                                                         -1))
            return u[-1:].expand_as(u).flatten(0, 1)
        monkeypatch.setattr(Engine, "_face_crops", last)
    else:
        clip_input = Engine._clip_input

        def half(self, clip):
            due, rows, n, x = clip_input(self, clip)
            keep = torch.arange(due.shape[0]) < due.shape[0] // 2
            return due & keep, rows, n, x
        monkeypatch.setattr(Engine, "_clip_input", half)


@pytest.mark.parametrize("fault, number", [
    ("theta0", "bvp_gap"), ("gra_sharp1", "bvp_gap"),
    ("last_crop", "crop_gap"), ("half_streams", "bvp_gap")])
def test_physformer_faults_are_not_correct(pf_tiny, monkeypatch, fault,
                                           number):
    """Theta 0, gra_sharp 1, frame F - 1's crop pushed for every frame of
    a call, the net's BVP kept on half the streams: each planted in the
    port reaches a compared number."""
    _plant(monkeypatch, fault)
    r = _pf()
    assert r["worst"][number] > r["limits"][number], r["check_lines"]
    assert not r["correct"]


def test_physformer_counts_by_hand():
    """The stem's three layers and the trunk, counted for one clip at the
    published widths: 9.4 + 40.8 + 40.8 GFLOP and 47 + 47 + 24 MB; the
    trunk 0.75 GFLOP of patch embedding, 12 blocks of 0.86."""
    from gpubench.systems import physformer as sysm
    cell = run.load_cell(ROOT, PF_CELL)
    stem = [sysm.stem_layer(1, **{k: v for k, v in s.items() if k != "net"})
            for s in cell.spec["kernels"]["pf_stem"]]
    assert [round(f / 1e9, 1) for f, _ in stem] == [9.4, 40.8, 40.8]
    assert [round(b / 1e6) for _, b in stem] == [47, 47, 24]
    t = cell.spec["kernels"]["pf_trunk"][0]
    flops, _ = sysm.trunk(1, **{k: v for k, v in t.items() if k != "net"})
    blocks = 12 * (2 * 640 * 192 * 96 * 27 + 2 * 2 * 640 * 96 * 96
                   + 4 * 640 * 640 * 96 + 4 * 640 * 96 * 144
                   + 2 * 640 * 144 * 27)
    assert round(blocks / 12 / 1e9, 2) == 0.86
    head = 2 * 80 * 16 * 96 * 96 * 3 + 2 * 160 * 16 * 48 * 96 * 3 \
        + 2 * 160 * 48
    assert flops == 2.0 * 640 * 96 * 96 * 64 + blocks + head
    assert round((sum(f for f, _ in stem) + flops) / 1e12, 3) == 0.102


def test_physformer_system_imports_neither_jax_nor_the_port():
    code = ("import sys; import gpubench.systems.physformer as s; "
            "assert 'gpubench.systems.physformer.ref' in sys.modules; "
            "from gpubench import guard; "
            "print(guard.loaded(guard.FORBIDDEN + (guard.PORT,)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
