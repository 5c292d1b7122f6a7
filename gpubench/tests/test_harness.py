"""CPU tests of the benchmark's harness: discovery by name, the statistics,
the operation and byte counts, and the import guard."""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys

import pytest

from gpubench import counts, guard, run, traffic, window

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = run.load_cell(ROOT, name)
    assert cell.spec["engine"]["streams"] >= 1
    assert cell.traffic.name == cell.workload["traffic"]
    assert {m["name"] for m in cell.end_to_end} == {
        "frames_per_s", "step_ms_p95", "setup_s"}
    for m in cell.per_layer:
        mod = importlib.import_module(f"gpubench.metrics.{m['name']}")
        assert callable(mod.read)
    assert set(run.numbers_for(cell)) <= set(cell.spec["limits"])


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A cell of a new configuration and a new traffic mix, with a metric
    listed for it alone: files the harness finds by the names in
    BENCHMARK.json, with no edit to the harness."""
    root = tmp_path
    bench = _bench()
    for sub in ("configs", "traffic"):
        os.makedirs(root / "gpubench" / sub)
    spec = json.load(open(os.path.join(ROOT, bench["configs"][0]["file"])))
    spec["engine"]["streams"] = 16
    json.dump(spec, open(root / "gpubench" / "configs" / "s16.json", "w"))
    mix = json.load(open(os.path.join(ROOT, "gpubench", "traffic",
                                      "live.json")))
    mix["tracked"] = 0.5
    json.dump(mix, open(root / "gpubench" / "traffic" / "half.json", "w"))
    bench["configs"].append(dict(bench["configs"][0], name="s16",
                                 file="gpubench/configs/s16.json"))
    bench["workloads"].append({"name": "s16.half", "config": "s16",
                               "traffic": "half", "chips": 1, "why": "x"})
    bench["per_layer"].append(dict(bench["per_layer"][0],
                                   name="k6_roofline_pct2",
                                   workloads=["s16.half"]))
    json.dump(bench, open(root / "BENCHMARK.json", "w"))
    cell = run.load_cell(str(root), "s16.half")
    assert cell.spec["engine"]["streams"] == 16
    assert cell.traffic.tracked == 0.5
    assert "k6_roofline_pct2" in [m["name"] for m in cell.per_layer]
    assert "frame_sample_gap" not in run.numbers_for(cell)


def test_traffic_refuses_a_clip_of_partial_periods():
    d = json.load(open(os.path.join(ROOT, "gpubench", "traffic",
                                    "live.json")))
    d["clip_frames"] = 251
    with pytest.raises(ValueError):
        traffic.Traffic.from_dict("bad", d)


def _series_result(step_s, per_call=64):
    res = window.WindowResult(step_s, sum(step_s), len(step_s), 0, [], None,
                              0)
    cell = run.load_cell(ROOT, "flagship_mesh.live")
    r = {"cell": cell, "window": res, "setup_s": 1.0, "peak": 0,
         "correct": True, "worst": {}, "limits": {}}
    return run.result_line(r, False, {"platform": "gpu", "kind": "x",
                                      "count": 1})


def test_rate_and_tail_count_every_call_and_the_stall():
    """Ten calls, one stalled: the rate is over all the work and all the
    time, the p95 is the stall; a median of chunks would hide both."""
    step_s = [0.030] * 9 + [0.300]
    line = _series_result(step_s)
    m = line["metrics"]
    assert m["frames_per_s"]["value"] == pytest.approx(640 / 0.570)
    assert m["step_ms_p95"]["value"] == pytest.approx(300.0)
    chunks = [sum(step_s[i:i + 2]) for i in range(0, 10, 2)]
    assert 128 / sorted(chunks)[2] > m["frames_per_s"]["value"] * 1.5
    assert window.p95([0.01] * 19 + [1.0]) == 0.01
    assert window.p95([0.01] * 18 + [1.0, 1.0]) == 1.0


def test_k3_counts_one_shape_by_hand():
    # The hand stand-in's last block: 96 -> 192 at 7x7 over 128 crops.
    flops, nbytes = counts.dense_s2_block(128, 96, 192, 7, "dwpw")
    px = 128 * 49
    assert flops == 2 * px * (96 * 9 + 96 * 192)
    assert nbytes == (128 * 96 * 14 * 14 * 2 + px * 192 * 2
                      + (9 * 96 + 96 * 192) * 2 + (96 + 192) * 4)
    flops, nbytes = counts.dense_s2_block(64, 3, 16, 128, "dense")
    assert flops == 2 * 64 * 128 * 128 * 16 * 27
    assert nbytes == 64 * 3 * 256 * 256 * 2 + 64 * 128 * 128 * 16 * 2 + (
        27 * 16 * 2 + 16 * 4)


def test_k6_counts_one_shape_by_hand():
    flops, nbytes = counts.bottleneck_chain(64, 16, 8, 128, 4)
    px = 64 * 128 * 128
    assert flops == 2 * px * 4 * (16 * 8 + 9 * 8 + 8 * 16)
    assert nbytes == 2 * px * 16 * 2 + 4 * ((128 + 72 + 128) * 2
                                           + (8 + 8 + 16 + 8 + 16) * 4)
    # The flagship's K6 call is bound by its bytes: 67 MB at 3.35 TB/s.
    assert counts.bound_s(nbytes, flops) == pytest.approx(
        nbytes / 3.35e12)
    assert 19e-6 < nbytes / 3.35e12 < 21e-6


def test_net_flops_of_the_hand_standin_by_hand():
    import torch

    from gpubench import nets, system
    spec = run.load_cell(ROOT, "flagship_mesh.live").spec
    spec = dict(spec, engine=dict(spec["engine"], streams=1, height=96,
                                  width=128))
    path = os.path.join(ROOT, ".gpubench", "test_hand.npz")
    crops = nets.calibration_crops("texture", 96, 128, 5)
    nets.save_standin(nets.hand_standin(5, crops["hand_lm"]), path, 224, 21)
    try:
        inputs = system.Inputs(nets.graphs_for(spec["nets"], 5, crops), path)
        ref = system.build_reference(spec, inputs, "cpu")
    finally:
        os.remove(path)
    torch.set_num_threads(2)
    got = counts.net_flops(ref, {"hand_lm": 2})
    convs = [(112, 3, 24, 9, 1)]                    # stem: dense 3x3
    for hw, cin, cout in ((56, 24, 48), (28, 48, 96), (14, 96, 96),
                          (7, 96, 192)):
        convs += [(hw, cin, cin, 9, cin), (hw, cin, cout, 1, 1)]
    want = sum(2 * hw * hw * cout * (cin // g) * k
               for hw, cin, cout, k, g in convs)
    want += 2 * 192 * 49 * 63 + 2 * 192 + 2 * 192      # readout, 1x1 heads
    assert got == 2 * want


def test_guard_compares_whole_top_level_names():
    mods = {"bp_from_video_tpu_torch": 1, "bp_from_video_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert guard.loaded(modules=mods) == []
    mods["bp_from_video_tpu.models"] = 1
    mods["jax.numpy"] = 1
    assert guard.loaded(modules=mods) == ["bp_from_video_tpu.models",
                                          "jax.numpy"]


def test_reference_and_harness_import_no_jax_and_the_reference_no_port():
    code = ("import importlib, pkgutil, sys; import gpubench.ref.runtime."
            "engine, gpubench.check, gpubench.nets, gpubench.precision, "
            "gpubench.systems as s; "
            "[importlib.import_module(f'gpubench.systems.{m.name}') "
            "for m in pkgutil.iter_modules(s.__path__)]; "
            "assert 'gpubench.systems.flagship' in sys.modules; "
            "from gpubench import guard; "
            "print(guard.loaded(guard.FORBIDDEN + (guard.PORT,)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
    code = ("import sys; import gpubench.run as r, gpubench.system, "
            "bp_from_video_tpu_torch.parallel.streams; "
            "from gpubench import guard; print(guard.loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_command_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", "flagship_mesh.live",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_hand_template_holds_its_rect():
    """Iterating the tracker on the pinned landmarks keeps the hand rect
    within a pixel over 300 steps and the face rect exactly."""
    import torch

    from gpubench import nets
    from gpubench.ref.models import warp
    for kind in ("face", "hand"):
        if kind == "face":
            size, rot, scale, shift = 256, (33, 263, 0.0), 1.5, 0.0
            pts_c = torch.tensor(nets.face_template()[:, :2],
                                 dtype=torch.bfloat16).float()
            rect = torch.tensor([320.0, 200.0, 420.0, 420.0, 0.0])
        else:
            size, rot, scale, shift = 224, (0, 9, math.pi / 2), 2.0, -0.1
            b = torch.tensor(nets.hand_template()[0][:, :2],
                             dtype=torch.bfloat16).float()
            pts_c = torch.sigmoid(b) * size
            rect = torch.tensor([150.0, 360.0, 200.0, 200.0, 0.0])
        cov0 = None
        for _ in range(300):
            cov = warp.rect_arr(warp.axis_aligned_cover(warp.arr_rect(rect)))
            cov0 = cov if cov0 is None else cov0
            pts = warp.project_landmarks((pts_c / size)[None],
                                         warp.arr_rect(cov[None]))
            rect = warp.rect_arr(warp.rect_transform(
                warp.landmarks_to_rect(pts, *rot), scale=scale,
                shift_y=shift))[0]
        assert float((cov - cov0).abs().max()) < 1.0, kind


def test_trace_reduction_and_the_idle_share():
    """A hand-made trace: two calls, device work 3 of the slice's 10 ms
    (two overlapping kernels count once); the idle share is read against
    the untraced window's call time, not the slice's."""
    from gpubench import trace
    from gpubench.metrics import device_idle_pct
    ev = [{"name": "gpubench.slice", "cat": "user_annotation", "ph": "X",
           "ts": 0, "dur": 10000},
          {"name": "k1", "cat": "kernel", "ph": "X", "ts": 1000, "dur": 2000},
          {"name": "k2", "cat": "kernel", "ph": "X", "ts": 2000, "dur": 1000},
          {"name": "cp", "cat": "gpu_memcpy", "ph": "X", "ts": 6000,
           "dur": 1000},
          {"name": "aten::add", "cat": "cpu_op", "ph": "X", "ts": 0,
           "dur": 900}]
    t = trace.reduce(ev, 2)
    assert t.busy_s == pytest.approx(3e-3)
    assert t.window_s == pytest.approx(10e-3)
    assert t.launches == 3
    assert t.by_name["k1"] == pytest.approx(2e-3)
    gaps = dict(t.idle_gaps)      # each gap named by the op at its start
    assert gaps["aten::add"] == pytest.approx(1e-3)
    assert gaps["host (no operation)"] == pytest.approx(6e-3)
    res = window.WindowResult([0.003] * 10, 0.030, 10, 0, [], None, 0)
    idle = device_idle_pct.read(run.Run(None, res, trace=t))
    assert idle == pytest.approx(50.0)
