"""CPU tests of how ``correct`` is decided, at a tiny size (2 streams of
96x128, float32, ``device="cpu"``): both cells pass against the plain
reference; the control (the reference a step below the stated precisions)
and the faults a cell can have come out not correct; a perturbed trunk
reaches the compared landmarks."""

from __future__ import annotations

import os

import pytest
import torch

from gpubench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2147483701
TINY = {"engine": {"streams": 2, "height": 96, "width": 128,
                   "compute_dtype": "float32"},
        "traffic": {"clip_frames": 25, "warmup_calls": 2, "check_calls": 2,
                    "own_calls": 4}}
# The trunk test at the cells' frame size: the gap is in frame pixels, and
# the crops map to more of them than at 96x128.
FULL = {"engine": {"streams": 2, "compute_dtype": "float32"},
        "traffic": TINY["traffic"]}
LAGGED = {"engine": TINY["engine"],
          "traffic": {"clip_frames": 100, "warmup_calls": 1,
                      "check_calls": 1, "own_calls": 2}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(cell, control=False, seconds=0.5, ov=None, root=ROOT):
    ov = ov or (LAGGED if "lagged" in cell else TINY)
    return run.execute(root, cell, SEED, seconds, False, device="cpu",
                       overrides=ov, control=control)


@pytest.mark.parametrize("cell", ["flagship_mesh.live",
                                  "flagship_mesh.lagged4"])
def test_cell_is_correct_and_its_control_is_not(cell):
    r = _run(cell, control=True)
    assert r["correct"], r["check_lines"]
    assert r["tracked_end"] == r["tracked_start"]
    from gpubench import check
    ok, lines = check.verdict(r["control_worst"], r["limits"])
    assert not ok, lines


def _fault(monkeypatch, kind):
    from bp_from_video_tpu_torch.parallel import streams
    from bp_from_video_tpu_torch.runtime import engine as engine_mod
    step = streams.MultiStreamEngine.step
    if kind == "state_unchanged":
        def faulty(self, params, state, frames, ts):
            _, out = step(self, params, state, frames, ts)
            return state, out
        monkeypatch.setattr(streams.MultiStreamEngine, "step", faulty)
    elif kind == "half_batch":
        # The second half of the streams' samples are the first half's:
        # the sampling ran on half the batch.
        roi = engine_mod.roi_ops.sample_rois_batch

        def half(frames, rois, *a, **k):
            s = frames.shape[0] // 2
            got = roi(frames[:s], rois[:s], *a, **{
                kk: (v[:s] if kk == "weights" and v is not None else v)
                for kk, v in k.items()})
            return torch.cat([got, got], 0)
        monkeypatch.setattr(engine_mod.roi_ops, "sample_rois_batch", half)
    elif kind == "last_frame_pushed":
        # A lagged call pushes its last frame's samples for all F frames.
        roi = engine_mod.roi_ops.sample_rois_batch

        def last(frames, rois, *a, **k):
            got = roi(frames, rois, *a, **k)
            s = TINY["engine"]["streams"]
            return got[-s:].repeat(got.shape[0] // s, 1)
        monkeypatch.setattr(engine_mod.roi_ops, "sample_rois_batch", last)
    elif kind == "answer_altered":
        def faulty(self, params, state, frames, ts):
            state, out = step(self, params, state, frames, ts)
            return state, out._replace(bpm=out.bpm + 1)
        monkeypatch.setattr(streams.MultiStreamEngine, "step", faulty)


@pytest.mark.parametrize("cell,kind", [
    ("flagship_mesh.live", "state_unchanged"),
    ("flagship_mesh.live", "half_batch"),
    ("flagship_mesh.live", "answer_altered"),
    ("flagship_mesh.lagged4", "last_frame_pushed")])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, kind):
    _fault(monkeypatch, kind)
    r = _run(cell)
    assert not r["correct"], (kind, r["check_lines"])


@pytest.mark.parametrize("where", ["hand_trunk", "mesh_stage"])
def test_a_perturbed_trunk_reaches_the_compared_landmarks(monkeypatch,
                                                          where):
    """The hand trunk's features of each crop swapped for another crop's,
    or the mesh's 128x128 stage (K6) scaled by 1.5: the landmarks move by
    more than the limit."""
    from bp_from_video_tpu_torch.kernels import block, bottleneck
    if where == "hand_trunk":
        trunk = block.trunk_apply
        monkeypatch.setattr(block, "trunk_apply", lambda *a, **k: torch.roll(
            trunk(*a, **k), 1, 0))
    else:
        chain = bottleneck.bottleneck_chain

        def perturbed(*a, **k):
            return chain(*a, **k) * 1.5
        perturbed.launches = 0
        monkeypatch.setattr(bottleneck, "bottleneck_chain", perturbed)
    r = _run("flagship_mesh.live", ov=FULL)
    key = "hand_lm_gap_px" if where == "hand_trunk" else "face_lm_gap_px"
    assert r["worst"][key] > r["limits"][key], r["worst"]
    assert not r["correct"]
