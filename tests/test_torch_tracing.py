"""The port's spans and counters (``utils/profiling.span`` and ``count``)
inside the engine step: a small CPU engine of 2 streams with both
landmarkers, through ``batch_step`` and ``batch_step_lagged`` (F = 2).

Under ``torch.profiler`` every stage the config reaches is a
``user_annotation`` range nested under its call's ``bpv.step``; outside a
profiler ``span`` is one shared no-op and ``record_function`` is never
entered; the outputs and state are bit-equal either way; the gates count
one sync a landmarker a call, and the detector rows and streams served
from the count they already read.
"""

import dataclasses
import json

import pytest
import torch

from bp_from_video_tpu_torch import config as tconfig
from bp_from_video_tpu_torch.config import SignalProcessingMethod as M
from bp_from_video_tpu_torch.models.runner import tree_leaves
from bp_from_video_tpu_torch.runtime.engine import Engine
from bp_from_video_tpu_torch.utils import profiling
from bp_from_video_tpu_torch.utils.profiling import StageProfiler, span

S, H, W, F = 2, 48, 64, 2
NO_FILES = dict(face_detector_path=None, face_landmarker_path=None,
                hand_landmarker_path=None, person_segmenter_path=None,
                hand_lm_standin_path=None, palm_det_standin_path=None,
                seg_standin_path=None)
METHODS = (M.DETREND_LINEAR, M.FILTER_BUTTER)
# Spans every config below reaches, and those of the detectors (a stream
# needs detection), of the standalone detector, the segmenter and the
# hybrid rotation gate (the ``extra`` config).
BASE = {"bpv.step", "bpv.runner", "bpv.gate.face", "bpv.gate.hand",
        "bpv.sync.face_gate", "bpv.sync.hand_gate", "bpv.crop",
        "bpv.net.flm_lm", "bpv.net.hand_lm", "bpv.track.face",
        "bpv.track.hand", "bpv.signal", "bpv.roi", "bpv.sample", "bpv.push",
        "bpv.spectrum", "bpv.correlate", "bpv.outputs"} | {
            f"bpv.dsp.{m.value}" for m in METHODS}
DETECT = {"bpv.detect.face", "bpv.detect.palm"}
EXTRA = {"bpv.detect.face_all", "bpv.segment", "bpv.sync.hybrid_gate"}
SIGNAL = {"bpv.roi", "bpv.sample", "bpv.push", "bpv.spectrum",
          "bpv.correlate", "bpv.outputs"} | {f"bpv.dsp.{m.value}"
                                             for m in METHODS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_engine(streams: int = S, **inference) -> Engine:
    """A CPU engine at 48x64 with both landmarkers (random-init
    stand-ins, no model files), a 32-sample ring and two chain methods."""
    cfg = tconfig.EngineConfig(
        signal=tconfig.SignalConfig(signal_max_samples=32,
                                    peak_max_samples=8,
                                    processing_methods=METHODS),
        inference=tconfig.InferenceConfig(**dict(NO_FILES, **inference)),
        frame_height=H, frame_width=W, num_streams=streams)
    return Engine(cfg, device="cpu")


def tracked_state(engine: Engine, lost: tuple = ()):
    """Every stream tracking a face and two hands, except the streams in
    ``lost``, which track nothing."""
    st = engine.init_state()
    ok = torch.ones(engine.config.num_streams, dtype=torch.bool)
    ok[list(lost)] = False
    tr = st.track._replace(
        face_rect=torch.tensor([[32.0, 24.0, 28.0, 28.0, 0.0]]).repeat(
            len(ok), 1),
        face_tracking=ok.clone(),
        hand_rects=torch.tensor([[[16.0, 36.0, 20.0, 20.0, 0.0],
                                  [48.0, 36.0, 20.0, 20.0, 0.0]]]).repeat(
                                      len(ok), 1, 1),
        hand_tracking=ok[:, None].repeat(1, 2))
    return st._replace(track=tr)


def frames_and_ts(lagged: bool, call: int = 0):
    """Seeded uint8 planar frames and timestamps of one call: [S, 3, H, W]
    and [S], or [F, S, 3, H, W] and [F, S]."""
    g = torch.Generator().manual_seed(call)
    n = F if lagged else 1
    frames = torch.randint(0, 256, (n, S, 3, H, W), dtype=torch.uint8,
                           generator=g)
    ts = ((torch.arange(n, dtype=torch.float32) + 1 + n * call)
          / 30.0)[:, None].repeat(1, S)
    return (frames, ts) if lagged else (frames[0], ts[0])


def call(engine: Engine, state, lagged: bool, i: int = 0):
    frames, ts = frames_and_ts(lagged, i)
    step = engine.batch_step_lagged if lagged else engine.batch_step
    return step(engine.params, state, frames, ts)


@pytest.fixture(scope="module")
def engine():
    return tiny_engine(detector_subbatch=1, use_pallas=False)


@pytest.fixture(scope="module")
def whole_engine():
    """Detection over the whole batch (no sub-batch)."""
    return tiny_engine(detector_subbatch=0, use_pallas=False)


@pytest.fixture(scope="module")
def extra_engine():
    """The standalone face detector, the segmenter and the hybrid
    rotation mode on the K1 path (plain versions on the CPU)."""
    return tiny_engine(detector_subbatch=1, use_pallas=True,
                       face_detector=True, person_segmenter=True,
                       rotation_mode="hybrid")


def traced(fn, path):
    """(result of ``fn()``, the ``bpv.`` ranges of its Chrome trace as
    (name, start, end))."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("ph") == "X"
             and e["name"].startswith("bpv.")]
    return out, spans


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("lagged", [False, True], ids=["step", "lagged"])
@pytest.mark.parametrize("which", ["base", "extra"])
def test_spans_nest_under_their_step(engine, extra_engine, lagged, which,
                                     tmp_path):
    """Two calls traced: every span the config reaches, each inside one
    of the two ``bpv.step`` roots; the runner's stages inside
    ``bpv.runner``, the signal half's inside ``bpv.signal``."""
    eng = engine if which == "base" else extra_engine
    st0 = tracked_state(eng, lost=(1,))

    def two_calls():
        st, _ = call(eng, st0, lagged, 0)
        return call(eng, st, lagged, 1)
    _, spans = traced(two_calls, tmp_path / "trace.json")
    names = {n for n, _, _ in spans}
    want = BASE | DETECT | (EXTRA if which == "extra" else set())
    assert want <= names, sorted(want - names)
    assert names <= BASE | DETECT | EXTRA, sorted(names - BASE - DETECT
                                                  - EXTRA)
    steps = [sp for sp in spans if sp[0] == "bpv.step"]
    assert len(steps) == 2
    parent = {"bpv.signal": "bpv.step", "bpv.runner": "bpv.step"}
    parent.update({n: "bpv.signal" for n in SIGNAL})
    parent.update({n: "bpv.runner" for n in names - SIGNAL - {
        "bpv.step", "bpv.signal", "bpv.runner"}})
    for sp in spans:
        if sp[0] == "bpv.step":
            continue
        assert sum(_inside(sp, r) for r in steps) == 1, sp
        assert any(_inside(sp, r) for r in spans
                   if r[0] == parent[sp[0]]), sp
    if lagged:       # the ROI stage once a frame, in each call
        assert sum(n == "bpv.roi" for n, _, _ in spans) == 2 * F


def test_span_outside_a_profiler_is_the_shared_noop(engine, monkeypatch):
    """No profiler: ``span`` hands out one shared no-op and never builds a
    ``record_function``, through a whole step."""
    assert span("bpv.a") is span("bpv.b") is profiling._NO_SPAN

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    call(engine, tracked_state(engine, lost=(1,)), False)
    call(engine, tracked_state(engine), True)


def _assert_bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.is_floating_point():
            assert torch.equal(torch.isnan(x), torch.isnan(y))
            x, y = torch.nan_to_num(x, nan=0.0), torch.nan_to_num(y, nan=0.0)
        assert torch.equal(x, y)


@pytest.mark.parametrize("lagged", [False, True], ids=["step", "lagged"])
def test_outputs_equal_with_and_without_a_profiler(engine, lagged,
                                                   tmp_path):
    """Every leaf of the state and the outputs, NaN-aware, with a stream
    that needs detection."""
    st0 = tracked_state(engine, lost=(1,))
    plain = call(engine, st0, lagged)
    prof, spans = traced(lambda: call(engine, st0, lagged),
                         tmp_path / "trace.json")
    assert spans
    _assert_bit_equal(plain, prof)


def _delta(fn) -> dict:
    before = dict(profiling.profiler.counts)
    fn()
    after = profiling.profiler.counts
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


@pytest.mark.parametrize("lagged", [False, True], ids=["step", "lagged"])
@pytest.mark.parametrize("subbatch", [1, 0], ids=["subbatch1", "whole"])
@pytest.mark.parametrize("lost", [(1,), ()], ids=["one-lost", "tracked"])
def test_gate_counters(engine, whole_engine, lagged, subbatch, lost):
    """A call counts one step and one sync a landmarker; with a stream
    lost, each detector adds the rows it ran (``k_max``, or every stream
    of the batch on the whole-batch path) and the streams it served
    (``min(n_need, k_max)``); with every stream tracked, nothing."""
    eng = engine if subbatch == 1 else whole_engine
    st0 = tracked_state(eng, lost=lost)
    got = _delta(lambda: call(eng, st0, lagged))
    rows = S * (F if lagged else 1)          # the runner's batch
    n_need = len(lost) * (F if lagged else 1)
    k_max = rows if subbatch <= 0 else min(subbatch, rows)
    want = {"steps": 1, "sync.face_gate": 1, "sync.hand_gate": 1}
    if n_need:
        for det in ("face", "palm"):
            want[f"det.{det}.rows"] = k_max
            want[f"det.{det}.served"] = min(n_need, k_max)
    assert got == want


def test_count_report_and_clear():
    """Counters print per engine step beneath the stage table, and
    ``clear`` empties them with the stages."""
    p = StageProfiler()
    for _ in range(4):
        p.count("steps")
        p.count("sync.face_gate")
    p.count("det.face.rows", 8)
    lines = p.count_report().splitlines()
    assert lines[0].split() == ["counter", "total", "per", "step"]
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[1:]}
    assert rows == {"det.face.rows": ["8", "2.000"],
                    "steps": ["4", "1.000"],
                    "sync.face_gate": ["4", "1.000"]}
    p.clear()
    assert p.counts == {} and p.stats == {}
    assert p.count_report().splitlines()[1:] == []


# -- PhysFormer's clip ring and net ------------------------------------------

PF_NET = tconfig.PhysFormerConfig(dim=24, ff_dim=36, num_heads=4,
                                  num_layers=3, clip_frames=8, crop=32,
                                  hop=8)
PF_SPANS = {"bpv.clip", "bpv.net.physformer", "bpv.pf.stem", "bpv.pf.trunk"}


@pytest.fixture(scope="module")
def pf_engine():
    """The PhysFormer preset at 48x64 with a tiny net (8-frame clips of
    32x32 crops), float32."""
    cfg = tconfig.physformer_config(S, H, W, PF_NET)
    return Engine(dataclasses.replace(
        cfg, compute_dtype="float32",
        inference=dataclasses.replace(cfg.inference, **NO_FILES)),
        device="cpu")


def _pf_frames(n: int, first: int = 0):
    g = torch.Generator().manual_seed(100 + first)
    frames = torch.randint(0, 256, (n, S, 3, H, W), dtype=torch.uint8,
                           generator=g)
    ts = ((torch.arange(n, dtype=torch.float32) + 1 + first)
          / 30.0)[:, None].repeat(1, S)
    return frames, ts


@pytest.mark.parametrize("lagged", [True, False], ids=["lagged", "step"])
def test_physformer_spans_and_counters(pf_engine, lagged, tmp_path):
    """A call that fills the ring and runs the net: ``bpv.clip`` and
    ``bpv.net.physformer`` once, inside the step, the stem and trunk once
    inside the net; ``clip.pushed`` counts the call's S x F crops and
    ``clip.runs`` the S clips.  Frame by frame, the ring is filled to one
    short of its length first."""
    eng = pf_engine
    st = tracked_state(eng)
    n = PF_NET.clip_frames
    frames, ts = _pf_frames(n)
    if lagged:
        def one():
            return eng.batch_step_lagged(eng.params, st, frames, ts)
    else:
        st, _ = eng.batch_step_lagged(eng.params, st, frames[:-1], ts[:-1])

        def one():
            return eng.batch_step(eng.params, st, frames[-1], ts[-1])
    f_n = n if lagged else 1
    before = dict(profiling.profiler.counts)
    _, spans = traced(one, tmp_path / "trace.json")
    counts = {k: v - before.get(k, 0)
              for k, v in profiling.profiler.counts.items()}
    for name in PF_SPANS:
        assert sum(s[0] == name for s in spans) == 1, name
    step = [s for s in spans if s[0] == "bpv.step"]
    net = [s for s in spans if s[0] == "bpv.net.physformer"]
    assert len(step) == 1
    for s in spans:
        if s[0] in PF_SPANS:
            assert _inside(s, step[0]), s
        if s[0].startswith("bpv.pf."):
            assert _inside(s, net[0]), s
    assert counts["clip.pushed"] == S * f_n
    assert counts["clip.runs"] == S


def test_the_flagship_opens_no_physformer_span(engine, tmp_path):
    st0 = tracked_state(engine)
    before = dict(profiling.profiler.counts)
    _, spans = traced(lambda: call(engine, st0, True), tmp_path / "t.json")
    assert not PF_SPANS & {n for n, _, _ in spans}
    assert not [k for k, v in profiling.profiler.counts.items()
                if k.startswith("clip.") and v != before.get(k, 0)]
