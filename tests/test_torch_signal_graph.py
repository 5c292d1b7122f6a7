"""The signal half's analysis as a CUDA graph (``runtime/signal_graph``),
on the CPU: the engine there never captures; the arena's packing and
unpacking, run eagerly in place of a capture, give what the plain analysis
gives, and each call's outputs their own storage; and a key's second
sighting is what captures.  The replays themselves are card tests
(``tests/test_torch_cuda.py``)."""

import math

import pytest
import torch

from bp_from_video_tpu_torch.config import EngineConfig
from bp_from_video_tpu_torch.runtime import signal_graph as sgm
from bp_from_video_tpu_torch.runtime.engine import Engine
from bp_from_video_tpu_torch.utils import profiling

S, H, W = 3, 96, 128
FIELDS = ("bpm_x", "bpm_y", "ptt_x", "ptt_y")
OUT_FIELDS = ("proc_x", "proc_y", "spec_x", "spec_y", "corr_x", "corr_y",
              "bpm", "ptt", "curr_fs", "mean_fs", "proc_range", "spec_range",
              "corr_range")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    return Engine(EngineConfig(frame_height=H, frame_width=W, num_streams=S),
                  device="cpu")


class EagerCapture:
    """Stands in for a captured call: the analysis run eagerly, packed into
    the arena, the arena cloned and unpacked, as a replay returns it."""

    def __init__(self, fn, args):
        self.fn = fn

    def __call__(self, args):
        arena, layout = sgm.pack(self.fn(*args))
        return sgm.unpack(arena.clone(), layout)


@pytest.fixture
def stubbed(monkeypatch, engine):
    """The engine's analysis with a key on the CPU and capture stubbed
    by :class:`EagerCapture`; the analysis's graphs start empty."""
    monkeypatch.setattr(sgm, "graph_key", lambda args: tuple(
        (a.shape, a.dtype) for a in args))
    monkeypatch.setattr(sgm.SignalGraphs, "capture",
                        lambda self, args: EagerCapture(self.fn, args))
    monkeypatch.setattr(engine, "_analysis", sgm.SignalGraphs(
        engine._analyze))
    return engine


def _rings(engine, call: int, s: int = S):
    """A signal state with raw rings full of a 1.2 Hz pulse plus noise up
    to ``call`` (30 fps), and the arguments of its analysis: the peak
    rings NaN, stream 1 stale (its timestamp the ring's tail)."""
    st = engine.init_signal_state(s)
    n = st.raw_x.shape[-1]
    t = (torch.arange(n, dtype=torch.float32) + call) / 30.0
    gen = torch.Generator().manual_seed(call)
    raw_x = t.expand(s, n).contiguous()
    raw_y = (torch.sin(2 * math.pi * 1.2 * t) * 3.0
             + torch.randn((s, st.raw_y.shape[1], n), generator=gen))
    st = st._replace(raw_x=raw_x, raw_y=raw_y)
    ts = raw_x[:, -1].clone()
    fresh = torch.ones(s, dtype=torch.bool)
    fresh[1] = False
    rois = torch.zeros((s, st.raw_y.shape[1], 6))
    return st, rois, ts, fresh


def _analysis_fields(new, out):
    return ([getattr(new, f) for f in FIELDS]
            + [getattr(out, f) for f in OUT_FIELDS])


def _same(a, b):
    return a.shape == b.shape and torch.equal(
        torch.nan_to_num(a, nan=-7.0), torch.nan_to_num(b, nan=-7.0)
    ) and torch.equal(torch.isnan(a), torch.isnan(b))


def _captures():
    return profiling.profiler.counts.get("signal_graph.captures", 0)


def test_cpu_engine_never_captures(engine):
    """On the CPU every step is eager: no key, no capture, no graph."""
    before = _captures()
    state = engine.init_state(S)
    frames = torch.randint(0, 256, (S, 3, H, W), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    for call in range(3):
        ts = torch.full((S,), (call + 1) / 30.0)
        state, out = engine.batch_step(engine.params, state, frames, ts)
    for call in range(3):
        st, rois, ts, fresh = _rings(engine, call)
        assert sgm.graph_key((st.raw_x, st.raw_y, ts, fresh)) is None
        engine.signal_analyze(st, rois, None, ts, fresh)
    assert _captures() == before
    assert engine._analysis.graphs == {}


def test_arena_unpacks_to_the_plain_analysis(stubbed):
    """Eager call, capture, replays (capture stubbed): every output equals
    the plain analysis's; the rings and ROIs the analysis only passes on
    are the caller's own tensors."""
    eng = stubbed
    for call in range(4):
        st, rois, ts, fresh = _rings(eng, call)
        models = object()
        new, out = eng.signal_analyze(st, rois, models, ts, fresh)
        want = eng._analyze(st.raw_x, st.raw_y, st.bpm_x, st.bpm_y,
                            st.ptt_x, st.ptt_y, ts, fresh)
        got = _analysis_fields(new, out)
        assert len(got) == len(want)
        for name, g, w in zip(FIELDS + OUT_FIELDS, got, want):
            assert g.dtype == w.dtype, name
            assert _same(g, w), name
        assert out.raw_x is st.raw_x and out.raw_y is st.raw_y
        assert new.raw_x is st.raw_x and new.raw_y is st.raw_y
        assert new.roi_x is st.roi_x and new.roi_y is st.roi_y
        assert out.rois is rois and out.models is models
    assert len(eng._analysis.graphs) == 1
    # A finite reading, so that the equality above is not one of NaNs.
    assert torch.isfinite(out.spec_y).any() and torch.isfinite(out.bpm).any()


def test_outputs_of_two_calls_share_no_storage(stubbed):
    """A replayed call's outputs live in a clone of the arena of their
    own: nothing the next call returns shares their storage, and writing
    the next call's leaves nothing in the kept ones."""
    eng = stubbed
    kept = []
    for call in range(4):
        st, rois, ts, fresh = _rings(eng, call)
        new, out = eng.signal_analyze(st, rois, None, ts, fresh)
        fields = _analysis_fields(new, out)
        kept.append((fields, [f.clone() for f in fields]))
    ptrs = [{f.untyped_storage().data_ptr() for f in fields}
            for fields, _ in kept]
    assert ptrs[2].isdisjoint(ptrs[3]) and ptrs[1].isdisjoint(ptrs[2])
    for f in kept[3][0]:
        f.fill_(123.0)
    for fields, copies in kept[:3]:
        assert all(_same(f, c) for f, c in zip(fields, copies))


def test_a_keys_second_sighting_captures(monkeypatch):
    """The first call with a key runs eagerly, the second captures and
    replays, later ones replay; another key starts over; a call while a
    profiler records and its key has no graph stays eager, and one whose
    key has a graph replays."""
    monkeypatch.setattr(sgm, "graph_key", lambda args: tuple(
        a.shape for a in args))
    captured, replays, eager = [], [], []

    def fn(x):
        eager.append(x.shape)
        return (x + 1.0,)

    class Graphs(sgm.SignalGraphs):
        def capture(self, args):
            captured.append(args[0].shape)

            def call(a):
                replays.append(a[0].shape)
                return (a[0] + 1.0,)
            return call

    g = Graphs(fn)
    a, b = torch.zeros(2), torch.zeros(3)
    c0 = dict(profiling.profiler.counts)
    for x in (a, a, a, b):
        assert torch.equal(g(x)[0], x + 1.0)
    assert eager == [a.shape, b.shape]
    assert captured == [a.shape] and replays == [a.shape, a.shape]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        g(b)            # b's second sighting, under the profiler: eager
        g(a)            # a has a graph: replays
    assert eager == [a.shape, b.shape, b.shape]
    assert captured == [a.shape] and replays == [a.shape] * 3
    g(b)
    assert captured == [a.shape, b.shape]
    counts = profiling.profiler.counts
    assert counts.get("signal_graph.captures", 0) - c0.get(
        "signal_graph.captures", 0) == 2
    assert counts.get("signal_graph.replays", 0) - c0.get(
        "signal_graph.replays", 0) == 4


def test_pack_refuses_mixed_dtypes():
    """``torch.cat`` would promote a mixed arena silently: pack raises."""
    with pytest.raises(TypeError):
        sgm.pack((torch.zeros(2), torch.zeros(2, dtype=torch.int32)))
