"""The port's host runtime against the reference package's: capture
(``runtime/capture.VideoReader``) on a generated MJPG file, the native
latest-wins frame slot (``native.FrameSlot``) against its pure-Python twin
``FrameSlotPlain``, the device feeder (``runtime/feeder.DeviceFeeder``,
``device="cpu"``), the stage profiler and the recorder.

Frames, timestamps and recorded files must be equal; the feeders are held
batch for batch with readers the test paces (a frame a stream only when
the test releases it), so latest-wins timing cannot change a batch.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bp_from_video_tpu.exceptions import CaptureError as JCaptureError
from bp_from_video_tpu.runtime import recorder as jrec
from bp_from_video_tpu.runtime.capture import FrameData as JFrameData
from bp_from_video_tpu.runtime.capture import VideoReader as JVideoReader
from bp_from_video_tpu.runtime.feeder import DeviceFeeder as JDeviceFeeder
from bp_from_video_tpu.utils.profiling import StageProfiler as JProfiler
from bp_from_video_tpu_torch.exceptions import CaptureError
from bp_from_video_tpu_torch.models.runner import tree_leaves
from bp_from_video_tpu_torch.native import FrameSlot, FrameSlotPlain
from bp_from_video_tpu_torch.runtime import recorder as rec
from bp_from_video_tpu_torch.runtime.capture import FrameData, VideoReader
from bp_from_video_tpu_torch.runtime.feeder import DeviceFeeder
from bp_from_video_tpu_torch.utils.profiling import StageProfiler
import test_torch_tracing as tracing
from test_torch_streams import write_video


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H, W, N_FRAMES = 48, 64, 30
SLOTS = [FrameSlot, FrameSlotPlain]


@pytest.fixture(scope="module")
def video_file(tmp_path_factory):
    """30 frames of a level ramp with a blue stripe on the left (BGR) and
    seeded noise."""
    rng = np.random.default_rng(0)
    frames = np.empty((N_FRAMES, H, W, 3), np.uint8)
    for i in range(N_FRAMES):
        frames[i] = np.clip(i * 8 % 256 + rng.integers(0, 9, (H, W, 3)),
                            0, 255)
        frames[i, :, :4] = (255, 0, 0)
    return write_video(str(tmp_path_factory.mktemp("vid") / "synth.avi"),
                       frames)


def _read_all(reader):
    out = []
    try:
        while True:
            out.append(reader.read_frame())
    except (CaptureError, JCaptureError):
        pass
    reader.cleanup()
    return out


@pytest.mark.parametrize("kw", [
    {}, {"target_res": (24, 32), "flip_horizontally": True},
    {"crop_portrait": True}], ids=["plain", "flip-resize", "portrait"])
def test_video_reader_matches_reference(video_file, kw):
    """Every frame, timestamp, sampling rate and calibrating flag of the
    file, and the advertised frame shape, as the reference reader reads
    them."""
    ours, ref = VideoReader(video_file, **kw), JVideoReader(video_file, **kw)
    shape = ours.frame_shape
    assert shape == ref.frame_shape
    got, want = _read_all(ours), _read_all(ref)
    assert len(got) == len(want) == N_FRAMES
    for a, b in zip(got, want):
        assert isinstance(a, FrameData) and isinstance(b, JFrameData)
        np.testing.assert_array_equal(a.frame, b.frame)
        assert a.frame.shape == shape
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.sampling_freq, b.sampling_freq)
        assert a.calibrating == b.calibrating
    assert got[0].timestamp == 0.0 and np.isnan(got[0].sampling_freq)


def test_video_reader_bad_path():
    with pytest.raises(CaptureError):
        VideoReader("/nonexistent/video.mp4")


# -- the frame slot ---------------------------------------------------------


@pytest.mark.parametrize("slot_cls", SLOTS, ids=["native", "plain"])
def test_frame_slot_latest_wins(slot_cls):
    slot = slot_cls((4, 4, 3))
    assert slot.get() is None
    for i in range(5):
        slot.put(np.full((4, 4, 3), i, np.uint8), float(i), 30.0, False)
    frame, ts, fs, cal, seq = slot.get()
    assert frame[0, 0, 0] == 4          # newest wins; 0..3 dropped
    assert (ts, fs, cal, seq) == (4.0, 30.0, False, 5)
    # Nothing new -> require_fresh returns None, a re-read the same frame.
    assert slot.get(require_fresh=True) is None
    assert slot.get(require_fresh=False)[4] == 5
    assert slot.latest_seq() == 5
    with pytest.raises(ValueError):
        slot.put(np.zeros((4, 5, 3), np.uint8), 0.0, 30.0, False)


def test_frame_slot_native_matches_plain():
    """The same puts and gets (plain and planar, ``out=`` included) give
    the same frames, metadata and sequence numbers."""
    rng = np.random.default_rng(5)
    for planar in (False, True):
        slots = [cls((6, 8, 3), planar=planar) for cls in SLOTS]
        outs = [np.zeros(s.out_shape, np.uint8) for s in slots]
        assert slots[0].out_shape == slots[1].out_shape == (
            (3, 6, 8) if planar else (6, 8, 3))
        for k in range(6):
            frame = rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)
            got = []
            for slot, out in zip(slots, outs):
                slot.put(frame, k / 30.0, 30.0 - k, k % 2 == 1)
                if k % 3:
                    slot.put(frame[::-1].copy(), k / 30.0 + 1, 1.0, True)
                item = slot.get(require_fresh=True,
                                out=out if k % 2 else None)
                got.append(item)
                if k % 2:
                    assert item[0] is out
            np.testing.assert_array_equal(got[0][0], got[1][0])
            assert got[0][1:] == got[1][1:]
            want = frame[::-1] if k % 3 else frame
            np.testing.assert_array_equal(
                got[0][0], want.transpose(2, 0, 1) if planar else want)
    with pytest.raises(ValueError):
        FrameSlot((6, 8, 3), planar=True).get(out=np.zeros((6, 8, 3),
                                                           np.uint8))


@pytest.mark.parametrize("slot_cls", SLOTS, ids=["native", "plain"])
@pytest.mark.parametrize("planar", [False, True], ids=["hwc", "planar"])
def test_frame_slot_threaded_never_tears(slot_cls, planar):
    """A producer thread publishing 300 frames while the consumer polls:
    sequence numbers only rise, every consumed frame is one put's (each
    channel a constant of its sequence number), and the last frame is
    observable."""
    slot = slot_cls((16, 16, 3), planar=planar)
    n = 300

    def produce():
        for k in range(1, n + 1):
            f = np.empty((16, 16, 3), np.uint8)
            f[..., 0], f[..., 1], f[..., 2] = (k % 251, k * 3 % 251,
                                               k * 7 % 251)
            slot.put(f, float(k), 30.0, False)
            if k % 10 == 0:
                time.sleep(0.0005)      # let the consumer see some frames

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # interleave the two threads often
    t = threading.Thread(target=produce)
    try:
        t.start()
        seen, deadline = [], time.time() + 30.0
        while time.time() < deadline:
            item = slot.get(require_fresh=True)
            if item is None:
                if not t.is_alive() and slot.latest_seq() == n:
                    break
                continue
            frame, ts, _, _, seq = item
            k = int(ts)
            assert seq == k
            chans = frame if planar else frame.transpose(2, 0, 1)
            for c, mul in enumerate((1, 3, 7)):
                assert (chans[c] == k * mul % 251).all(), (seq, c)
            seen.append(seq)
    finally:
        sys.setswitchinterval(switch)
        t.join(timeout=10.0)
    assert not t.is_alive()
    assert seen == sorted(seen) and seen
    assert slot.get()[4] == n


# -- the device feeder ------------------------------------------------------


class PacedReader:
    """Reads ``frames`` (BGR [T, H, W, 3]) one at a time, each only when the
    test releases it; raises CaptureError (``error``) after the last."""

    def __init__(self, frames, error=None):
        self.frames = frames
        self.error = error
        self.gate = threading.Semaphore(0)
        self.i = 0

    def read_frame(self):
        if self.i >= len(self.frames):
            raise self.error
        if not self.gate.acquire(timeout=10.0):
            raise TimeoutError("never released")
        fd = (self.i / 30.0, 30.0 if self.i else float("nan"),
              self.i < 2)
        self.i += 1
        return fd, self.frames[self.i - 1]

    def cleanup(self):
        pass


class OursReader(PacedReader):
    def read_frame(self):
        (ts, fs, cal), frame = super().read_frame()
        return FrameData(frame, ts, fs, cal)


class RefReader(PacedReader):
    def read_frame(self):
        (ts, fs, cal), frame = super().read_frame()
        return JFrameData(frame, ts, fs, cal)


def _released(feeder, counts, timeout=10.0):
    """Wait until each stream's slot holds its ``counts`` frames."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(f.slot.latest_seq() >= c for f, c in zip(feeder.feeds, counts)):
            return
        time.sleep(0.001)
    raise TimeoutError("capture threads did not publish")


def _np(x):
    """A copy: the reference feeder's CPU arrays may share its buffers."""
    return x.numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


def test_device_feeder_batches_match_reference():
    """Three streams, paced: stream 2 never produces a frame (NaN
    timestamps), stream 1 skips a batch (it keeps its last frame) and
    publishes two frames for another (the older is dropped).  Every batch
    (planar RGB frames, timestamps, sampling rates, calibrating flags)
    equals the reference feeder's; after the last frames both raise
    CaptureError."""
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 4, H, W, 3), dtype=np.uint8)
    # (stream 0, stream 1) frames released before each batch.
    plan = [(1, 1), (1, 0), (1, 2), (1, 1)]
    batches = {}
    for name, cls, feeder_cls, err in (
            ("ours", OursReader, DeviceFeeder, CaptureError("eof")),
            ("ref", RefReader, JDeviceFeeder, JCaptureError("eof"))):
        readers = [cls(frames[0], err), cls(frames[1], err), cls([], err)]
        kw = {"device": "cpu"} if feeder_cls is DeviceFeeder else {}
        feeder = feeder_cls(readers, (H, W, 3), **kw)
        out, counts = [], [0, 0, 0]
        try:
            for step in plan:
                for i, k in enumerate(step):
                    for _ in range(k):
                        readers[i].gate.release()
                    counts[i] += k
                _released(feeder, counts)
                out.append([_np(x) for x in feeder.get_batch()])
            with pytest.raises((CaptureError, JCaptureError)):
                for _ in range(200):
                    feeder.get_batch()
                    time.sleep(0.005)
        finally:
            feeder.cleanup()
        batches[name] = out
        if name == "ours":
            np.testing.assert_array_equal(feeder.dropped, [0, 1, 0])
    for got, want in zip(batches["ours"], batches["ref"]):
        assert got[0].shape == (3, 3, H, W) and got[0].dtype == np.uint8
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    ours = batches["ours"]
    # BGR -> RGB: channel 0 of the batch is the file's channel 2.
    np.testing.assert_array_equal(ours[0][0][0],
                                  frames[0, 0].transpose(2, 0, 1)[::-1])
    assert np.isnan(ours[0][1][2]) and not np.isnan(ours[0][1][0])
    np.testing.assert_array_equal(ours[1][0][1], ours[0][0][1])


def test_device_feeder_propagates_thread_errors():
    """An unexpected capture-thread exception reaches the caller (the
    reference's any-stage-dies-stops-all contract, pbp.py:49-53)."""
    class Boom:
        def read_frame(self):
            raise ValueError("boom")

        def cleanup(self):
            pass

    feeder = DeviceFeeder([Boom()], (H, W, 3), device="cpu")
    try:
        with pytest.raises(ValueError, match="boom"):
            for _ in range(200):
                feeder.get_batch(block=False)
                time.sleep(0.005)
    finally:
        feeder.cleanup()


def test_device_feeder_nonblocking_returns_none_until_first_frame():
    reader = OursReader(np.full((1, H, W, 3), 7, np.uint8),
                        CaptureError("eof"))
    feeder = DeviceFeeder([reader], (H, W, 3), device="cpu")
    try:
        assert feeder.get_batch(block=False) is None
        reader.gate.release()
        _released(feeder, [1])
        frames, ts, fs, cal = feeder.get_batch(block=False)
        assert frames.max() == 7 and float(ts[0]) == 0.0 and bool(cal[0])
    finally:
        feeder.cleanup()


def test_device_feeder_default_device_is_cuda(video_file):
    if torch.cuda.is_available():
        feeder = DeviceFeeder([VideoReader(video_file)], (H, W, 3))
        try:
            frames = feeder.get_batch()[0]
            assert frames.is_cuda and tuple(frames.shape) == (1, 3, H, W)
        finally:
            feeder.cleanup()
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceFeeder([], (H, W, 3))


# -- profiler and recorder ----------------------------------------------------


def test_stage_profiler_report_matches_reference():
    """The same stages timed by both profilers give reports with the same
    header and stage names, ordered by total time; ``fence`` on CPU
    tensors, ``enabled`` off and ``clear`` as the reference's."""
    reports = []
    for prof in (StageProfiler(), JProfiler()):
        @prof.timeit
        def work(x):
            time.sleep(0.002)
            return x + 1

        @prof.timeit(name="named", fence=True)
        def work2(x):
            return (torch.ones(4) * x, {"a": [torch.zeros(1)]})

        for i in range(3):
            work(i)
        work2(2.0)
        assert prof.stats["work"].calls == 3
        assert prof.stats["named"].calls == 1
        reports.append([line.split()[:2] for line in
                        prof.report().splitlines()])
        prof.enabled = False
        work(1)
        assert prof.stats["work"].calls == 3
        prof.clear()
        assert prof.report() == "(no profile data)"
    assert reports[0] == reports[1]
    assert [r[0] for r in reports[0][1:]] == ["work", "named"]


def test_stage_profiler_trace_writes_chrome_trace(tmp_path):
    """``start_trace``/``stop_trace`` wrap a region in a ``torch.profiler``
    trace and write it as a Chrome trace holding the region's operators
    and, around one CPU engine step, the port's ``bpv.step`` span."""
    engine = tracing.tiny_engine(use_pallas=False)
    state = tracing.tracked_state(engine)
    prof = StageProfiler()
    prof.start_trace(str(tmp_path / "trace"))
    torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    tracing.call(engine, state, False)
    prof.stop_trace()
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.get("name") == "bpv.step"
               and e.get("cat") == "user_annotation" for e in events)
    assert prof._trace is None


class _Out:
    def __init__(self, bpm, ptt, fs):
        self.bpm, self.ptt, self.curr_fs = bpm, ptt, fs


class _Clip:
    def __init__(self, t):
        self.bpm = np.array([[60.0 + t, np.nan], [61.0 + t, 71.0]])
        self.ptt = np.array([[25.0], [26.0]])
        self.curr_fs = np.array([30.0, 29.5])


def test_signal_recorder_files_match_reference(tmp_path):
    """Live rows (tensors here, arrays there) and clip rows mixed: the two
    recorders write the same arrays."""
    files = []
    for name, mod, conv in (("ours", rec, torch.tensor),
                            ("ref", jrec, np.asarray)):
        r = mod.SignalRecorder(str(tmp_path / name))
        r.add(0.0, _Out(conv([60.0, 70.0]), conv([25.0]), conv(30.0)))
        r.add_clip([1 / 30.0, 2 / 30.0], _Clip(1.0))
        r.add(3 / 30.0, _Out(conv([63.0, float("nan")]), conv([28.0]),
                             conv(30.0)))
        assert len(r) == 4
        path = r.save()
        assert path.endswith(".npz") and os.path.exists(path)
        files.append(np.load(path))
    assert sorted(files[0].files) == sorted(files[1].files)
    for k in files[1].files:
        np.testing.assert_array_equal(files[0][k], files[1][k])
        assert files[0][k].dtype == files[1][k].dtype


def test_state_checkpoint_round_trip(tmp_path):
    """``save_state``/``load_state`` of an ``EngineState`` (with a recognizable
    ring and a bool tracking flag) round-trip; its leaves are those of the
    reference's state in ``jax.tree`` order (the npz form both use)."""
    import jax

    from bp_from_video_tpu.runtime.engine import Engine as JEngine
    from bp_from_video_tpu_torch.runtime.engine import Engine
    from test_torch_streams import jconfig, tconfig, tiny_config
    kw = dict(frame_height=16, frame_width=16, num_streams=2)
    eng = Engine(tiny_config(tconfig, **kw), device="cpu")
    state = eng.init_state()
    state = state._replace(
        signals=state.signals._replace(
            raw_x=torch.arange(64, dtype=torch.float32).reshape(2, 32)),
        track=state.track._replace(
            face_tracking=torch.tensor([True, False])))
    path = rec.save_state(str(tmp_path / "ckpt"), state)
    restored = rec.load_state(path, eng.init_state())
    for a, b in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, equal_nan=True, rtol=0, atol=0)
    # The reference's state: the same leaf order, shapes and dtypes.
    je = JEngine(tiny_config(jconfig, **kw))
    jst = jax.tree.map(lambda x: np.broadcast_to(x, (2,) + x.shape),
                       je.init_state())
    jflat = jrec._flat_dict(jst)
    flat = rec._flat_dict(eng.init_state())
    assert sorted(flat) == sorted(jflat)
    for k in jflat:
        assert flat[k].shape == jflat[k].shape, k
        assert flat[k].dtype == jflat[k].dtype, k
        np.testing.assert_array_equal(flat[k], jflat[k])
