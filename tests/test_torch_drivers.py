"""The port's drivers and CLI against the reference package's, on two
30-frame MJPG files written here (person scenes pulsing at 72 BPM, 96x128,
``chip_smoke.pulse_clip``): ``offline.process_videos`` with a tail block
(``chunk=16``) and with a partial last micro-batch window
(``micro_batch=4``), ``sequential.run``, ``pipelined.run`` (no oracle:
latest-wins drops frames), ``cli.config_from_args`` field for field and
``cli.main`` in offline mode.

The drivers build their engines inside, so each parity test swaps both
packages' ``MultiStreamEngine`` / ``Engine``, as the driver modules see
them, for subclasses computing with the reference engine's weights, with
template landmark heads, from a start tracking the clip's face and hands
(``test_torch_streams.locked``): the BPM compared is then a pulse's, not a
NaN.  Both packages run without their
kernels (``use_pallas=False``: the reference's XLA paths, the port's plain
versions) and with random-init stand-ins (no trained stand-in files; the
reference's are stubbed by ``conftest.py``, the port's here).  Tolerances:
timestamps, PTT and ``curr_fs`` equal; BPM equal, NaN pattern included,
from ``test_torch_streams.SETTLED`` on (per-frame rows; the micro-batch's
per-window rows from the first).
"""

import dataclasses
import enum
import os
import subprocess
import sys
import time

import cv2
import numpy as np
import pytest
import torch

from bp_from_video_tpu import cli as jcli
from bp_from_video_tpu.config import CaptureConfig as JCaptureConfig
from bp_from_video_tpu.drivers import sequential as jsequential
from bp_from_video_tpu.parallel import MultiStreamEngine as JMultiStream
from bp_from_video_tpu.runtime import offline as joffline
from bp_from_video_tpu_torch import cli
from bp_from_video_tpu_torch.config import CaptureConfig
from bp_from_video_tpu_torch.drivers import pipelined, sequential
from bp_from_video_tpu_torch.exceptions import CaptureError
from bp_from_video_tpu_torch.models.runner import InferenceRunner
from bp_from_video_tpu_torch.runtime import offline
from bp_from_video_tpu_torch.utils.profiling import profiler
from chip_smoke import pulse_clip
from test_torch_multistream import _params as template_params
from test_torch_streams import (H, SETTLED, W, assert_clip_equal, jconfig,
                                locked, np_tree, tconfig, tiny_config,
                                write_video)

N = 30
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_trained_standins(monkeypatch):
    """The port's runner, like the reference's under ``conftest.py``, builds
    seeded stand-ins instead of loading the trained stand-in files."""
    monkeypatch.setattr(InferenceRunner, "_load_trained_standin",
                        lambda self, *a, **k: None)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """Two 30-frame files, one person scene a stream."""
    clip = pulse_clip(N, 2, H, W, split=60, seed=6, device="cpu",
                      person=True).numpy()              # [T, S, 3, H, W]
    d = tmp_path_factory.mktemp("clips")
    return [write_video(str(d / f"s{s}.avi"),
                        np.ascontiguousarray(clip[:, s, ::-1]
                                             .transpose(0, 2, 3, 1)))
            for s in range(2)]


@pytest.fixture(scope="module")
def jparams():
    """The reference engine's weights for the tiny config, with template
    landmark heads (numpy)."""
    return np_tree(template_params(JMultiStream(tiny_config(jconfig)))[0])


def _lock(monkeypatch, params, pairs):
    """Swap each (module, class name) for its ``locked`` subclass."""
    for mod, name in pairs:
        monkeypatch.setattr(mod, name, locked(getattr(mod, name), params, H))


@pytest.mark.parametrize("kw", [dict(chunk=16), dict(micro_batch=4)],
                         ids=["tail-block", "micro-batch"])
def test_process_videos_matches_reference(videos, jparams, monkeypatch, kw):
    """30 frames: in blocks of 16 (the second a 14-frame tail), or in
    windows of 4 (7 whole windows and a partial one, padded with the last
    frame at NaN timestamps and kept)."""
    _lock(monkeypatch, jparams, [(offline, "MultiStreamEngine"),
                                 (joffline, "MultiStreamEngine")])
    jout, jts = joffline.process_videos(videos, tiny_config(jconfig), **kw)
    tout, tts = offline.process_videos(videos, tiny_config(tconfig),
                                       device="cpu", **kw)
    np.testing.assert_array_equal(tts, jts)
    assert tts.shape == (N, 2)
    rows = N if "chunk" in kw else (N + 3) // 4
    assert tout.bpm.shape == (rows, 2, 2) and isinstance(tout.bpm, np.ndarray)
    assert_clip_equal(tout, np_tree(jout),
                      settled=SETTLED if "chunk" in kw else 0)
    assert np.isfinite(tout.curr_fs[2:]).all()
    assert np.isfinite(tout.bpm[-1]).all() and np.isfinite(tout.ptt[-1]).all()


def test_sequential_run_matches_reference(videos, jparams, monkeypatch,
                                          capsys):
    """The sequential driver to EOF on one file (headless): the last
    outputs equal the reference driver's; the profiler names its stages as
    the reference does."""
    _lock(monkeypatch, jparams, [(sequential, "Engine"),
                                 (jsequential, "Engine")])
    jo = jsequential.run(tiny_config(jconfig), JCaptureConfig(path=videos[0]),
                         show=False, print_profile=False)
    profiler.clear()
    to = sequential.run(tiny_config(tconfig), CaptureConfig(path=videos[0]),
                        show=False, device="cpu")
    assert tuple(to.raw_x.shape) == (32,)
    for f in ("bpm", "ptt", "curr_fs", "raw_x", "rois"):
        np.testing.assert_array_equal(getattr(to, f).numpy(),
                                      np.asarray(getattr(jo, f)), err_msg=f)
    assert np.isfinite(to.bpm.numpy()).all()
    report = capsys.readouterr().out
    for stage in ("engine_step", "draw_and_plot", "read_frame"):
        assert stage in report
    assert profiler.stats["engine_step"].calls == N


class LiveReader(pipelined.VideoReader):
    """A file read as a camera delivers it: one frame every 1/30 s, from the
    start again after the last, timestamps running on.  The pipelined
    driver's latest-wins feeder then sees a live stream, however long a
    step takes here."""

    def read_frame(self):
        time.sleep(1 / 30)
        try:
            fd = super().read_frame()
        except CaptureError:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            self.loops = getattr(self, "loops", 0) + 1
            fd = super().read_frame()
        fd.timestamp += getattr(self, "loops", 0) * N / 30.0
        return fd


def test_pipelined_run_to_max_frames(videos, monkeypatch):
    """Two streams to ``max_frames`` (no frame-exact oracle: latest-wins
    drops frames): stream-major outputs, one step a batch, the recorder
    fed every step."""
    from bp_from_video_tpu_torch.runtime.recorder import SignalRecorder
    monkeypatch.setattr(pipelined, "VideoReader", LiveReader)
    profiler.clear()
    rec = SignalRecorder("unused.npz")
    out = pipelined.run(tiny_config(tconfig),
                        [CaptureConfig(path=v) for v in videos], show=False,
                        max_frames=8, print_profile=False, recorder=rec,
                        display_stream=1, device="cpu")
    assert tuple(out.bpm.shape) == (2, 2)       # stream-major outputs
    assert tuple(out.raw_x.shape) == (2, 32)
    assert profiler.stats["fused_step"].calls == 8 == len(rec)
    ts = np.stack(rec._rows["timestamp"])
    assert ts.shape == (8, 2) and np.all(np.diff(ts, axis=0) > 0)


def _plain(x):
    """A config as plain data: enums by value, tuples as lists."""
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("argv", [
    [],
    ["--preset", "multistream", "--dtype", "bfloat16"],
    ["--preset", "segmenter_fir", "--pallas", "--host-text"],
    ["--source", "vid.mp4", "--rois", "forehead", "cheek", "--channel",
     "chrom_green", "--methods", "detrend_linear", "filter_butter",
     "--transform", "pgram_welch", "--signal-samples", "128", "--min-freq",
     "0.7", "--models", "face_landmarker", "--running-mode", "image",
     "--crop-portrait", "--no-flip", "--calibration-time", "2.5",
     "--target-res", "240", "320", "--max-hands", "1", "--rotation-mode",
     "shear", "--no-pallas"],
    ["--source", "0", "a.avi", "--exact-rotation", "--flip", "--fir-taps",
     "31", "--butter-order", "4", "--peak-samples", "16", "--min-lag",
     "-0.2", "--max-lag", "0.4", "--roi-samples", "3", "--max-freq", "3.0",
     "--hybrid-max-tilt", "20", "--shear-subbatch", "2"],
], ids=["default", "multistream", "segmenter", "flags", "more-flags"])
def test_config_from_args_matches_reference(argv):
    """The same argv gives the reference's ``EngineConfig`` and capture
    configs field for field (``--device cpu``: the auto kernel rule then
    reads as the reference's on a CPU backend)."""
    cfg, caps = cli.config_from_args(
        cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    jcfg, jcaps = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert _plain(dataclasses.asdict(cfg)) == _plain(dataclasses.asdict(jcfg))
    assert ([_plain(dataclasses.asdict(c)) for c in caps]
            == [_plain(dataclasses.asdict(c)) for c in jcaps])


def test_auto_kernels_follow_the_device():
    for device, on in (("cuda", True), ("cpu", False), ("cuda:0", True)):
        cfg, _ = cli.config_from_args(
            cli.build_parser().parse_args(["--device", device]))
        assert cfg.inference.use_pallas is on


def test_cli_offline_prints_reference_lines(videos, jparams, monkeypatch,
                                           capsys):
    """``main([... --offline --headless --device cpu])`` prints the
    reference CLI's settled-BPM line for each stream."""
    _lock(monkeypatch, jparams, [(offline, "MultiStreamEngine"),
                                 (joffline, "MultiStreamEngine")])
    argv = ["--source", *videos, "--offline", "--headless",
            "--signal-samples", "32", "--peak-samples", "8"]
    assert jcli.main(argv) == 0
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("stream ")]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith("stream ")]
    assert len(got) == 2 and got == want
    assert "None" not in got[0]


def test_cli_needs_cuda_unless_cpu_is_asked(videos, monkeypatch):
    """Without a card, the default ``--device cuda`` raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--source", *videos, "--offline", "--headless"])


def test_cli_bp_raises_naming_item_14a(videos, tmp_path):
    """``--bp`` loads its head before any video is read: a missing file
    raises at once."""
    with pytest.raises(FileNotFoundError):
        cli.main(["--source", videos[0], "--offline", "--bp",
                  str(tmp_path / "p.npz"), "--device", "cpu"])


def test_module_entry_point_runs_offline(videos):
    """``python -m bp_from_video_tpu_torch ... --offline --headless
    --device cpu`` runs and prints one settled-BPM line a stream."""
    proc = subprocess.run(
        [sys.executable, "-m", "bp_from_video_tpu_torch", "--source",
         *videos, "--offline", "--headless", "--device", "cpu",
         "--signal-samples", "32", "--peak-samples", "8"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("stream ")]
    assert [line.split(":")[0] for line in lines] == ["stream 0", "stream 1"]
