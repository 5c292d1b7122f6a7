"""PhysFormer on the port's path, on the CPU at a small size (dim 24, ff 36,
4 heads, 3 layers, 32-frame clips of 64x64 crops, seeded weights and
BatchNorm statistics): the port's net (``models/physformer.py``) against
the published forward pass (``models/physformer_ref.py``), its folds, and
the engine's clip ring through ``batch_step_lagged``, ``batch_step`` and
``MultiStreamEngine``."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch import config as tconfig
from bp_from_video_tpu_torch.models import physformer as pf
from bp_from_video_tpu_torch.models import physformer_ref as ref
from bp_from_video_tpu_torch.models import warp
from bp_from_video_tpu_torch.models.runner import tree_leaves
from bp_from_video_tpu_torch.ops import chain, spectrum
from bp_from_video_tpu_torch.ops import signal as sig
from bp_from_video_tpu_torch.parallel.streams import MultiStreamEngine
from bp_from_video_tpu_torch.runtime.engine import Engine, EngineState
from bp_from_video_tpu_torch.utils import profiling

NET = tconfig.PhysFormerConfig(dim=24, ff_dim=36, num_heads=4, num_layers=3,
                               clip_frames=32, crop=64, hop=32)
S, H, W = 2, 96, 128
NO_FILES = dict(face_detector_path=None, face_landmarker_path=None,
                hand_landmarker_path=None, person_segmenter_path=None,
                hand_lm_standin_path=None, palm_det_standin_path=None,
                seg_standin_path=None)
REF_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bp_from_video_tpu_torch", "models",
    "physformer_ref.py")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return pf.init_params(NET, 7)


@pytest.fixture(scope="module")
def clips():
    """Standardised f32 clips [2, T, C, C, 3]."""
    g = torch.Generator().manual_seed(1)
    return ref.standardise(torch.rand(2, NET.clip_frames, NET.crop, NET.crop,
                                      3, generator=g))


def _ref_bvp(params, x, net=NET):
    return ref.forward(params, x.permute(0, 4, 1, 2, 3), net.num_heads,
                       net.theta, net.gra_sharp)


def _rel(got, want) -> float:
    """Largest |gap| over the largest |reference|."""
    return float((got - want).abs().max() / want.abs().max())


def test_port_net_in_f32_equals_the_reference(params, clips):
    """rtol 1e-5 of the largest output: the folds and the channels-last
    layout reorder f32 sums only."""
    got = pf.PhysFormer(NET, params, torch.float32, "cpu")(clips)
    assert got.shape == (2, NET.clip_frames)
    assert _rel(got, _ref_bvp(params, clips)) < 1e-5


def test_port_net_in_bf16_is_within_bf16_rounding(params, clips):
    """bf16 keeps 8 significant bits (a rounding of up to 2^-9 relative);
    about 40 convolution, product and activation outputs are rounded in
    a chain before the BVP, so the largest gap stays within 3 % of the
    largest output (0.011 here), and a net run a step lower does not."""
    got = pf.PhysFormer(NET, params, torch.bfloat16, "cpu")(
        clips.to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert _rel(got, _ref_bvp(params, clips)) < 0.03


@pytest.mark.parametrize("theta", [0.7, 0.0])
def test_folded_cdc_t_equals_its_two_convolutions(theta):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 6, 5, 4, 4, generator=g)
    w = torch.randn(8, 6, 3, 3, 3, generator=g)
    want = ref._cdc_t(x, w, theta)
    got = F.conv3d(x, pf.fold_cdc(w, theta), padding=1)
    assert _rel(got, want) < 1e-5


def test_folded_batchnorm_equals_the_unfolded(params):
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, NET.dim // 4, 5, 8, 8, generator=g)
    p = params["stem1"]
    want = ref._bn(F.conv3d(x, p["w"], p["b"], padding=1), p["bn"])
    w, b = pf.fold_bn(p["w"].double(), p["b"].double(),
                      pf.map_params(torch.Tensor.double, p["bn"]))
    got = F.conv3d(x, w.float(), b.float(), padding=1)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("field, value", [("theta", 0.0), ("gra_sharp", 1.0)])
def test_the_mechanism_moves_the_output(params, clips, field, value):
    """Without the temporal difference, or with the attention's
    temperature at 1, the BVP is another: both are really in the net (and
    in the reference, which agrees with the port on either)."""
    other = dataclasses.replace(NET, **{field: value})
    base = pf.PhysFormer(NET, params, torch.float32, "cpu")(clips)
    moved = pf.PhysFormer(other, params, torch.float32, "cpu")(clips)
    assert _rel(moved, base) > 1e-2
    assert _rel(moved, _ref_bvp(params, clips, other)) < 1e-5


def tiny_config(hop: int = NET.hop, **inference):
    cfg = tconfig.physformer_config(S, H, W, dataclasses.replace(NET,
                                                                 hop=hop))
    return dataclasses.replace(cfg, compute_dtype="float32",
                               inference=dataclasses.replace(
                                   cfg.inference, **NO_FILES, **inference))


RECT = [[64.0, 48.0, 60.0, 60.0, 0.0], [60.0, 44.0, 56.0, 48.0, 0.3]]


def tracked(state):
    """Both streams tracking a face (the second one tilted)."""
    return state._replace(track=state.track._replace(
        face_rect=torch.tensor(RECT), face_tracking=torch.ones(
            S, dtype=torch.bool)))


def frames_and_ts(n: int, first: int = 0):
    """Seeded uint8 planar frames [n, S, 3, H, W] and their timestamps."""
    g = torch.Generator().manual_seed(first)
    frames = torch.randint(0, 256, (n, S, 3, H, W), dtype=torch.uint8,
                           generator=g)
    ts = ((torch.arange(n, dtype=torch.float32) + 1 + first)
          / 30.0)[:, None].repeat(1, S)
    return frames, ts


@pytest.fixture(scope="module")
def engine():
    return Engine(tiny_config(), device="cpu")


def _delta(fn):
    before = dict(profiling.profiler.counts)
    out = fn()
    after = profiling.profiler.counts
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


@pytest.mark.parametrize("use_pallas", [True, False], ids=["k1", "plain"])
def test_lagged_step_gives_the_reference_bvp_on_its_crops(use_pallas):
    """One 32-frame window: every frame cropped at the cover of the rect
    from before the window (K1's plain version, or the plain crop), the
    reference's BVP of those crops as the raw ring, the ring's timestamps
    as its times, and the BPM of the chain, spectrum and peak on it."""
    eng = Engine(tiny_config(use_pallas=use_pallas), device="cpu")
    st0 = tracked(eng.init_state())
    frames, ts = frames_and_ts(NET.clip_frames)
    (st, out), counts = _delta(lambda: eng.batch_step_lagged(
        eng.params, st0, frames, ts))
    assert counts["clip.pushed"] == S * NET.clip_frames
    assert counts["clip.runs"] == S
    cover = warp.axis_aligned_cover(warp.arr_rect(torch.tensor(RECT)))
    want = torch.stack([warp.crop_rect(f.permute(0, 2, 3, 1), cover,
                                       NET.crop) / 255.0 for f in frames], 1)
    got = st.clip.ordered()
    assert float((got - want).abs().max()) < 1e-5
    assert torch.equal(st.clip.ordered_ts(), ts.T)
    assert torch.equal(st.clip.new, torch.zeros(S, dtype=torch.int32))
    assert torch.equal(st.signals.raw_x, ts.T)
    want_bvp = _ref_bvp(pf.init_params(NET, _rppg_seed()),
                        ref.standardise(got))
    assert _rel(st.signals.raw_y[:, 0], want_bvp) < 1e-5
    c = eng.config.signal
    x = ts.T[:, None]
    px, py = chain.process_signal(c, x, want_bvp[:, None])
    sx, sy = spectrum.transform_signal(c, px, py)
    bpm = torch.round(sig.peak_auto(sx, sy)[0] * 60.0)
    assert torch.equal(out.bpm, bpm)
    assert torch.isnan(out.ptt).all()
    assert torch.equal(st.signals.bpm_x[:, -1], ts[-1])


def _rppg_seed() -> int:
    from bp_from_video_tpu_torch.models.runner import _seed
    return _seed("rppg")


def test_batch_step_runs_the_net_when_full_then_every_hop():
    """One frame a step, hop 8: nothing until the ring holds 32 crops,
    then a run every 8 crops; a re-sent timestamp pushes nothing."""
    eng = Engine(tiny_config(hop=8), device="cpu")
    st = tracked(eng.init_state())
    frames, ts = frames_and_ts(50)
    ran = []
    for i in range(50):
        (st, _), counts = _delta(lambda: eng.batch_step(
            eng.params, st, frames[i], ts[i]))
        assert counts["clip.pushed"] == S
        ran.append(counts.get("clip.runs", 0))
    assert [i for i, n in enumerate(ran) if n] == [31, 39, 47]
    assert all(ran[i] == S for i in (31, 39, 47))
    assert torch.equal(st.clip.new, torch.full((S,), 2, dtype=torch.int32))
    again, _ = eng.batch_step(eng.params, st, frames[49], ts[49])
    assert torch.equal(again.clip.new, st.clip.new)
    assert torch.equal(again.clip.ordered_ts(), st.clip.ordered_ts())


def test_a_window_with_stale_frames_pushes_only_the_fresh():
    """A window padded with NaN timestamps (the offline driver's last
    window) pushes its fresh frames, in order, and no others."""
    eng = Engine(tiny_config(), device="cpu")
    st = tracked(eng.init_state())
    frames, ts = frames_and_ts(8)
    ts[5:] = float("nan")
    st, _ = eng.batch_step_lagged(eng.params, st, frames, ts)
    got = st.clip.ordered_ts()
    assert torch.isnan(got[:, :-5]).all()
    assert torch.equal(got[:, -5:], ts[:5].T)
    assert torch.equal(st.clip.new, torch.full((S,), 5, dtype=torch.int32))


def _assert_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(torch.nan_to_num(x.double(), nan=-7.0),
                           torch.nan_to_num(y.double(), nan=-7.0))


def test_multistream_engine_equals_engine(engine):
    """``MultiStreamEngine`` (``mesh=None``) carries the clip ring in its
    state and steps it as the engine does, lagged and frame by frame."""
    ms = MultiStreamEngine(tiny_config(), device="cpu")
    st_e = tracked(engine.init_state())
    st_m = tracked(ms.init_states())
    _assert_equal(st_e, ms.shard_state(st_m))
    frames, ts = frames_and_ts(NET.clip_frames + 2)
    w, t = frames[:NET.clip_frames], ts[:NET.clip_frames]
    st_e, out_e = engine.batch_step_lagged(engine.params, st_e, w, t)
    st_m, out_m = ms.run_clip_lagged(ms.params, st_m, w[None], t[None])
    _assert_equal(st_e, st_m)
    assert torch.equal(out_e.bpm, out_m.bpm[0])
    for i in (NET.clip_frames, NET.clip_frames + 1):
        st_e, out_e = engine.batch_step(engine.params, st_e, frames[i],
                                        ts[i])
        st_m, out_m = ms.step(ms.params, st_m, frames[i], ts[i])
        _assert_equal((st_e, out_e), (st_m, out_m))


def test_flagship_state_has_no_clip_ring():
    eng = Engine(tconfig.EngineConfig(
        inference=tconfig.InferenceConfig(**NO_FILES), frame_height=H,
        frame_width=W, num_streams=S), device="cpu")
    assert eng.rppg is None
    assert type(eng.init_state()) is EngineState


def test_an_rppg_net_refuses_rois():
    cfg = tiny_config()
    with pytest.raises(ValueError, match="no ROI"):
        Engine(dataclasses.replace(cfg, signal=dataclasses.replace(
            cfg.signal, roi_configs=(tconfig.FACE_FOREHEAD_CONFIG,))),
            device="cpu")


def test_the_reference_imports_neither_jax_nor_the_port():
    """Its source imports torch alone, and loaded by its path in a fresh
    interpreter it brings in no module of the port or of JAX."""
    with open(REF_PATH) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= {"__future__", "contextlib", "torch"}, roots
    code = ("import importlib.util, sys\n"
            "s = importlib.util.spec_from_file_location('pfref', "
            f"{REF_PATH!r})\n"
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', "
            "'jaxlib', 'bp_from_video_tpu', 'bp_from_video_tpu_torch')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_cli_selects_physformer():
    from bp_from_video_tpu_torch import cli
    cfg, _ = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "physformer", "--device", "cpu"]))
    assert cfg.rppg_net == tconfig.PhysFormerConfig()
    assert cfg.signal.roi_configs == () and not cfg.inference.hand_landmarker


def test_offline_micro_batch_runs_physformer(tmp_path):
    """``process_videos`` with ``micro_batch`` = the clip length over two
    20-frame files: windows of 8, 8 and 4 frames (the last padded with NaN
    timestamps); the net runs on both streams after each full window and
    not after the partial one."""
    import cv2

    from bp_from_video_tpu_torch.runtime import offline
    paths = []
    frames, _ = frames_and_ts(20)
    for s in range(S):
        path = str(tmp_path / f"s{s}.avi")
        wr = cv2.VideoWriter(path, cv2.VideoWriter.fourcc(*"MJPG"), 30.0,
                             (W, H))
        for f in frames[:, s].permute(0, 2, 3, 1).numpy():
            wr.write(f.copy())
        wr.release()
        paths.append(path)
    net = dataclasses.replace(NET, clip_frames=8, crop=32, hop=8)
    cfg = dataclasses.replace(tiny_config(), rppg_net=net,
                              signal=dataclasses.replace(
                                  tiny_config().signal, signal_max_samples=8))
    (out, ts), counts = _delta(lambda: offline.process_videos(
        paths, cfg, micro_batch=8, device="cpu"))
    assert out.bpm.shape == (3, S, 1) and ts.shape == (20, S)
    assert counts["clip.runs"] == 2 * S
    assert counts["clip.pushed"] == 24 * S
