"""PhysMamba on the port's path, on the CPU at a small size with the
published widths (slow 64, fast 32, N 16, 16-frame clips of 32x32 crops,
seeded weights and BatchNorm statistics): the port's net
(``models/physmamba.py``) against the published forward pass
(``models/physmamba_ref.py``), both selective scans against a token-by-token
loop, the engine's seam (``config.rppg_net`` names its module) through
``batch_step_lagged``, ``batch_step`` and ``MultiStreamEngine``, and the
scan's counters."""

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
from bp_from_video_tpu_torch.models import physmamba as pm
from bp_from_video_tpu_torch.models import physmamba_ref as ref
from bp_from_video_tpu_torch.models import warp
from bp_from_video_tpu_torch.models.runner import _seed, tree_leaves
from bp_from_video_tpu_torch.parallel.streams import MultiStreamEngine
from bp_from_video_tpu_torch.runtime.engine import Engine
from bp_from_video_tpu_torch.utils import profiling

NET = tconfig.PhysMambaConfig(clip_frames=16, crop=32, hop=16)
S, H, W = 2, 96, 128
NO_FILES = dict(face_detector_path=None, face_landmarker_path=None,
                hand_landmarker_path=None, person_segmenter_path=None,
                hand_lm_standin_path=None, palm_det_standin_path=None,
                seg_standin_path=None)
REF_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bp_from_video_tpu_torch", "models",
    "physmamba_ref.py")
# The port in float32 against the reference: measured up to 1.4e-5 of the
# largest output on three seeds at two sizes (f32 sums in other orders:
# taps as channels, BatchNorm and CDC_T folded, the scan's tree) through
# six blocks whose LayerNorms amplify it; the faults below read 2.3e-3 (a
# bf16 scan state) and over 1 (a direction or D dropped).
F32_TOL = 1e-4


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
    return pm.init_params(NET, 7)


@pytest.fixture(scope="module")
def clips():
    """Standardised f32 clips [2, T, C, C, 3]."""
    g = torch.Generator().manual_seed(1)
    return ref.standardise(torch.rand(2, NET.clip_frames, NET.crop, NET.crop,
                                      3, generator=g))


@pytest.fixture(scope="module")
def ref_bvp(params, clips):
    return _ref_bvp(params, clips)


def _ref_bvp(params, x, net=NET):
    return ref.forward(params, x.permute(0, 4, 1, 2, 3), net.theta)


def _rel(got, want) -> float:
    """Largest |gap| over the largest |reference|."""
    return float((got - want).abs().max() / want.abs().max())


def loop_scan(v, dt, bm, cm, a, d, state_dtype=torch.float32):
    """One direction's recurrence token by token, the state kept in
    ``state_dtype``: v, dt [B, L, E], bm, cm [B, L, N], a [E, N], d [E]."""
    b, n, e = v.shape
    h = torch.zeros((b, e, a.shape[-1]), dtype=state_dtype)
    ys = []
    for t in range(n):
        h = (torch.exp(dt[:, t, :, None] * a) * h
             + (dt[:, t] * v[:, t])[..., None] * bm[:, t, None, :]
             ).to(state_dtype)
        ys.append((h.float() * cm[:, t, None, :]).sum(-1) + d * v[:, t])
    return torch.stack(ys, 1)


def loop_bidirectional(v, dt, bm, cm, a, d, state_dtype=torch.float32):
    """:func:`loop_scan` forward plus backward, in the port's argument
    layout (direction first)."""
    fwd = loop_scan(v[0].float(), dt[0], bm[0].float(), cm[0].float(), a[0],
                    d[0], state_dtype)
    bwd = loop_scan(*(t[1].flip(1).float() for t in (v, dt, bm, cm)), a[1],
                    d[1], state_dtype)
    return fwd + bwd.flip(1)


def _scan_inputs(b, n, e=5, st=4, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(2, b, n, e, generator=g),
            torch.rand(2, b, n, e, generator=g) * 0.5,
            torch.randn(2, b, n, st, generator=g),
            torch.randn(2, b, n, st, generator=g),
            -3 * torch.rand(2, e, st, generator=g),
            torch.randn(2, e, generator=g))


@pytest.mark.parametrize("n", [1, 7, 8, 9, 64, 77, 300, 600])
def test_port_scan_equals_the_token_loop(n):
    """Both directions, three clips in blocks of two (the budget fits
    two), sequences shorter than one run of the tree, a whole run, a run
    and a tail, and up to four levels (600 > 8^3): rtol 1e-5 of the
    largest output (f32 sums in another association)."""
    args = _scan_inputs(3, n)
    budget = 2 * (2 * 2 * n * 5 * 4 * 4)
    got = pm.selective_scan(*args, budget=budget)
    want = loop_bidirectional(*args)
    assert got.shape == (3, n, 5)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("n", [1, 2, 7, 64, 77, 300])
def test_reference_scan_equals_the_token_loop(n):
    v, dt, bm, cm, a, d = (t[0] for t in _scan_inputs(2, n, seed=1))
    got = ref.selective_scan(v, dt, a, bm, cm, d)
    assert _rel(got, loop_scan(v, dt, bm, cm, a, d)) < 1e-5


def test_port_net_in_f32_equals_the_reference(params, clips, ref_bvp):
    got = pm.PhysMamba(NET, params, torch.float32, "cpu")(clips)
    assert got.shape == (2, NET.clip_frames)
    assert _rel(got, ref_bvp) < F32_TOL


def test_port_net_in_bf16_is_within_bf16_rounding(params, clips, ref_bvp):
    """bf16 keeps 8 significant bits: the standardised input's rounding
    alone moves this net's BVP by 0.5-1.2 % of its largest output (three
    seeds), and its bf16 stem (shared with PhysFormer) by 2.5-3 %; the
    whole bf16 net read 2.5-5.8 %, so the largest gap is held to 8 %."""
    got = pm.PhysMamba(NET, params, torch.bfloat16, "cpu")(
        clips.to(torch.bfloat16))
    assert got.dtype == torch.float32
    assert _rel(got, ref_bvp) < 0.08


def _fault(monkeypatch, fault, params):
    if fault == "one_direction":
        scan = pm.selective_scan

        def forward_only(v, dt, bm, cm, a, d, budget=pm.SCAN_BYTES):
            v = torch.stack((v[0], torch.zeros_like(v[1])))
            return scan(v, dt, bm, cm, a, d, budget)
        monkeypatch.setattr(pm, "selective_scan", forward_only)
    elif fault == "no_d":
        def zero_d(blocks):
            return [dict(b, mamba=dict(b["mamba"], **{
                k: dict(b["mamba"][k], d=torch.zeros_like(b["mamba"][k]["d"]))
                for k in ("fwd", "bwd")})) for b in blocks]
        params = dict(params, slow=zero_d(params["slow"]),
                      fast=zero_d(params["fast"]))
    else:
        def bf16_state(v, dt, bm, cm, a, d, budget=pm.SCAN_BYTES):
            return loop_bidirectional(v, dt, bm, cm, a, d, torch.bfloat16)
        monkeypatch.setattr(pm, "selective_scan", bf16_state)
    return params


@pytest.mark.parametrize("fault", ["one_direction", "no_d", "bf16_state"])
def test_the_f32_tolerance_catches_a_lesser_scan(monkeypatch, params, clips,
                                                 ref_bvp, fault):
    """A scan with its backward direction dropped, without the ``D``
    skip, or with its state in bf16: each leaves the f32 port past
    :data:`F32_TOL` of the reference."""
    p = _fault(monkeypatch, fault, params)
    got = pm.PhysMamba(NET, p, torch.float32, "cpu")(clips)
    assert _rel(got, ref_bvp) > 3 * F32_TOL


def test_theta_moves_the_output(params, clips, ref_bvp):
    """Without the temporal difference the BVP is another, and the
    reference agrees with the port on it."""
    other = dataclasses.replace(NET, theta=0.0)
    moved = pm.PhysMamba(other, params, torch.float32, "cpu")(clips)
    assert _rel(moved, ref_bvp) > 1e-2
    assert _rel(moved, _ref_bvp(params, clips, other)) < F32_TOL


@pytest.mark.parametrize("kw", [{"clip_frames": 18, "hop": 18},
                                {"crop": 48}, {"hop": 0}])
def test_the_config_refuses_shapes_the_net_cannot_take(kw):
    with pytest.raises(ValueError):
        tconfig.PhysMambaConfig(**kw)


# -- the engine -------------------------------------------------------------


def tiny_config(hop: int = NET.hop, net=NET, **inference):
    cfg = tconfig.physmamba_config(S, H, W, dataclasses.replace(net,
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


def _delta(fn):
    before = dict(profiling.profiler.counts)
    out = fn()
    after = profiling.profiler.counts
    return out, {k: after[k] - before.get(k, 0) for k in after
                 if after[k] != before.get(k, 0)}


def _tokens(net) -> int:
    """Tokens one clip's six scans run over (one direction)."""
    g = net.crop // 4
    slow = fast = 0
    for i in range(3):
        side = g >> i
        slow += net.clip_frames // 4 * side * side
        fast += net.clip_frames // 2 * side * side
    return slow + fast


def test_lagged_step_gives_the_reference_bvp_and_counts_the_scans():
    """One 16-frame window: every frame cropped at the cover of the rect
    from before the window, the reference's BVP of those crops as the raw
    ring; 12 scans a net call, and tokens x clips x 2 scanned."""
    eng = Engine(tiny_config(), device="cpu")
    assert isinstance(eng.rppg, pm.PhysMamba)
    st0 = tracked(eng.init_state())
    frames, ts = frames_and_ts(NET.clip_frames)
    (st, out), counts = _delta(lambda: eng.batch_step_lagged(
        eng.params, st0, frames, ts))
    assert counts["clip.runs"] == S
    assert counts["pm.scans"] == 12
    assert counts["pm.scan_tokens"] == 2 * S * _tokens(NET)
    cover = warp.axis_aligned_cover(warp.arr_rect(torch.tensor(RECT)))
    want = torch.stack([warp.crop_rect(f.permute(0, 2, 3, 1), cover,
                                       NET.crop) / 255.0 for f in frames], 1)
    got = st.clip.ordered()
    assert float((got - want).abs().max()) < 1e-5
    assert torch.equal(st.signals.raw_x, ts.T)
    want_bvp = _ref_bvp(pm.init_params(NET, _seed("rppg")),
                        ref.standardise(got))
    assert _rel(st.signals.raw_y[:, 0], want_bvp) < F32_TOL
    assert torch.equal(st.signals.bpm_x[:, -1], ts[-1])
    assert torch.isfinite(out.bpm).all()


def test_batch_step_runs_the_net_when_full_then_every_hop():
    """One frame a step, hop 8: nothing until the ring holds 16 crops,
    then a run every 8 crops, 12 scans each."""
    eng = Engine(tiny_config(hop=8), device="cpu")
    st = tracked(eng.init_state())
    frames, ts = frames_and_ts(26)
    ran, scans = [], []
    for i in range(26):
        (st, _), counts = _delta(lambda: eng.batch_step(
            eng.params, st, frames[i], ts[i]))
        ran.append(counts.get("clip.runs", 0))
        scans.append(counts.get("pm.scans", 0))
    assert [i for i, n in enumerate(ran) if n] == [15, 23]
    assert [i for i, n in enumerate(scans) if n] == [15, 23]
    assert all(scans[i] == 12 for i in (15, 23))


def _assert_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(torch.nan_to_num(x.double(), nan=-7.0),
                           torch.nan_to_num(y.double(), nan=-7.0))


def test_multistream_engine_equals_engine():
    """``MultiStreamEngine`` (``mesh=None``) builds PhysMamba through the
    seam and steps it as the engine does, lagged and frame by frame."""
    engine = Engine(tiny_config(), device="cpu")
    ms = MultiStreamEngine(tiny_config(), device="cpu")
    st_e = tracked(engine.init_state())
    st_m = tracked(ms.init_states())
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


PF_NET = tconfig.PhysFormerConfig(dim=24, ff_dim=36, num_heads=4,
                                  num_layers=1, clip_frames=16, crop=32,
                                  hop=16)


@pytest.mark.parametrize("make, net, cls, name", [
    (tconfig.physformer_config, PF_NET, pf.PhysFormer, "bpv.net.physformer"),
    (tconfig.physmamba_config, NET, pm.PhysMamba, "bpv.net.physmamba")],
    ids=["physformer", "physmamba"])
def test_the_seam_builds_the_named_net_and_opens_its_span(make, net, cls,
                                                          name):
    """Each net config names its module: the engine builds that module's
    net from its seeded ``init_params`` and opens ``bpv.net.<module>``
    around it (PhysFormer's span as before)."""
    cfg = make(S, H, W, net)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              inference=dataclasses.replace(cfg.inference,
                                                            **NO_FILES))
    eng = Engine(cfg, device="cpu")
    assert type(eng.rppg) is cls
    st = tracked(eng.init_state())
    frames, ts = frames_and_ts(net.clip_frames)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.batch_step_lagged(eng.params, st, frames, ts)
    names = {e.name for e in prof.events()}
    assert name in names
    assert not {"bpv.net.physformer", "bpv.net.physmamba"} - {name} & names
    if cls is pm.PhysMamba:
        assert {"bpv.pm.stem", "bpv.pm.blocks", "bpv.pm.scan",
                "bpv.pm.head"} <= names


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
            "s = importlib.util.spec_from_file_location('pmref', "
            f"{REF_PATH!r})\n"
            "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', "
            "'jaxlib', 'bp_from_video_tpu', 'bp_from_video_tpu_torch')]\n"
            "print(bad); sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_cli_selects_physmamba():
    from bp_from_video_tpu_torch import cli
    cfg, _ = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "physmamba", "--device", "cpu"]))
    assert cfg.rppg_net == tconfig.PhysMambaConfig()
    assert cfg.signal.signal_max_samples == 128
    assert cfg.signal.roi_configs == () and not cfg.inference.hand_landmarker


def test_the_depthwise_convs_match_conv1d(params):
    """The port's two token convs (forward causal, backward anti-causal)
    against ``F.conv1d`` on the tokens and on the reversed tokens."""
    net = pm.PhysMamba(NET, params, torch.float32, "cpu")
    blk = net.fast[0]
    g = torch.Generator().manual_seed(5)
    u = torch.randn(2, 11, blk["conv_w"].shape[1], generator=g)
    e, k = u.shape[-1], blk["conv_w"].shape[-1]

    def conv(x, i):
        return F.conv1d(x.transpose(1, 2), blk["conv_w"][i][:, None],
                        blk["conv_b"][i], padding=k - 1,
                        groups=e)[..., :x.shape[1]].transpose(1, 2)
    got = pm.depthwise_convs(u, blk["conv_w"], blk["conv_b"])
    assert _rel(got[0], conv(u, 0)) < 1e-6
    assert _rel(got[1], conv(u.flip(1), 1).flip(1)) < 1e-6
