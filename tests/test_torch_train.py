"""The port's BP head and its training (``train/bp_regressor.py``,
``python -m bp_from_video_tpu_torch.train``), the drawer's BP line and the
CLI's ``--bp`` against the reference package, on the same numpy inputs
and converted parameters (``convert.mlp_params_from_numpy``).

Tolerances: features equal; the MLP, the loss and 20 AdamW steps at rtol
1e-5 (f32 matmuls and moment updates in another order); the host
predictor at rtol 1e-6 (numpy on both sides); printed reports equal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu import cli as jcli
from bp_from_video_tpu.drivers import sequential as jsequential
from bp_from_video_tpu.parallel import MultiStreamEngine as JMultiStream
from bp_from_video_tpu.runtime import offline as joffline
from bp_from_video_tpu.train import bp_regressor as jbpr
from bp_from_video_tpu.train.__main__ import main as jtrain_main
from bp_from_video_tpu_torch import cli, convert
from bp_from_video_tpu_torch.config import EngineConfig
from bp_from_video_tpu_torch.drivers import sequential
from bp_from_video_tpu_torch.parallel import MultiStreamEngine
from bp_from_video_tpu_torch.render import plotter
from bp_from_video_tpu_torch.render.drawer import Drawer
from bp_from_video_tpu_torch.runtime import offline
from bp_from_video_tpu_torch.runtime.recorder import SignalRecorder
from bp_from_video_tpu_torch.train import bp_regressor as bpr
from bp_from_video_tpu_torch.train.__main__ import main as train_main
from bp_from_video_tpu_torch.train.__main__ import synth_dataset
from test_torch_drivers import (_lock, _no_trained_standins,  # noqa: F401
                                jparams, videos)
from test_torch_multistream import _params as template_params
from test_torch_streams import (H, S, SETTLED, W, _clip, jconfig, lock_on,
                                tconfig, tiny_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREDICTOR = os.path.join(REPO, "models", "bp_e2e_predictor.npz")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.array(a, np.float32)


def _jparams(seed=3, in_dim=6, hidden=(16, 8)):
    p = jbpr.init_mlp(jax.random.key(seed), in_dim, hidden)
    return p, convert.mlp_params_from_numpy(jax.tree.map(np.asarray, p))


def test_features_from_outputs_matches_reference():
    bpm = np.array([[70.0, np.nan], [np.inf, 60.0], [-np.inf, 80.0]],
                   np.float32)
    ptt = np.array([[30.0], [np.nan], [-12.0]], np.float32)
    want = jbpr.features_from_outputs(jnp.asarray(bpm), jnp.asarray(ptt))
    got = bpr.features_from_outputs(torch.from_numpy(bpm),
                                    torch.from_numpy(ptt))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got)[1], [0, 60, 0, 0, 1, 0])


def test_mlp_apply_and_loss_match_reference():
    jp, tp = _jparams()
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (32, 6)).astype(np.float32)
    y = rng.normal(0, 8, (32, 2)).astype(np.float32)   # some past delta 5
    np.testing.assert_allclose(
        _np(bpr.mlp_apply(tp, torch.from_numpy(x))),
        np.asarray(jbpr.mlp_apply(jp, jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        _np(bpr.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y))),
        np.asarray(jbpr.loss_fn(jp, jnp.asarray(x), jnp.asarray(y))),
        rtol=1e-5)


def test_train_steps_match_reference():
    """20 AdamW steps from the same parameters on the same batches: the
    losses, the parameters and the step count."""
    jp, _ = _jparams(seed=5)
    opt = jbpr.make_optimizer(1e-2)
    jstate = jbpr.TrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax.jit(lambda s, x, y: jbpr.train_step(opt, s, x, y))
    state, _ = bpr.init_train_state(torch.Generator().manual_seed(0), 6,
                                    (16, 8), device="cpu")
    state = state._replace(params=convert.mlp_params_from_numpy(
        jax.tree.map(np.asarray, jp)))
    topt = bpr.make_optimizer(state, 1e-2)
    for i in range(20):
        rng = np.random.default_rng([7, i])
        x = rng.normal(0, 1, (64, 6)).astype(np.float32)
        y = rng.normal(0, 6, (64, 2)).astype(np.float32)
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        state, loss = bpr.train_step(topt, state, torch.from_numpy(x),
                                     torch.from_numpy(y))
        np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5,
                                   err_msg=f"loss of step {i}")
    assert int(state.step) == int(jstate.step) == 20
    for g, w in zip(bpr._flat(state.params),
                    [*jstate.params.weights, *jstate.params.biases]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_train_step_refuses_an_optimizer_of_another_state():
    state, _ = bpr.init_train_state(torch.Generator().manual_seed(0), 6)
    other, opt = bpr.init_train_state(torch.Generator().manual_seed(1), 6)
    with pytest.raises(ValueError, match="make_optimizer"):
        bpr.train_step(opt, state, torch.zeros(4, 6), torch.zeros(4, 2))


def _norm(in_dim=6):
    return {"f_mu": np.arange(in_dim, dtype=np.float32) * 0.1,
            "f_sd": np.full((in_dim,), 2.0, np.float32),
            "l_mu": np.array([100.0, 70.0], np.float32),
            "l_sd": np.array([15.0, 10.0], np.float32)}


@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("jax", "port"),
                                           ("port", "jax")])
def test_predictor_round_trip(tmp_path, writer, reader):
    """A head saved by one package loads in the other and predicts what
    the training-time forward does (standardize, MLP, un-standardize); an
    all-NaN row gives NaN; the wrong vital count raises."""
    jp, tp = _jparams(seed=9)
    norm = _norm()
    path = str(tmp_path / "head.npz")
    if writer == "port":
        bpr.save_predictor(path, tp, {k: torch.from_numpy(v)
                                      for k, v in norm.items()})
    else:
        jbpr.save_predictor(path, jp, {k: jnp.asarray(v)
                                       for k, v in norm.items()})
    pred = (bpr if reader == "port" else jbpr).load_predictor(path)
    bpm = np.array([[72.0, 80.0], [np.nan, 65.0], [np.nan, np.nan]],
                   np.float32)
    ptt = np.array([[30.0], [np.nan], [np.nan]], np.float32)
    got = pred(bpm, ptt)
    x = bpr.features_from_outputs(torch.from_numpy(bpm),
                                  torch.from_numpy(ptt))
    want = _np(bpr.mlp_apply(tp, (x - torch.from_numpy(norm["f_mu"]))
                             / torch.from_numpy(norm["f_sd"])))
    want = want * norm["l_sd"] + norm["l_mu"]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    assert np.isnan(got[2]).all()
    with pytest.raises(ValueError, match="vitals"):
        pred(np.array([72.0], np.float32), np.array([30.0], np.float32))


def test_repo_predictor_matches_reference():
    """``models/bp_e2e_predictor.npz`` in both packages' host heads."""
    rng = np.random.default_rng(2)
    bpm = rng.uniform(50, 110, (64, 2)).astype(np.float32)
    ptt = rng.uniform(-90, 90, (64, 1)).astype(np.float32)
    bpm[::7, 0] = np.nan
    ptt[::5] = np.nan
    got = bpr.load_predictor(PREDICTOR)(bpm, ptt)
    want = jbpr.load_predictor(PREDICTOR)(bpm, ptt)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isfinite(got).all()


# -- python -m bp_from_video_tpu_torch.train ---------------------------------


def _last_mae(out: str) -> tuple[float, float]:
    last = [ln for ln in out.splitlines() if "eval MAE" in ln][-1]
    return (float(last.split("SBP")[1].split()[0]),
            float(last.split("DBP")[1].split()[0]))


def test_synth_dataset_is_the_reference_one():
    from bp_from_video_tpu.train.__main__ import synth_dataset as jsynth
    for g, w in zip(synth_dataset(300, seed=4), jsynth(300, seed=4)):
        np.testing.assert_array_equal(g, w)


def test_train_cli_synthetic_checkpoint_resume(tmp_path, capsys):
    """Synthetic training learns (held-out MAE like the reference's on the
    same rows), checkpoints, and a 60 + 20 resumed run ends where an
    uninterrupted 80-step run does, predictor file for predictor file."""
    base = ["--synthetic", "512", "--batch", "64", "--device", "cpu"]
    ck = str(tmp_path / "ck")
    assert train_main(base + ["--steps", "60", "--ckpt-every", "30",
                              "--checkpoint", ck]) == 0
    assert "eval MAE" in capsys.readouterr().out
    assert train_main(base + ["--steps", "80", "--checkpoint", ck,
                              "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 60" in out
    one = str(tmp_path / "one.npz")
    assert train_main(base + ["--steps", "80", "--predictor", one]) == 0
    mae = _last_mae(capsys.readouterr().out)
    a, b = np.load(ck + "_predictor.npz"), np.load(one)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert jtrain_main(["--synthetic", "512", "--batch", "64", "--steps",
                        "80"]) == 0
    jmae = _last_mae(capsys.readouterr().out)
    assert max(mae) < 2 * max(jmae) + 2.0, (mae, jmae)


def test_train_cli_recorded_stream_features(tmp_path, capsys):
    """A recording with a stream axis ([T, S, R]) and per-step labels."""
    rng = np.random.default_rng(0)

    class Out:
        def __init__(self, bpm, ptt, fs):
            self.bpm, self.ptt, self.curr_fs = bpm, ptt, fs

    rec = SignalRecorder(str(tmp_path / "rec.npz"))
    for t in range(64):
        rec.add(t / 30.0, Out(rng.uniform(50, 110, (2, 2)),
                              rng.uniform(10, 60, (2, 1)),
                              np.full(2, 30.0)))
    feats = rec.save()
    labels = str(tmp_path / "labels.npz")
    np.savez(labels, labels=rng.uniform(60, 140, (64, 2)).astype(np.float32))
    assert train_main(["--features", feats, "--labels", labels, "--steps",
                       "20", "--batch", "32", "--device", "cpu"]) == 0
    assert "eval MAE" in capsys.readouterr().out


def test_train_cli_csv_cohort_and_export(tmp_path, capsys):
    """A CSV cohort learns to single-digit MAE; the exported head loads in
    the reference package and predicts as the port's does."""
    rng = np.random.default_rng(1)
    n = 512
    hr = rng.uniform(50, 110, n)
    ptt = rng.uniform(15, 60, n)
    sbp = 150 - 0.9 * ptt + 0.15 * hr + rng.normal(0, 2, n)
    dbp = 95 - 0.5 * ptt + 0.08 * hr + rng.normal(0, 1.5, n)
    path = str(tmp_path / "cohort.csv")
    np.savetxt(path, np.stack([hr, ptt, sbp, dbp], -1), delimiter=",",
               header="hr,ptt,sbp,dbp")
    head = str(tmp_path / "head.npz")
    assert train_main(["--csv", path, "--steps", "300", "--batch", "128",
                       "--device", "cpu", "--predictor", head]) == 0
    assert _last_mae(capsys.readouterr().out)[0] < 8.0
    v = np.array([[70.0], [np.nan]], np.float32), np.array([[30.0], [40.0]],
                                                          np.float32)
    np.testing.assert_allclose(bpr.load_predictor(head)(*v),
                               jbpr.load_predictor(head)(*v), rtol=1e-6)


def test_train_cli_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--synthetic", "64", "--steps", "1"])


# -- the drawer and the CLI --------------------------------------------------


@pytest.mark.parametrize("device_text", [True, False])
def test_drawer_bp_line(device_text):
    """``present`` sets ``last_bp`` from the downloaded vitals and writes
    the magenta BP line (below the card-stamped block, or in the host
    HUD); without a head no magenta appears."""
    pytest.importorskip("cv2")
    cfg = EngineConfig(frame_height=480, frame_width=640)
    cfg = dataclasses.replace(cfg, draw=dataclasses.replace(
        cfg.draw, device_text=device_text))
    pred = bpr.load_predictor(PREDICTOR)
    frame = torch.full((480, 640, 3), 40, dtype=torch.uint8)
    plot = torch.zeros((8, 8, 3), dtype=torch.uint8)
    # curr_fs, mean_fs, BPM x2, PTT, then every graph's tick data (no
    # ticks).
    per = 5 + 2 * plotter.MAX_VLINES
    packed = torch.full((5 + cfg.draw.num_plots * per,), float("nan"))
    packed[:5] = torch.tensor([30.0, 30.0, 72.0, 75.0, 40.0])
    packed[5::per] = 0.0
    magenta, last_bp = {}, {}
    for head in (pred, None):
        d = Drawer(cfg, show=False, bp_predictor=head, device="cpu")
        assert d.present(frame, plot, packed) == -1
        img = d.last_frame                         # BGR
        magenta[head is None] = int(((img[..., 0] > 150) & (img[..., 1] < 90)
                                     & (img[..., 2] > 150)).sum())
        last_bp[head is None] = d.last_bp
    assert last_bp[True] is None
    np.testing.assert_allclose(
        last_bp[False], jbpr.load_predictor(PREDICTOR)(
            np.array([72.0, 75.0]), np.array([40.0])), rtol=1e-6)
    assert magenta[False] > 0 and magenta[True] == 0


def test_cli_offline_bp_report_matches_reference(videos, jparams,
                                                 monkeypatch, capsys):
    """``--offline --headless --bp``: the settled mean BP line of each
    stream as the reference CLI prints it."""
    _lock(monkeypatch, jparams, [(offline, "MultiStreamEngine"),
                                 (joffline, "MultiStreamEngine")])
    argv = ["--source", *videos, "--offline", "--headless", "--bp",
            PREDICTOR, "--signal-samples", "32", "--peak-samples", "8"]
    assert jcli.main(argv) == 0
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("stream ")]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("stream ")]
    assert got == want and len(got) == 4
    assert "mmHg" in got[1]


def test_cli_headless_bp_estimate_matches_reference(videos, jparams,
                                                    monkeypatch, capsys):
    """The sequential driver to the end of one file, headless, with
    ``--bp``: the BPM, PTT and BP estimate lines as the reference's."""
    _lock(monkeypatch, jparams, [(sequential, "Engine"),
                                 (jsequential, "Engine")])
    argv = ["--source", videos[0], "--headless", "--bp", PREDICTOR,
            "--signal-samples", "32", "--peak-samples", "8"]

    def report(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("mean BPM", "mean PTT", "BP estimate"))]
    assert jcli.main(argv) == 0
    want = report(capsys.readouterr().out)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    got = report(capsys.readouterr().out)
    assert got == want and any("mmHg" in ln for ln in got)


# -- end to end ---------------------------------------------------------------


def test_e2e_train_step_matches_reference():
    """``make_e2e_train_step`` over the tiny engine (S = 2, template heads,
    a tracked start): both engines run ``SETTLED`` frames, then three
    end-to-end steps from the same head: the losses and the head's
    parameters as the reference's, the engine state as after plain
    steps."""
    jms = JMultiStream(tiny_config(jconfig, frame_height=H, frame_width=W,
                                   num_streams=S))
    tms = MultiStreamEngine(tiny_config(tconfig, frame_height=H,
                                        frame_width=W, num_streams=S),
                            device="cpu")
    jp_eng, tp_eng = template_params(jms)
    jst = lock_on(jms.init_states(), H, jnp.asarray)
    tst = lock_on(tms.init_states(), H, torch.from_numpy)
    clip, ts = _clip()
    jvstep = jax.jit(jms._vstep)
    for i in range(SETTLED):
        jst, _ = jvstep(jp_eng, jst, jnp.asarray(clip[i]), jnp.asarray(ts[i]))
        tst, _ = tms.step(tp_eng, tst, torch.from_numpy(clip[i]),
                          torch.from_numpy(ts[i]))
    sig = tms.config.signal
    in_dim = 2 * (sig.num_signals + sig.num_pairs)
    jp, _ = _jparams(seed=11, in_dim=in_dim, hidden=(16,))
    opt = jbpr.make_optimizer(1e-2)
    jtrain = jbpr.TrainState(jp, opt.init(jp), jnp.zeros((), jnp.int32))
    norm = {"f_mu": np.r_[np.full(in_dim // 2, 60.0), np.zeros(in_dim // 2)]
            .astype(np.float32),
            "f_sd": np.r_[np.full(in_dim // 2, 30.0), np.ones(in_dim // 2)]
            .astype(np.float32),
            "l_mu": np.array([120.0, 80.0], np.float32),
            "l_sd": np.array([15.0, 10.0], np.float32)}
    je2e = jax.jit(jbpr.make_e2e_train_step(
        jms._vstep, opt, {k: jnp.asarray(v) for k, v in norm.items()}))
    ttrain, _ = bpr.init_train_state(torch.Generator().manual_seed(0),
                                     in_dim, (16,))
    ttrain = ttrain._replace(params=convert.mlp_params_from_numpy(
        jax.tree.map(np.asarray, jp)))
    te2e = bpr.make_e2e_train_step(
        tms.step, bpr.make_optimizer(ttrain, 1e-2),
        {k: torch.from_numpy(v) for k, v in norm.items()})
    labels = np.array([[125.0, 82.0], [110.0, 75.0]], np.float32)
    plain = tst
    for i in range(SETTLED, SETTLED + 3):
        jst, jtrain, jloss = je2e(jp_eng, jst, jtrain, jnp.asarray(clip[i]),
                                  jnp.asarray(ts[i]), jnp.asarray(labels))
        tst, ttrain, loss = te2e(tp_eng, tst, ttrain,
                                 torch.from_numpy(clip[i]),
                                 torch.from_numpy(ts[i]),
                                 torch.from_numpy(labels))
        plain, pout = tms.step(tp_eng, plain, torch.from_numpy(clip[i]),
                               torch.from_numpy(ts[i]))
        np.testing.assert_allclose(_np(loss), np.asarray(jloss), rtol=1e-5)
        assert np.isfinite(_np(loss))
    np.testing.assert_array_equal(_np(tst.signals.raw_y),
                                  _np(plain.signals.raw_y))
    assert int(ttrain.step) == 3
    for g, w in zip(bpr._flat(ttrain.params),
                    [*jtrain.params.weights, *jtrain.params.biases]):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
