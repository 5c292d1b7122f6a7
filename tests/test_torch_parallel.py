"""Several ranks on the CPU: the port's ``parallel/{mesh,distributed,
streams,dryrun}.py``, the pipelined driver with a mesh, the data-parallel
trainer and the e2e step over a ``dp`` x ``tp`` mesh, in worlds of 1, 2
and 4 processes (gloo) started by ``parallel.dryrun.spawn``, each with
its own deadline.  The counterparts of ``tests/test_parallel.py``,
``test_runtime.py``'s ``test_distributed_helpers_single_host``,
``test_drivers.py``'s ``test_pipelined_driver_with_mesh`` and
``test_train.py``'s CLI and e2e tests.

Tolerances: a sharded step equals the per-shard runs (an engine of S/dp
streams on each part, in this process) bit for bit, and the unsharded run
bit for bit where ``detector_subbatch`` >= S; the sharded ``run_clip``
holds to the JAX package's unsharded engine as ``test_torch_streams``
holds the port's (PTT, ``curr_fs`` and the NaN pattern equal, BPM from row
``SETTLED``); the e2e step's loss and updated head within rtol 1e-5 of
the unsharded step's (f32 sums split over ranks); a one-rank trainer's
losses equal one process's.  The rank bodies are in
``torch_parallel_workers.py``.
"""

import dataclasses
import multiprocessing
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import torch_parallel_workers as workers
from bp_from_video_tpu_torch.models.runner import map_leaves
from bp_from_video_tpu_torch.parallel import distributed
from bp_from_video_tpu_torch.parallel import mesh as mesh_lib
from bp_from_video_tpu_torch.parallel.dryrun import dryrun, spawn, tiny_config
from bp_from_video_tpu_torch.parallel.streams import (ClipOutputs,
                                                      MultiStreamEngine)
from bp_from_video_tpu_torch.train import bp_regressor as bpr
from chip_smoke import pulse_clip
from test_torch_streams import (H, S, T, W, assert_clip_equal, np_tree,
                                write_video)
from test_torch_streams import pair  # noqa: F401  (a fixture, by name)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread (every spawned rank sets the
    same): the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def one_rank_world(monkeypatch):
    """No launcher environment; the process group this test starts is
    destroyed after it, so later tests in this process run alone."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_distributed_helpers_single_process(one_rank_world):
    """Unconfigured: ``initialize`` is a no-op returning False; the
    stream slice is everything; ``global_mesh`` starts a world of one
    rank on a local store and builds a 1-D ``dp`` mesh over it."""
    assert distributed.initialize(device="cpu") is False
    assert distributed.local_stream_slice(8) == (0, 8)
    mesh = distributed.global_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("dp",) and mesh.size() == 1
    assert distributed.initialize() is True            # idempotent
    assert distributed.local_stream_slice(8) == (0, 8)


def test_make_mesh_rejects_a_mesh_larger_than_the_world(one_rank_world):
    distributed.global_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_lib.make_mesh({"dp": 2}, "cpu")


def test_placements_on_a_2x2_world():
    """A ``[8, 5]`` stream tree split over dp (4 rows a rank, replicated
    over tp); ``w [3, 16]`` split over tp, ``b [3]`` replicated; a mesh of
    8 on 4 ranks raises; ``local_stream_slice`` of 8 and of 10 streams
    (the last rank takes the remainder); ``mesh.gather`` reads both split
    leaves whole on every rank and refuses partial sums."""
    got = spawn(workers.placements, 4)
    for r, g in enumerate(got):
        dp, tp = divmod(r, 2)
        assert g["rank"] == r and g["coord"] == (dp, tp)
        pl, x, shape = g["x"]
        assert pl == (Shard(0), Replicate()) and shape == (8, 5)
        np.testing.assert_array_equal(
            x, np.arange(40.0).reshape(8, 5)[4 * dp:4 * dp + 4])
        pl, w = g["w"]
        assert pl == (Replicate(), Shard(1))
        np.testing.assert_array_equal(
            w, np.arange(48.0).reshape(3, 16)[:, 8 * tp:8 * tp + 8])
        assert g["b"] == (Replicate(), Replicate())
        assert "needs 8 ranks" in g["too_big"]
        assert g["stream_sharding"] == (Shard(1), Replicate())
        assert g["slices"] == ((2 * r, 2 * r + 2),
                               (2 * r, 2 * r + 2 if r < 3 else 10))
        np.testing.assert_array_equal(g["whole"][0],
                                      np.arange(40.0).reshape(8, 5))
        np.testing.assert_array_equal(g["whole"][1],
                                      np.arange(48.0).reshape(3, 16))
        assert "partial values" in g["partial"]


def _noise_inputs(s: int, t: int, seed: int):
    """uint8 [t, s, 32, 32, 3] noise frames with a green pulse, and
    timestamps [t, s]."""
    rng = np.random.default_rng(seed)
    clip = rng.integers(0, 60, (t, s, 32, 32, 3), dtype=np.uint8)
    clip[..., 1] += (60 + 50 * np.sin(np.arange(t) / 3.0)).astype(
        np.uint8)[:, None, None, None]
    ts = np.repeat(((np.arange(t) + 1) / 30.0).astype(np.float32)[:, None],
                   s, 1)
    return clip, ts


def _assert_trees_equal(got, want, what):
    for i, (a, b) in enumerate(zip(workers.leaves(got),
                                   workers.leaves(want))):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_step_equals_per_shard_runs(dp):
    """S = 4 streams of noise, ``step`` over 4 frames then
    ``run_clip_lagged`` over 2 windows of F = 3, on a dp mesh: with
    ``detector_subbatch`` 1 (< S) each rank's state and outputs equal an
    engine of S/dp streams run here on its part; with F * S (the lagged
    step detects on F * S rows) they equal the unsharded engine's rows.
    Outputs are the rank's rows; placed, they keep the global stream
    axis, split over dp; gathered, they are in stream order."""
    s, f = 4, 3
    clip, ts = _noise_inputs(s, 4, seed=dp)
    lagged, lts = _noise_inputs(s, 2 * f, seed=10 + dp)
    lagged = lagged.reshape(2, f, *lagged.shape[1:])
    lts = lts.reshape(2, f, s)
    for k in (1, f * s):
        cfg = tiny_config(s)
        cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
            cfg.inference, detector_subbatch=k))
        got = spawn(workers.sharded_runs, dp, ({"dp": dp}, cfg, clip, ts,
                                               lagged, lts))
        parts = [(0, s)] if k >= f * s else [g["slice"] for g in got]
        want = {}
        for lo, hi in parts:
            one = MultiStreamEngine(dataclasses.replace(
                cfg, num_streams=hi - lo), device="cpu")
            st = one.init_states()
            for t in range(clip.shape[0]):
                st, out = one.step(one.params, st,
                                   torch.from_numpy(clip[t, lo:hi]),
                                   torch.from_numpy(ts[t, lo:hi]))
            st_l, out_l = one.run_clip_lagged(
                one.params, one.init_states(),
                torch.from_numpy(lagged[:, :, lo:hi]),
                torch.from_numpy(lts[:, :, lo:hi]))
            want[lo] = (workers.np_tree(st), workers.np_tree(out),
                        workers.np_tree(st_l), workers.np_tree(out_l))
        for r, g in enumerate(got):
            lo, hi = g["slice"]
            assert (lo, hi) == (r * s // dp, (r + 1) * s // dp)
            assert g["placed"] == ((Shard(0),), (s, 2), (Shard(1),),
                                   (2, s, 2))
            base = 0 if k >= f * s else lo

            def rows(tree, axis=0):
                return map_leaves(lambda a: a.take(
                    np.arange(lo - base, hi - base), axis), tree)
            w_st, w_out, w_stl, w_outl = want[base]
            for name, a, b in (
                    ("state", g["state"], rows(w_st)),
                    ("outputs", g["out"], rows(w_out)),
                    ("lagged state", g["lagged_state"], rows(w_stl)),
                    ("lagged outputs", g["lagged_out"], rows(w_outl, 1))):
                _assert_trees_equal(a, b, f"k={k} rank {r} {name}")
            if k >= f * s:
                _assert_trees_equal(g["gathered"], w_out, "gathered")


def test_sharded_run_clip_matches_reference(pair):
    """``run_clip`` over ``test_torch_streams``' 40-frame clip (96x128,
    template heads, tracked start, ``detector_subbatch`` 8) on a dp = 2
    mesh, its two streams given to each rank (S = 4), gathered, against
    the JAX package's unsharded ``run_clip`` of the two (S = 2):
    ``test_torch_streams``' tolerances, on each half.  Each shard steps
    the batch the reference steps: on this clip both packages read one PTT
    of stream 1 a millisecond apart at S = 1 and S = 2 (a correlation peak
    on a knife edge: JAX at row 16, the port at row 25)."""
    jms, tms, jparams, tparams, jst, tst = pair
    clip = pulse_clip(T, S, H, W, split=60, seed=6, device="cpu").numpy()
    ts = np.repeat(((np.arange(T) + 1) / 30.0).astype(np.float32)[:, None],
                   S, 1)
    twice = workers.np_tree(map_leaves(lambda a: torch.cat([a, a]), tst))
    got = spawn(workers.run_clip_locked, 2, (
        dataclasses.replace(tms.config, num_streams=2 * S),
        workers.np_tree(tparams), twice, np.concatenate([clip, clip], 1),
        np.concatenate([ts, ts], 1)))
    _, jout = jax.jit(jms.run_clip)(jparams, jst, jnp.asarray(clip),
                                    jnp.asarray(ts))
    for g in got:
        assert g.bpm.shape == (T, 2 * S, 2)
        for half in (slice(0, S), slice(S, 2 * S)):
            assert_clip_equal(ClipOutputs(*(a[:, half] for a in g)),
                              np_tree(jout))


def test_pipelined_driver_with_mesh(tmp_path):
    """``pipelined.run`` on a dp = 2 mesh of two ranks, each given both
    files: each rank opens only its own file, and each returns the whole
    stream axis (``bpm.shape[0] == 2``, plain tensors)."""
    clip = pulse_clip(12, 2, H, W, split=60, seed=6, device="cpu").numpy()
    videos = [write_video(str(tmp_path / f"v{i}.avi"),
                          np.ascontiguousarray(
                              clip[:, i, ::-1].transpose(0, 2, 3, 1)))
              for i in range(2)]
    got = spawn(workers.pipelined_mesh, 2, (tiny_config(1), videos))
    for r, (opened, shape, kind) in enumerate(got):
        assert opened == [videos[r]]
        assert shape == (2, 2) and kind == "Tensor"


@pytest.mark.parametrize("how", ["ended", "quit", "error"])
def test_pipelined_mesh_ranks_stop_together(how):
    """Two ranks whose cameras give unequal frame counts (rank 0: 3, rank
    1: 30) step together and stop together: when both cameras have ended
    (rank 0 steps its last frame again meanwhile), at 'q' on the
    presenting rank 0 after its second frame, or when rank 1 fails at its
    second step (it raises its error, rank 0 ``RuntimeError``).  Finished
    runs return the same whole BPM on both ranks."""
    frames = (3, 30) if how == "ended" else (3, None)
    got = spawn(workers.pipelined_stop, 2, (tiny_config(1), frames, how))
    assert got[0]["steps"] == got[1]["steps"]
    if how == "ended":
        assert [g["read"] for g in got] == [3, 30]
        assert all(g["ended"] and g["error"] is None for g in got)
        assert got[0]["bpm"].shape == (2, 2)
        np.testing.assert_array_equal(got[0]["bpm"], got[1]["bpm"])
    elif how == "quit":
        assert got[0]["steps"] == 2
        assert all(g["error"] is None and g["bpm"].shape == (2, 2)
                   for g in got)
        np.testing.assert_array_equal(got[0]["bpm"], got[1]["bpm"])
    else:
        assert got[0]["steps"] == 2
        assert "RuntimeError" in got[0]["error"]
        assert got[1]["error"] == "ValueError: the recorder failed"


@pytest.mark.parametrize("what", ["engine", "pipelined"])
def test_indivisible_streams_raise(what):
    """Three streams on a dp = 2 mesh: ``MultiStreamEngine`` and
    ``pipelined.run`` raise ``ValueError``."""
    got = spawn(workers.indivisible, 2, (what, ["a.avi", "b.avi", "c.avi"]))
    assert all(m is not None and "not divisible by dp=2" in m for m in got)


TRAIN = ["--synthetic", "512", "--batch", "64", "--device", "cpu"]


def test_trainer_on_a_world_of_two(tmp_path):
    """Two ranks, 32 rows each a step: the loss falls, and equals one
    process's on the same 64-row batches (rtol 1e-5: the gradient is
    averaged over the ranks, the mean summed in two halves); rank 0 alone
    prints and checkpoints, both ranks read the same losses, and a resumed
    world starts at the saved step."""
    ck = str(tmp_path / "ck")
    got = spawn(workers.train, 2, (TRAIN + [
        "--steps", "60", "--ckpt-every", "30", "--checkpoint", ck],))
    (rc0, out0, loss0), (rc1, out1, loss1) = got
    assert rc0 == rc1 == 0 and "eval MAE" in out0 and out1 == ""
    assert loss0 == loss1 and len(loss0) == 60
    assert np.mean(loss0[-10:]) < 0.5 * np.mean(loss0[:10])
    _, _, plain = workers.train(TRAIN + ["--steps", "60"])
    np.testing.assert_allclose(loss0, plain, rtol=1e-5)
    assert os.path.exists(ck + ".npz") and os.path.exists(
        ck + "_predictor.npz")
    got = spawn(workers.train, 2, (TRAIN + [
        "--steps", "80", "--checkpoint", ck, "--resume"],))
    assert "resumed at step 60" in got[0][1] and len(got[0][2]) == 20


def test_trainer_one_rank_world_equals_one_process(tmp_path):
    """A world of one rank (the mesh path) reads the losses of a plain
    process, bit for bit, and exports the same head."""
    one = str(tmp_path / "one.npz")
    rank = str(tmp_path / "rank.npz")
    (rc, _, losses), = spawn(workers.train, 1, (TRAIN + [
        "--steps", "30", "--predictor", rank],))
    rc2, _, plain = workers.train(TRAIN + ["--steps", "30",
                                           "--predictor", one])
    assert rc == rc2 == 0 and losses == plain
    with np.load(one) as a, np.load(rank) as b:
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("replicate_last", [False, True])
def test_e2e_step_dp_tp(replicate_last):
    """One e2e step on a 2x2 world (S = 2 tiny engine, 10 warm steps; the
    head split over tp, or with its last weight and bias replicated: a
    tp-split hidden layer then leaves partial sums that the loss must not
    see) against the unsharded e2e step: loss and updated head within
    rtol 1e-5."""
    clip, ts = _noise_inputs(2, 11, seed=5)
    labels = np.random.default_rng(0).uniform(60, 140, (2, 2)).astype(
        np.float32)
    got = spawn(workers.e2e_dp_tp, 4, (clip, ts, labels, 10,
                                       replicate_last))
    ms = MultiStreamEngine(tiny_config(2), device="cpu")
    state = ms.init_states()
    for t in range(10):
        state, _ = ms.step(ms.params, state, torch.from_numpy(clip[t]),
                           torch.from_numpy(ts[t]))
    tstate, opt = bpr.init_train_state(torch.Generator().manual_seed(3), 6)
    _, tstate, loss = bpr.make_e2e_train_step(ms.step, opt)(
        ms.params, state, tstate, torch.from_numpy(clip[10]),
        torch.from_numpy(ts[10]), torch.from_numpy(labels))
    want = workers.leaves(workers.np_tree(tstate.params))
    for g in got:
        last = ((Replicate(), Replicate()) if replicate_last
                else (Replicate(), Shard(1)))
        assert g["w_placements"][-1] == last and g["step"] == 1
        np.testing.assert_allclose(g["loss"], float(loss), rtol=1e-5)
        for a, b in zip(workers.leaves(g["params"]), want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_dryrun_two_by_two():
    """``dryrun(4)``: the e2e step over dp 2 x tp 2 gives every rank the
    same finite loss."""
    losses = dryrun(4)
    assert len(losses) == 4 and np.isfinite(losses[0])


def test_spawn_names_a_dead_rank():
    """Rank 1 exits with 17 after start-up while rank 0 waits in a
    collective: the spawner raises naming rank 1 and its code well within
    the deadline, and no child is left running."""
    t = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 1 died \(rc=17\)"):
        spawn(workers.die_after_start, 2, (17,), deadline=60)
    assert time.monotonic() - t < 60
    assert multiprocessing.active_children() == []
