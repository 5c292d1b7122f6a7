"""Train the blood-pressure regressor — ``python -m
bp_from_video_tpu_torch.train`` (the counterpart of ``python -m
bp_from_video_tpu.train``, with ``--device`` in place of ``--platform``):

  * ``--features rec.npz`` — a ``runtime.recorder.SignalRecorder`` file
    (``bpm [T, num_signals]`` / ``[T, S, R]``, ``ptt``), paired with cuff
    labels (``--labels labels.npz``, key ``labels``: SBP/DBP mmHg).
  * ``--csv cohort.csv`` — ``hr,ptt,sbp,dbp`` rows (one header line).
  * ``--synthetic N`` — a self-contained toy task (SBP/DBP affine in HR
    and pulse-wave velocity ~ 1/PTT, plus noise and NaN dropouts).

Features and labels are standardized on training-split statistics (the
validity flags pass through); the constants ride in the checkpoint beside
the parameters.  One device (``--device``, default ``cuda``): a batch is
``--batch`` rows, drawn with ``numpy.random.default_rng([seed, step])``,
so a resumed run draws the batches an uninterrupted run would.
Checkpoints (parameters, AdamW moments, step, standardization) go through
``runtime.recorder.save_state``/``load_state`` every ``--ckpt-every``
steps; ``--resume`` continues from the saved step.  ``--predictor`` (or
``<checkpoint>_predictor.npz``) exports the head for the CLI's ``--bp``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def synth_dataset(n: int, num_signals: int = 2, num_pairs: int = 1,
                  seed: int = 0
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Toy physiological task: labels affine in HR and 1/PTT, with
    measurement noise and ~5% NaN dropouts of a signal, as unsettled
    engine output has (the same rows as the reference package's)."""
    rng = np.random.default_rng(seed)
    hr = rng.uniform(50.0, 110.0, (n, num_signals)).astype(np.float32)
    ptt = rng.uniform(10.0, 60.0, (n, num_pairs)).astype(np.float32)
    pwv = 1000.0 / ptt
    sbp = (0.35 * hr.mean(-1, keepdims=True)
           + 1.2 * pwv.mean(-1, keepdims=True) + 60.0)
    dbp = (0.20 * hr.mean(-1, keepdims=True)
           + 0.7 * pwv.mean(-1, keepdims=True) + 40.0)
    labels = np.concatenate([sbp, dbp], axis=-1)
    labels += rng.normal(0.0, 2.0, labels.shape)
    drop = rng.random((n, num_signals)) < 0.05
    hr[drop] = np.nan
    return hr, ptt, labels.astype(np.float32)


def load_recorded(features_path: str, labels_path: str):
    """(bpm, ptt, labels) rows of a recording and its labels; a stream
    axis ([T, S, R]) makes each (step, stream) one row, with per-step
    labels repeated over the streams."""
    rec = np.load(features_path)
    bpm = rec["bpm"].astype(np.float32)
    ptt = rec["ptt"].astype(np.float32)
    labels = np.load(labels_path)["labels"].astype(np.float32)
    if bpm.ndim == 3:
        t, s = bpm.shape[:2]
        if labels.ndim == 2 and labels.shape[0] == t:
            labels = np.repeat(labels[:, None, :], s, axis=1)
        bpm = bpm.reshape(t * s, -1)
        ptt = ptt.reshape(t * s, -1)
        labels = labels.reshape(-1, labels.shape[-1])
    if labels.shape[0] != bpm.shape[0]:
        raise SystemExit(f"labels rows {labels.shape[0]} != feature rows "
                         f"{bpm.shape[0]}")
    if labels.ndim != 2 or labels.shape[-1] != 2:
        raise SystemExit(f"labels must be [rows, 2] (SBP, DBP); got "
                         f"{labels.shape}")
    return bpm, ptt, labels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m bp_from_video_tpu_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--features", help="SignalRecorder npz (bpm/ptt rows)")
    src.add_argument("--csv", help="hr,ptt,sbp,dbp rows (one header line)")
    src.add_argument("--synthetic", type=int, metavar="N",
                     help="generate N synthetic rows instead")
    ap.add_argument("--labels", help="npz with 'labels' [T, 2] (SBP, DBP)")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    ap.add_argument("--eval-frac", type=float, default=0.2)
    ap.add_argument("--checkpoint", default=None, metavar="DIR")
    ap.add_argument("--predictor", default=None, metavar="OUT.npz",
                    help="export a standalone inference head (weights + "
                         "normalization) for the CLI's --bp flag "
                         "(default: <checkpoint>_predictor.npz when "
                         "--checkpoint is given)")
    ap.add_argument("--ckpt-every", type=int, default=200,
                    help="save every N steps; 0 = only at the end")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from bp_from_video_tpu_torch import resolve_device
    from bp_from_video_tpu_torch.runtime.recorder import load_state, save_state
    from bp_from_video_tpu_torch.train import bp_regressor as bpr

    device = resolve_device(args.device)
    if args.synthetic is not None:
        bpm, ptt, labels = synth_dataset(args.synthetic, seed=args.seed)
    elif args.csv:
        rows = np.loadtxt(args.csv, delimiter=",", skiprows=1,
                          dtype=np.float32, ndmin=2)
        bpm, ptt, labels = rows[:, 0:1], rows[:, 1:2], rows[:, 2:4]
    else:
        if not args.labels:
            ap.error("--features requires --labels")
        bpm, ptt, labels = load_recorded(args.features, args.labels)

    n = bpm.shape[0]
    n_eval = max(1, int(n * args.eval_frac))
    perm = np.random.default_rng(args.seed).permutation(n)
    bpm, ptt, labels = bpm[perm], ptt[perm], labels[perm]
    feats = bpr.features_from_outputs(torch.from_numpy(bpm),
                                      torch.from_numpy(ptt)).numpy()
    tr_x, ev_x = feats[n_eval:], feats[:n_eval]
    tr_y, ev_y = labels[n_eval:], labels[:n_eval]
    if tr_x.shape[0] == 0:
        raise SystemExit(f"no training rows left: {n} rows with "
                         f"--eval-frac {args.eval_frac} leaves an empty "
                         "training split")
    in_dim = feats.shape[-1]

    # Training-split statistics; the validity half passes through.
    f_mu = tr_x.mean(0).astype(np.float32)
    f_sd = np.maximum(tr_x.std(0), 1e-6).astype(np.float32)
    f_mu[in_dim // 2:] = 0.0
    f_sd[in_dim // 2:] = 1.0
    l_mu = tr_y.mean(0).astype(np.float32)
    l_sd = np.maximum(tr_y.std(0), 1e-6).astype(np.float32)

    state, opt = bpr.init_train_state(
        torch.Generator().manual_seed(args.seed), in_dim,
        tuple(args.hidden), args.lr, device)
    norm = {k: torch.from_numpy(v).to(device) for k, v in
            (("f_mu", f_mu), ("f_sd", f_sd), ("l_mu", l_mu),
             ("l_sd", l_sd))}
    if args.resume:
        if not args.checkpoint:
            ap.error("--resume requires --checkpoint")
        state, norm = load_state(args.checkpoint, (state, norm))
        opt = bpr.make_optimizer(state, args.lr)
        print(f"resumed at step {int(state.step)}")
    f_mu, f_sd, l_mu, l_sd = (norm[k].cpu().numpy()
                              for k in ("f_mu", "f_sd", "l_mu", "l_sd"))
    tr_x = (tr_x - f_mu) / f_sd
    ev_x = torch.from_numpy((ev_x - f_mu) / f_sd).to(device)
    ev_y = torch.from_numpy(ev_y).to(device)
    tr_y_n = (tr_y - l_mu) / l_sd

    loss = float("nan")
    saved_at = -1
    for i in range(int(state.step), args.steps):
        idx = np.random.default_rng([args.seed, i]).integers(
            0, tr_x.shape[0], (args.batch,))
        x = torch.from_numpy(tr_x[idx]).to(device)
        y = torch.from_numpy(tr_y_n[idx]).to(device)
        state, loss = bpr.train_step(opt, state, x, y)
        if (i + 1) % 50 == 0 or i + 1 == args.steps:
            with torch.no_grad():
                mae = (bpr.mlp_apply(state.params, ev_x) * norm["l_sd"]
                       + norm["l_mu"] - ev_y).abs().mean(0).tolist()
            print(f"step {i + 1:6d}  huber {float(loss):8.3f}  "
                  f"eval MAE mmHg  SBP {mae[0]:6.2f}  DBP {mae[1]:6.2f}",
                  flush=True)
        if (args.checkpoint and args.ckpt_every > 0
                and (i + 1) % args.ckpt_every == 0):
            save_state(args.checkpoint, (state, norm))
            saved_at = i + 1
    if args.checkpoint:
        path = (save_state(args.checkpoint, (state, norm))
                if saved_at != int(state.step) else args.checkpoint)
        print(f"checkpoint: {path}")
    predictor_path = args.predictor or (
        args.checkpoint + "_predictor.npz" if args.checkpoint else None)
    if predictor_path:
        p = bpr.save_predictor(predictor_path, state.params, norm)
        print(f"predictor: {p}  (live HUD: python -m bp_from_video_tpu_torch "
              f"--source 0 --bp {p})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
