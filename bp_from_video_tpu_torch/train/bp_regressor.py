"""Blood-pressure regression from rPPG features — the counterpart of
``bp_from_video_tpu/train/bp_regressor.py``.

Model: a small MLP mapping per-stream feature vectors ``[HR_bpm,
PTT_ms...]`` plus their validity flags to ``[systolic, diastolic]`` mmHg.
Training: the mean Huber loss (delta 5), autograd, and
``torch.optim.AdamW`` with ``optax.adamw``'s defaults (betas 0.9/0.999, eps
1e-8, weight decay 1e-4).  The optimizer's moments live in the
:class:`TrainState` (``opt_state``), so a state checkpoints and restores
whole through ``runtime/recorder.save_state``/``load_state``; bind an
optimizer to a state with :func:`make_optimizer`.

:class:`BPPredictor` is the inference head on the host (numpy): its inputs,
the HUD vitals, are already on the host when the display reads them.
:func:`save_predictor` writes the npz that either package loads.

:func:`make_e2e_train_step` runs the engine step as a feature extractor
under ``torch.no_grad()`` (through its kernels, as at inference) and
updates the head: the gradient stops at the features, as in the reference.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# optax.adamw's defaults (torch's own weight decay default is 1e-2).
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
HUBER_DELTA = 5.0


class MLPParams(NamedTuple):
    weights: tuple[Tensor, ...]
    biases: tuple[Tensor, ...]


def init_mlp(gen: torch.Generator, in_dim: int,
             hidden: tuple[int, ...] = (64, 64), out_dim: int = 2,
             device="cpu") -> MLPParams:
    """He-normal weights drawn from ``gen`` (a CPU generator), zero biases,
    on ``device``."""
    dims = (in_dim, *hidden, out_dim)
    ws, bs = [], []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=gen
                        ) * (2.0 / dims[i]) ** 0.5
        ws.append(w.to(device))
        bs.append(torch.zeros(dims[i + 1], device=device))
    return MLPParams(tuple(ws), tuple(bs))


def mlp_apply(params: MLPParams, x: Tensor) -> Tensor:
    """x: [..., in_dim] -> [..., out_dim] (systolic, diastolic) mmHg."""
    h = x
    n = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        h = h @ w + b
        if i < n - 1:
            h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    return h


def features_from_outputs(bpm: Tensor, ptt: Tensor) -> Tensor:
    """The regression features of engine outputs: bpm [..., num_signals]
    and ptt [..., num_pairs] -> [..., 2 (num_signals + num_pairs)], the
    values with every non-finite one (NaN and +-inf) as 0, then a validity
    flag per value."""
    feats = torch.cat([bpm, ptt], -1).to(torch.float32)
    valid = torch.isfinite(feats)
    return torch.cat([torch.where(valid, feats, 0.0),
                      valid.to(torch.float32)], -1)


def loss_fn(params: MLPParams, feats: Tensor, labels: Tensor) -> Tensor:
    """Mean Huber loss (delta 5) over (SBP, DBP)."""
    return F.huber_loss(mlp_apply(params, feats), labels, delta=HUBER_DELTA)


class AdamWState(NamedTuple):
    """AdamW's moments, one tensor per parameter in ``weights + biases``
    order; the step count is ``TrainState.step``."""

    exp_avg: tuple[Tensor, ...]
    exp_avg_sq: tuple[Tensor, ...]


class TrainState(NamedTuple):
    params: MLPParams
    opt_state: AdamWState
    step: Tensor          # int32 []


def _flat(params: MLPParams) -> list[Tensor]:
    return [*params.weights, *params.biases]


def make_optimizer(state: TrainState, lr: float = 1e-3
                   ) -> torch.optim.AdamW:
    """``torch.optim.AdamW`` (optax.adamw's defaults) over ``state``'s
    parameters, its moments ``state.opt_state``'s tensors and its step
    ``state.step``: :func:`train_step` updates them in place.  Bind anew
    after restoring a state (one host read of the step)."""
    params = _flat(state.params)
    for p in params:
        p.requires_grad_(True)
    opt = torch.optim.AdamW(params, lr=lr, **ADAMW)
    step = float(state.step)
    for p, m, v in zip(params, state.opt_state.exp_avg,
                       state.opt_state.exp_avg_sq):
        opt.state[p] = {"step": torch.tensor(step), "exp_avg": m,
                        "exp_avg_sq": v}
    return opt


def init_train_state(gen: torch.Generator, in_dim: int,
                     hidden: tuple[int, ...] = (64, 64), lr: float = 1e-3,
                     device="cpu") -> tuple[TrainState, torch.optim.AdamW]:
    params = init_mlp(gen, in_dim, hidden, device=device)
    flat = _flat(params)
    state = TrainState(params, AdamWState(
        tuple(torch.zeros_like(p) for p in flat),
        tuple(torch.zeros_like(p) for p in flat)),
        torch.zeros((), dtype=torch.int32, device=device))
    return state, make_optimizer(state, lr)


def train_step(opt: torch.optim.AdamW, state: TrainState, feats: Tensor,
               labels: Tensor) -> tuple[TrainState, Tensor]:
    """One AdamW step on a feature batch; ``opt`` is bound to ``state``
    (:func:`make_optimizer`).  Returns the state (parameters and moments
    updated in place, the step counted) and the loss before the step."""
    if opt.param_groups[0]["params"][0] is not state.params.weights[0]:
        raise ValueError("train_step: the optimizer is bound to another "
                         "state (make_optimizer(state))")
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(state.params, feats, labels)
    loss.backward()
    opt.step()
    return state._replace(step=state.step + 1), loss.detach()


def save_predictor(path: str, params: MLPParams, norm: dict) -> str:
    """Write the inference head as one npz: ``w_i``, ``b_i`` and the
    standardization constants ``f_mu``, ``f_sd``, ``l_mu``, ``l_sd`` (the
    reference package's keys: a file written by either package loads in
    the other).  Returns the path written."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def host(t):
        return (t.detach().cpu().numpy() if isinstance(t, Tensor)
                else np.asarray(t))
    arrays = {f"w_{i}": host(w) for i, w in enumerate(params.weights)}
    arrays |= {f"b_{i}": host(b) for i, b in enumerate(params.biases)}
    arrays |= {k: host(v) for k, v in norm.items()}
    np.savez(path, **arrays)
    return path if path.endswith(".npz") else path + ".npz"


class BPPredictor:
    """The blood-pressure head on the host, in numpy, over the HUD vitals
    (mean BPM per ROI, mean PTT per pair).  Returns mmHg ``[..., 2]``
    (SBP, DBP); a row with no finite vital gives NaN, as unsettled vitals
    show "NaN" on the HUD.  The wrong vital count raises ``ValueError``."""

    def __init__(self, weights, biases, f_mu, f_sd, l_mu, l_sd):
        self.weights = [np.asarray(w, np.float32) for w in weights]
        self.biases = [np.asarray(b, np.float32) for b in biases]
        self.f_mu = np.asarray(f_mu, np.float32)
        self.f_sd = np.asarray(f_sd, np.float32)
        self.l_mu = np.asarray(l_mu, np.float32)
        self.l_sd = np.asarray(l_sd, np.float32)
        self.in_dim = self.weights[0].shape[0]

    def __call__(self, bpm, ptt):
        bpm = np.atleast_1d(np.asarray(bpm, np.float32))
        ptt = np.atleast_1d(np.asarray(ptt, np.float32))
        feats = np.concatenate([bpm, ptt], axis=-1)
        valid = np.isfinite(feats)
        x = np.concatenate([np.where(valid, feats, 0.0),
                            valid.astype(np.float32)], axis=-1)
        if x.shape[-1] != self.in_dim:
            raise ValueError(
                f"predictor expects {self.in_dim // 2} vitals (trained on "
                f"that many BPM+PTT columns), got {x.shape[-1] // 2}")
        h = (x - self.f_mu) / self.f_sd
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = h @ w + b
            if i < n - 1:
                # GELU's tanh form, as mlp_apply computes it.
                h = 0.5 * h * (1.0 + np.tanh(
                    np.sqrt(2.0 / np.pi) * (h + 0.044715 * h ** 3)))
        pred = h * self.l_sd + self.l_mu
        none_valid = ~valid.any(axis=-1, keepdims=True)
        return np.where(none_valid, np.nan, pred)


def load_predictor(path: str) -> BPPredictor:
    """A :func:`save_predictor` file (of either package) as a host head."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        n_layers = sum(1 for k in data.files if k.startswith("w_"))
        return BPPredictor([data[f"w_{i}"] for i in range(n_layers)],
                           [data[f"b_{i}"] for i in range(n_layers)],
                           data["f_mu"], data["f_sd"], data["l_mu"],
                           data["l_sd"])


def make_e2e_train_step(engine_step: Callable, opt: torch.optim.AdamW,
                        norm: dict | None = None) -> Callable:
    """End-to-end training step: frames -> engine (vision models, DSP,
    spectra, PTT) -> features -> head update.

    ``engine_step(engine_params, engine_state, frames [S, ...], ts [S])
    -> (engine_state, StepOutputs)`` is ``MultiStreamEngine.step`` (=
    ``Engine.batch_step``).  It runs under ``torch.no_grad()``, through its
    kernels as at inference: the gradient reaches the head only.  ``norm``
    ({"f_mu", "f_sd", "l_mu", "l_sd"}, tensors on the head's device)
    standardizes features and labels before the update.

    Returns ``step(engine_params, engine_state, train_state, frames, ts,
    labels) -> (engine_state, train_state, loss)``."""
    def step(engine_params, engine_state, train_state: TrainState,
             frames: Tensor, timestamps: Tensor, labels: Tensor):
        with torch.no_grad():
            engine_state, out = engine_step(engine_params, engine_state,
                                            frames, timestamps)
            feats = features_from_outputs(out.bpm, out.ptt)
        feats = feats.detach()
        if norm is not None:
            feats = (feats - norm["f_mu"]) / norm["f_sd"]
            labels = (labels - norm["l_mu"]) / norm["l_sd"]
        train_state, loss = train_step(opt, train_state, feats, labels)
        return engine_state, train_state, loss

    return step

