"""Recording + checkpoint/resume — the counterpart of
``bp_from_video_tpu/runtime/recorder.py``.

  * :class:`SignalRecorder` — appends per-frame physiological outputs
    (timestamps, per-ROI BPM, per-pair PTT, sampling rate) and writes one
    ``.npz``; the offline analog of watching the live HUD.  Takes tensors
    on any device, or numpy.
  * :func:`save_state` / :func:`load_state` — whole-state checkpoints
    (``EngineState`` or any nest of NamedTuples of tensors) in the JAX
    package's npz form: one ``leaf_%06d`` array per leaf, in
    ``models/runner.tree_leaves`` order, the order ``jax.tree`` flattens
    the same structure.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from bp_from_video_tpu_torch.models.runner import map_leaves, tree_leaves


def _np(a) -> np.ndarray:
    """A tensor (any device, any dtype) or array-like as f32 numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.array(a, np.float32)


class SignalRecorder:
    """Accumulate per-frame outputs; ``save()`` writes one npz file."""

    def __init__(self, path: str):
        self.path = path
        self._rows: dict[str, list[np.ndarray]] = {
            "timestamp": [], "bpm": [], "ptt": [], "curr_fs": []}

    def add(self, timestamp, out) -> None:
        """Record one step's compact outputs (StepOutputs or any object with
        .bpm/.ptt/.curr_fs)."""
        self._rows["timestamp"].append(_np(timestamp))
        self._rows["bpm"].append(_np(out.bpm))
        self._rows["ptt"].append(_np(out.ptt))
        self._rows["curr_fs"].append(_np(out.curr_fs))

    def add_clip(self, timestamps, clip_out) -> None:
        """Record a whole offline clip result (parallel.ClipOutputs,
        time-major), stored row-per-step so clips and live ``add`` steps
        mix freely (``save`` stacks uniformly shaped rows)."""
        ts = _np(timestamps)
        bpm, ptt, fs = (_np(clip_out.bpm), _np(clip_out.ptt),
                        _np(clip_out.curr_fs))
        for t in range(ts.shape[0]):
            self._rows["timestamp"].append(ts[t])
            self._rows["bpm"].append(bpm[t])
            self._rows["ptt"].append(ptt[t])
            self._rows["curr_fs"].append(fs[t])

    def __len__(self) -> int:
        return len(self._rows["timestamp"])

    def save(self) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        arrays = {k: np.stack(v) for k, v in self._rows.items() if v}
        np.savez_compressed(self.path, **arrays)
        # np.savez appends '.npz' when the suffix is missing; return the
        # path of the file that actually exists.
        return (self.path if self.path.endswith(".npz")
                else self.path + ".npz")


def _flat_dict(tree: Any) -> dict[str, np.ndarray]:
    """Leaves keyed by zero-padded flatten index (bf16 leaves as f32:
    numpy has no bf16)."""
    out = {}
    for i, leaf in enumerate(tree_leaves(tree)):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        out[f"leaf_{i:06d}"] = t.numpy()
    return out


def save_state(path: str, tree: Any) -> str:
    """Checkpoint a nest of tensors as ``path + ".npz"``; returns the path
    written.  The caller's template supplies the structure on load."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path + ".npz", **_flat_dict(tree))
    return path + ".npz"


def load_state(path: str, template: Any) -> Any:
    """Restore a nest saved by :func:`save_state` (or by the JAX package's
    npz form); ``template`` supplies the structure, dtypes and device."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        arrays = iter([data[f"leaf_{i:06d}"]
                       for i in range(len(tree_leaves(template)))])
    return map_leaves(lambda leaf: torch.from_numpy(next(arrays)).to(
        leaf.device, leaf.dtype), template)
