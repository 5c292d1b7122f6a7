"""Building the system under test (the port) and its reference from one
configuration file and ``--seed``.

The port is driven through ``MultiStreamEngine`` (``mesh=None``); its
runner takes the seeded compiled face mesh through ``Engine(graphs=...)``,
handed in by wrapping the ``Engine`` that ``parallel/streams.py`` builds
(the pattern the repository's parity tests use), and the seeded hand
stand-in through ``hand_lm_standin_path``.  The reference is the frozen
plain copy under ``gpubench/ref`` in float32 with every kernel route off,
built from the same graph and the same stand-in file; the control is that
reference again, run a step below the stated precisions
(``gpubench.precision``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import types

import torch

from gpubench import nets
from gpubench.precision import Rounding


def engine_config(config_mod, spec: dict, **infer):
    """An ``EngineConfig`` from ``config_mod`` (the port's or the
    reference's ``config``) as the configuration file's ``engine`` entry
    names it, with ``infer`` overrides of its ``InferenceConfig``."""
    e = spec["engine"]
    if e["factory"] != "flagship_config":
        raise ValueError(f"unknown engine factory {e['factory']!r}")
    cfg = config_mod.flagship_config(e["streams"], e["height"], e["width"])
    over = dict(e.get("inference", {}), **infer)
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, **over))
    if "compute_dtype" in e:
        cfg = dataclasses.replace(cfg, compute_dtype=e["compute_dtype"])
    return cfg


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""

    graphs: dict          # {runner key: Graph} (raw, numpy weights)
    standin_path: str     # the hand stand-in's npz

    def close(self) -> None:
        """Remove the stand-in's file."""
        if os.path.exists(self.standin_path):
            os.remove(self.standin_path)


def make_inputs(spec: dict, scene: str, seed: int, workdir: str) -> Inputs:
    e = spec["engine"]
    crops = nets.calibration_crops(scene, e["height"], e["width"], seed)
    path = os.path.join(workdir, f"hand_lm-{seed}-{os.getpid()}.npz")
    nets.save_standin(nets.hand_standin(seed, crops["hand_lm"]), path,
                      nets.HAND_SIZE, nets.HAND_LANDMARKS)
    return Inputs(nets.graphs_for(spec["nets"], seed, crops), path)


def build_port(spec: dict, inputs: Inputs, device):
    """(MultiStreamEngine, its config) of the port."""
    from bp_from_video_tpu_torch import config as port_config
    from bp_from_video_tpu_torch.parallel import streams
    cfg = engine_config(port_config, spec,
                        hand_lm_standin_path=inputs.standin_path)
    engine_cls = streams.Engine
    streams.Engine = functools.partial(
        engine_cls, graphs=nets.copy_graphs(inputs.graphs))
    try:
        ms = streams.MultiStreamEngine(cfg, device=device)
    finally:
        streams.Engine = engine_cls
    return ms, cfg


def reference_config(spec: dict, inputs: Inputs):
    from gpubench.ref import config as ref_config
    cfg = engine_config(
        ref_config, spec, use_pallas=False, fused_stem=False,
        fused_trunk=False, fuse_dw_pw=False, pack_s2d=0,
        hand_lm_standin_path=inputs.standin_path, face_detector_path=None,
        face_landmarker_path=None, hand_landmarker_path=None,
        palm_det_standin_path=None)
    return dataclasses.replace(cfg, compute_dtype="float32")


def build_reference(spec: dict, inputs: Inputs, device):
    """The reference ``Engine`` in float32, TF32 off, plain routes."""
    from gpubench.ref.runtime.engine import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reference_config(spec, inputs)
    return Engine(cfg, device=device, graphs=nets.copy_graphs(inputs.graphs))


def engine_step(engine, state, frames, ts):
    """One call of the reference ``engine``: ``batch_step``, or
    ``batch_step_lagged`` for timestamps [F, S]."""
    if ts.ndim == 2:
        return engine.batch_step_lagged(engine.params, state, frames, ts)
    return engine.batch_step(engine.params, state, frames, ts)


class Control:
    """The reference in the port's place a step below the configuration's
    precisions: the nets (bf16 stated) in fp8; the DSP's products and
    convolutions (f32, TF32 off) in TF32; ROI sampling, peak picking and
    ring means (other f32) in bf16.  Crop and tracking geometry stay f32.
    ``step`` gives what the port's would."""

    def __init__(self, spec: dict, inputs: Inputs, device):
        from gpubench.ref.ops import roi as roi_ops
        from gpubench.ref.ops import signal as sig
        from gpubench.ref.runtime import engine as engine_mod
        self.engine = build_reference(spec, inputs, device)
        self.mode = Rounding()
        run = self.engine.runner
        at = self.mode.at

        def under(prec, fn):
            @functools.wraps(fn)
            def wrapped(*a, **k):
                with at(prec):
                    return fn(*a, **k)
            return wrapped
        run._landmarks = under("fp8", run._landmarks)
        self.engine.signal_analyze = under("tf32", self.engine.signal_analyze)
        self._engine_mod = engine_mod
        self._sig = types.SimpleNamespace(**{
            k: getattr(sig, k) for k in dir(sig) if not k.startswith("__")})
        self._sig.peak_auto = under("bf16", sig.peak_auto)
        self._sig.masked_mean = under("bf16", sig.masked_mean)
        self._roi = types.SimpleNamespace(**{
            k: getattr(roi_ops, k) for k in dir(roi_ops)
            if not k.startswith("__")})
        self._roi.sample_rois_batch = under("bf16", roi_ops.sample_rois_batch)

    @contextlib.contextmanager
    def _patched(self):
        mod = self._engine_mod
        saved = (mod.sig, mod.roi_ops)
        mod.sig, mod.roi_ops = self._sig, self._roi
        try:
            with self.mode:
                yield
        finally:
            mod.sig, mod.roi_ops = saved

    def step(self, state, frames, ts):
        with self._patched():
            return engine_step(self.engine, state, frames, ts)
