"""The flagship system: ``bp_from_video_tpu_torch``'s ``MultiStreamEngine``
(``mesh=None``; ``Engine.batch_step_lagged`` for F > 1 frames a call) with
the seeded face mesh and hand stand-in (``gpubench/nets.py``,
``gpubench/system.py``), judged stage by stage and on a run of its own by
the frozen plain reference under ``gpubench/ref`` (``gpubench/check.py``),
its control a step below the stated precisions
(``gpubench/precision.py``), its nets and kernels counted by
``gpubench/counts.py``.  This module binds them to the interface of
``gpubench.systems``."""

from __future__ import annotations

import dataclasses

import torch

from gpubench import check, counts, system
from gpubench import traffic as traffic_mod

TRAFFIC_KEYS: tuple[str, ...] = ()
KERNELS = counts.KERNELS

build_port = system.build_port
build_reference = system.build_reference
ref_step = system.engine_step
judge = check.judge
judge_own = check.judge_own
control = system.Control


def make_inputs(spec: dict, traffic, seed: int, workdir: str
                ) -> system.Inputs:
    return system.make_inputs(spec, traffic.scene, seed, workdir)


def _tracked_start(init_state, cfg, traffic, device):
    """``init_state`` with the mix's tracked streams started on the face
    and hands (``traffic.tracked_state``)."""
    tracked = traffic_mod.tracked_mask(traffic, cfg.num_streams, device)
    return traffic_mod.tracked_state(init_state, cfg.frame_height,
                                     cfg.frame_width, tracked)


def start_state(port, cfg, traffic, device):
    return _tracked_start(port.init_states(), cfg, traffic, device)


def ref_start_state(ref, cfg, traffic, device):
    return _tracked_start(ref.init_state(cfg.num_streams), cfg, traffic,
                          device)


def same_start(ref_state, port_state) -> bool:
    """The port's starting state equals the reference's built alike."""
    from gpubench.ref.models.runner import tree_leaves
    a, b = tree_leaves(ref_state), tree_leaves(port_state)
    return len(a) == len(b) and all(
        x.shape == y.shape and bool(torch.equal(
            torch.nan_to_num(x.double(), nan=-7.0),
            torch.nan_to_num(y.double(), nan=-7.0))) for x, y in zip(a, b))


def call(port, state, frames, ts):
    """``MultiStreamEngine.step`` (timestamps [S]) or the engine's
    ``batch_step_lagged`` (timestamps [F, S]), then BPM and PTT read back
    to the host."""
    if ts.ndim == 1:
        state, out = port.step(port.params, state, frames, ts)
    else:
        state, out = port.engine.batch_step_lagged(port.params, state,
                                                   frames, ts)
    host = torch.cat([out.bpm.reshape(-1).float(),
                      out.ptt.reshape(-1).float()]).cpu()
    return state, out, host


def limits(spec: dict, traffic) -> dict:
    """The configuration's limits; ``frame_sample_gap`` only where a call
    holds several frames."""
    lim = dict(spec["limits"])
    if traffic.frames_per_call == 1:
        lim.pop("frame_sample_gap", None)
    return lim


def faults(ref, checked: list, traffic) -> dict | None:
    """A lagged call that pushes frame F - 1's samples for every frame: the
    port's checked calls with that fault planted in their pushed rings,
    judged; None for one frame a call."""
    f_n = traffic.frames_per_call
    if f_n == 1:
        return None
    readings = []
    for c in checked:
        sig = c.state_out.signals
        raw = sig.raw_y.clone()
        raw[..., -f_n:] = raw[..., -1:]
        st = c.state_out._replace(signals=sig._replace(raw_y=raw))
        readings.append(check.judge(ref, dataclasses.replace(
            c, state_out=st)))
    return check.worst(readings)


def net_flops(ref, spec: dict, traffic, cfg) -> float:
    """The nets' operations a call: each net of ``mfu_crops`` times its
    crops a stream-frame, the streams and the frames a call."""
    per = cfg.num_streams * traffic.frames_per_call
    return counts.net_flops(ref, {k: per * v for k, v in
                                  spec.get("mfu_crops", {}).items()})


def batch_of(net: str, cfg, traffic) -> int:
    return counts.crops_per_call(net, cfg.num_streams,
                                 traffic.frames_per_call,
                                 cfg.inference.max_hands)


def launch_counts() -> dict:
    from bp_from_video_tpu_torch.kernels import block, bottleneck, roi, stem, warp
    fns = {"multi_crop": warp.multi_crop, "stem_packed": stem.stem_packed,
           "dense_s2_block": block.dense_s2_block,
           "roi_samples": roi.roi_samples, "roi_sums": roi.roi_sums,
           "bottleneck_s1": bottleneck.bottleneck_s1,
           "bottleneck_chain": bottleneck.bottleneck_chain}
    return {k: getattr(fn, "launches", 0) for k, fn in fns.items()}


def tracked(state) -> tuple[int, int]:
    """(tracked face slots, tracked hand slots)."""
    return (int(state.track.face_tracking.sum()),
            int(state.track.hand_tracking.sum()))
