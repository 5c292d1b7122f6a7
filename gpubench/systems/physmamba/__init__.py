"""The physmamba system: ``bp_from_video_tpu_torch`` built with
``config.physmamba_config`` (the face mesh keeps the face rect, K1 crops it
at 128 into each stream's clip ring, PhysMamba turns a full ring into the
stream's BVP, the signal half reads BPM from it), driven through
``MultiStreamEngine`` (``Engine.batch_step_lagged`` for F > 1 frames a
call), judged by the plain reference beside this file (``ref.py``).

Everything but the net is the physformer system's (``systems/physformer``):
the face mesh and the tracked start, the clip ring and its judge, the
planted fault (a stale ring), the DSP.  The net's weights and BatchNorm
statistics are drawn from the seed (``ref.init_params``).  The numbers
judged are the physformer system's: ``face_lm_gap_px``, ``rect_gap_px``,
``crop_gap``, ``bvp_gap`` (the reference PhysMamba's BVP of the port's
clips against the raw ring the port pushed), ``proc_gap``, ``spec_gap``
and ``own_crop_gap``.

The control is the reference a step below the stated precisions: the face
mesh and PhysMamba's bf16 layers in fp8, its float32 selective scan in
bf16, the crop's operands in e4m3, the DSP's products in TF32.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gpubench import counts, nets
from gpubench.precision import Rounding
from gpubench.systems import physformer

from . import ref as ref_mod

TRAFFIC_KEYS: tuple[str, ...] = ()

start_state = physformer.start_state
ref_start_state = physformer.ref_start_state
same_start = physformer.same_start
call = physformer.call
launch_counts = physformer.launch_counts
limits = physformer.limits
judge = physformer.judge
judge_own = physformer.judge_own
faults = physformer.faults
batch_of = physformer.batch_of
tracked = physformer.tracked


@dataclasses.dataclass
class Inputs:
    """The seeded face mesh and PhysMamba weights, handed to both sides."""

    graphs: dict      # {"flm_lm": Graph}
    params: dict      # the net's unfolded weights, f32 on the CPU

    def close(self) -> None:
        pass


def make_inputs(spec: dict, traffic, seed: int, workdir: str) -> Inputs:
    e = spec["engine"]
    crops = nets.calibration_crops(traffic.scene, e["height"], e["width"],
                                   seed)
    return Inputs(nets.graphs_for(spec["nets"], seed, crops),
                  ref_mod.init_params(spec["net"], nets.sub_seed(seed, 21)))


def _to(params: dict, device) -> dict:
    return ref_mod.pf_ref._map(lambda t: t.to(device), params)


def build_port(spec: dict, inputs: Inputs, device):
    """(MultiStreamEngine, its config) of the port."""
    from bp_from_video_tpu_torch import config as port_config
    from bp_from_video_tpu_torch.parallel import streams
    e = spec["engine"]
    cfg = port_config.physmamba_config(
        e["streams"], e["height"], e["width"],
        port_config.PhysMambaConfig(**spec["net"]))
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, **e.get("inference", {})))
    if "compute_dtype" in e:
        cfg = dataclasses.replace(cfg, compute_dtype=e["compute_dtype"])
    engine_cls = streams.Engine
    streams.Engine = functools.partial(
        engine_cls, graphs=nets.copy_graphs(inputs.graphs),
        rppg_params=_to(inputs.params, device))
    try:
        ms = streams.MultiStreamEngine(cfg, device=device)
    finally:
        streams.Engine = engine_cls
    return ms, cfg


def build_reference(spec: dict, inputs: Inputs, device):
    """The reference in float32, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e = spec["engine"]
    return ref_mod.Reference(spec["net"], _to(inputs.params, device),
                             nets.copy_graphs(inputs.graphs)["flm_lm"],
                             e["height"], e["width"], device)


def ref_step(ref, state, frames, ts):
    return ref.step(state, frames, ts)


class Control(physformer.Control):
    """The reference in the port's place a step below the configuration's
    precisions (the module's docstring); ``step`` as the physformer
    system's control."""

    def __init__(self, spec: dict, inputs: Inputs, device):
        self.ref = build_reference(spec, inputs, device)
        self.mode = Rounding()
        at = self.mode.at

        def under(prec, fn):
            @functools.wraps(fn)
            def wrapped(*a, **k):
                with at(prec):
                    return fn(*a, **k)
            return wrapped
        r = self.ref
        r.tracker._landmarks = under("fp8", r.tracker._landmarks)
        r.crops = functools.partial(r.crops, dtype=torch.float8_e4m3fn)
        r.scan = under("bf16", ref_mod.selective_scan)
        r.bvp = under("fp8", r.bvp)
        r.analyze = under("tf32", r.analyze)


control = Control


# -- counts -------------------------------------------------------------------


def stem_layer(b: int, cin: int, cout: int, kt: int, k: int, t: int, hw: int,
               stride: int, pool: int) -> tuple[float, float]:
    """(operations, bytes) of one stem or split layer over ``b`` clips: a
    kt x k x k conv of ``cin`` -> ``cout`` at ``t`` frames of ``hw``
    squared (padding keeps the size; temporal stride ``stride``), then
    with ``pool`` the 1x2x2 max-pool; bf16 input read once, the (pooled)
    output written once, weights read once."""
    t_out = t // stride
    hw_out = hw // 2 if pool else hw
    flops = 2.0 * b * t_out * hw * hw * cout * cin * kt * k * k
    nbytes = (b * t * hw * hw * cin + b * t_out * hw_out * hw_out * cout
              + cout * cin * kt * k * k + cout) * counts.BF16
    return flops, nbytes


def scan(b: int, tokens: int, d_inner: int, d_state: int
         ) -> tuple[float, float]:
    """(operations, bytes) of one bidirectional selective scan over ``b``
    clips of ``tokens`` tokens.  Bytes: each direction's v, delta, B and C
    and the shared z read once, y written once, in the compute dtype
    (bf16).  Operations: each direction's d_inner x d_state state updates
    a token at 6 each (the exp, the decay's multiply, the update's and the
    output's multiply-adds), on float32 units: returned scaled to the bf16
    tensor peak that ``counts.bound_s`` divides by, so that they bound at
    67 TFLOP/s."""
    nbytes = b * tokens * (6 * d_inner + 4 * d_state) * counts.BF16
    ops = 2 * 6.0 * b * tokens * d_inner * d_state
    return ops * counts.BF16_TENSOR_FLOPS / counts.F32_FLOPS, nbytes


KERNELS = {"pm_stem": stem_layer, "pm_scan": scan}


def net_ops(net: dict) -> float:
    """PhysMamba's operations for one clip (2 a multiply-add), counted
    from its architecture: the stem and split convs, each block's
    ``CDC_T`` conv, Mamba projections, depthwise convs and scan (6 an
    update and direction), the laterals and the head.  LayerNorms,
    poolings and the channel attention are left out (under 0.1 %)."""
    t, c = net["clip_frames"], net["crop"]
    s, f, n, hd = (net["slow_dim"], net["fast_dim"], net["d_state"],
                   net["head_dim"])
    g = c // 4
    ops = 2.0 * t * (c * c * 16 * 3 * 25 + g * g * 4 * (32 * 16 * 27
                                                         + s * 32 * 27))
    ops += 2.0 * g * g * (t // 4 * s * s * 4 + t // 2 * f * s * 2)
    for dim, frames in ((s, t // 4), (f, t // 2)):
        e, r = net["expand"] * dim, -(-dim // 16)
        for i in range(3):
            tok = frames * (g >> i) ** 2
            ops += 2.0 * tok * (dim * dim * 27 + dim * 2 * e + e * dim)
            ops += 2 * 2.0 * tok * (e * net["d_conv"] + e * (r + 2 * n)
                                    + r * e)
            ops += 2 * 6.0 * tok * e * n
    ops += 2.0 * (t // 4) * ((g >> 1) ** 2 + (g >> 2) ** 2) * s * f * 3
    h2 = (g >> 2) ** 2
    ops += 2.0 * h2 * (t // 2 * (f * f * 3 + hd * s * 3)
                       + t * hd * (f + hd) * 3)
    return ops + 2.0 * t * hd


def net_flops(ref, spec: dict, traffic, cfg) -> float:
    """PhysMamba's operations a call: :func:`net_ops` for every clip the
    call runs."""
    return physformer.clips_per_call(cfg, traffic) * net_ops(spec["net"])
