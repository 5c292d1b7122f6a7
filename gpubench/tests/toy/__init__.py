"""A toy system for the harness's CPU tests, written to the interface of
``gpubench.systems`` and installed there by copying this folder: its port
(``port.py``) and its plain reference (``ref.py``) share no code, and its
traffic mixes carry a key of its own, ``ring_frames``.  Compared, with
the limits the configuration file gives: ``value_gap``, ``ring_gap``,
``mean_gap`` of each checked call and ``own_ring_gap`` of the reference's
own run, each the largest gap over the largest reference magnitude."""

from __future__ import annotations

import torch

from . import port as port_mod
from . import ref as ref_mod

TRAFFIC_KEYS = ("ring_frames",)


class Inputs:
    def __init__(self, weight: torch.Tensor, readout: torch.Tensor):
        self.weight, self.readout = weight, readout

    def close(self) -> None:
        pass


def make_inputs(spec, traffic, seed, workdir):
    gen = torch.Generator().manual_seed(seed)
    c = spec["engine"]["channels"]
    return Inputs(torch.randn(c, 3, 3, 3, generator=gen) / 27 ** 0.5,
                  torch.randn(c, generator=gen))


def build_port(spec, inputs, device):
    return port_mod.ToyPort(inputs.weight, inputs.readout, device), spec


def start_state(port, cfg, traffic, device):
    return port.init_state(cfg["engine"]["streams"],
                           traffic.params["ring_frames"], device)


def ref_start_state(ref, cfg, traffic, device):
    return ref.init_state(cfg["engine"]["streams"],
                          traffic.params["ring_frames"], device)


def same_start(ref_state, port_state) -> bool:
    return bool(torch.equal(ref_state.ring, port_state.ring))


def call(port, state, frames, ts):
    state, out = port.step(state, frames)
    return state, out, out.value.cpu()


def build_reference(spec, inputs, device):
    return ref_mod.Reference(inputs.weight, inputs.readout, device)


def ref_step(ref, state, frames, ts):
    return ref.step(state, frames, ts)


def limits(spec, traffic):
    return dict(spec["limits"])


def _rel(ref, got) -> float:
    scale = float(ref.abs().max()) or 1.0
    return float((ref.double() - got.double()).abs().max()) / scale


def judge(ref, c):
    st, out = ref.step(c.state_in, c.frames)
    return {"value_gap": _rel(out.value, c.out.value),
            "ring_gap": _rel(st.ring, c.state_out.ring),
            "mean_gap": _rel(out.mean, c.out.mean)}


def judge_own(cfg, ref_state, ref_out, state, out):
    return {"own_ring_gap": _rel(ref_state.ring, state.ring)}


def control(spec, inputs, device):
    return ref_mod.Reference(inputs.weight, inputs.readout, device,
                             dtype=torch.bfloat16)


def faults(ref, checked, traffic):
    return None


def _conv(b: int, cin: int, cout: int, hw: int) -> tuple[float, float]:
    """(operations, bytes) of one 3x3 stride-2 convolution over ``b``
    uint8 frames to ``hw`` squared f32 outputs."""
    flops = 2.0 * b * hw * hw * cout * cin * 9
    return flops, b * cin * (2 * hw + 1) ** 2 + b * hw * hw * cout * 4


KERNELS = {"toy_conv": _conv}


def net_flops(ref, spec, traffic, cfg):
    e = spec["engine"]
    hw = (e["height"] - 3) // 2 + 1
    return _conv(e["streams"] * traffic.frames_per_call, 3, e["channels"],
                 hw)[0]


def batch_of(net, cfg, traffic):
    return cfg["engine"]["streams"] * traffic.frames_per_call


def launch_counts():
    return {"toy_conv": port_mod.conv.launches}


def tracked(state):
    return int(torch.isfinite(state.ring).all(1).sum())
