"""The toy system's program under test: per stream, a seeded 3x3 stride-2
convolution of the frame, ReLU, the spatial mean, a readout to one value,
pushed into a ring of the last values; the output is the value and the
ring's mean."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class State(NamedTuple):
    ring: torch.Tensor        # f32 [S, ring frames]


class Out(NamedTuple):
    value: torch.Tensor       # f32 [S]
    mean: torch.Tensor        # f32 [S]


def conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    conv.launches += 1
    return F.conv2d(x, w, stride=2)


conv.launches = 0


class ToyPort:
    def __init__(self, weight: torch.Tensor, readout: torch.Tensor, device):
        self.weight = weight.to(device)
        self.readout = readout.to(device)

    def init_state(self, streams: int, ring: int, device) -> State:
        return State(torch.zeros(streams, ring, device=device))

    def step(self, state: State, frames: torch.Tensor) -> tuple[State, Out]:
        y = torch.relu(conv(frames.float() / 255.0, self.weight))
        value = y.mean((2, 3)) @ self.readout
        ring = torch.cat([state.ring[:, 1:], value[:, None]], 1)
        return State(ring), Out(value, ring.mean(1))
