"""The toy system's plain reference, which shares no code with its port:
the convolution as patches times weights, in ``dtype`` (float32; the
control runs it in bfloat16)."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class State(NamedTuple):
    ring: torch.Tensor


class Out(NamedTuple):
    value: torch.Tensor
    mean: torch.Tensor


class Reference:
    def __init__(self, weight: torch.Tensor, readout: torch.Tensor, device,
                 dtype=torch.float32):
        self.dtype = dtype
        self.weight = weight.reshape(weight.shape[0], -1).to(device, dtype)
        self.readout = readout.to(device, dtype)

    def value(self, frames: torch.Tensor) -> torch.Tensor:
        """f32 [S]: one value a stream."""
        x = frames.to(self.dtype) / 255
        cols = F.unfold(x, 3, stride=2)                  # [S, 27, L]
        y = (self.weight @ cols).clamp(min=0)            # [S, C, L]
        return (y.mean(-1) @ self.readout).float()

    def init_state(self, streams: int, ring: int, device) -> State:
        return State(torch.zeros(streams, ring, device=device))

    def step(self, state, frames: torch.Tensor, ts=None
             ) -> tuple[State, Out]:
        """One call from ``state`` (anything with a ``ring``)."""
        v = self.value(frames)
        ring = torch.cat([state.ring[:, 1:], v[:, None]], 1)
        return State(ring), Out(v, ring.mean(1))
