"""Lower precisions for the control: the reference computed a step below
what the configuration states, emulated in float32 by a function mode.

- ``fp8``: every operation's floating inputs and outputs rounded to 3
  mantissa bits (e4m3's mantissa, without its range limit): the nets,
  whose configuration states bfloat16.
- ``tf32``: the inputs of matrix products and convolutions rounded to 10
  mantissa bits, outputs left in float32: the float32 stages the port runs
  with TF32 off (DSP transforms, filters, spectra, correlation).
- ``bf16``: every operation's floating outputs rounded to 7 mantissa bits:
  the other float32 stages (ROI sampling, peak picking and ring means).

Outputs that are views of an input are left alone (nothing was computed,
and a caller may write through them).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

BITS = {"fp8": 3, "bf16": 7, "tf32": 10}
_PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.bmm, torch.einsum,
             F.linear, F.conv1d, F.conv2d, F.conv_transpose2d, torch.addmm,
             torch.baddbmm}


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded to ``bits`` mantissa bits (ties to even), exponent
    range unlimited; non-finite values pass."""
    m, e = torch.frexp(x)
    scale = float(2 ** (bits + 1))
    return torch.ldexp(torch.round(m * scale) / scale, e)


def _is_float(t) -> bool:
    return isinstance(t, torch.Tensor) and t.dtype in (
        torch.float32, torch.float64, torch.bfloat16, torch.float16)


class Rounding(TorchFunctionMode):
    """A function mode whose rounding is set by :meth:`at`: a stack of
    precisions, ``None`` at the bottom (no rounding)."""

    def __init__(self):
        super().__init__()
        self.stack: list[str | None] = [None]

    @contextlib.contextmanager
    def at(self, precision: str | None):
        self.stack.append(precision)
        try:
            yield
        finally:
            self.stack.pop()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        prec = self.stack[-1]
        if prec is None:
            return func(*args, **kwargs)
        bits = BITS[prec]

        def rnd(a):
            return round_mantissa(a, bits) if _is_float(a) else a
        if func in _PRODUCTS or prec == "fp8":
            args = tuple(rnd(a) if _is_float(a) else
                         (type(a)(rnd(b) for b in a)
                          if isinstance(a, (list, tuple)) else a)
                         for a in args)
            kwargs = {k: rnd(v) for k, v in kwargs.items()}
        out = func(*args, **kwargs)
        if prec == "tf32":
            return out
        ins = [a for a in args if isinstance(a, torch.Tensor)]

        def rnd_out(o):
            if not _is_float(o):
                return o
            if any(o.untyped_storage().data_ptr()
                   == a.untyped_storage().data_ptr() for a in ins):
                return o
            return round_mantissa(o, bits)
        if isinstance(out, torch.Tensor):
            return rnd_out(out)
        if isinstance(out, tuple) and not hasattr(out, "_fields"):
            return tuple(rnd_out(o) for o in out)
        return out
