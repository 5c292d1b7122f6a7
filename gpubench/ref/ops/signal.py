"""Fixed-shape, NaN-masked signal ring buffers — the PyTorch counterpart of
``bp_from_video_tpu/ops/signal.py`` (reference signal_data.py:12-117).

A "signal" is a pair of tensors ``(x, y)`` NaN-prefilled to capacity;
validity is re-derived from finiteness.  Where the JAX module puts time on
axis 0 and ``vmap``s over signals and streams, every function here takes
explicit leading batch dimensions and keeps TIME ON THE LAST AXIS (for
per-sample vectors, such as the ROI ring's 6-tuples, time is axis -2 and
the vector is the last axis — pass ``vec=True``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor
_NAN = float("nan")
_INF = float("inf")


def push(ring: Tensor, new: Tensor, dim: int = -1) -> Tensor:
    """Ring push along ``dim``: drop the oldest sample, append ``new``
    (``new`` has ``ring``'s shape without ``dim``)."""
    n = ring.shape[dim]
    return torch.cat([ring.narrow(dim, 1, n - 1), new.unsqueeze(dim)], dim)


def push_if(cond: Tensor, ring: Tensor, new: Tensor, dim: int = -1
            ) -> Tensor:
    """``push`` gated per leading batch entry: where ``cond`` (shape = the
    ring's leading batch dims) is false the ring passes through unchanged
    (stale-resend suppression, see the JAX ``push_if``)."""
    c = cond.reshape(cond.shape + (1,) * (ring.ndim - cond.ndim))
    return torch.where(c, push(ring, new, dim), ring)


def valid_x(x: Tensor) -> Tensor:
    """The ``v`` mask: finite timestamps."""
    return torch.isfinite(x)


def valid_y(y: Tensor, vec: bool = False) -> Tensor:
    """The ``w`` mask: finite values; rows-all-finite for per-sample
    vectors (``vec=True``: the vector is the last axis)."""
    w = torch.isfinite(y)
    return w.all(-1) if vec else w


def masked_minmax(a: Tensor, mask: Tensor) -> tuple[Tensor, Tensor]:
    """(nanmin, nanmax) over the masked last axis; NaN when fewer than two
    valid entries."""
    lo = torch.where(mask, a, _INF).amin(-1)
    hi = torch.where(mask, a, -_INF).amax(-1)
    ok = mask.sum(-1) >= 2
    return torch.where(ok, lo, _NAN), torch.where(ok, hi, _NAN)


def mean_fs(x: Tensor, w: Tensor | None = None) -> Tensor:
    """Mean sampling frequency 1/mean(dx over consecutive valid pairs);
    NaN when fewer than two valid samples."""
    u = valid_x(x) if w is None else w
    dx = x[..., 1:] - x[..., :-1]
    pair = u[..., 1:] & u[..., :-1]
    cnt = pair.sum(-1).clamp(min=1)
    mean_dx = torch.where(pair, dx, 0.0).sum(-1) / cnt
    return torch.where(u.sum(-1) >= 2, 1.0 / mean_dx, _NAN)


def masked_mean(y: Tensor, as_int: bool = False, vec: bool = False
                ) -> Tensor:
    """NaN-mean over time, falling back to the newest sample when nothing
    is valid; ``as_int`` rounds (half to even) when some sample is valid."""
    w = valid_y(y, vec)
    any_valid = w.any(-1)
    cnt = w.sum(-1).clamp(min=1)
    if vec:
        mean = torch.where(w[..., None], y, 0.0).sum(-2) / cnt[..., None]
        any_valid = any_valid[..., None]
        last = y[..., -1, :]
    else:
        mean = torch.where(w, y, 0.0).sum(-1) / cnt
        last = y[..., -1]
    out = torch.where(any_valid, mean, last)
    if as_int:
        out = torch.where(any_valid, torch.round(out), out)
    return out


def peak(x: Tensor, y: Tensor, min_x, max_x) -> tuple[Tensor, Tensor]:
    """Arg-max of ``y`` restricted to ``min_x <= x <= max_x`` and valid y
    (first index on ties, like ``jnp.argmax``); NaN when fewer than two
    in-window valid samples."""
    if isinstance(min_x, Tensor):
        min_x = min_x[..., None]
    if isinstance(max_x, Tensor):
        max_x = max_x[..., None]
    u = (x >= min_x) & (x <= max_x) & valid_y(y)
    ok = u.sum(-1) >= 2
    i = torch.argmax(torch.where(u, y, -_INF), dim=-1, keepdim=True)
    px = torch.gather(x, -1, i)[..., 0]
    py = torch.gather(y, -1, i)[..., 0]
    return torch.where(ok, px, _NAN), torch.where(ok, py, _NAN)


def peak_auto(x: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    """``peak`` over the signal's own auto x-range (the reference's
    effective default: its group constructor clobbers set_range)."""
    lo, hi = masked_minmax(x, valid_x(x))
    return peak(x, y, lo, hi)


def auto_range(x: Tensor, y: Tensor
               ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """(min_x, max_x, min_y, max_y) auto data ranges."""
    lo_x, hi_x = masked_minmax(x, valid_x(x))
    lo_y, hi_y = masked_minmax(y, valid_y(y))
    return lo_x, hi_x, lo_y, hi_y


def group_range(los: Tensor, his: Tensor) -> tuple[Tensor, Tensor]:
    """Joint range over the last (signal) axis: NaN unless every signal has
    at least one finite bound."""
    ok = (torch.isfinite(los) | torch.isfinite(his)).all(-1)
    lo = torch.where(torch.isfinite(los), los, _INF).amin(-1)
    hi = torch.where(torch.isfinite(his), his, -_INF).amax(-1)
    return torch.where(ok, lo, _NAN), torch.where(ok, hi, _NAN)


class Compacted(NamedTuple):
    """Valid samples moved (stably) to the front of the last axis;
    ``count`` valid leading entries, ``fill`` beyond."""

    values: Tensor
    count: Tensor


def _front_perm(mask: Tensor) -> Tensor:
    """perm[..., i] = original index of front slot i (stable)."""
    return torch.argsort((~mask).to(torch.int32), dim=-1, stable=True)


def compact(mask: Tensor, values: Tensor, fill: float = 0.0) -> Compacted:
    """Stable-move masked entries of ``values`` to the front."""
    out = torch.gather(values, -1, _front_perm(mask))
    count = mask.sum(-1)
    slot = torch.arange(mask.shape[-1], device=mask.device)
    out = torch.where(slot < count[..., None], out, fill)
    return Compacted(out, count)


def scatter_back(mask: Tensor, compacted: Tensor, original: Tensor
                 ) -> Tensor:
    """Inverse of :func:`compact`: write compacted values back into the
    masked slots of ``original``."""
    aligned = torch.empty_like(compacted).scatter_(
        -1, _front_perm(mask), compacted)
    return torch.where(mask, aligned, original)


def take_at(values: Tensor, i: int, count: Tensor) -> Tensor:
    """``values[..., i]`` with negative-from-count semantics (``i=-1`` is
    the last valid entry); out-of-range indices wrap once then clamp, like
    JAX's dynamic indexing."""
    n = values.shape[-1]
    idx = count + i if i < 0 else torch.full_like(count, i)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return torch.gather(values, -1, idx[..., None].to(torch.int64))[..., 0]
