"""Tridiagonal solves by parallel cyclic reduction (PCR) — the counterpart
of ``bp_from_video_tpu/ops/tridiag.py``.

A tridiagonal system solves in ``ceil(log2 n)`` elementwise reduction
levels: each level eliminates every row's neighbours at distance ``s``
at once, doubling ``s`` until the system is diagonal.  No pivoting: stable
for the diagonally dominant systems of the DSP (spline slopes).  Batched
over every leading axis; no host sync.

Padding contract: a size-``k`` system embeds in size ``n`` with identity
rows (``a = c = d = 0, b = 1``) beyond ``k``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def pcr_solve(a: Tensor, b: Tensor, c: Tensor, d: Tensor) -> Tensor:
    """Solve ``tridiag(a, b, c) @ x = d`` over the last axis.

    ``a`` = sub-diagonal (``a[..., 0]`` must be 0), ``b`` = diagonal,
    ``c`` = super-diagonal (``c[..., -1]`` must be 0), ``d`` = rhs."""
    n = a.shape[-1]
    s = 1
    while s < n:
        def up(v, fill, s=s):     # v[i-s], ``fill`` out of range
            pad = torch.full(v.shape[:-1] + (s,), fill, dtype=v.dtype,
                             device=v.device)
            return torch.cat([pad, v[..., :-s]], -1)

        def dn(v, fill, s=s):     # v[i+s]
            pad = torch.full(v.shape[:-1] + (s,), fill, dtype=v.dtype,
                             device=v.device)
            return torch.cat([v[..., s:], pad], -1)

        alpha = -a / up(b, 1.0)
        beta = -c / dn(b, 1.0)
        a, b, c, d = (alpha * up(a, 0.0),
                      b + alpha * up(c, 0.0) + beta * dn(a, 0.0),
                      beta * dn(c, 0.0),
                      d + alpha * up(d, 0.0) + beta * dn(d, 0.0))
        s *= 2
    return d / b
