"""Small real DFTs as matmuls — the counterpart of
``bp_from_video_tpu/ops/dft.py``.

Signatures mirror ``torch.fft.rfft`` / ``irfft`` over the last axis.  The
bases are built exactly as the JAX module builds them (angle reduced mod n
on exact int32 products, then one f32 multiply, then cos/sin), and cached
per (size, device), so the spectra agree with the reference to f32 roundoff.
The contractions are plain f32 matmuls: the package never enables TF32, and
callers measuring on the card keep ``torch.backends.cuda.matmul.allow_tf32``
False (the default).
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

_MAX_N = 46340  # (r*c) must stay exact in int32
_CACHE: dict = {}


def _angles(rows: int, cols: int, n: int, device) -> Tensor:
    """2*pi*(r*c mod n)/n as an [rows, cols] f32 tensor."""
    assert n <= _MAX_N, f"DFT size {n} overflows int32 angle reduction"
    r = torch.arange(rows, dtype=torch.int32, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int32, device=device)[None, :]
    m = (r * c) % n
    return torch.tensor(2.0 * math.pi / n, dtype=torch.float32,
                        device=device) * m.to(torch.float32)


def _rfft_mats(n: int, rows: int, device) -> tuple[Tensor, Tensor]:
    key = ("rfft", n, rows, str(device))
    if key not in _CACHE:
        ang = _angles(rows, n // 2 + 1, n, device)
        _CACHE[key] = (torch.cos(ang), -torch.sin(ang))
    return _CACHE[key]


def _irfft_mats(n: int, out_len: int, device) -> tuple[Tensor, Tensor]:
    key = ("irfft", n, out_len, str(device))
    if key not in _CACHE:
        nf = n // 2 + 1
        ang = _angles(nf, out_len, n, device)
        w = torch.full((nf, 1), 2.0, dtype=torch.float32, device=device)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        # Divided by a tensor: CUDA turns a division by a Python scalar into
        # a multiplication by its reciprocal, an ulp off the IEEE quotient.
        nt = torch.full((), float(n), dtype=torch.float32, device=device)
        _CACHE[key] = (w * torch.cos(ang) / nt, -w * torch.sin(ang) / nt)
    return _CACHE[key]


def rfft(x: Tensor, n: int) -> Tensor:
    """``rfft(x, n)`` of real ``x`` over the last axis (complex64);
    shorter inputs contract against only their own basis rows."""
    ln = x.shape[-1]
    if ln > n:
        x = x[..., :n]
        ln = n
    c, s = _rfft_mats(n, ln, x.device)
    x = x.to(torch.float32)
    return torch.complex(x @ c, x @ s)


def irfft(y: Tensor, n: int, out_len: int | None = None) -> Tensor:
    """``irfft(y, n)[..., :out_len]`` over the last axis (f32)."""
    c, s = _irfft_mats(n, n if out_len is None else out_len, y.device)
    return y.real.to(torch.float32) @ c + y.imag.to(torch.float32) @ s
