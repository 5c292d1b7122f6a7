"""PhysMamba's forward pass as published, in plain float32 ``torch``: the
reference that ``models/physmamba.py`` is held to.

Luo et al., "PhysMamba: Efficient Remote Physiological Measurement with
SlowFast Temporal Difference Mamba" (arXiv:2409.12031), the ``PhysMamba``
model of rPPG-Toolbox (arXiv:2210.00716, ``neural_methods/model/
PhysMamba.py``), whose ``Mamba`` is Gu and Dao's selective state-space
layer (arXiv:2312.00752) run in both directions as VideoMamba runs it
(``bimamba``: the backward direction on the flipped tokens, its own conv,
projections, ``A_log`` and ``D``, the two outputs summed before
``out_proj``).  Every BatchNorm runs unfolded on its running statistics,
``CDC_T`` as its two convolutions (``conv(x) - theta * conv1x1(x, sum of
the weight's temporal taps 0 and 2)``), the Mamba layer as
``LN2(x + Mamba(LN1(x)))`` over the (t, h, w) tokens.

Departures from the published code, all of inference:

- dropout and drop-path are off (``eval()``), so they are left out;
- the input is the clip already standardised per stream over the chunk,
  ``(x - mean) / std`` (the caller standardises, as for PhysFormer);
- the selective scan is :func:`selective_scan`, the recurrence evaluated
  exactly in float32 by a pairwise tree over the tokens (Mamba's own
  kernel runs it token by token; the tests hold the two to each other).

It imports nothing of the package it is the reference of, and nothing of
JAX.  :func:`forward` sets ``allow_tf32`` off for matrix products and cuDNN
on the way in and puts both back on the way out.

``params`` hold the unfolded weights (``models/physmamba.py``'s
``init_params`` lays them out): ``stem0..2``, ``slow0``, ``fast0``,
``lat`` [2], ``fast_out``, ``up1``, ``up2`` {w, b, bn}; ``slow``, ``fast``
[3] {cdc {w, bn}, ln1, mamba {in_w, fwd, bwd, out_w}, ln2, ca {fc1,
fc2}}, each direction {conv_w, conv_b, x_w, dt_w, dt_b, a_log, d};
``last`` {w, b}; each ``bn`` {gamma, beta, mean, var}, each ``ln`` {w, b}.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
BN_EPS = 1e-5
LN_EPS = 1e-5


@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and cuDNN convolutions inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def standardise(clip: Tensor) -> Tensor:
    """[B, ...] -> f32, each row less its mean over the rest, over its
    population standard deviation; a constant row gives zeros."""
    x = clip.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    x = x - x.mean(dims, keepdim=True)
    x = x / x.pow(2).mean(dims, keepdim=True).sqrt()
    return torch.nan_to_num(x, nan=0.0)


def _pair_scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h = 0: the states at the
    odd tokens are the scan of adjacent pairs combined, those at the even
    tokens follow from their left neighbours."""
    n = a.shape[1]
    if n == 1:
        return b
    m = n // 2
    a0, a1 = a[:, 0:2 * m:2], a[:, 1:2 * m:2]
    b0, b1 = b[:, 0:2 * m:2], b[:, 1:2 * m:2]
    odd = _pair_scan(a1 * a0, a1 * b0 + b1)
    even = torch.cat([b0[:, :1], a0[:, 1:] * odd[:, :-1] + b0[:, 1:]], 1)
    h = torch.stack([even, odd], 2).flatten(1, 2)
    if n % 2:
        h = torch.cat([h, (a[:, -1:] * h[:, -1:] + b[:, -1:])], 1)
    return h


def selective_scan(v: Tensor, dt: Tensor, a: Tensor, bm: Tensor, cm: Tensor,
                   d: Tensor) -> Tensor:
    """One direction's scan over tokens in order: v, dt [B, L, E], a [E,
    N], bm, cm [B, L, N], d [E] -> y [B, L, E], ``h_t = exp(dt_t a)
    h_{t-1} + (dt_t v_t) B_t`` from h = 0, ``y_t = h_t . C_t + d v_t``."""
    decay = torch.exp(dt[..., None] * a)
    h = _pair_scan(decay, (dt * v)[..., None] * bm[:, :, None, :])
    return (h * cm[:, :, None, :]).sum(-1) + d * v


def _bn(x, p):
    return F.batch_norm(x, p["mean"], p["var"], p["gamma"], p["beta"],
                        False, 0.0, BN_EPS)


def _cbr(x, p, act=F.relu, **kw):
    """act(BN(conv3d(x)))."""
    return act(_bn(F.conv3d(x, p["w"], p["b"], **kw), p["bn"]))


def _cdc_t(x, w, theta):
    out = F.conv3d(x, w, padding=1)
    if abs(theta) < 1e-8:
        return out
    diff = (w[:, :, 0].sum((2, 3)) + w[:, :, 2].sum((2, 3)))
    return out - theta * F.conv3d(x, diff[..., None, None, None])


def _pool(x):
    return F.max_pool3d(x, (1, 2, 2), (1, 2, 2))


def mamba(p: dict, x: Tensor, scan=selective_scan) -> Tensor:
    """The bidirectional Mamba layer of tokens x [B, L, c]."""
    e = p["in_w"].shape[0] // 2
    xz = x @ p["in_w"].T
    out = 0.0
    for name, rev in (("fwd", False), ("bwd", True)):
        q = p[name]
        seq = xz.flip(1) if rev else xz
        u, z = seq[..., :e], seq[..., e:]
        k, n = q["conv_w"].shape[-1], u.shape[1]
        v = F.conv1d(u.transpose(1, 2), q["conv_w"][:, None], q["conv_b"],
                     padding=k - 1, groups=e)[..., :n]
        v = F.silu(v).transpose(1, 2)
        r_n, st = q["dt_w"].shape[1], q["a_log"].shape[1]
        proj = v @ q["x_w"].T
        r, bm, cm = proj[..., :r_n], proj[..., r_n:r_n + st], \
            proj[..., r_n + st:]
        dt = F.softplus(r @ q["dt_w"].T + q["dt_b"])
        y = scan(v, dt, -torch.exp(q["a_log"]), bm, cm, q["d"])
        y = y * F.silu(z)
        out = out + (y.flip(1) if rev else y)
    return out @ p["out_w"].T


def tdm_block(p: dict, x: Tensor, theta: float, scan=selective_scan
              ) -> Tensor:
    """CDC_T, BatchNorm, ReLU; the Mamba layer over the tokens; channel
    attention. x [B, c, T, H, W]."""
    x = F.relu(_bn(_cdc_t(x, p["cdc"]["w"], theta), p["cdc"]["bn"]))
    b, c = x.shape[:2]
    tok = x.flatten(2).transpose(1, 2)                  # [B, L, c]
    ln1, ln2 = p["ln1"], p["ln2"]
    m = mamba(p["mamba"], F.layer_norm(tok, (c,), ln1["w"], ln1["b"],
                                       LN_EPS), scan)
    tok = F.layer_norm(tok + m, (c,), ln2["w"], ln2["b"], LN_EPS)
    x = tok.transpose(1, 2).reshape(x.shape)
    fc1, fc2 = p["ca"]["fc1"], p["ca"]["fc2"]

    def mlp(t):
        return F.conv3d(F.relu(F.conv3d(t, fc1)), fc2)
    att = torch.sigmoid(mlp(F.adaptive_avg_pool3d(x, 1))
                        + mlp(F.adaptive_max_pool3d(x, 1)))
    return x * att


def forward(params: dict, x: Tensor, theta: float, scan=selective_scan
            ) -> Tensor:
    """The BVP [B, T] of standardised clips ``x`` [B, 3, T, H, W]."""
    with no_tf32():
        x = x.to(torch.float32)
        t = x.shape[2]
        x = _pool(_cbr(x, params["stem0"], padding=(0, 2, 2)))
        x = _cbr(x, params["stem1"], padding=1)
        x = _pool(_cbr(x, params["stem2"], padding=1))
        s = _cbr(x, params["slow0"], stride=(4, 1, 1))
        f = _cbr(x, params["fast0"], stride=(2, 1, 1))
        for i in range(2):
            s = _pool(tdm_block(params["slow"][i], s, theta, scan))
            f = _pool(tdm_block(params["fast"][i], f, theta, scan))
            s = s + _cbr(f, params["lat"][i], stride=(2, 1, 1),
                         padding=(1, 0, 0))
        s = tdm_block(params["slow"][2], s, theta, scan)
        f = tdm_block(params["fast"][2], f, theta, scan)
        s = _cbr(F.interpolate(s, scale_factor=(2.0, 1.0, 1.0),
                               mode="nearest"), params["up1"], F.elu,
                 padding=(1, 0, 0))
        f = _cbr(f, params["fast_out"], padding=(1, 0, 0))
        y = torch.cat([f, s], 1)
        y = _cbr(F.interpolate(y, scale_factor=(2.0, 1.0, 1.0),
                               mode="nearest"), params["up2"], F.elu,
                 padding=(1, 0, 0))
        y = F.adaptive_avg_pool3d(y, (t, 1, 1))
        last = params["last"]
        return F.conv3d(y, last["w"], last["b"]).reshape(-1, t)
