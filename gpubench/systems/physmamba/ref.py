"""The physmamba system's plain reference, in float32 with TF32 off: it
imports nothing of the port, of the JAX package or of JAX.

- The net: a frozen copy of the port's ``models/physmamba_ref.py``
  (PhysMamba's forward pass as published, Luo et al., arXiv:2409.12031, as
  rPPG-Toolbox's ``PhysMamba.py`` runs it: unfolded BatchNorm, unfolded
  ``CDC_T``, the bidirectional Mamba layer as ``LN2(x + Mamba(LN1(x)))``,
  the selective scan evaluated exactly in float32 by a pairwise tree),
  with its departures: dropout off, the input standardised per clip over
  the chunk.  :func:`init_params` draws its weights from the seed, laid
  out as the port's ``init_params`` lays them (the port folds them
  itself).
- The tracker, the crop, the clip ring and the DSP: the physformer
  system's reference (``gpubench/systems/physformer/ref.py``), whose
  :class:`Reference` this one extends with the net.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from gpubench.systems.physformer import ref as pf_ref

Tensor = torch.Tensor
BN_EPS = 1e-5
LN_EPS = 1e-5
BLOCK = 8          # clips a reference forward pass takes at a time


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


# -- the weights ------------------------------------------------------------


def init_params(net: dict, seed: int, device=None) -> dict:
    """Seeded unfolded weights and BatchNorm statistics of the net ``net``
    ({slow_dim, fast_dim, d_state, d_conv, expand, reduction, head_dim,
    ...}): convs at 1/sqrt(fan-in) (sqrt(2/fan-in) before a ReLU),
    BatchNorm and LayerNorm near their identities; each scan direction as
    Mamba initialises it (``b_dt`` the inverse softplus of a step drawn
    log-uniform in [1e-3, 1e-1], ``A_log`` near log(1..N), ``D`` near 1)."""
    gen = torch.Generator().manual_seed(int(seed) % 2**63)
    n, hd = net["d_state"], net["head_dim"]

    def conv(cout, cin, *k, gain=1.0):
        fan = cin * math.prod(k)
        return torch.randn((cout, cin) + k, generator=gen) * (
            gain / math.sqrt(fan))

    def vec(m, scale=0.1, base=0.0):
        return base + scale * torch.randn(m, generator=gen)

    def bn(m):
        return {"gamma": vec(m, 0.1, 1.0), "beta": vec(m),
                "mean": vec(m), "var": 0.5 + torch.rand(m, generator=gen)}

    def ln(m):
        return {"w": vec(m, 0.1, 1.0), "b": vec(m)}

    def cbr(cout, cin, *k):
        return {"w": conv(cout, cin, *k, gain=2 ** 0.5), "b": vec(cout),
                "bn": bn(cout)}

    def direction(e, r):
        step = torch.exp(math.log(1e-3) + torch.rand(e, generator=gen)
                         * (math.log(1e-1) - math.log(1e-3)))
        return {"conv_w": conv(e, 1, net["d_conv"])[:, 0], "conv_b": vec(e),
                "x_w": conv(r + 2 * n, e), "dt_w": conv(e, r),
                "dt_b": step + torch.log(-torch.expm1(-step)),
                "a_log": (torch.log(torch.arange(1, n + 1,
                                                 dtype=torch.float32))
                          + vec(e * n).reshape(e, n)),
                "d": vec(e, 0.1, 1.0)}

    def block(c):
        e, r = net["expand"] * c, math.ceil(c / 16)
        red = net["reduction"]
        return {"cdc": {"w": conv(c, c, 3, 3, 3, gain=2 ** 0.5),
                        "bn": bn(c)},
                "ln1": ln(c),
                "mamba": {"in_w": conv(2 * e, c), "fwd": direction(e, r),
                          "bwd": direction(e, r), "out_w": conv(c, e)},
                "ln2": ln(c),
                "ca": {"fc1": conv(c // red, c, 1, 1, 1, gain=2 ** 0.5),
                       "fc2": conv(c, c // red, 1, 1, 1)}}
    s, f = net["slow_dim"], net["fast_dim"]
    p = {"stem0": cbr(16, 3, 1, 5, 5), "stem1": cbr(32, 16, 3, 3, 3),
         "stem2": cbr(s, 32, 3, 3, 3), "slow0": cbr(s, s, 4, 1, 1),
         "fast0": cbr(f, s, 2, 1, 1),
         "slow": [block(s) for _ in range(3)],
         "fast": [block(f) for _ in range(3)],
         "lat": [cbr(s, f, 3, 1, 1) for _ in range(2)],
         "fast_out": cbr(f, f, 3, 1, 1),
         "up1": {"w": conv(hd, s, 3, 1, 1), "b": vec(hd), "bn": bn(hd)},
         "up2": {"w": conv(hd, f + hd, 3, 1, 1), "b": vec(hd),
                 "bn": bn(hd)},
         "last": {"w": conv(1, hd, 1, 1, 1), "b": vec(1)}}
    return pf_ref._map(lambda t: t.to(device), p)


# -- the step ---------------------------------------------------------------


class Reference(pf_ref.Reference):
    """The physformer system's reference step (tracker, crops, ring, DSP)
    with PhysMamba as its net.  ``scan`` is the selective scan the net
    runs (the control replaces it)."""

    scan = staticmethod(selective_scan)

    def bvp(self, clips: Tensor) -> Tensor:
        """The net's BVP [B, T] of clips [B, T, C, C, 3] in [0, 1], each
        standardised, in blocks of :data:`BLOCK` clips."""
        return torch.cat([forward(
            self.params, pf_ref.standardise(b).permute(0, 4, 1, 2, 3),
            self.net["theta"], self.scan) for b in clips.split(BLOCK)])
