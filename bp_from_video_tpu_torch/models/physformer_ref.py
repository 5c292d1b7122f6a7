"""PhysFormer's forward pass as published, in plain float32 ``torch``: the
reference that ``models/physformer.py`` is held to.

Yu et al., "PhysFormer: Facial Video-based Physiological Measurement with
Temporal Difference Transformer", CVPR 2022 (arXiv:2111.12082), the
``ViT_ST_ST_Compact3_TDC_gra_sharp`` model of its code as rPPG-Toolbox
(arXiv:2210.00716) carries it under ``PHYSFORMER``.  Every BatchNorm runs
unfolded on its running statistics, ``CDC_T`` runs as its two convolutions
(``conv(x) - theta * conv1x1(x, sum of the weight's temporal taps 0 and
2)``), attention is ``softmax(QK^T / gra_sharp)`` with no 1/sqrt(d).

Departures from the published code, all of inference:

- dropout is off (``eval()``), so it is left out;
- the input is the clip already standardised per stream over the chunk,
  ``(x - mean) / std`` (rPPG-Toolbox's "Standardized" input); the
  caller standardises (:func:`standardise`);
- the attention maps the published ``forward`` also returns are not kept.

It imports nothing of the package it is the reference of, and nothing of
JAX.  ``forward`` sets ``allow_tf32`` off for matrix products and cuDNN on
the way in and puts both back on the way out.

``params`` hold the unfolded weights (``models/physformer.py``'s
``init_params`` lays them out): ``stem0..2`` {w, b, bn}, ``patch`` {w, b},
``blocks`` [{ln1, q {w, bn}, k {w, bn}, v {w}, proj {w, b}, ln2, fc1 {w,
bn}, dw {w, bn}, fc2 {w, bn}}], ``up1``, ``up2`` {w, b, bn}, ``last`` {w,
b}; each ``bn`` {gamma, beta, mean, var}.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
BN_EPS = 1e-5
LN_EPS = 1e-6


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
    population standard deviation; a constant row gives zeros (NaN set to
    0, as rPPG-Toolbox does)."""
    x = clip.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    x = x - x.mean(dims, keepdim=True)
    x = x / x.pow(2).mean(dims, keepdim=True).sqrt()
    return torch.nan_to_num(x, nan=0.0)


def _bn(x: Tensor, p: dict) -> Tensor:
    return F.batch_norm(x, p["mean"], p["var"], p["gamma"], p["beta"],
                        False, 0.0, BN_EPS)


def _cdc_t(x: Tensor, w: Tensor, theta: float) -> Tensor:
    """``CDC_T``: a 3x3x3 conv (padding 1, no bias) less ``theta`` times a
    1x1x1 conv by the sum of the weight's temporal taps 0 and 2."""
    out = F.conv3d(x, w, padding=1)
    if abs(theta) < 1e-8:
        return out
    diff = (w[:, :, 0].sum((2, 3)) + w[:, :, 2].sum((2, 3)))
    return out - theta * F.conv3d(x, diff[..., None, None, None])


def _grid(x: Tensor, gt: int, g: int) -> Tensor:
    """Tokens [B, P, C] -> [B, C, gt, g, g] (the published ``view``)."""
    b, p, c = x.shape
    return x.transpose(1, 2).reshape(b, c, gt, g, g)


def _tokens(x: Tensor) -> Tensor:
    return x.flatten(2).transpose(1, 2)


def _attention(blk: dict, x: Tensor, gt: int, g: int, heads: int,
               theta: float, gra_sharp: float) -> Tensor:
    """``MultiHeadedSelfAttention_TDC_gra_sharp`` then ``proj``."""
    h = _grid(x, gt, g)
    q = _tokens(_bn(_cdc_t(h, blk["q"]["w"], theta), blk["q"]["bn"]))
    k = _tokens(_bn(_cdc_t(h, blk["k"]["w"], theta), blk["k"]["bn"]))
    v = _tokens(F.conv3d(h, blk["v"]["w"]))
    b, p, c = q.shape
    q, k, v = (t.reshape(b, p, heads, c // heads).transpose(1, 2)
               for t in (q, k, v))
    scores = torch.softmax(q @ k.transpose(-2, -1) / gra_sharp, dim=-1)
    out = (scores @ v).transpose(1, 2).reshape(b, p, c)
    return F.linear(out, blk["proj"]["w"], blk["proj"]["b"])


def _feed_forward(blk: dict, x: Tensor, gt: int, g: int) -> Tensor:
    """``PositionWiseFeedForward_ST``."""
    h = _grid(x, gt, g)
    h = F.elu(_bn(F.conv3d(h, blk["fc1"]["w"]), blk["fc1"]["bn"]))
    h = F.elu(_bn(F.conv3d(h, blk["dw"]["w"], padding=1,
                           groups=h.shape[1]), blk["dw"]["bn"]))
    h = _bn(F.conv3d(h, blk["fc2"]["w"]), blk["fc2"]["bn"])
    return _tokens(h)


def forward(params: dict, x: Tensor, num_heads: int, theta: float,
            gra_sharp: float) -> Tensor:
    """The BVP [B, T] of standardised clips ``x`` [B, 3, T, H, W]."""
    with no_tf32():
        x = x.to(torch.float32)
        for name, pad in (("stem0", (0, 2, 2)), ("stem1", 1),
                          ("stem2", 1)):
            p = params[name]
            x = F.relu(_bn(F.conv3d(x, p["w"], p["b"], padding=pad),
                           p["bn"]))
            x = F.max_pool3d(x, (1, 2, 2), (1, 2, 2))
        pe = params["patch"]
        x = F.conv3d(x, pe["w"], pe["b"], stride=pe["w"].shape[2:])
        gt, g = x.shape[2], x.shape[3]
        x = _tokens(x)
        for blk in params["blocks"]:
            ln1, ln2 = blk["ln1"], blk["ln2"]
            h = F.layer_norm(x, x.shape[-1:], ln1["w"], ln1["b"], LN_EPS)
            x = x + _attention(blk, h, gt, g, num_heads, theta, gra_sharp)
            h = F.layer_norm(x, x.shape[-1:], ln2["w"], ln2["b"], LN_EPS)
            x = x + _feed_forward(blk, h, gt, g)
        x = _grid(x, gt, g)
        for name in ("up1", "up2"):
            p = params[name]
            x = F.interpolate(x, scale_factor=(2.0, 1.0, 1.0),
                              mode="nearest")
            x = F.elu(_bn(F.conv3d(x, p["w"], p["b"], padding=(1, 0, 0)),
                          p["bn"]))
        x = x.mean(3).mean(3)
        return F.conv1d(x, params["last"]["w"], params["last"]["b"])[:, 0]
