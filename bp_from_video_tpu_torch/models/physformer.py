"""PhysFormer on the card: the temporal-difference transformer that turns a
stream's clip of face crops into its BVP (``runtime/engine.py`` runs it on
each stream's clip ring).

Yu et al., CVPR 2022 (arXiv:2111.12082), ``ViT_ST_ST_Compact3_TDC_gra_sharp``
at rPPG-Toolbox's ``PHYSFORMER`` settings (``config.PhysFormerConfig``):

- stem: three 3-D convolutions, each with BatchNorm, ReLU and a 1x2x2
  max-pool: 3 -> dim/4 at 1x5x5, dim/4 -> dim/2 and dim/2 -> dim at 3x3x3;
- patch embedding: a ``patch``-cubed conv of stride ``patch``, giving
  (T/patch) x grid x grid tokens of ``dim`` (run as one product over the
  non-overlapping patches);
- ``num_layers`` blocks of ``x + proj(TD-MHSA(LN(x)))`` then ``x +
  FF(LN(x))``: Q and K from ``CDC_T`` 3x3x3 convolutions with BatchNorm, V
  from a 1x1x1 conv, ``softmax(QK^T / gra_sharp)``; FF a 1x1x1 conv, a
  depthwise 3x3x3 conv and a 1x1x1 conv, with BatchNorm, ELU between;
- head: twice a nearest x2 temporal upsample, a [3, 1, 1] conv, BatchNorm
  and ELU (dim -> dim -> dim/2), the spatial mean, a 1x1 Conv1d to one
  sample a frame.

``params`` hold the unfolded weights (:func:`init_params` lays them out;
``models/physformer_ref.py`` runs them as published).  :class:`PhysFormer`
folds them once: every BatchNorm into the conv before it, and ``CDC_T``
exactly into its centre tap, ``W[:, :, 1, 1, 1] -= theta * (sum W[:, :, 0]
+ sum W[:, :, 2])`` (the 1x1x1 difference conv reads the centre tap's
input).  The Q and K convolutions of a block run as one conv of 2 dim
outputs.

Activations are in the compute dtype (bf16 on the card), channels last:
the clip comes in as [B, T, C, C, 3] (the ring's layout).  Each stem layer
(``kernels/pf_stem.py``) is one conv, its 1x2x2 max-pool, bias and ReLU:
stem0's kernel is one frame deep and it runs on the 2x2-packed frame (12
channels in place of 3), its four output groups the four positions of its
max-pool (:func:`_packed_stem0`); stem1 and stem2 read their three
temporal taps.  With ``use_kernel`` a bf16 net on a card runs kernel K7
(``pf_stem``: the taps read in place, the pool, bias and ReLU in its
epilogue, one launch a layer; it takes bf16 alone, so a net in another
dtype keeps the plain stem); otherwise ``pf_stem_plain``, a 2-D conv over
the B*T frames (stem1's and stem2's taps as channels, a frame's beside its
neighbours', :func:`temporal_taps`), then the pool, and the bias and ReLU
on a quarter of the values (both commute with the max).  cuDNN's 3-D
convs at these shapes ran slower (NVIDIA H100: stem1 58.7 ms against 39.2
ms, stem2 25.4 against 15.1, 64 clips; stem0 unpacked, 3 channels: 45.5
ms).  The Q/K conv runs as a channels-last-3d conv, the depthwise one
planar, the head's [3, 1, 1] convs as products over the temporal taps;
``scaled_dot_product_attention`` computes the attention
(``scale=1/gra_sharp``).  Products accumulate in f32; the residual stream,
the LayerNorms, the spatial mean and the last projection are f32.  Spans:
``bpv.pf.stem`` (the three stem layers), ``bpv.pf.trunk`` (the patch
embedding, the blocks and the head).
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch.config import PhysFormerConfig
from bp_from_video_tpu_torch.kernels import pf_stem
from bp_from_video_tpu_torch.utils.profiling import span

Tensor = torch.Tensor
BN_EPS = 1e-5
LN_EPS = 1e-6
_CL3 = torch.channels_last_3d


def _packed_stem0(w: Tensor) -> Tensor:
    """stem0's 5x5 conv weight [co, ci, 5, 5] as a 3x3 conv over the
    2x2-packed frame (channel (p*2+q)*ci + c holds pixel (2i+p, 2j+q))
    whose output channel (a*2+b)*co + o is the full-resolution output at
    (2i+a, 2j+b): [4 co, 4 ci, 3, 3].  Output row 2i+a reads input row
    2i+a+dy = 2(i+k)+p, so packed tap k (-1..1) and parity p carry the
    5x5 tap dy = 2k+p-a where |dy| <= 2; padding 2 becomes padding 1."""
    co, ci = w.shape[:2]
    wp = w.new_zeros(2, 2, co, 2, 2, ci, 3, 3)
    for a, b, p, q, ky, kx in itertools.product(range(2), range(2),
                                                range(2), range(2),
                                                range(3), range(3)):
        dy, dx = 2 * (ky - 1) + p - a, 2 * (kx - 1) + q - b
        if abs(dy) <= 2 and abs(dx) <= 2:
            wp[a, b, :, p, q, :, ky, kx] = w[:, :, dy + 2, dx + 2]
    return wp.reshape(4 * co, 4 * ci, 3, 3)


def temporal_taps(y: Tensor) -> Tensor:
    """[B, T, ..., C] -> [B, T, ..., 3C]: each frame's channels after its
    previous frame's and before its next's, zero past the clip's ends (the
    input of a conv three frames deep, as one product)."""
    t = y.shape[1]
    yp = F.pad(y, (0, 0) * (y.ndim - 2) + (1, 1))
    return torch.cat([yp[:, :t], yp[:, 1:t + 1], yp[:, 2:]], -1)


def init_params(cfg: PhysFormerConfig, seed: int, device=None) -> dict:
    """Seeded unfolded weights and BatchNorm statistics (f32): convs drawn
    at 1/sqrt(fan-in) (sqrt(2/fan-in) before a ReLU), BatchNorm scales near
    1 and shifts, means and variances near their identities, LayerNorms
    near the identity."""
    gen = torch.Generator().manual_seed(int(seed) % 2**63)
    d, ff = cfg.dim, cfg.ff_dim

    def conv(cout, cin, *k, gain=1.0):
        fan = cin * math.prod(k)
        return torch.randn((cout, cin) + k, generator=gen) * (
            gain / math.sqrt(fan))

    def vec(n, scale=0.1, base=0.0):
        return base + scale * torch.randn(n, generator=gen)

    def bn(n):
        return {"gamma": vec(n, 0.1, 1.0), "beta": vec(n),
                "mean": vec(n), "var": 0.5 + torch.rand(n, generator=gen)}

    def ln(n):
        return {"w": vec(n, 0.1, 1.0), "b": vec(n)}

    p = {"stem0": {"w": conv(d // 4, 3, 1, 5, 5, gain=2 ** 0.5),
                   "b": vec(d // 4), "bn": bn(d // 4)},
         "stem1": {"w": conv(d // 2, d // 4, 3, 3, 3, gain=2 ** 0.5),
                   "b": vec(d // 2), "bn": bn(d // 2)},
         "stem2": {"w": conv(d, d // 2, 3, 3, 3, gain=2 ** 0.5),
                   "b": vec(d), "bn": bn(d)},
         "patch": {"w": conv(d, d, *(cfg.patch,) * 3), "b": vec(d)},
         "blocks": [{"ln1": ln(d),
                     "q": {"w": conv(d, d, 3, 3, 3), "bn": bn(d)},
                     "k": {"w": conv(d, d, 3, 3, 3), "bn": bn(d)},
                     "v": {"w": conv(d, d, 1, 1, 1)},
                     "proj": {"w": conv(d, d), "b": vec(d)},
                     "ln2": ln(d),
                     "fc1": {"w": conv(ff, d, 1, 1, 1), "bn": bn(ff)},
                     "dw": {"w": conv(ff, 1, 3, 3, 3), "bn": bn(ff)},
                     "fc2": {"w": conv(d, ff, 1, 1, 1), "bn": bn(d)}}
                    for _ in range(cfg.num_layers)],
         "up1": {"w": conv(d, d, 3, 1, 1), "b": vec(d), "bn": bn(d)},
         "up2": {"w": conv(d // 2, d, 3, 1, 1), "b": vec(d // 2),
                 "bn": bn(d // 2)},
         "last": {"w": conv(1, d // 2, 1), "b": vec(1)}}
    return map_params(lambda t: t.to(device), p)


def map_params(fn, p):
    """``fn`` on every tensor of a params nest (dicts and lists)."""
    if isinstance(p, dict):
        return {k: map_params(fn, v) for k, v in p.items()}
    if isinstance(p, list):
        return [map_params(fn, v) for v in p]
    return fn(p)


def fold_cdc(w: Tensor, theta: float) -> Tensor:
    """``CDC_T``'s weight with its temporal difference folded into the
    centre tap."""
    w = w.clone()
    w[:, :, 1, 1, 1] -= theta * (w[:, :, 0].sum((2, 3))
                                 + w[:, :, 2].sum((2, 3)))
    return w


def fold_bn(w: Tensor, b: Tensor | None, bn: dict) -> tuple[Tensor, Tensor]:
    """(weight, bias) of a conv followed by BatchNorm at inference."""
    s = bn["gamma"] / torch.sqrt(bn["var"] + BN_EPS)
    b = torch.zeros_like(bn["mean"]) if b is None else b
    return (w * s.reshape((-1,) + (1,) * (w.ndim - 1)),
            (b - bn["mean"]) * s + bn["beta"])


def folded(cfg: PhysFormerConfig, params: dict) -> dict:
    """The weights the port computes with, folded in float64: {name: (w,
    b)} for every conv and linear layer, {name: (w, b)} for the
    LayerNorms, per block under ``blocks``."""
    p = map_params(lambda t: t.to(torch.float64), params)
    out = {n: fold_bn(p[n]["w"], p[n]["b"], p[n]["bn"])
           for n in ("stem0", "stem1", "stem2", "up1", "up2")}
    out["patch"] = (p["patch"]["w"], p["patch"]["b"])
    out["last"] = (p["last"]["w"], p["last"]["b"])
    out["blocks"] = []
    for blk in p["blocks"]:
        q = fold_bn(fold_cdc(blk["q"]["w"], cfg.theta), None, blk["q"]["bn"])
        k = fold_bn(fold_cdc(blk["k"]["w"], cfg.theta), None, blk["k"]["bn"])
        out["blocks"].append({
            "ln1": (blk["ln1"]["w"], blk["ln1"]["b"]),
            "qk": (torch.cat([q[0], k[0]]), torch.cat([q[1], k[1]])),
            "v": (blk["v"]["w"], None),
            "proj": (blk["proj"]["w"], blk["proj"]["b"]),
            "ln2": (blk["ln2"]["w"], blk["ln2"]["b"]),
            "fc1": fold_bn(blk["fc1"]["w"], None, blk["fc1"]["bn"]),
            "dw": fold_bn(blk["dw"]["w"], None, blk["dw"]["bn"]),
            "fc2": fold_bn(blk["fc2"]["w"], None, blk["fc2"]["bn"])})
    return out


class PhysFormer:
    """The folded net in ``dtype`` on ``device``; ``net(x)`` is the BVP f32
    [B, T] of standardised clips ``x`` [B, T, C, C, 3] in ``dtype``.
    ``use_kernel``: a bf16 net on a CUDA device runs its stem on kernel K7
    (which takes bf16 alone); any other net keeps the plain stem.  The
    route is chosen here, once."""

    def __init__(self, cfg: PhysFormerConfig, params: dict,
                 dtype=torch.bfloat16, device=None, use_kernel: bool = False):
        self.cfg, self.dtype = cfg, dtype
        f = folded(cfg, params)

        def put(t):
            return None if t is None else t.to(device=device, dtype=dtype)

        def frames(wb):
            """A 3-D conv's weight for the 2-D conv over frames whose
            channels hold the kt temporal taps (tap-major), channels-last."""
            w, b = wb
            w = w.transpose(1, 2).flatten(1, 2)
            return put(w).contiguous(memory_format=torch.channels_last), \
                put(b)

        def lin(wb, taps: bool = False):
            """A 1x1x1 conv's or linear layer's weight (with ``taps``: a
            [kt, 1, 1] conv's over tap-major channels) for ``F.linear``."""
            w, b = wb
            w = (w[..., 0, 0].transpose(1, 2) if taps else w)
            return put(w.reshape(w.shape[0], -1)), put(b)

        def f32(wb):
            return tuple(t.to(device=device, dtype=torch.float32) for t in wb)
        # stem0 on the 2x2-packed frame (``_packed_stem0``), its 12 input
        # channels padded to 16 (tensor-core products take multiples of 8).
        w0, b0 = f["stem0"]
        w0 = F.pad(_packed_stem0(w0[:, :, 0]), (0, 0, 0, 0, 0, 4))
        self.stem = [(put(w0).contiguous(memory_format=torch.channels_last),
                      put(b0)), frames(f["stem1"]), frames(f["stem2"])]
        # K7's layout of the same weights for a bf16 net on a card
        # (``kernel_weights``).
        on_card = device is not None and torch.device(device).type == "cuda"
        self.stem_k7 = ([pf_stem.kernel_weights(w, b, packed=i == 0)
                         for i, (w, b) in enumerate(self.stem)]
                        if use_kernel and on_card and dtype == torch.bfloat16
                        else None)
        # The patch embedding (kernel = stride) as a product over patches:
        # the weight's input axes in a patch's channels-last order.
        w, b = f["patch"]
        self.patch = lin((w.permute(0, 2, 3, 4, 1), b))
        self.blocks = [{"ln1": f32(b["ln1"]),
                        "qk": (put(b["qk"][0]).contiguous(memory_format=_CL3),
                               put(b["qk"][1])),
                        "v": lin(b["v"]), "proj": lin(b["proj"]),
                        "ln2": f32(b["ln2"]), "fc1": lin(b["fc1"]),
                        "dw": (put(b["dw"][0]), put(b["dw"][1])),
                        "fc2": lin(b["fc2"])}
                       for b in f["blocks"]]
        self.up = [lin(f["up1"], taps=True), lin(f["up2"], taps=True)]
        w, b = f32(f["last"])
        self.last = (w[0, :, 0], b)

    def stem_apply(self, x: Tensor) -> Tensor:
        """[B, T, C, C, 3] -> [B, T, C/8, C/8, dim]: the three stem layers,
        on K7 for a bf16 net on a card with ``use_kernel``, else their plain
        composition."""
        if self.stem_k7 is not None:
            x = x.contiguous()
            for wk, b in self.stem_k7:
                x = pf_stem.pf_stem(x, wk, b)
            return x
        for w, b in self.stem:
            x = pf_stem.pf_stem_plain(x, w, b)
        return x

    def _grid(self, tok: Tensor, gt: int) -> Tensor:
        """Tokens [B, P, C] -> the channels-last-3d view [B, C, gt, g, g]."""
        g = self.cfg.grid
        return tok.unflatten(1, (gt, g, g)).permute(0, 4, 1, 2, 3)

    @staticmethod
    def _tokens(y: Tensor) -> Tensor:
        """[B, C, gt, g, g] -> tokens [B, P, C] (a view when channels-last)."""
        return y.permute(0, 2, 3, 4, 1).flatten(1, 3)

    def _block(self, blk: dict, x: Tensor, gt: int) -> Tensor:
        cfg, dt = self.cfg, self.dtype
        d, nh = cfg.dim, cfg.num_heads
        h = F.layer_norm(x, (d,), *blk["ln1"], LN_EPS).to(dt)
        qk = self._tokens(F.conv3d(self._grid(h, gt), *blk["qk"], padding=1))
        v = F.linear(h, *blk["v"])
        bsz, p = h.shape[:2]

        def heads(t):
            return t.unflatten(-1, (nh, d // nh)).transpose(1, 2)
        a = F.scaled_dot_product_attention(
            heads(qk[..., :d]), heads(qk[..., d:]), heads(v),
            scale=1.0 / cfg.gra_sharp)
        a = a.transpose(1, 2).reshape(bsz, p, d)
        x = x + F.linear(a, *blk["proj"]).float()
        h = F.layer_norm(x, (d,), *blk["ln2"], LN_EPS).to(dt)
        h = F.elu(F.linear(h, *blk["fc1"]))
        # The depthwise conv on the planar layout, where cuDNN's grouped
        # 3-D conv is fast.
        w, b = blk["dw"]
        h = F.elu(F.conv3d(self._grid(h, gt).contiguous(), w, b, padding=1,
                           groups=h.shape[-1]))
        return x + F.linear(h.flatten(2).transpose(1, 2), *blk["fc2"]).float()

    def trunk_apply(self, m: Tensor) -> Tensor:
        """Stem output [B, T, h, w, C] -> the BVP f32 [B, T]."""
        bsz, t, hh, ww, c = m.shape
        pt, g = self.cfg.patch, self.cfg.grid
        gt = t // pt
        patches = m.reshape(bsz, gt, pt, g, pt, g, pt, c).permute(
            0, 1, 3, 5, 2, 4, 6, 7)
        x = F.linear(patches.reshape(bsz, gt * g * g, -1),
                     *self.patch).float()
        for blk in self.blocks:
            x = self._block(blk, x, gt)
        # Head: nearest x2 in time, then the [3, 1, 1] conv as a product
        # over the frame and its two neighbours' channels.
        y = x.to(self.dtype).unflatten(1, (gt, g * g))       # [B, t, g*g, C]
        for w, b in self.up:
            y = y.repeat_interleave(2, dim=1)
            y = F.elu(F.linear(temporal_taps(y), w, b))
        feat = y.float().mean(2)                             # [B, T, dim/2]
        w, b = self.last
        return feat @ w + b

    def __call__(self, x: Tensor) -> Tensor:
        with span("bpv.pf.stem"):
            y = self.stem_apply(x)
        with span("bpv.pf.trunk"):
            return self.trunk_apply(y)


# The net the engine builds for a ``PhysFormerConfig`` (its ``module``).
Net = PhysFormer
