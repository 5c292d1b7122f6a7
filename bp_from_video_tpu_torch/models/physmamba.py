"""PhysMamba on the card: the SlowFast temporal-difference Mamba net that
turns a stream's clip of face crops into its BVP (``runtime/engine.py``
runs it on each stream's clip ring, as PhysFormer).

Luo et al., "PhysMamba: Efficient Remote Physiological Measurement with
SlowFast Temporal Difference Mamba" (arXiv:2409.12031), as rPPG-Toolbox
(arXiv:2210.00716) carries it in ``neural_methods/model/PhysMamba.py``, at
its published widths (``config.PhysMambaConfig``), in eval mode (dropout
the identity):

- stem: ``s0 = pool(ReLU(BN(conv 3->16, 1x5x5)))``, ``s1 = ReLU(BN(conv
  16->32, 3x3x3))``, ``s2 = pool(ReLU(BN(conv 32->64, 3x3x3)))`` (``pool``
  a 1x2x2 max-pool); then the slow pathway ``ReLU(BN(conv 64->64, 4x1x1,
  stride 4))`` at T/4 and the fast one ``ReLU(BN(conv 64->32, 2x1x1,
  stride 2))`` at T/2;
- six temporal-difference Mamba blocks, three a pathway: ``a =
  ReLU(BN(CDC_T(x)))``; over its tokens (every (t, h, w) position, in that
  order) ``o = LN2(a + Mamba(LN1(a)))``; ``o * sigmoid(MLP(avgpool(o)) +
  MLP(maxpool(o)))`` (channel attention, the MLP c -> c/2 -> c with no
  bias, the pools over all tokens).  The first two blocks of each pathway
  are followed by the spatial pool, then the fast pathway is merged into
  the slow one by a lateral ``ReLU(BN(conv 32->64, 3x1x1, stride 2))``;
- ``Mamba`` is bidirectional (Vision Mamba / VideoMamba, ``bimamba``):
  ``[u, z] = x W_in``; each direction has its own causal depthwise conv
  (width ``d_conv``), ``W_x``, ``W_dt``, ``b_dt``, ``A_log`` and ``D``, the
  backward one running on the reversed tokens; ``v = SiLU(conv(u))``,
  ``[r, B, C] = v W_x``, ``delta = softplus(r W_dt + b_dt)``, ``A =
  -exp(A_log)``, ``h_t = exp(delta_t A) h_{t-1} + (delta_t v_t) B_t``,
  ``y_t = h_t C_t + D v_t``; the output ``((y_fwd + y_bwd) * SiLU(z))
  W_out``;
- head: ``S3 = Up1(block(S2))``, ``F3 = ReLU(BN(conv 32->32, 3x1x1))(
  block(F2))``, ``Up2(cat(F3, S3))`` (each ``Up`` a nearest x2 temporal
  upsample, a 3x1x1 conv, BatchNorm and ELU: 64 -> 48, 80 -> 48), the
  spatial mean, a 1x1 conv to one sample a frame.

``params`` hold the unfolded weights (:func:`init_params` lays them out;
``models/physmamba_ref.py`` runs them as published).  :class:`PhysMamba`
folds every BatchNorm into the conv before it and ``CDC_T`` into its
centre tap (``models/physformer.fold_cdc``), in float64, once.

Activations are in the compute dtype (bf16 on the card), channels last:
the clip comes in as [B, T, C, C, 3] (the ring's layout, standardised).
The stem's pooled layers run ``kernels/pf_stem.pf_stem_plain`` (K7 takes
PhysFormer's three shapes alone), ``s1`` and every ``CDC_T`` run as a 2-D
conv over the frames with the temporal taps as channels
(``physformer.temporal_taps``), and the temporal convs of the split, the
laterals and the head as products over their taps.  The selective scan
(:func:`selective_scan`) runs in float32 and so do the LayerNorms, the
channel attention, the spatial mean and the last projection; products
accumulate in float32.

Spans: ``bpv.pm.stem`` (the stem and the split), ``bpv.pm.blocks`` (the
six blocks, their pools and the two laterals; ``bpv.pm.scan`` around each
selective scan inside it), ``bpv.pm.head``.  Counters: ``pm.scans`` (one a
direction: 12 a net call), ``pm.scan_tokens`` (tokens times clips
scanned, both directions counted).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch.config import PhysMambaConfig
from bp_from_video_tpu_torch.kernels import pf_stem
from bp_from_video_tpu_torch.models.physformer import (_packed_stem0,
                                                       fold_bn, fold_cdc,
                                                       map_params,
                                                       temporal_taps)
from bp_from_video_tpu_torch.utils.profiling import count, span

Tensor = torch.Tensor
LN_EPS = 1e-5
# The scan's radix: each level of its tree combines runs of this many.
RADIX = 8
# The float32 scratch (decays and states) a scan holds at once; clips are
# taken in blocks that fit it.
SCAN_BYTES = 12 << 30


def init_params(cfg: PhysMambaConfig, seed: int, device=None) -> dict:
    """Seeded unfolded weights and BatchNorm statistics (f32): convs drawn
    at 1/sqrt(fan-in) (sqrt(2/fan-in) before a ReLU), BatchNorm and
    LayerNorm near their identities; each scan direction as Mamba
    initialises it: ``b_dt`` the inverse softplus of a step drawn
    log-uniform in [1e-3, 1e-1], ``A_log`` near log(1..N), ``D`` near 1."""
    gen = torch.Generator().manual_seed(int(seed) % 2**63)
    n, hd = cfg.d_state, cfg.head_dim

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
        return {"conv_w": conv(e, 1, cfg.d_conv)[:, 0], "conv_b": vec(e),
                "x_w": conv(r + 2 * n, e), "dt_w": conv(e, r),
                "dt_b": step + torch.log(-torch.expm1(-step)),
                "a_log": (torch.log(torch.arange(1, n + 1,
                                                 dtype=torch.float32))
                          + vec(e * n).reshape(e, n)),
                "d": vec(e, 0.1, 1.0)}

    def block(c):
        e, r = cfg.expand * c, cfg.dt_rank(c)
        return {"cdc": {"w": conv(c, c, 3, 3, 3, gain=2 ** 0.5),
                        "bn": bn(c)},
                "ln1": ln(c),
                "mamba": {"in_w": conv(2 * e, c), "fwd": direction(e, r),
                          "bwd": direction(e, r), "out_w": conv(c, e)},
                "ln2": ln(c),
                "ca": {"fc1": conv(c // cfg.reduction, c, 1, 1, 1,
                                   gain=2 ** 0.5),
                       "fc2": conv(c, c // cfg.reduction, 1, 1, 1)}}
    s, f = cfg.slow_dim, cfg.fast_dim
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
    return map_params(lambda t: t.to(device), p)


# -- the selective scan -----------------------------------------------------


def _scan_(a: Tensor, u: Tensor) -> None:
    """``u[:, t] = a[:, t] * u[:, t - 1] + u[:, t]`` for t >= 1 along dim 1
    of [P, L, K] float32, in place: ``u`` becomes the recurrence's state at
    every token from a zero state.  A radix-:data:`RADIX` tree: each run of
    RADIX tokens is scanned from zero (RADIX - 1 vectorised steps over all
    runs, ``a`` turning into the decay from the run's start), the runs'
    last states by the same function one level up, then each run's carry
    added; a tail shorter than a run follows its predecessor token by
    token.  Every step multiplies decays in (0, 1] and adds, so no value
    leaves float32's range."""
    n = u.shape[1]
    q = RADIX
    full = n // q * q if n > q else 0
    if full:
        ar, ur = a[:, :full].unflatten(1, (-1, q)), \
            u[:, :full].unflatten(1, (-1, q))
        for j in range(1, q):
            ur[:, :, j].addcmul_(ar[:, :, j], ur[:, :, j - 1])
            ar[:, :, j].mul_(ar[:, :, j - 1])
        _scan_(ar[:, :, -1], ur[:, :, -1])
        ur[:, 1:, :-1].addcmul_(ar[:, 1:, :-1], ur[:, :-1, -1:])
    for t in range(max(full, 1), n):
        u[:, t].addcmul_(a[:, t], u[:, t - 1])


def selective_scan(v: Tensor, dt: Tensor, bm: Tensor, cm: Tensor, a: Tensor,
                   d: Tensor, budget: int = SCAN_BYTES) -> Tensor:
    """The bidirectional selective scan: y [B, L, E] float32, the sum over
    the two directions of ``y_t = h_t . C_t + D * v_t`` with ``h_t =
    exp(dt_t A) h_prev + (dt_t v_t) B_t`` from a zero state, direction 0
    over the tokens in order, direction 1 in reverse.

    v [2, B, L, E] (any float dtype), dt [2, B, L, E] float32, bm, cm [2, B,
    L, N], a [2, E, N] float32 (negative), d [2, E] float32, index 0 the
    forward direction's.  The state is float32 and never held for more
    clips than fit ``budget`` bytes (decays and states of both
    directions): clips go in blocks, and each block is scanned in place by
    :func:`_scan_`."""
    _, b, n, e = v.shape
    per_clip = 2 * 2 * n * e * a.shape[-1] * 4
    blk = max(1, min(b, budget // per_clip))
    y = torch.empty((b, n, e), dtype=torch.float32, device=v.device)

    def ordered(t):
        """Both directions of a block in scan order: [2, b, L, ...]."""
        return torch.stack((t[0], t[1].flip(1))).float()
    for i in range(0, b, blk):
        rows = slice(i, i + blk)
        vv, dd = ordered(v[:, rows]), ordered(dt[:, rows])
        bb, cc = ordered(bm[:, rows]), ordered(cm[:, rows])
        decay = torch.exp_(dd[..., None] * a[:, None, None])
        state = (dd * vv)[..., None] * bb[..., None, :]
        _scan_(decay.flatten(0, 1).flatten(2),
               state.flatten(0, 1).flatten(2))
        del decay
        yy = state.mul_(cc[..., None, :]).sum(-1).addcmul_(
            vv, d[:, None, None])
        del state
        y[rows] = yy[0] + yy[1].flip(1)
    return y


# -- the net ----------------------------------------------------------------


def depthwise_convs(u: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Both directions' depthwise convs over the tokens of u [B, L, E], in
    float32: [2, B, L, E], direction 0 causal (tokens t-k+1..t), direction
    1 causal on the reversed tokens (t..t+k-1); w [2, E, k], b [2, E]."""
    k, n = w.shape[-1], u.shape[1]
    up = F.pad(u, (0, 0, k - 1, k - 1))
    v = b[:, None, None].repeat(1, *u.shape[:2], 1)
    for j in range(k):
        v[0].addcmul_(up[:, j:j + n], w[0, :, j])
        v[1].addcmul_(up[:, 2 * (k - 1) - j:2 * (k - 1) - j + n], w[1, :, j])
    return v


def _conv_frames(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """A 3x3x3 conv (padding 1) of [B, T, H, W, C] as one 2-D conv over
    the B*T frames with each frame's temporal taps as its channels
    (``w`` [cout, 3C, 3, 3], tap-major, channels-last), bias added:
    [B, T, H, W, cout]."""
    bsz, t = x.shape[:2]
    y = F.conv2d(temporal_taps(x).flatten(0, 1).permute(0, 3, 1, 2), w, b,
                 padding=1)
    return y.permute(0, 2, 3, 1).unflatten(0, (bsz, t))


def _strided_taps(x: Tensor, k: int) -> Tensor:
    """[B, T, H, W, C] -> [B, T/k, H, W, kC]: each run of k frames'
    channels side by side (the input of a kx1x1 conv of stride k)."""
    return x.unflatten(1, (-1, k)).permute(0, 1, 3, 4, 2, 5).flatten(-2)


def _pool(x: Tensor) -> Tensor:
    """The 1x2x2 max-pool of [B, T, H, W, C]."""
    return x.unflatten(3, (-1, 2)).unflatten(2, (-1, 2)).amax((3, 5))


class PhysMamba:
    """The folded net in ``dtype`` on ``device``; ``net(x)`` is the BVP f32
    [B, T] of standardised clips ``x`` [B, T, C, C, 3] in ``dtype``.
    ``use_kernel`` is taken for the engine's seam: no kernel of the port
    takes PhysMamba's shapes, so every route is the plain one."""

    def __init__(self, cfg: PhysMambaConfig, params: dict,
                 dtype=torch.bfloat16, device=None, use_kernel: bool = False):
        self.cfg, self.dtype = cfg, dtype
        p = map_params(lambda t: t.to(torch.float64), params)

        def put(t):
            return t.to(device=device, dtype=dtype)

        def f32(t):
            return t.to(device=device, dtype=torch.float32)

        def folded(q, w=None):
            return fold_bn(q["w"] if w is None else w, q.get("b"), q["bn"])

        def frames(wb):
            """A 3-D conv's weight for the 2-D conv over frames whose
            channels hold the kt temporal taps (tap-major), channels-last."""
            w, b = wb
            return (put(w.transpose(1, 2).flatten(1, 2)).contiguous(
                memory_format=torch.channels_last), put(b))

        def taps(wb):
            """A [kt, 1, 1] conv's weight for ``F.linear`` over tap-major
            channels."""
            w, b = wb
            return put(w[..., 0, 0].transpose(1, 2).flatten(1)), put(b)

        w0, b0 = folded(p["stem0"])
        w0 = F.pad(_packed_stem0(w0[:, :, 0]), (0, 0, 0, 0, 0, 4))
        self.stem = [(put(w0).contiguous(memory_format=torch.channels_last),
                      put(b0)), frames(folded(p["stem1"])),
                     frames(folded(p["stem2"]))]
        self.split = [taps(folded(p["slow0"])), taps(folded(p["fast0"]))]

        def block(q):
            mb = q["mamba"]
            dirs = (mb["fwd"], mb["bwd"])

            def both(key, fn=f32):
                return fn(torch.stack([dd[key] for dd in dirs]))
            return {
                "cdc": frames(fold_bn(fold_cdc(q["cdc"]["w"], cfg.theta),
                                      None, q["cdc"]["bn"])),
                "ln1": (f32(q["ln1"]["w"]), f32(q["ln1"]["b"])),
                "in_w": put(mb["in_w"]),
                "conv_w": both("conv_w"), "conv_b": both("conv_b"),
                "x_w": both("x_w", put), "dt_w": both("dt_w"),
                "dt_b": both("dt_b"), "a": -torch.exp(both("a_log")),
                "d": both("d"), "out_w": put(mb["out_w"]),
                "ln2": (f32(q["ln2"]["w"]), f32(q["ln2"]["b"])),
                "fc1": f32(q["ca"]["fc1"][..., 0, 0, 0]),
                "fc2": f32(q["ca"]["fc2"][..., 0, 0, 0])}
        self.slow = [block(q) for q in p["slow"]]
        self.fast = [block(q) for q in p["fast"]]
        self.lat = [taps(folded(q)) for q in p["lat"]]
        self.fast_out = taps(folded(p["fast_out"]))
        self.up = [taps(folded(p["up1"])), taps(folded(p["up2"]))]
        w, b = p["last"]["w"], p["last"]["b"]
        self.last = (f32(w.reshape(-1)), f32(b))

    # -- stem -----------------------------------------------------------------

    def stem_apply(self, x: Tensor) -> tuple[Tensor, Tensor]:
        """[B, T, C, C, 3] -> (slow [B, T/4, C/4, C/4, slow_dim], fast [B,
        T/2, C/4, C/4, fast_dim])."""
        (w0, b0), (w1, b1), (w2, b2) = self.stem
        x = pf_stem.pf_stem_plain(x, w0, b0)
        x = F.relu_(_conv_frames(x, w1, b1))
        x = pf_stem.pf_stem_plain(x, w2, b2)
        (ws, bs), (wf, bf) = self.split
        return (F.relu_(F.linear(_strided_taps(x, 4), ws, bs)),
                F.relu_(F.linear(_strided_taps(x, 2), wf, bf)))

    # -- blocks ---------------------------------------------------------------

    def _mamba(self, blk: dict, h: Tensor) -> Tensor:
        """The bidirectional Mamba of tokens h [B, L, c] (compute dtype):
        [B, L, c] float32."""
        e = blk["in_w"].shape[0] // 2
        uz = F.linear(h, blk["in_w"])
        u, z = uz[..., :e], uz[..., e:]
        n = u.shape[1]
        v = F.silu(depthwise_convs(u, blk["conv_w"], blk["conv_b"])).to(
            self.dtype)
        r_n = blk["dt_w"].shape[-1]
        proj = [F.linear(v[i], blk["x_w"][i]) for i in range(2)]
        dt = torch.stack([F.softplus(F.linear(
            proj[i][..., :r_n].float(), blk["dt_w"][i], blk["dt_b"][i]))
            for i in range(2)])
        bm = torch.stack([q[..., r_n:-self.cfg.d_state] for q in proj])
        cm = torch.stack([q[..., -self.cfg.d_state:] for q in proj])
        with span("bpv.pm.scan"):
            y = selective_scan(v, dt, bm, cm, blk["a"], blk["d"])
        count("pm.scans", 2)
        count("pm.scan_tokens", 2 * u.shape[0] * n)
        g = (y * F.silu(z.float())).to(self.dtype)
        return F.linear(g, blk["out_w"]).float()

    def _tdm(self, blk: dict, x: Tensor) -> Tensor:
        """One temporal-difference Mamba block of [B, T, H, W, c]."""
        a = F.relu_(_conv_frames(x, *blk["cdc"]))
        c = a.shape[-1]
        tok = a.flatten(1, 3).float()                     # [B, L, c]
        h = F.layer_norm(tok, (c,), *blk["ln1"], LN_EPS).to(self.dtype)
        o = F.layer_norm(tok + self._mamba(blk, h), (c,), *blk["ln2"],
                         LN_EPS)

        def mlp(t):
            return F.linear(F.relu(F.linear(t, blk["fc1"])), blk["fc2"])
        att = torch.sigmoid(mlp(o.mean(1)) + mlp(o.amax(1)))
        return (o * att[:, None]).to(self.dtype).view(a.shape)

    def _lateral(self, i: int, s: Tensor, f: Tensor) -> Tensor:
        """``s + ReLU(BN(conv 3x1x1, stride 2, padding 1))(f)``: the fast
        pathway merged into the slow one."""
        w, b = self.lat[i]
        return s + F.relu_(F.linear(temporal_taps(f)[:, ::2], w, b))

    def blocks_apply(self, s: Tensor, f: Tensor) -> tuple[Tensor, Tensor]:
        """The six blocks and the two laterals -> (S2's block, F2's block),
        before the head."""
        for i in range(2):
            s = _pool(self._tdm(self.slow[i], s))
            f = _pool(self._tdm(self.fast[i], f))
            s = self._lateral(i, s, f)
        return self._tdm(self.slow[2], s), self._tdm(self.fast[2], f)

    # -- head -----------------------------------------------------------------

    def head_apply(self, s: Tensor, f: Tensor) -> Tensor:
        """Block outputs (slow at T/4, fast at T/2) -> the BVP f32 [B, T]."""
        (w1, b1), (w2, b2) = self.up
        s = F.elu(F.linear(temporal_taps(s.repeat_interleave(2, dim=1)),
                           w1, b1))
        f = F.relu_(F.linear(temporal_taps(f), *self.fast_out))
        y = torch.cat([f, s], -1).repeat_interleave(2, dim=1)
        y = F.elu(F.linear(temporal_taps(y), w2, b2))
        feat = y.float().mean((2, 3))                        # [B, T, head]
        w, b = self.last
        return feat @ w + b

    def __call__(self, x: Tensor) -> Tensor:
        with span("bpv.pm.stem"):
            s, f = self.stem_apply(x)
        with span("bpv.pm.blocks"):
            s, f = self.blocks_apply(s, f)
        with span("bpv.pm.head"):
            return self.head_apply(s, f)


# The net the engine builds for a ``PhysMambaConfig`` (its ``module``).
Net = PhysMamba
