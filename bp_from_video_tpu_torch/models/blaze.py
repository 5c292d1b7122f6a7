"""BlazePalm/BlazeFace detector and landmark-net stand-ins — the
counterpart of ``bp_from_video_tpu/models/blaze.py``.

Parameters are nested dicts of arrays in the reference package's layouts
(conv weights HWIO), built host-side in numpy with the same random draws,
so one seed gives identical weights in both packages.  Activations are
planar [N, C, H, W] and every function takes the batch as its leading
axis.  The packed-stem twin (``stem_p``) feeds only the unfused packed
path of the reference package and is not built here; it draws no random
numbers, so skipping it leaves every other draw identical.  The segmenter
stand-in is not ported yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def _conv_init(rng, kh, kw, cin, cout):
    """He-init conv params as numpy arrays (``rng``: np.random.Generator)."""
    fan_in = kh * kw * cin
    w = rng.standard_normal((kh, kw, cin, cout), np.float32)
    return {"w": w * np.float32(np.sqrt(2.0 / fan_in)),
            "b": np.zeros((cout,), np.float32)}


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA "SAME" padding of one axis: lo = total // 2, hi = the rest."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p, x: Tensor, stride: int = 1, groups: int = 1) -> Tensor:
    """SAME conv: x [N, C, H, W] -> [N, C', H', W'] in the weight dtype
    (the reference's one rounding after f32 accumulation)."""
    w = p["w"]                                        # HWIO
    kh, kw = w.shape[0], w.shape[1]
    py = _same_pads(x.shape[2], kh, stride)
    px = _same_pads(x.shape[3], kw, stride)
    x = F.pad(x.to(w.dtype), (px[0], px[1], py[0], py[1]))
    y = F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    return y + p["b"].to(w.dtype).reshape(-1, 1, 1)


def _maxpool_same(x: Tensor) -> Tensor:
    """2x2/2 max pool with SAME padding (-inf outside)."""
    py = _same_pads(x.shape[2], 2, 2)
    px = _same_pads(x.shape[3], 2, 2)
    if any(py + px):
        x = F.pad(x, (px[0], px[1], py[0], py[1]), value=-float("inf"))
    return F.max_pool2d(x, 2, 2)


def _blaze_block_init(rng, cin, cout, k=5):
    return {"dw": _conv_init(rng, k, k, 1, cin),
            "pw": _conv_init(rng, 1, 1, cin, cout)}


def _blaze_block(p, x: Tensor, stride: int = 1) -> Tensor:
    cin = x.shape[1]
    y = _conv(p["dw"], x, stride=stride, groups=cin)
    y = _conv(p["pw"], y)
    if stride == 2:
        x = _maxpool_same(x)
    cout = y.shape[1]
    if cout != cin:
        x = F.pad(x, (0, 0, 0, 0, 0, cout - cin))
    return torch.relu(y + x)


def init_blaze_detector(seed: int, input_size: int, num_anchors: int,
                        num_kps: int) -> dict:
    """Two-scale SSD detector: heads at /8 and /16 with 2 and 6 anchors per
    cell."""
    rng = np.random.default_rng(seed)
    box_dim = 4 + 2 * num_kps
    return {
        "stem": _conv_init(rng, 5, 5, 3, 24),
        "b1": _blaze_block_init(rng, 24, 24),
        "b2": _blaze_block_init(rng, 24, 48),   # /4
        "b3": _blaze_block_init(rng, 48, 48),
        "b4": _blaze_block_init(rng, 48, 96),   # /8
        "b5": _blaze_block_init(rng, 96, 96),
        "b6": _blaze_block_init(rng, 96, 96),   # /16
        "head8_box": _conv_init(rng, 1, 1, 96, 2 * box_dim),
        "head16_box": _conv_init(rng, 1, 1, 96, 6 * box_dim),
        "head8_cls": _conv_init(rng, 1, 1, 96, 2),
        "head16_cls": _conv_init(rng, 1, 1, 96, 6),
    }


def _head(p, y: Tensor, last_dim: int) -> Tensor:
    """1x1 head conv + anchor-major flatten (cells row-major, per-cell
    anchors contiguous)."""
    h = _conv(p, y)                                   # [B, A*D, Hc, Wc]
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1, last_dim)


def blaze_detector_apply(p: dict, x: Tensor, num_kps: int
                         ) -> tuple[Tensor, Tensor]:
    """x: planar [B, 3, S, S] -> (regressors [B, A, 4+2K], logits
    [B, A, 1])."""
    box_dim = 4 + 2 * num_kps
    y = torch.relu(_conv(p["stem"], x, stride=2))    # /2
    y = _blaze_block(p["b1"], y)
    y = _blaze_block(p["b2"], y, stride=2)           # /4
    y = _blaze_block(p["b3"], y)
    y8 = _blaze_block(p["b4"], y, stride=2)          # /8
    y8 = _blaze_block(p["b5"], y8)
    y16 = _blaze_block(p["b6"], y8, stride=2)        # /16
    r8 = _head(p["head8_box"], y8, box_dim)
    r16 = _head(p["head16_box"], y16, box_dim)
    c8 = _head(p["head8_cls"], y8, 1)
    c16 = _head(p["head16_cls"], y16, 1)
    return torch.cat([r8, r16], 1), torch.cat([c8, c16], 1)


def init_blaze_landmark(seed: int, input_size: int, num_landmarks: int
                        ) -> dict:
    """Landmark stand-in: 3x3/2 stem, four stride-2 3x3 dw+pw blocks, a
    dense landmark readout of the flattened [192, S/32, S/32] map and
    pooled 1x1 presence/aux heads (draw order as in the reference)."""
    rng = np.random.default_rng(seed)
    stem = _conv_init(rng, 3, 3, 3, 24)
    g = input_size // 32
    fan = 192 * g * g
    head_w = rng.standard_normal((fan, 3 * num_landmarks), np.float32)
    return {
        "stem": stem,
        "b1": _blaze_block_init(rng, 24, 48, k=3),
        "b2": _blaze_block_init(rng, 48, 96, k=3),
        "b3": _blaze_block_init(rng, 96, 96, k=3),
        "b4": _blaze_block_init(rng, 96, 192, k=3),
        "head_lm": {"w": head_w * np.float32(np.sqrt(1.0 / fan)),
                    "b": np.zeros((3 * num_landmarks,), np.float32)},
        "head_presence": _conv_init(rng, 1, 1, 192, 1),
        "head_aux": _conv_init(rng, 1, 1, 192, 1),
    }


def blaze_landmark_apply(p: dict, x: Tensor, input_size: int
                         ) -> tuple[Tensor, Tensor, Tensor]:
    """Unfused landmark net on plain planar crops [B, 3, S, S] (the path
    without the fused kernels): stem, four stride-2 blocks, heads."""
    y = torch.relu(_conv(p["stem"], x, stride=2))
    for name in ("b1", "b2", "b3", "b4"):
        y = _blaze_block(p[name], y, stride=2)
    return landmark_heads(p, y, input_size)


def landmark_heads(p: dict, y: Tensor, input_size: int
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """Spatial trunk features [B, 192, S/32, S/32] -> (landmarks [B, 3L] in
    crop pixels, presence [B, 1], aux [B, 1]).  The dense readout rounds
    its operands to the weight dtype and accumulates in f32."""
    b = y.shape[0]
    w = p["head_lm"]["w"]
    feats = y.reshape(b, -1).to(w.dtype)
    lm = feats.to(torch.float32) @ w.to(torch.float32)
    lm = lm + p["head_lm"]["b"].to(torch.float32)
    lm = torch.sigmoid(lm) * input_size
    pooled = y.mean((2, 3), keepdim=True)
    presence = torch.sigmoid(_conv(p["head_presence"], pooled).reshape(b, 1))
    aux = torch.sigmoid(_conv(p["head_aux"], pooled).reshape(b, 1))
    return lm, presence, aux


def load_standin_npz(path: str, return_meta: bool = False):
    """Stand-in params from a flat npz keyed by '/'-joined paths (numpy
    leaves); ``return_meta=True`` also returns the ``__meta__`` geometry
    stamp (empty for artifacts without one)."""
    out: dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for k in parts[:-1]:
                node = node.setdefault(k, {})
            node[parts[-1]] = data[key]
    meta = {k: int(v) for k, v in out.pop("__meta__", {}).items()}
    if return_meta:
        return out, meta
    return out
