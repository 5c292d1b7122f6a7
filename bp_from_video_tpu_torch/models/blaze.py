"""BlazePalm/BlazeFace detector, landmark-net and segmenter stand-ins — the
counterpart of ``bp_from_video_tpu/models/blaze.py``.

Parameters are nested dicts of arrays in the reference package's layouts
(conv weights HWIO), built host-side in numpy with the same random draws,
so one seed gives identical weights in both packages.  Activations are
planar [N, C, H, W] and every function takes the batch as its leading
axis.  A landmark stand-in also carries ``stem_p``, the 2x2
space-to-depth packed twin of its stem (the same linear map on packed
crops, derived from ``stem``; it draws no random numbers), which
``blaze_landmark_apply`` runs on crops that arrive packed (kernel K1's
``pack=2``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch.kernels import warp as warp_kernel
from bp_from_video_tpu_torch.models import warp

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


def _pack_stem(stem: dict, k: int, in_size: int) -> dict:
    """The 2x2 space-to-depth packed twin of a stride-2 SAME stem conv
    (numpy): the same linear map from a packed crop [12, S/2, S/2] to the
    packed stem output [4*O, S/4, S/4] (channel (dy*2+dx)*O + o)."""
    from bp_from_video_tpu_torch.models.tflite_compiler import (
        _pack_conv_weight, _tflite_pad)
    w = np.asarray(stem["w"], np.float32)            # HWIO [k, k, 3, O]
    b = np.asarray(stem["b"], np.float32)
    out = in_size // 2
    pads = (_tflite_pad(in_size, k, 2, "SAME"),) * 2
    wp, bp, _, _ = _pack_conv_weight(
        w.transpose(3, 0, 1, 2), b, 2, pads, 2,
        (in_size, in_size), (out // 2, out // 2))
    return {"w": np.ascontiguousarray(wp.transpose(1, 2, 3, 0)),  # HWIO
            "b": np.asarray(bp)}


def init_blaze_landmark(seed: int, input_size: int, num_landmarks: int
                        ) -> dict:
    """Landmark stand-in: 3x3/2 stem (and its packed twin ``stem_p``), four
    stride-2 3x3 dw+pw blocks, a dense landmark readout of the flattened
    [192, S/32, S/32] map and pooled 1x1 presence/aux heads (draw order as
    in the reference)."""
    rng = np.random.default_rng(seed)
    stem = _conv_init(rng, 3, 3, 3, 24)
    g = input_size // 32
    fan = 192 * g * g
    head_w = rng.standard_normal((fan, 3 * num_landmarks), np.float32)
    return {
        "stem": stem,
        "stem_p": _pack_stem(stem, 3, input_size),
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
    """Unfused landmark net: stem, four stride-2 blocks, heads, on plain
    planar crops [B, 3, S, S] or on 2x2 space-to-depth packed crops
    [B, 12, S/2, S/2] (channel (a*2+b)*3 + c, K1's ``pack=2``), which run
    the packed stem twin ``stem_p``."""
    s = input_size
    if x.shape[1] == 12 and "stem_p" in p:
        from bp_from_video_tpu_torch.models.tflite_compiler import (
            _pack_axis, _tflite_pad)
        k = p["stem"]["w"].shape[0]
        _, _, (lo, hi) = _pack_axis(k, _tflite_pad(s, k, 2, "SAME"), 2, 2, s,
                                    s // 4)
        w = p["stem_p"]["w"]                           # HWIO
        xp = F.pad(x.to(w.dtype), (lo, hi, lo, hi))
        y = F.conv2d(xp, w.permute(3, 2, 0, 1), stride=2)
        y = y + p["stem_p"]["b"].to(w.dtype).reshape(-1, 1, 1)
        # Unpack [B, 4*O, S/4, S/4] -> [B, O, S/2, S/2] (group-major
        # channels: (dy*2+dx)*O + o), per batch row.
        y = torch.relu(warp_kernel.unpack_s2d(y))
    else:
        y = torch.relu(_conv(p["stem"], x, stride=2))
    return landmark_trunk(p, y, s)


def landmark_trunk(p: dict, y: Tensor, input_size: int
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """Post-stem trunk + heads as plain convolutions: y = ReLU'd stem
    activations [B, 24, S/2, S/2] (the fused stem kernel K2 feeds this
    when the fused trunk is off)."""
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


def init_segmenter(seed: int, input_size: int, num_classes: int = 6) -> dict:
    """Encoder/decoder segmenter stand-in sized to the selfie_multiclass
    model's compute class (draw order as in the reference)."""
    rng = np.random.default_rng(seed)
    return {
        "stem": _conv_init(rng, 3, 3, 3, 16),
        "b1": _blaze_block_init(rng, 16, 32),
        "b2": _blaze_block_init(rng, 32, 64),
        "b3": _blaze_block_init(rng, 64, 64),
        "up1": _conv_init(rng, 3, 3, 64, 24),
        "up2": _conv_init(rng, 3, 3, 24, 12),
        "head": _conv_init(rng, 1, 1, 12, num_classes),
    }


def segmenter_features(p: dict, x: Tensor, input_size: int) -> Tensor:
    """Encoder and decoder up to the /2 feature map: planar [B, 3, S, S]
    -> [B, 12, S/2, S/2], everything but the class head and the last
    upsample."""
    s = input_size
    y = torch.relu(_conv(p["stem"], x, stride=2))    # /2
    y = _blaze_block(p["b1"], y, stride=2)           # /4
    y = _blaze_block(p["b2"], y, stride=2)           # /8
    y = _blaze_block(p["b3"], y)
    y = warp.resize_bilinear_planar(y, s // 4, s // 4)
    y = torch.relu(_conv(p["up1"], y))
    y = warp.resize_bilinear_planar(y, s // 2, s // 2)
    return torch.relu(_conv(p["up2"], y))


def segmenter_apply(p: dict, x: Tensor, input_size: int) -> Tensor:
    """Planar [B, 3, S, S] -> softmaxed class confidences [B, C, S, S],
    planar.  The 1x1 class head runs at /2, before the last bilinear
    upsample: a 1x1 conv commutes with bilinear interpolation (both linear,
    the interpolation weights of a pixel sum to 1), so the upsample moves
    C channels instead of 12."""
    s = input_size
    y = _conv(p["head"], segmenter_features(p, x, s))
    y = warp.resize_bilinear_planar(y, s, s)
    return torch.softmax(y, dim=1)


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
