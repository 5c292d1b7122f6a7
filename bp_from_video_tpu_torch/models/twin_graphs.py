"""Detector and segmenter architectures as parsed ``Graph``s, built with
numpy alone, beside ``mesh_graph.face_mesh_graph``.

They are the IR-level twins of the faithful TensorFlow-built fixtures the
CPU tests parse (``tests/tflite_fixtures.py``): what
``tflite_compiler.parse_tflite`` returns for a flatbuffer of that
architecture, with weights drawn from ``np.random.default_rng(seed)``.  A
machine that runs only the port has no TensorFlow to parse a flatbuffer
with; ``tflite_compiler.compile_graph`` takes these directly, so the
compiled-detector and compiled-segmenter paths of the runner run there.

``detector_graph(seed, input_size, anchors_per_scale, num_kps)`` (NHWC):
input [1, S, S, 3]; a 3x3/2 SAME conv to 16 channels + HARD_SWISH; a
depthwise-separable trunk (DEPTHWISE_CONV_2D 3x3 -> HARD_SWISH -> 1x1
CONV_2D -> HARD_SWISH, a residual ADD where the block keeps its shape) to
stride 8 (24, 24, 48 channels) and stride 16 (64); at each scale a 1x1
regressor conv and a 1x1 logit conv, each RESHAPEd to [1, cells*a, D] and
CONCATENATED over the scales: outputs logits [1, A, 1] and regressors
[1, A, 4+2K].  (192, (2, 6), 7) is the palm detector (2,016 anchors),
(128, (2, 6), 6) the BlazeFace short-range detector (896 anchors,
``anchors.FACE_SHORT_RANGE``).  The logit convs' bias is -3, as the
fixtures', so that random-weight detections stay sparse.  ``hot_anchor``
adds a constant after each concatenation (an ADD op each, as the
converter emits ``reg + c``) that makes that anchor detect: logit +12, a
box of ``hot_box`` input pixels, keypoints 0 and 1 level (the eyes of a
face).

``segmenter_graph(seed, input_size, classes)``: a 3x3/2 stem to 12
channels + HARD_SWISH, depthwise-separable encoder blocks to S/4 (16) and
S/8 (24), a residual block at S/8, a TRANSPOSE_CONV back to S/4 added to
the S/4 encoder output, a RESIZE_BILINEAR to S/2, a 1x1 conv added to the
stem output, a 1x1 class head, a RESIZE_BILINEAR to S and a SOFTMAX:
confidences [1, S, S, classes].
"""

from __future__ import annotations

import numpy as np

from bp_from_video_tpu_torch.models.mesh_graph import _GraphMaker
from bp_from_video_tpu_torch.models.tflite_compiler import Graph

# He gain of the fixtures' TensorFlow twins (0.7 * sqrt(2) over sqrt(fan_in)).
_GAIN = 0.7 * float(np.sqrt(2.0))


class _TwinMaker(_GraphMaker):
    def hswish(self, x: int, name: str) -> int:
        return self.op("HARD_SWISH", [x], self.shape(x), {}, name)

    def block(self, x: int, name: str, cout: int, stride: int) -> int:
        """Depthwise-separable block with HARD_SWISH after each conv; a
        residual ADD where it keeps its input's shape."""
        cin = self.shape(x)[3]
        y = self.hswish(self.depthwise(x, name + "/dw", stride), name + "/a")
        y = self.hswish(self.conv(y, name + "/pw", cout, gain=_GAIN),
                        name + "/b")
        if stride == 1 and cin == cout:
            y = self.op("ADD", [x, y], self.shape(y), dict(activation="NONE"),
                        name + "/add")
        return y

    def ints(self, name: str, values) -> int:
        return self.const(name, np.asarray(values, np.int32))

    def reshape(self, x: int, name: str, shape) -> int:
        return self.op("RESHAPE", [x, self.ints(name + "/shape", shape)],
                       tuple(shape), dict(new_shape=None), name)

    def concat(self, xs: list[int], name: str) -> int:
        n, _, d = self.shape(xs[0])
        a = sum(self.shape(t)[1] for t in xs)
        return self.op("CONCATENATION", xs, (n, a, d), dict(axis=1), name)

    def resize(self, x: int, name: str, size: int) -> int:
        n, _, _, c = self.shape(x)
        return self.op("RESIZE_BILINEAR", [x, self.ints(name + "/size",
                                                        [size, size])],
                       (n, size, size, c),
                       dict(align_corners=False, half_pixel_centers=True),
                       name)


def detector_graph(seed: int, input_size: int = 192,
                   anchors_per_scale: tuple[int, int] = (2, 6),
                   num_kps: int = 7, hot_anchor: int | None = None,
                   hot_box: float = 40.0) -> Graph:
    """The two-scale SSD detector with seeded random weights (module
    docstring)."""
    if input_size % 16:
        raise ValueError(f"input_size {input_size} is not a multiple of 16")
    box = 4 + 2 * num_kps
    b = _TwinMaker(seed)
    x = b.act("input", (1, input_size, input_size, 3))
    y = b.hswish(b.conv(x, "stem", 16, k=3, stride=2, gain=_GAIN),
                 "stem/hswish")
    for i, (c, s) in enumerate(((24, 2), (24, 1), (48, 2))):
        y = b.block(y, f"trunk8/{i}", c, s)
    regs, logits = [], []

    def hot(t: int, name: str, cols) -> int:
        """``t`` + a constant that is ``cols`` at the hot anchor."""
        c = np.zeros(b.shape(t), np.float32)
        c[0, hot_anchor, cols[0]:cols[0] + len(cols[1])] = cols[1]
        return b.op("ADD", [t, b.const(name + "/hot", c)], b.shape(t),
                    dict(activation="NONE"), name + "/add")
    # The converter's op order: a scale's regressor conv and reshape, then
    # (at the last scale after the regressors' concat and its hot ADD) its
    # logit conv and reshape.
    for scale, a in zip(("8", "16"), anchors_per_scale):
        if scale == "16":
            y = b.block(y, "trunk16/0", 64, 2)
        n, g, _, _ = b.shape(y)
        r = b.conv(y, f"head{scale}/reg", a * box, gain=_GAIN,
                   bias=np.zeros(a * box))
        regs.append(b.reshape(r, f"head{scale}/reg_flat",
                              (n, g * g * a, box)))
        if scale == "16":
            reg = b.concat(regs, "regressors")
            if hot_anchor is not None:
                reg = hot(reg, "regressors", (2, (
                    hot_box, hot_box, -hot_box / 4, -hot_box / 8,
                    hot_box / 4, -hot_box / 8)))
        lg = b.conv(y, f"head{scale}/logit", a, gain=_GAIN,
                    bias=np.full(a, -3.0))
        logits.append(b.reshape(lg, f"head{scale}/logit_flat",
                                (n, g * g * a, 1)))
    log = b.concat(logits, "classificators")
    if hot_anchor is not None:
        log = hot(log, "classificators", (0, (12.0,)))
    return Graph(b.tensors, b.ops, [x], [log, reg])


def segmenter_graph(seed: int, input_size: int = 256,
                    classes: int = 6) -> Graph:
    """The encoder-decoder segmenter with seeded random weights (module
    docstring)."""
    if input_size % 8:
        raise ValueError(f"input_size {input_size} is not a multiple of 8")
    s = input_size
    b = _TwinMaker(seed)
    x = b.act("input", (1, s, s, 3))
    stem = b.hswish(b.conv(x, "stem", 12, k=3, stride=2, gain=_GAIN),
                    "stem/hswish")                            # S/2, 12
    e1 = b.block(stem, "enc1", 16, 2)                          # S/4, 16
    e2 = b.block(e1, "enc2", 24, 2)                            # S/8, 24
    m = b.block(e2, "mid", 24, 1)
    n = b.shape(m)[0]
    w = (b.rng.standard_normal((16, 3, 3, 24))
         * (_GAIN / np.sqrt(9 * 24))).astype(np.float32)
    d1 = b.op("TRANSPOSE_CONV",
              [b.ints("up1/output_shape", [n, s // 4, s // 4, 16]),
               b.const("up1/w", w), m], (n, s // 4, s // 4, 16),
              dict(stride=(2, 2), padding="SAME"), "up1")
    d1 = b.op("ADD", [d1, e1], b.shape(d1), dict(activation="NONE"),
              "up1/skip")
    d1 = b.hswish(d1, "up1/hswish")
    d2 = b.resize(d1, "up2/resize", s // 2)
    d2 = b.conv(d2, "dec2", 12, gain=_GAIN)
    d2 = b.op("ADD", [d2, stem], b.shape(d2), dict(activation="NONE"),
              "dec2/skip")
    d2 = b.hswish(d2, "dec2/hswish")
    logits = b.conv(d2, "head", classes, gain=_GAIN)
    full = b.resize(logits, "head/resize", s)
    out = b.op("SOFTMAX", [full], b.shape(full), dict(beta=1.0), "softmax")
    return Graph(b.tensors, b.ops, [x], [out])
