"""The face-mesh architecture as a parsed ``Graph``, built with numpy alone.

``face_mesh_graph(seed)`` is the IR-level twin of the random-init stand-ins
the runner falls back to: the architecture of MediaPipe's
``face_landmarks_detector.tflite`` with weights drawn from
``np.random.default_rng(seed)``, as ``tflite_compiler.parse_tflite`` would
return it for a flatbuffer of that architecture.  It exists because parsing
a flatbuffer needs TensorFlow's schema bindings, which a machine that only
runs the port need not have; ``tflite_compiler.compile_graph`` takes the
result directly.

Architecture (NHWC shapes): input [1, S, S, 3]; a 3x3/2 SAME conv to
``widths[0][0]`` channels + per-channel PRELU; then one stage per
``widths`` entry (C, D) of ``units_per_stage`` bottleneck units

    CONV_2D 1x1 (C->D) -> PRELU -> DEPTHWISE_CONV_2D 3x3/1 SAME
    -> CONV_2D 1x1 (D->C) -> ADD(x) -> PRELU

each stage after the first opened by a stride-2 downsample unit (a 2x2/2
conv as the down-projection, the residual a 2x2 max-pool with a channel
PAD); three heads over the last map, in the shipped output order:
landmarks [1, 1, 1, 3*L], presence and tongueOut [1, 1, 1, 1] (both
LOGISTIC).  At the default sizes: 7 stages at 128^2 ... 2^2, 28 stride-1
units, 6 downsample units.
"""

from __future__ import annotations

import numpy as np

from gpubench.ref.models.tflite_compiler import (Graph, OpNode,
                                                            TensorInfo)

FACE_MESH_WIDTHS = ((16, 8), (32, 16), (64, 32), (128, 64), (128, 64),
                    (128, 64), (128, 64))

_CONV = dict(dilation=(1, 1), activation="NONE")


class _GraphMaker:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.tensors: list[TensorInfo] = []
        self.ops: list[OpNode] = []

    def act(self, name: str, shape) -> int:
        self.tensors.append(TensorInfo(name, tuple(shape), np.float32, None,
                                       None))
        return len(self.tensors) - 1

    def const(self, name: str, arr: np.ndarray) -> int:
        self.tensors.append(TensorInfo(name, tuple(arr.shape), arr.dtype,
                                       np.ascontiguousarray(arr), None))
        return len(self.tensors) - 1

    def shape(self, t: int) -> tuple[int, ...]:
        return self.tensors[t].shape

    def op(self, opcode: str, ins: list[int], out_shape, options: dict,
           name: str) -> int:
        out = self.act(name, out_shape)
        self.ops.append(OpNode(opcode, ins, [out], options))
        return out

    def conv(self, x: int, name: str, cout: int, k: int = 1, stride: int = 1,
             padding: str = "SAME", gain: float = 1.0, bias=None) -> int:
        n, h, w, cin = self.shape(x)
        wt = self.rng.standard_normal((cout, k, k, cin)).astype(np.float32)
        wt *= np.float32(gain / np.sqrt(k * k * cin))
        if bias is None:
            bias = self.rng.uniform(-0.1, 0.1, cout)
        oh, ow = ((-(-h // stride), -(-w // stride)) if padding == "SAME"
                  else ((h - k) // stride + 1, (w - k) // stride + 1))
        return self.op("CONV_2D",
                       [x, self.const(name + "/w", wt),
                        self.const(name + "/b", np.asarray(bias, np.float32))],
                       (n, oh, ow, cout),
                       dict(stride=(stride, stride), padding=padding,
                            **_CONV), name)

    def prelu(self, x: int, name: str) -> int:
        c = self.shape(x)[3]
        alpha = self.rng.uniform(0.05, 0.3, (1, 1, c)).astype(np.float32)
        return self.op("PRELU", [x, self.const(name + "/alpha", alpha)],
                       self.shape(x), {}, name)

    def depthwise(self, x: int, name: str, stride: int = 1) -> int:
        n, h, w, c = self.shape(x)
        wt = (self.rng.standard_normal((1, 3, 3, c)) / 3.0).astype(np.float32)
        b = self.rng.uniform(-0.1, 0.1, c).astype(np.float32)
        return self.op("DEPTHWISE_CONV_2D",
                       [x, self.const(name + "/w", wt),
                        self.const(name + "/b", b)],
                       (n, -(-h // stride), -(-w // stride), c),
                       dict(stride=(stride, stride), padding="SAME",
                            depth_multiplier=1, **_CONV), name)

    def unit(self, x: int, name: str, c: int, d: int, down: bool) -> int:
        """One bottleneck unit; ``down`` makes it the stage's stride-2
        opener (2x2/2 down-projection, max-pool + channel-pad residual)."""
        z = self.conv(x, name + "/down", d, k=2 if down else 1,
                      stride=2 if down else 1)
        z = self.prelu(z, name + "/mid")
        z = self.depthwise(z, name + "/dw")
        z = self.conv(z, name + "/up", c, gain=0.25)
        r = x
        if down:
            n, h, w, cin = self.shape(x)
            r = self.op("MAX_POOL_2D", [x], (n, h // 2, w // 2, cin),
                        dict(stride=(2, 2), filter=(2, 2), padding="SAME",
                             activation="NONE"), name + "/pool")
            if c != cin:
                pads = np.asarray([[0, 0], [0, 0], [0, 0], [0, c - cin]],
                                  np.int32)
                r = self.op("PAD", [r, self.const(name + "/pads", pads)],
                            (n, h // 2, w // 2, c), {}, name + "/pad")
        y = self.op("ADD", [z, r], self.shape(z), dict(activation="NONE"),
                    name + "/add")
        return self.prelu(y, name + "/out")


def face_mesh_graph(seed: int, input_size: int = 256,
                    widths=FACE_MESH_WIDTHS, units_per_stage=None,
                    num_landmarks: int = 478) -> Graph:
    """The face-mesh graph with seeded random weights.

    ``widths``: (C, D) per stage; ``units_per_stage``: stride-1 units per
    stage (default 4 each; a stage of one unit cannot chain and compiles to
    a lone fused unit).  Gains keep activations of order 1 through all the
    units; the landmark head's bias spreads the landmarks over the crop
    interior and the presence head reports a face, so the random net keeps
    a tracker's geometry sane."""
    if units_per_stage is None:
        units_per_stage = (4,) * len(widths)
    if len(units_per_stage) != len(widths):
        raise ValueError(f"{len(widths)} stages, units_per_stage "
                         f"{units_per_stage}")
    if input_size % (2 ** len(widths)):
        raise ValueError(f"input_size {input_size} does not halve "
                         f"{len(widths)} times")
    b = _GraphMaker(seed)
    x = b.act("input", (1, input_size, input_size, 3))
    y = b.conv(x, "stem", widths[0][0], k=3, stride=2, gain=1.5)
    y = b.prelu(y, "stem/prelu")
    for s, ((c, d), units) in enumerate(zip(widths, units_per_stage)):
        if s > 0:
            y = b.unit(y, f"stage{s}/down", c, d, down=True)
        for u in range(units):
            y = b.unit(y, f"stage{s}/unit{u}", c, d, down=False)
    k = b.shape(y)[1]
    lm_bias = np.stack([b.rng.uniform(0.25, 0.75, num_landmarks),
                        b.rng.uniform(0.25, 0.75, num_landmarks),
                        np.zeros(num_landmarks)], -1) * input_size
    lm = b.conv(y, "landmarks", 3 * num_landmarks, k=k, padding="VALID",
                bias=lm_bias.reshape(-1))
    outs = [lm]
    for name, logit in (("presence", 4.0), ("tongue_out", -4.0)):
        h = b.conv(y, name + "/logit", 1, k=k, padding="VALID",
                   bias=[logit])
        outs.append(b.op("LOGISTIC", [h], b.shape(h), {}, name))
    return Graph(b.tensors, b.ops, [x], outs)
