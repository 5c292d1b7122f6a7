"""The op-by-op TFLite graph executor — the plain path of the port's
``models/tflite_compiler.py`` (a frozen copy, trimmed to what the
benchmark's nets run): a parsed graph (``Graph``, the IR that
``models/mesh_graph.py`` builds with numpy) compiles into
``fn(params, *inputs) -> [outputs]``, a plain Python function over a dict
of tensors, plus that dict.  No graph pass and no hand-written kernel:
every op runs as its PyTorch counterpart, activations stored planar
between ops while the graph's inputs and outputs keep the NHWC contract.
The op set is the face mesh's (``CONV_2D``, ``DEPTHWISE_CONV_2D``,
``MAX_POOL_2D``, ``PAD``, ``ADD``, ``PRELU``, ``LOGISTIC``); any other op
raises with its name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.ref import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class TensorInfo:
    name: str
    shape: tuple[int, ...]
    dtype: Any
    data: np.ndarray | None          # constant data
    quant: tuple | None              # (scale, zero_point[, axis]) if quantized


@dataclasses.dataclass
class OpNode:
    opcode: str
    inputs: list[int]
    outputs: list[int]
    options: dict


@dataclasses.dataclass
class Graph:
    tensors: list[TensorInfo]
    ops: list[OpNode]
    inputs: list[int]
    outputs: list[int]


def _tflite_pad(in_size: int, k: int, s: int, padding) -> tuple[int, int]:
    """TFLite's explicit (lo, hi) padding for one spatial dim (``k`` is the
    dilated kernel extent)."""
    if padding == "VALID":
        return (0, 0)
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    lo = total // 2
    return (lo, total - lo)


def _act(x: Tensor, name: str) -> Tensor:
    if name == "NONE":
        return x
    if name == "RELU":
        return torch.clamp(x, min=0.0)
    if name == "RELU6":
        return torch.clamp(x, 0.0, 6.0)
    if name == "RELU_N1_TO_1":
        return torch.clamp(x, -1.0, 1.0)
    if name == "TANH":
        return torch.tanh(x)
    raise NotImplementedError(f"activation {name}")


def _pad_same(x: Tensor, kh: int, kw: int, stride, padding, value=0.0
              ) -> Tensor:
    """Planar x padded by TFLite's SAME/VALID amounts."""
    ph = _tflite_pad(x.shape[2], kh, stride[0], padding)
    pw = _tflite_pad(x.shape[3], kw, stride[1], padding)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x


def compile_graph(graph: Graph, dtype=torch.float32, device=None
                  ) -> tuple[Callable[..., list[Tensor]], dict[str, Tensor]]:
    """Compile a parsed ``Graph`` into ``fn(params, *inputs) -> [outputs]``
    and its params, a dict of tensors on ``device`` (None means "cuda").

    ``dtype`` casts float weights and compute.  ``fn`` takes its 4-D image
    inputs planar ([N, C, H, W]), stores activations planar between ops
    and returns the graph's outputs in the NHWC contract.  Convolution
    outputs are emitted in the compute dtype (one rounding after f32
    accumulation).  Any leading batch runs."""
    device = resolve_device(device)

    def to_param(arr: np.ndarray) -> Tensor:
        t = torch.from_numpy(np.array(arr))     # a copy: never the graph's
        return (t.to(dtype) if t.is_floating_point() else t).to(device)

    params: dict[str, Tensor] = {}
    const_keys: dict[int, str] = {}
    for idx, info in enumerate(graph.tensors):
        if info.data is None:
            continue
        val = np.asarray(info.data)
        key = f"{idx}:{info.name}"
        params[key] = to_param(val.astype(np.float32)
                               if np.issubdtype(val.dtype, np.floating)
                               else val)
        const_keys[idx] = key

    def fn(p: dict[str, Tensor], *inputs: Tensor) -> list[Tensor]:
        if len(inputs) != len(graph.inputs):
            raise ValueError(f"expected {len(graph.inputs)} inputs")
        env: dict[int, Tensor] = {}
        lay: dict[int, bool] = {}  # idx -> stored planar (NCHW)
        for idx, key in const_keys.items():
            env[idx] = p[key]
        for idx, x in zip(graph.inputs, inputs):
            x = x.to(dtype)
            env[idx] = x
            if x.ndim == 4:
                lay[idx] = True

        def get(i: int) -> Tensor:
            """Tensor in its NHWC-contract form."""
            x = env[i]
            if lay.get(i):
                x = x.permute(0, 2, 3, 1)
            return x

        def get_planar(i: int) -> Tensor:
            """Tensor as [N, C, H, W] (sub-4D shapes right-aligned by NHWC
            broadcast semantics first)."""
            x = env[i]
            if lay.get(i):
                return x
            if x.ndim < 4:
                x = x.reshape((1,) * (4 - x.ndim) + tuple(x.shape))
            return x.permute(0, 3, 1, 2)

        def put(i: int, x: Tensor, planar: bool = False) -> None:
            env[i] = x
            if planar:
                lay[i] = True

        def ew_operands(ins_: list[int]) -> tuple[list[Tensor], bool]:
            if any(lay.get(i) for i in ins_):
                return [get_planar(i) for i in ins_], True
            return [get(i) for i in ins_], False

        def bias(y: Tensor, ins: list[int], slot: int) -> Tensor:
            if len(ins) > slot and ins[slot] >= 0:
                y = y + env[ins[slot]].reshape(-1, 1, 1)
            return y

        for op in graph.ops:
            name, ins, outs, o = op.opcode, op.inputs, op.outputs, op.options
            if name == "CONV_2D":
                x = get_planar(ins[0])
                w = env[ins[1]]                      # [out, kh, kw, in]
                dil = o["dilation"]
                x = _pad_same(x, (w.shape[1] - 1) * dil[0] + 1,
                              (w.shape[2] - 1) * dil[1] + 1, o["stride"],
                              o["padding"])
                y = F.conv2d(x, w.permute(0, 3, 1, 2), stride=o["stride"],
                             dilation=dil)
                put(outs[0], _act(bias(y, ins, 2), o["activation"]), True)
            elif name == "DEPTHWISE_CONV_2D":
                x = get_planar(ins[0])
                w = env[ins[1]]                      # [1, kh, kw, in*mult]
                cin = x.shape[1]
                dil = o["dilation"]
                x = _pad_same(x, (w.shape[1] - 1) * dil[0] + 1,
                              (w.shape[2] - 1) * dil[1] + 1, o["stride"],
                              o["padding"])
                y = F.conv2d(x, w.permute(3, 0, 1, 2), stride=o["stride"],
                             dilation=dil, groups=cin)
                put(outs[0], _act(bias(y, ins, 2), o["activation"]), True)
            elif name == "MAX_POOL_2D":
                x = get_planar(ins[0])
                kh, kw = o["filter"]
                xp = _pad_same(x, kh, kw, o["stride"], o["padding"],
                               value=-float("inf"))
                y = F.max_pool2d(xp, (kh, kw), o["stride"])
                put(outs[0], _act(y.to(dtype), o["activation"]), True)
            elif name == "PAD":
                pads = [(int(a), int(b))
                        for a, b in np.asarray(graph.tensors[ins[1]].data)]
                planar = len(pads) == 4
                x = get_planar(ins[0]) if planar else get(ins[0])
                if planar:
                    pads = [pads[0], pads[3], pads[1], pads[2]]
                y = F.pad(x, [v for pair in reversed(pads) for v in pair])
                put(outs[0], y, planar)
            elif name in ("ADD", "PRELU"):
                (a, b), planar = ew_operands([ins[0], ins[1]])
                y = (torch.where(a >= 0, a, a * b) if name == "PRELU"
                     else torch.add(a, b))
                put(outs[0], _act(y, o.get("activation", "NONE")), planar)
            elif name == "LOGISTIC":
                put(outs[0], torch.sigmoid(env[ins[0]]),
                    lay.get(ins[0], False))
            else:
                raise NotImplementedError(f"TFLite op {name}")
        return [get(i) for i in graph.outputs]

    fn.input_shapes = [graph.tensors[i].shape  # type: ignore[attr-defined]
                       for i in graph.inputs]
    fn.output_shapes = [graph.tensors[i].shape  # type: ignore[attr-defined]
                        for i in graph.outputs]
    return fn, params
