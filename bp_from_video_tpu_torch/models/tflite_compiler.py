"""TFLite -> PyTorch graph compiler — the counterpart of
``bp_from_video_tpu/models/tflite_compiler.py``.

A ``.tflite`` flatbuffer is parsed into a small IR (``Graph``), rewritten by
graph passes and compiled into ``fn(params, *inputs) -> [outputs]``, a plain
Python function over a dict of tensors, plus that dict.  The op set is that
of the MediaPipe face/hand/segmentation model family; an unsupported op
raises with its name.  Execution is float: f32, f16 behind DEQUANTIZE and
dynamic-range int8 weights (per-channel scales included) dequantize at load.

``compile_tflite(data, ...)`` is ``compile_graph(parse_tflite(data), ...)``.
Only ``parse_tflite`` needs TensorFlow (its generated flatbuffer schema),
imported when it is first called; ``compile_graph`` takes a ``Graph`` from
any source (``models/mesh_graph.py`` makes one with numpy alone).

Graph passes, applied in this order by ``compile_graph``:
``_extract_stem`` splits a leading 3x3/2 image conv (+PReLU) off for the
fused stem kernels; ``fuse_bottlenecks`` rewrites the face-mesh residual
unit into a ``PALLAS_BN`` op (kernel K5, ``kernels/bottleneck``) and
``chain_bottlenecks`` merges a stage of them into ``PALLAS_BN_CHAIN``
(kernel K6); ``fuse_dw_pw_pairs`` composes depthwise -> 1x1 conv pairs into
dense convs; ``space_to_depth_pack`` stores large activations 2x2
space-to-depth packed (with ``packed_inputs`` the graph takes its image
packed, as kernel K1 emits it with ``pack=2``) through the pseudo-ops
``SPACE_TO_DEPTH``, ``DEPTH_TO_SPACE``, ``CHANNEL_GROUP_MAX`` and
``PACKED_CHANNEL_PAD``.  Each pass returns a new ``Graph`` that shares the
tensor storage.  The op names and appended constants' names are the
reference package's, kept so that the two packages' graphs compare op for
op.
"""

from __future__ import annotations

import dataclasses
import logging
import zipfile
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.kernels import bottleneck as bn_kernel
from bp_from_video_tpu_torch.kernels import warp as warp_kernel
from bp_from_video_tpu_torch.models import warp

Tensor = torch.Tensor
# space_to_depth_pack's pseudo-ops that the executor runs in planar storage
# (layout "NCHW") alone.
PLANAR_ONLY = frozenset({"CHANNEL_GROUP_MAX", "PACKED_CHANNEL_PAD"})

# TensorFlow is needed only to parse a flatbuffer, never to run a graph.
_schema = None


def _schema_fb():
    global _schema
    if _schema is None:
        from tensorflow.lite.python import schema_py_generated as schema_fb
        _schema = schema_fb
    return _schema


_TENSOR_DTYPES = {
    # TFLite schema TensorType numbering; 17 = INT4 (packed nibbles) is
    # unsupported and must not be viewed as a wider dtype.
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    6: np.bool_, 7: np.int16, 9: np.int8, 10: np.float64, 15: np.uint32,
    16: np.uint16,
}


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


def _opcode_name(model, op) -> str:
    schema_fb = _schema_fb()
    oc = model.OperatorCodes(op.OpcodeIndex())
    code = oc.DeprecatedBuiltinCode()
    if code == 127:  # placeholder: the real code is in BuiltinCode
        code = oc.BuiltinCode()
    else:
        code = max(code, oc.BuiltinCode())
    for name in dir(schema_fb.BuiltinOperator):
        if (not name.startswith("_")
                and getattr(schema_fb.BuiltinOperator, name) == code):
            return name
    return f"UNKNOWN_{code}"


def _options(op, cls) -> Any:
    o = cls()
    tab = op.BuiltinOptions()
    if tab is None:
        return None
    o.Init(tab.Bytes, tab.Pos)
    return o


_ACT_NAMES = {0: "NONE", 1: "RELU", 2: "RELU_N1_TO_1", 3: "RELU6", 4: "TANH"}
_PAD_NAMES = {0: "SAME", 1: "VALID"}


def _parse_options(model, op, name) -> dict:
    schema_fb = _schema_fb()
    if name == "CONV_2D":
        o = _options(op, schema_fb.Conv2DOptions)
        return dict(stride=(o.StrideH(), o.StrideW()),
                    dilation=(o.DilationHFactor(), o.DilationWFactor()),
                    padding=_PAD_NAMES[o.Padding()],
                    activation=_ACT_NAMES[o.FusedActivationFunction()])
    if name == "DEPTHWISE_CONV_2D":
        o = _options(op, schema_fb.DepthwiseConv2DOptions)
        return dict(stride=(o.StrideH(), o.StrideW()),
                    dilation=(o.DilationHFactor(), o.DilationWFactor()),
                    padding=_PAD_NAMES[o.Padding()],
                    depth_multiplier=o.DepthMultiplier(),
                    activation=_ACT_NAMES[o.FusedActivationFunction()])
    if name == "TRANSPOSE_CONV":
        o = _options(op, schema_fb.TransposeConvOptions)
        return dict(stride=(o.StrideH(), o.StrideW()),
                    padding=_PAD_NAMES[o.Padding()])
    if name in ("MAX_POOL_2D", "AVERAGE_POOL_2D"):
        o = _options(op, schema_fb.Pool2DOptions)
        return dict(stride=(o.StrideH(), o.StrideW()),
                    filter=(o.FilterHeight(), o.FilterWidth()),
                    padding=_PAD_NAMES[o.Padding()],
                    activation=_ACT_NAMES[o.FusedActivationFunction()])
    if name in ("ADD", "SUB", "MUL", "DIV"):
        cls = getattr(schema_fb, name.capitalize() + "Options")
        o = _options(op, cls)
        act = o.FusedActivationFunction() if o is not None else 0
        return dict(activation=_ACT_NAMES[act])
    if name == "CONCATENATION":
        o = _options(op, schema_fb.ConcatenationOptions)
        return dict(axis=o.Axis())
    if name == "RESHAPE":
        o = _options(op, schema_fb.ReshapeOptions)
        new_shape = None
        if o is not None and o.NewShapeLength() > 0:
            new_shape = tuple(o.NewShape(i) for i in range(o.NewShapeLength()))
        return dict(new_shape=new_shape)
    if name in ("MEAN", "SUM", "REDUCE_MAX"):
        o = _options(op, schema_fb.ReducerOptions)
        return dict(keep_dims=bool(o.KeepDims()) if o is not None else False)
    if name == "STRIDED_SLICE":
        o = _options(op, schema_fb.StridedSliceOptions)
        return dict(begin_mask=o.BeginMask(), end_mask=o.EndMask(),
                    ellipsis_mask=o.EllipsisMask(),
                    new_axis_mask=o.NewAxisMask(),
                    shrink_axis_mask=o.ShrinkAxisMask())
    if name == "RESIZE_BILINEAR":
        o = _options(op, schema_fb.ResizeBilinearOptions)
        return dict(align_corners=bool(o.AlignCorners()),
                    half_pixel_centers=bool(o.HalfPixelCenters()))
    if name == "RESIZE_NEAREST_NEIGHBOR":
        o = _options(op, schema_fb.ResizeNearestNeighborOptions)
        return dict(align_corners=bool(o.AlignCorners()),
                    half_pixel_centers=bool(o.HalfPixelCenters()))
    if name == "FULLY_CONNECTED":
        o = _options(op, schema_fb.FullyConnectedOptions)
        return dict(activation=_ACT_NAMES[o.FusedActivationFunction()])
    if name == "SOFTMAX":
        o = _options(op, schema_fb.SoftmaxOptions)
        return dict(beta=o.Beta())
    return {}


def parse_tflite(data: bytes) -> Graph:
    """Parse a .tflite flatbuffer into the IR (tensors + topological op
    list).  Needs TensorFlow's schema bindings."""
    schema_fb = _schema_fb()
    model = schema_fb.Model.GetRootAsModel(data, 0)
    sg = model.Subgraphs(0) if model.SubgraphsLength() else None
    if sg is None:
        raise ValueError("not a TFLite flatbuffer: no subgraph")
    tensors: list[TensorInfo] = []
    for i in range(sg.TensorsLength()):
        t = sg.Tensors(i)
        shape = tuple(t.ShapeAsNumpy().tolist()) if t.ShapeLength() else ()
        dtype = _TENSOR_DTYPES.get(t.Type())
        buf = model.Buffers(t.Buffer())
        if dtype is None:
            if buf.DataLength() > 0:
                raise NotImplementedError(
                    f"tensor type {t.Type()} with constant data")
            dtype = np.float32
        arr = None
        if buf.DataLength() > 0:
            raw = buf.DataAsNumpy().view(dtype)
            arr = raw.reshape(shape) if shape else raw
        quant = None
        q = t.Quantization()
        if q is not None and q.ScaleLength() == 1:
            quant = (float(q.Scale(0)),
                     int(q.ZeroPoint(0)) if q.ZeroPointLength() else 0)
        elif q is not None and q.ScaleLength() > 1:
            # Per-channel quantization: the full scale and zero-point
            # vectors plus the quantized dimension.
            quant = (q.ScaleAsNumpy().astype(np.float32),
                     (q.ZeroPointAsNumpy().astype(np.int64)
                      if q.ZeroPointLength() else
                      np.zeros(q.ScaleLength(), np.int64)),
                     int(q.QuantizedDimension()))
        name = t.Name().decode() if t.Name() else f"t{i}"
        tensors.append(TensorInfo(name, shape, dtype, arr, quant))
    ops: list[OpNode] = []
    for i in range(sg.OperatorsLength()):
        op = sg.Operators(i)
        name = _opcode_name(model, op)
        ins = [op.Inputs(j) for j in range(op.InputsLength())]
        outs = [op.Outputs(j) for j in range(op.OutputsLength())]
        ops.append(OpNode(name, ins, outs, _parse_options(model, op, name)))
    inputs = [sg.Inputs(i) for i in range(sg.InputsLength())]
    outputs = [sg.Outputs(i) for i in range(sg.OutputsLength())]
    return Graph(tensors, ops, inputs, outputs)


# --- graph passes ----------------------------------------------------------------


class _GraphEdit:
    """Shared machinery of the graph passes: the consumers map, constant
    resolution that folds DEQUANTIZE, and tensor appends — one copy, so the
    passes cannot disagree about which tensors are constant."""

    def __init__(self, graph: Graph):
        self.graph = graph
        self.tensors = list(graph.tensors)
        self.consumers: dict[int, list[int]] = {}
        for i, op in enumerate(graph.ops):
            for t in op.inputs:
                if t >= 0:
                    self.consumers.setdefault(t, []).append(i)
        self.dequant_of = {op.outputs[0]: op.inputs[0] for op in graph.ops
                           if op.opcode == "DEQUANTIZE"
                           and graph.tensors[op.inputs[0]].data is not None}

    def const(self, idx: int) -> np.ndarray | None:
        if idx < 0:
            return None
        src = self.dequant_of.get(idx)
        if src is not None:
            info = self.graph.tensors[src]
            return _dequant(info, info.data)
        info = self.tensors[idx]
        return None if info.data is None else _dequant(info, info.data)

    def add_const(self, name: str, arr: np.ndarray) -> int:
        self.tensors.append(TensorInfo(name, tuple(arr.shape), arr.dtype,
                                       np.ascontiguousarray(arr), None))
        return len(self.tensors) - 1

    def add_tensor(self, name: str, shape, data=None) -> int:
        self.tensors.append(TensorInfo(
            name, tuple(int(x) for x in shape), np.float32,
            None if data is None else np.ascontiguousarray(data), None))
        return len(self.tensors) - 1

    def sole_consumer(self, t: int) -> tuple[int, "OpNode | None"]:
        cons = self.consumers.get(t, [])
        if len(cons) == 1 and t not in self.graph.outputs:
            return cons[0], self.graph.ops[cons[0]]
        return -1, None


def fuse_dw_pw_pairs(graph: Graph) -> Graph:
    """Fold DEPTHWISE_CONV_2D -> 1x1 CONV_2D pairs into single dense convs.

    The MediaPipe graphs put no activation between a depthwise conv and the
    pointwise conv after it, so the pair is a composition of two linear
    maps and folds exactly into one dense (kh, kw) convolution:

        W[o,u,v,c] = pw[o,c] * dw[u,v,c]      b[o] = pw_b[o] + sum_c pw[o,c] dw_b[c]

    The composed conv reads the activation once and never writes the
    depthwise output.  Composed weights are appended as constants
    ``fused_dwpw_w_{i}`` / ``fused_dwpw_b_{i}`` (``i`` the depthwise op's
    index)."""
    ge = _GraphEdit(graph)
    consumers, tensors = ge.consumers, ge.tensors
    const, add_const = ge.const, ge.add_const

    new_ops: list[OpNode] = []
    skip: set[int] = set()
    for i, op in enumerate(graph.ops):
        if i in skip:
            continue
        if (op.opcode == "DEPTHWISE_CONV_2D"
                and op.options.get("activation") == "NONE"
                and op.options.get("depth_multiplier") == 1
                and op.options.get("dilation") == (1, 1)):
            out = op.outputs[0]
            cons = consumers.get(out, [])
            if len(cons) == 1 and out not in graph.outputs:
                nxt = graph.ops[cons[0]]
                dw_w = const(op.inputs[1])
                pw_w = const(nxt.inputs[1]) if nxt.opcode == "CONV_2D" else None
                if (nxt.opcode == "CONV_2D" and nxt.inputs[0] == out
                        and nxt.options.get("stride") == (1, 1)
                        and nxt.options.get("dilation") == (1, 1)
                        and dw_w is not None and pw_w is not None
                        and pw_w.shape[1] == pw_w.shape[2] == 1):
                    kh, kw = dw_w.shape[1], dw_w.shape[2]
                    c = dw_w.shape[3]
                    o_ = pw_w.shape[0]
                    # [o, kh, kw, c]: the TFLite CONV_2D weight layout.
                    comp = (pw_w.reshape(o_, 1, 1, c).astype(np.float32)
                            * dw_w.reshape(1, kh, kw, c).astype(np.float32))
                    dw_b = const(op.inputs[2]) if len(op.inputs) > 2 else None
                    pw_b = const(nxt.inputs[2]) if len(nxt.inputs) > 2 else None
                    bias = np.zeros((o_,), np.float32)
                    if pw_b is not None:
                        bias += pw_b.astype(np.float32)
                    if dw_b is not None:
                        bias += pw_w.reshape(o_, c).astype(np.float32) @ (
                            dw_b.astype(np.float32))
                    w_idx = add_const(f"fused_dwpw_w_{i}", comp)
                    b_idx = add_const(f"fused_dwpw_b_{i}", bias)
                    new_ops.append(OpNode(
                        "CONV_2D", [op.inputs[0], w_idx, b_idx],
                        list(nxt.outputs),
                        dict(stride=op.options["stride"], dilation=(1, 1),
                             padding=op.options["padding"],
                             activation=nxt.options.get("activation",
                                                        "NONE"))))
                    skip.add(cons[0])
                    continue
        new_ops.append(op)
    return Graph(tensors, new_ops, list(graph.inputs), list(graph.outputs))


def fuse_bottlenecks(graph: Graph, min_hw: int = 0) -> Graph:
    """Fuse the MediaPipe bottleneck residual unit into one op.

    The face-mesh trunk repeats
        CONV1x1(C->D) -> PRELU -> DW3x3/s1 -> CONV1x1(D->C') -> ADD(r)
        [-> PRELU]
    with no activation between the depthwise and the up-projection, so the
    pair composes exactly into one dense 3x3 D->C' conv and the unit becomes
    two products on an activation that never leaves the chip (kernel K5).

    A matched unit becomes a ``PALLAS_BN`` op with inputs [x, residual, wd,
    bd, ad, wu, bu, au] (the packed weights appended as constants) and
    options {"cmid", "last_act"}.  ``min_hw``: only units whose spatial size
    is at least ``min_hw`` fuse.
    """
    ge = _GraphEdit(graph)
    tensors = ge.tensors
    const, add_const = ge.const, ge.add_const
    sole_consumer = ge.sole_consumer
    producer = {t: j for j, o in enumerate(graph.ops) for t in o.outputs}

    new_ops: list[OpNode] = []
    skip: set[int] = set()
    n_fused = 0
    for i, op in enumerate(graph.ops):
        if i in skip:
            continue
        # -- match: 1x1 down-projection ---------------------------------------
        w_down = const(op.inputs[1]) if op.opcode == "CONV_2D" else None
        if (w_down is None or w_down.shape[1] != 1 or w_down.shape[2] != 1
                or op.options.get("stride") != (1, 1)
                or op.options.get("activation") != "NONE"):
            new_ops.append(op)
            continue
        out_shape = graph.tensors[op.outputs[0]].shape
        if len(out_shape) != 4 or min(out_shape[1], out_shape[2]) < min_hw:
            new_ops.append(op)
            continue
        pre_i, pre = sole_consumer(op.outputs[0])
        if pre is None or pre.opcode != "PRELU":
            new_ops.append(op)
            continue
        a_mid = const(pre.inputs[1])
        dwo_i, dwo = sole_consumer(pre.outputs[0])
        if (dwo is None or dwo.opcode != "DEPTHWISE_CONV_2D"
                or dwo.options.get("stride") != (1, 1)
                or dwo.options.get("dilation") != (1, 1)
                or dwo.options.get("depth_multiplier") != 1
                or dwo.options.get("padding") != "SAME"
                or dwo.options.get("activation") != "NONE"
                or a_mid is None):
            new_ops.append(op)
            continue
        w_dw = const(dwo.inputs[1])
        if w_dw is None or w_dw.shape[1:3] != (3, 3):
            new_ops.append(op)
            continue
        upo_i, upo = sole_consumer(dwo.outputs[0])
        w_up = const(upo.inputs[1]) if (upo is not None
                                        and upo.opcode == "CONV_2D") else None
        if (w_up is None or w_up.shape[1] != 1 or w_up.shape[2] != 1
                or upo.options.get("stride") != (1, 1)
                or upo.options.get("activation") != "NONE"):
            new_ops.append(op)
            continue
        addo_i, addo = sole_consumer(upo.outputs[0])
        if addo is None or addo.opcode != "ADD":
            new_ops.append(op)
            continue
        resid = [t for t in addo.inputs if t != upo.outputs[0]]
        if len(resid) != 1 or const(resid[0]) is not None:
            new_ops.append(op)
            continue
        if producer.get(resid[0], -1) > i:
            # The fused op lands at the down-conv's position; a residual
            # produced after it would be read before it exists.
            new_ops.append(op)
            continue
        last_i, last = sole_consumer(addo.outputs[0])
        act = addo.options.get("activation", "NONE")
        if last is not None and last.opcode == "PRELU" and act == "NONE":
            a_out = const(last.inputs[1])
            out_t = last.outputs[0]
            last_act = "prelu"
            tail = {addo_i, last_i}
        elif act in ("NONE", "RELU"):
            a_out = None
            out_t = addo.outputs[0]
            last_act = "relu" if act == "RELU" else "none"
            tail = {addo_i}
        else:
            # RELU6 / RELU_N1_TO_1 / TANH on the ADD have no kernel
            # epilogue: fusing would change the activation.
            new_ops.append(op)
            continue
        # -- pack ---------------------------------------------------------------
        d = w_down.shape[0]
        cout = w_up.shape[0]
        # TFLite conv weights are [out, kh, kw, in]; the packer takes HWIO.
        wd, wu = bn_kernel.pack_bottleneck_weights(
            w_down.transpose(1, 2, 3, 0),      # [1,1,C,D]
            w_dw.transpose(1, 2, 0, 3),        # [3,3,1,D]
            w_up.transpose(1, 2, 3, 0),        # [1,1,D,C']
            dtype=np.float32)                  # graph dtype applied at load
        bd = const(op.inputs[2]) if len(op.inputs) > 2 else None
        bd = (np.zeros((d,), np.float32) if bd is None
              else bd.astype(np.float32))
        b_dw = const(dwo.inputs[2]) if len(dwo.inputs) > 2 else None
        b_up = const(upo.inputs[2]) if len(upo.inputs) > 2 else None
        bu = np.zeros((cout,), np.float32)
        if b_up is not None:
            bu += b_up.astype(np.float32)
        if b_dw is not None:
            # The depthwise bias rides through the up-projection once per
            # output.
            bu += w_up.reshape(cout, d).astype(np.float32) @ (
                b_dw.astype(np.float32))
        au = (np.zeros((cout,), np.float32) if a_out is None
              else a_out.reshape(-1).astype(np.float32))
        ins = [op.inputs[0], resid[0],
               add_const(f"bn_wd_{i}", np.asarray(wd, np.float32)),
               add_const(f"bn_bd_{i}", bd),
               add_const(f"bn_ad_{i}", a_mid.reshape(-1).astype(np.float32)),
               add_const(f"bn_wu_{i}", np.asarray(wu, np.float32)),
               add_const(f"bn_bu_{i}", bu),
               add_const(f"bn_au_{i}", au)]
        new_ops.append(OpNode("PALLAS_BN", ins, [out_t],
                              {"cmid": int(d), "last_act": last_act}))
        skip.update({pre_i, dwo_i, upo_i} | tail)
        n_fused += 1
    if n_fused:
        logging.getLogger(__name__).info(
            "fuse_bottlenecks: fused %d residual units", n_fused)
    return Graph(tensors, new_ops, list(graph.inputs), list(graph.outputs))


def chain_bottlenecks(graph: Graph) -> Graph:
    """Merge runs of self-residual same-shape ``PALLAS_BN`` ops into one
    ``PALLAS_BN_CHAIN`` op (kernel K6): a whole stage in one launch, its
    activation read once and written once.

    Chain inputs: [x, wd, bd, ad, wu, bu, au] with the units' packed
    weights stacked on a leading U axis; options {"cmid", "last_act"}."""
    ge = _GraphEdit(graph)
    consumers, tensors, add_const = ge.consumers, ge.tensors, ge.add_const

    def chainable(op: OpNode) -> bool:
        return op.opcode == "PALLAS_BN" and op.inputs[0] == op.inputs[1]

    def follows(a: OpNode, ai: int, b: OpNode) -> bool:
        # set(): a self-residual unit consumes its input at both operand
        # slots, so the consumers list holds its index twice.
        return (b.inputs[0] == a.outputs[0] and b.inputs[1] == a.outputs[0]
                and b.options == a.options
                and set(consumers.get(a.outputs[0], ())) == {ai + 1}
                and a.outputs[0] not in graph.outputs)

    new_ops: list[OpNode] = []
    i = 0
    n_chained = 0
    ops = graph.ops
    while i < len(ops):
        op = ops[i]
        run = [i]
        if chainable(op):
            j = i
            while (j + 1 < len(ops) and chainable(ops[j + 1])
                   and follows(ops[j], j, ops[j + 1])):
                run.append(j + 1)
                j += 1
        if len(run) < 2:
            new_ops.append(op)
            i += 1
            continue
        members = [ops[k] for k in run]

        def stacked(slot: int, name: str) -> int:
            arrs = [tensors[m.inputs[slot]].data for m in members]
            return add_const(f"bnc_{name}_{run[0]}", np.stack(arrs))

        ins = [op.inputs[0], stacked(2, "wd"), stacked(3, "bd"),
               stacked(4, "ad"), stacked(5, "wu"), stacked(6, "bu"),
               stacked(7, "au")]
        new_ops.append(OpNode("PALLAS_BN_CHAIN", ins,
                              [members[-1].outputs[0]], dict(op.options)))
        n_chained += 1
        i = run[-1] + 1
    if n_chained:
        logging.getLogger(__name__).info(
            "chain_bottlenecks: merged %d stage chains", n_chained)
    return Graph(tensors, new_ops, list(graph.inputs), list(graph.outputs))


def _tflite_pad(in_size: int, k: int, s: int, padding) -> tuple[int, int]:
    """TFLite's explicit (lo, hi) padding for one spatial dim (``k`` is the
    dilated kernel extent)."""
    if isinstance(padding, tuple):
        return padding
    if padding == "VALID":
        return (0, 0)
    out = -(-in_size // s)
    total = max((out - 1) * s + k - in_size, 0)
    lo = total // 2
    return (lo, total - lo)


def _pack_axis(k: int, pad: tuple[int, int], s: int, f_out: int,
               in_size: int, out_size: int) -> tuple[int, int, tuple[int, int]]:
    """Packed-domain kernel start, extent and explicit padding for one
    spatial dim (shared by ``_pack_conv_weight`` and the stand-ins' packed
    stems): (r_min, k', (pad_lo, pad_hi))."""
    sp = s * f_out // 2
    lo, _ = pad
    ts = [s * d + u - lo for d in range(f_out) for u in range(k)]
    r_min = min(t // 2 for t in ts)
    r_max = max(t // 2 for t in ts)
    kp = r_max - r_min + 1
    plo = -r_min
    packed_in = in_size // 2
    phi = max(0, sp * (out_size - 1) + kp - plo - packed_in)
    return r_min, kp, (plo, phi)


def _pack_conv_weight(w: np.ndarray, b: np.ndarray | None, s: int,
                      pads: tuple[tuple[int, int], tuple[int, int]],
                      f_out: int, in_hw: tuple[int, int],
                      out_hw: tuple[int, int]):
    """Re-scatter a conv weight [O, kh, kw, C] into the 2x2 space-to-depth
    packed domain.

    Packed tensors hold x[2i+a, 2j+b, c] at X[i, j, (a*2+b)*C + c].  A
    (kh, kw, stride s) conv becomes a (kh', kw', stride s*f_out/2) conv on
    the packed tensor: tap offset t = s*dy + u - pad_lo maps to packed tap
    t//2, sub-position t%2.  ``f_out`` 2 emits a packed output (channels
    (dy*2+dx)*O + o), 1 an unpacked one.

    Returns (w' [O', kh', kw', 4C], b' [O'], stride', explicit padding)."""
    o_, kh, kw, c = w.shape
    assert s * f_out in (2, 4), "unsupported stride/packing combination"
    sp = s * f_out // 2
    ry0, khp, pad_y = _pack_axis(kh, pads[0], s, f_out, in_hw[0], out_hw[0])
    rx0, kwp, pad_x = _pack_axis(kw, pads[1], s, f_out, in_hw[1], out_hw[1])

    wp = np.zeros((f_out * f_out * o_, khp, kwp, 4 * c), np.float32)
    for dy in range(f_out):
        for dx in range(f_out):
            g = dy * f_out + dx
            for u in range(kh):
                ty = s * dy + u - pads[0][0]
                for v in range(kw):
                    tx = s * dx + v - pads[1][0]
                    gi = (ty % 2) * 2 + (tx % 2)
                    wp[g * o_:(g + 1) * o_, ty // 2 - ry0, tx // 2 - rx0,
                       gi * c:(gi + 1) * c] = w[:, u, v, :]
    bp = None if b is None else np.tile(b.astype(np.float32), f_out * f_out)
    return wp, bp, sp, (pad_y, pad_x)


def space_to_depth_pack(graph: Graph, min_hw: int = 64,
                        packed_inputs: bool = False) -> Graph:
    """Store every activation with H, W >= ``min_hw`` 2x2 space-to-depth
    packed ([H/2, W/2, 4C]) and rewrite the ops between them: convs (weights
    re-scattered by ``_pack_conv_weight``), PRELU, ADD, 2x2/2 MAX_POOL
    (``CHANNEL_GROUP_MAX``: the max over a packed pixel's four
    sub-positions) and channel PAD (``PACKED_CHANNEL_PAD``).  Any other op
    runs unpacked: a ``DEPTH_TO_SPACE`` materializes its input on demand.

    ``packed_inputs``: the caller feeds 4-D image inputs already packed
    (kernel K1's ``pack=2`` output): the graph input becomes a packed-shape
    tensor and the original materializes only on demand.  Shapes are the
    graph's static batch-1 shapes; the pseudo-ops take the batch from the
    tensor they run on."""
    ge = _GraphEdit(graph)
    tensors = ge.tensors
    const, add_tensor = ge.const, ge.add_tensor

    new_ops: list[OpNode] = []
    packed_of: dict[int, int] = {}    # orig idx -> packed tensor idx
    unpacked_of: dict[int, int] = {}  # packed-only outputs -> unpacked idx

    def shape_of(t: int):
        return tensors[t].shape

    def packable(t: int) -> bool:
        s = shape_of(t)
        return (len(s) == 4 and s[0] == 1 and s[1] >= min_hw
                and s[1] % 2 == 0 and s[2] % 2 == 0)

    def get_packed(t: int) -> int | None:
        if t in packed_of:
            return packed_of[t]
        if t not in produced or not packable(t):
            return None
        _, h, w, c = shape_of(t)
        p = add_tensor(f"{tensors[t].name}_s2d", (1, h // 2, w // 2, 4 * c))
        new_ops.append(OpNode("SPACE_TO_DEPTH", [t], [p], {"block": 2}))
        packed_of[t] = p
        return p

    def ensure_unpacked(t: int) -> int:
        if t in unpacked_of:
            return unpacked_of[t]
        if t in packed_of and t not in produced:
            u = add_tensor(f"{tensors[t].name}_d2s", shape_of(t))
            new_ops.append(OpNode("DEPTH_TO_SPACE", [packed_of[t]], [u],
                                  {"block": 2}))
            unpacked_of[t] = u
            return u
        return t

    produced: set[int] = set(graph.inputs)  # tensors with an unpacked copy
    new_inputs = list(graph.inputs)
    if packed_inputs:
        for i, t in enumerate(graph.inputs):
            if packable(t):
                _, h, w, c = shape_of(t)
                p = add_tensor(f"{tensors[t].name}_pin",
                               (1, h // 2, w // 2, 4 * c))
                packed_of[t] = p
                new_inputs[i] = p
                produced.discard(t)
    for idx, info in enumerate(tensors):
        if info.data is not None:
            produced.add(idx)
    produced.update(ge.dequant_of.keys())

    for op in graph.ops:
        name, ins, outs = op.opcode, op.inputs, op.outputs
        out0 = outs[0] if outs else -1

        if name == "CONV_2D" and len(ins) >= 2:
            pin = get_packed(ins[0])
            w = const(ins[1])
            osh = shape_of(out0)
            stride = op.options["stride"]
            if (pin is not None and w is not None and len(osh) == 4
                    and op.options.get("dilation") == (1, 1)
                    and stride in ((1, 1), (2, 2))):
                ish = shape_of(ins[0])
                f_out = 2 if (osh[1] >= min_hw and osh[1] % 2 == 0
                              and osh[2] % 2 == 0) else 1
                s = stride[0]
                if s * f_out in (2, 4):
                    b = const(ins[2]) if len(ins) > 2 and ins[2] >= 0 else None
                    pads = (_tflite_pad(ish[1], w.shape[1], s,
                                        op.options["padding"]),
                            _tflite_pad(ish[2], w.shape[2], s,
                                        op.options["padding"]))
                    out_hw = ((osh[1] // 2, osh[2] // 2) if f_out == 2
                              else (osh[1], osh[2]))
                    wp, bp, sp, padp = _pack_conv_weight(
                        w, b, s, pads, f_out, (ish[1], ish[2]), out_hw)
                    w_idx = add_tensor(f"s2d_w_{out0}", wp.shape, wp)
                    b_idx = (-1 if bp is None
                             else add_tensor(f"s2d_b_{out0}", bp.shape, bp))
                    if f_out == 2:
                        p_out = add_tensor(f"{tensors[out0].name}_p",
                                           (1, osh[1] // 2, osh[2] // 2,
                                            4 * osh[3]))
                        packed_of[out0] = p_out
                        dst = p_out
                    else:
                        dst = out0
                        produced.add(out0)
                    new_ops.append(OpNode(
                        "CONV_2D", [pin, w_idx, b_idx], [dst],
                        dict(stride=(sp, sp), dilation=(1, 1), padding=padp,
                             activation=op.options.get("activation",
                                                       "NONE"))))
                    continue

        elif name == "PRELU" and len(ins) == 2:
            alpha = const(ins[1])
            pin = get_packed(ins[0]) if alpha is not None else None
            if pin is not None:
                at = np.tile(alpha.reshape(-1), 4)
                a_idx = add_tensor(f"s2d_alpha_{out0}", at.shape, at)
                p_out = add_tensor(f"{tensors[out0].name}_p",
                                   shape_of(pin))
                packed_of[out0] = p_out
                new_ops.append(OpNode("PRELU", [pin, a_idx], [p_out],
                                      dict(op.options)))
                continue

        elif name == "ADD" and len(ins) == 2:
            if (shape_of(ins[0]) == shape_of(ins[1])
                    and const(ins[0]) is None and const(ins[1]) is None
                    and (ins[0] in packed_of or ins[1] in packed_of)):
                pa, pb = get_packed(ins[0]), get_packed(ins[1])
                if pa is not None and pb is not None:
                    p_out = add_tensor(f"{tensors[out0].name}_p",
                                       shape_of(pa))
                    packed_of[out0] = p_out
                    new_ops.append(OpNode("ADD", [pa, pb], [p_out],
                                          dict(op.options)))
                    continue

        elif name == "MAX_POOL_2D":
            pin = packed_of.get(ins[0])
            if (pin is not None
                    and op.options.get("filter") == (2, 2)
                    and op.options.get("stride") == (2, 2)):
                # Pool output (i, j) is the max over the 4 sub-positions of
                # packed pixel (i, j): a channel-group max.
                new_ops.append(OpNode("CHANNEL_GROUP_MAX", [pin], [out0],
                                      {"groups": 4}))
                produced.add(out0)
                continue

        elif name == "PAD":
            padv = const(ins[1])
            pin = (get_packed(ins[0])
                   if (padv is not None and padv.shape == (4, 2)
                       and not padv[:3].any() and padv[3, 0] == 0) else None)
            if pin is not None:
                c_old = shape_of(ins[0])[3]
                p_out = add_tensor(f"{tensors[out0].name}_p",
                                   (1,) + shape_of(pin)[1:3]
                                   + (4 * shape_of(out0)[3],))
                packed_of[out0] = p_out
                new_ops.append(OpNode(
                    "PACKED_CHANNEL_PAD", [pin], [p_out],
                    {"groups": 4, "channels": int(c_old),
                     "pad": int(padv[3, 1])}))
                continue

        # Fallback: the op runs unpacked, packed-only inputs materialized.
        rewired = [ensure_unpacked(t) if t >= 0 else t for t in ins]
        new_ops.append(OpNode(name, rewired, list(outs), op.options))
        for t in outs:
            produced.add(t)

    # Graph outputs exist unpacked.
    tail: list[OpNode] = []
    for t in graph.outputs:
        if t in packed_of and t not in produced:
            tail.append(OpNode("DEPTH_TO_SPACE", [packed_of[t]], [t],
                               {"block": 2}))
    new_ops.extend(tail)
    return Graph(tensors, new_ops, new_inputs, list(graph.outputs))


def _dequant(info: TensorInfo, arr: np.ndarray) -> np.ndarray:
    if arr.dtype in (np.float16,):
        return arr.astype(np.float32)
    if arr.dtype in (np.int8, np.uint8) and info.quant is not None:
        if len(info.quant) == 3:
            scales, zps, dim = info.quant
            bshape = [1] * arr.ndim
            bshape[dim] = -1
            return ((arr.astype(np.float32) - zps.reshape(bshape))
                    * scales.reshape(bshape))
        scale, zp = info.quant
        return (arr.astype(np.float32) - zp) * scale
    return arr


def _dce(graph: Graph) -> Graph:
    """Drop ops whose outputs nothing consumes and blank the constant data
    of unreferenced tensors (the passes supersede weights by appending
    rewritten copies; without this every original weight would still be
    hoisted into the params)."""
    live: set[int] = set(graph.outputs)
    keep: list[OpNode] = []
    for op in reversed(graph.ops):
        if any(t in live for t in op.outputs):
            keep.append(op)
            live.update(t for t in op.inputs if t >= 0)
    keep.reverse()
    live.update(graph.inputs)
    tensors = [info if (i in live or info.data is None)
               else TensorInfo(info.name, info.shape, info.dtype, None,
                               info.quant)
               for i, info in enumerate(graph.tensors)]
    return Graph(tensors, keep, list(graph.inputs), list(graph.outputs))


def _extract_stem(graph: Graph) -> tuple[Graph, dict | None]:
    """Split off a leading 3x3/stride-2 SAME image-stem conv (+ optional
    PReLU) so it can run as a fused stem kernel on packed crops while the
    rest of the graph compiles as usual.

    Matches the MediaPipe landmark-net entry (the face mesh: CONV_2D
    [1,S,S,3] -> [1,S/2,S/2,O] stride 2 SAME, then PRELU with per-channel
    slopes).  On a match returns a graph whose input is the activation
    after the stem, plus {'w' HWIO, 'b', 'alpha', 'in_size',
    'out_channels'}; otherwise (graph, None)."""
    if len(graph.inputs) != 1:
        return graph, None
    inp = graph.inputs[0]
    ishape = graph.tensors[inp].shape
    if len(ishape) != 4 or ishape[3] != 3 or ishape[1] != ishape[2] \
            or ishape[1] % 2:
        return graph, None

    const = _GraphEdit(graph).const

    conv = next((op for op in graph.ops if op.opcode == "CONV_2D"
                 and op.inputs[0] == inp), None)
    if conv is None:
        return graph, None
    # The stem conv must be the image's sole consumer: re-rooting the graph
    # at the stem output orphans the input tensor.
    if any(inp in op.inputs for op in graph.ops if op is not conv):
        return graph, None
    o = conv.options
    if (o.get("stride") != (2, 2) or o.get("padding") != "SAME"
            or o.get("activation") not in ("NONE", "RELU")
            or o.get("dilation", (1, 1)) != (1, 1)):
        return graph, None
    w = const(conv.inputs[1])
    b = const(conv.inputs[2]) if len(conv.inputs) > 2 and \
        conv.inputs[2] >= 0 else None
    if w is None or w.shape[1:3] != (3, 3) or w.shape[3] != 3:
        return graph, None
    cout = w.shape[0]
    if b is None:
        b = np.zeros((cout,), np.float32)

    stem_out = conv.outputs[0]
    alpha = np.zeros((cout,), np.float32)
    consumed = {id(conv)}
    if o.get("activation") == "NONE":
        users = [op for op in graph.ops
                 if stem_out in op.inputs and op is not conv]
        if len(users) != 1 or users[0].opcode != "PRELU":
            return graph, None
        prelu = users[0]
        a = const(prelu.inputs[1])
        if a is None or int(np.prod(a.shape)) != cout:
            return graph, None
        alpha = np.asarray(a, np.float32).reshape(cout)
        stem_out = prelu.outputs[0]
        consumed.add(id(prelu))

    keep_ops = [op for op in graph.ops if id(op) not in consumed]
    new_graph = Graph(tensors=graph.tensors, ops=keep_ops,
                      inputs=[stem_out], outputs=graph.outputs)
    stem = {
        "w": np.transpose(np.asarray(w, np.float32), (1, 2, 3, 0)),  # HWIO
        "b": np.asarray(b, np.float32),
        "alpha": alpha,
        "in_size": ishape[1],
        "out_channels": cout,
    }
    return new_graph, stem


# --- execution --------------------------------------------------------------------


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
    """Planar x padded by TFLite's SAME/VALID amounts, or by an explicit
    per-axis ``((top, bottom), (left, right))`` (``space_to_depth_pack``'s
    packed convs)."""
    if isinstance(padding, tuple):
        ph, pw = padding
    else:
        ph = _tflite_pad(x.shape[2], kh, stride[0], padding)
        pw = _tflite_pad(x.shape[3], kw, stride[1], padding)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)
    return x


def _mirror_pad(x: Tensor, pads: list[tuple[int, int]]) -> Tensor:
    """Reflect padding (edge not repeated) on any axes, by index."""
    for ax, (lo, hi) in enumerate(pads):
        if lo == 0 and hi == 0:
            continue
        n = x.shape[ax]
        idx = np.concatenate([np.arange(lo, 0, -1), np.arange(n),
                              np.arange(n - 2, n - 2 - hi, -1)])
        x = x.index_select(ax, torch.from_numpy(idx).to(x.device))
    return x


def bottleneck_units(dtype, device: torch.device
                     ) -> tuple[Callable[..., Tensor], Callable[..., Tensor]]:
    """What a graph compiled in ``dtype`` for ``device`` runs its fused
    units (``PALLAS_BN``, ``PALLAS_BN_CHAIN``) on.  K5/K6 take bf16 alone,
    so a graph for the card in another dtype binds the plain units; any
    other graph calls the wrappers, which run the plain units themselves
    on a CPU tensor."""
    if device.type == "cuda" and dtype != torch.bfloat16:
        return bn_kernel.bottleneck_s1_plain, bn_kernel.bottleneck_chain_plain
    return bn_kernel.bottleneck_s1, bn_kernel.bottleneck_chain


def compile_graph(graph: Graph, dtype=torch.float32, layout: str = "NHWC",
                  planar_inputs: bool = False, fuse_dw_pw: bool = False,
                  pack_s2d: int = 0, packed_inputs: bool = False,
                  external_stem: bool = False, fuse_bn: bool = False,
                  fuse_bn_min_hw: int = 96, batch_flexible: bool = False,
                  device=None
                  ) -> tuple[Callable[..., list[Tensor]], dict[str, Tensor]]:
    """Compile a parsed ``Graph`` into ``fn(params, *inputs) -> [outputs]``
    and its params, a dict of tensors on ``device`` (None means "cuda").

    Constant DEQUANTIZE chains fold into the weights.  ``dtype`` casts
    float weights and compute.  ``layout="NCHW"`` stores activations planar
    ([N, C, H, W]) between ops while keeping the NHWC contract at the
    graph's inputs and outputs; ``planar_inputs=True`` additionally makes
    ``fn`` take its 4-D image inputs already planar.  Convolution outputs
    are emitted in the compute dtype (one rounding after f32 accumulation).
    ``batch_flexible`` lets the graph's static batch-1 reshapes follow the
    real batch, so one compiled ``fn`` serves any leading batch.

    Passes, in this order: ``external_stem`` (``_extract_stem``),
    ``fuse_bn`` (``fuse_bottlenecks`` + ``chain_bottlenecks``, units of at
    least ``fuse_bn_min_hw``), ``fuse_dw_pw`` (``fuse_dw_pw_pairs``),
    ``pack_s2d`` (``space_to_depth_pack`` with that ``min_hw`` and
    ``packed_inputs``), then dead-op elimination.  A packed graph that
    pools or pads channels (``PLANAR_ONLY`` ops) needs ``layout="NCHW"``.
    """
    device = resolve_device(device)
    stem_meta = None
    if external_stem:
        graph, stem_meta = _extract_stem(graph)
    if fuse_bn:
        # Before fuse_dw_pw: the bottleneck matcher claims its dw -> 1x1-up
        # pairs before the generic pair fusion could rewrite them.
        graph = fuse_bottlenecks(graph, min_hw=fuse_bn_min_hw)
        # DCE first: dead DEQUANTIZE ops of the fused weights sit between
        # consecutive PALLAS_BN ops and would break the adjacency scan.
        graph = chain_bottlenecks(_dce(graph))
    if fuse_dw_pw:
        graph = fuse_dw_pw_pairs(graph)
    if pack_s2d:
        graph = space_to_depth_pack(graph, min_hw=pack_s2d,
                                    packed_inputs=packed_inputs)
    if fuse_bn or fuse_dw_pw or pack_s2d or stem_meta is not None:
        graph = _dce(graph)
    if layout != "NCHW" and any(op.opcode in PLANAR_ONLY for op in graph.ops):
        raise ValueError(
            f"{sorted(PLANAR_ONLY)} (space_to_depth_pack's packed 2x2 pool "
            "and channel pad) run in planar storage only: compile with "
            "layout='NCHW'")

    # Fold constant-input DEQUANTIZE ops.
    dequant_of: dict[int, int] = {}
    for op in graph.ops:
        if op.opcode == "DEQUANTIZE":
            src = op.inputs[0]
            if graph.tensors[src].data is not None:
                dequant_of[op.outputs[0]] = src

    def const_value(idx: int) -> np.ndarray | None:
        if idx in dequant_of:
            src = dequant_of[idx]
            return _dequant(graph.tensors[src], graph.tensors[src].data)
        return graph.tensors[idx].data

    # Raw f16/int8 weight tensors whose only consumers are folded
    # DEQUANTIZE ops are not hoisted beside their dequantized copies.
    consumers: dict[int, set[str]] = {}
    for op in graph.ops:
        for t in op.inputs:
            if t >= 0:
                consumers.setdefault(t, set()).add(
                    "folded" if (op.opcode == "DEQUANTIZE"
                                 and op.outputs[0] in dequant_of)
                    else op.opcode)
    folded_sources = {src for out, src in dequant_of.items()
                      if consumers.get(src) == {"folded"}
                      and src not in graph.outputs}

    def to_param(arr: np.ndarray) -> Tensor:
        t = torch.from_numpy(np.array(arr))     # a copy: never the graph's
        return (t.to(dtype) if t.is_floating_point() else t).to(device)

    params: dict[str, Tensor] = {}
    const_keys: dict[int, str] = {}
    for idx, info in enumerate(graph.tensors):
        if idx in folded_sources:
            continue
        val = const_value(idx)
        if val is None:
            continue
        val = np.asarray(val)
        key = f"{idx}:{info.name}"
        if np.issubdtype(val.dtype, np.floating):
            params[key] = to_param(val.astype(np.float32))
        elif val.dtype in (np.int8, np.uint8) and info.quant is not None:
            # Hybrid dynamic-range graphs feed int8 weight constants
            # directly into float conv/FC ops, with no DEQUANTIZE node to
            # fold: dequantized here (per-channel scales included).
            params[key] = to_param(_dequant(info, val).astype(np.float32))
        elif val.dtype in (np.uint16, np.uint32):
            params[key] = to_param(val.astype(np.int64))
        else:
            params[key] = to_param(val)
        const_keys[idx] = key

    input_shapes = [graph.tensors[i].shape for i in graph.inputs]

    nchw = layout == "NCHW"
    if layout not in ("NHWC", "NCHW"):
        raise ValueError(f"unknown layout {layout}")
    # NHWC axis -> NCHW axis, for concat and reduction axes.
    _AX = {0: 0, 1: 2, 2: 3, 3: 1}
    f32 = torch.float32
    # Constants an op builds from host values (resize matrices, index
    # vectors), made once per device: each build is a host-to-device copy.
    made: dict = {}
    bn_s1, bn_chain = bottleneck_units(dtype, device)

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
            if planar_inputs and nchw and x.ndim == 4:
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

        def put_conv(i: int, y: Tensor) -> None:
            """A planar conv/pool result, stored planar under NCHW and in
            the NHWC contract otherwise."""
            put(i, y if nchw else y.permute(0, 2, 3, 1), nchw)

        def ew_operands(ins_: list[int]) -> tuple[list[Tensor], bool]:
            if nchw and any(lay.get(i) for i in ins_):
                return [get_planar(i) for i in ins_], True
            return [get(i) for i in ins_], False

        def np_const(i: int) -> np.ndarray:
            v = const_value(i)
            if v is None:
                raise NotImplementedError("dynamic shape operand")
            return np.asarray(v)

        def bias(y: Tensor, ins: list[int], slot: int) -> Tensor:
            if len(ins) > slot and ins[slot] >= 0:
                y = y + env[ins[slot]].reshape(-1, 1, 1)
            return y

        def once(key, build):
            key = (key, str(device))
            if key not in made:
                made[key] = build()
            return made[key]

        for n_op, op in enumerate(graph.ops):
            name, ins, outs, o = op.opcode, op.inputs, op.outputs, op.options
            if name == "DEQUANTIZE":
                if outs[0] in dequant_of:
                    continue  # folded constant
                put(outs[0], env[ins[0]].to(dtype), lay.get(ins[0], False))
            elif name == "CONV_2D":
                x = get_planar(ins[0])
                w = env[ins[1]]                      # [out, kh, kw, in]
                dil = o["dilation"]
                x = _pad_same(x, (w.shape[1] - 1) * dil[0] + 1,
                              (w.shape[2] - 1) * dil[1] + 1, o["stride"],
                              o["padding"])
                y = F.conv2d(x, w.permute(0, 3, 1, 2), stride=o["stride"],
                             dilation=dil)
                put_conv(outs[0], _act(bias(y, ins, 2), o["activation"]))
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
                put_conv(outs[0], _act(bias(y, ins, 2), o["activation"]))
            elif name == "TRANSPOSE_CONV":
                out_shape = np_const(ins[0])
                w = env[ins[1]]                      # [out, kh, kw, in]
                x = get_planar(ins[2])
                # The op's explicit output shape is authoritative: SAME with
                # stride > 1 admits several legal sizes and TFLite derives
                # the padding from the declared one.  The full scatter
                # ((in-1)*stride + k) is cropped by that padding.
                full = F.conv_transpose2d(
                    x.to(f32), w.to(f32).permute(3, 0, 1, 2),
                    stride=o["stride"])
                oh, ow = int(out_shape[1]), int(out_shape[2])
                sl = []
                for size, want in ((full.shape[2], oh), (full.shape[3], ow)):
                    total = (max(size - want, 0) if o["padding"] == "SAME"
                             else 0)
                    sl.append(slice(total // 2, size - (total - total // 2)))
                y = full[:, :, sl[0], sl[1]].to(dtype)
                if tuple(y.shape[2:]) != (oh, ow):
                    raise ValueError(
                        f"TRANSPOSE_CONV output {tuple(y.shape[2:])} != "
                        f"declared ({oh}, {ow})")
                put_conv(outs[0], bias(y, ins, 3))
            elif name in ("MAX_POOL_2D", "AVERAGE_POOL_2D"):
                x = get_planar(ins[0])
                kh, kw = o["filter"]
                if name == "MAX_POOL_2D":
                    xp = _pad_same(x, kh, kw, o["stride"], o["padding"],
                                   value=-float("inf"))
                    y = F.max_pool2d(xp, (kh, kw), o["stride"])
                else:
                    xp = _pad_same(x, kh, kw, o["stride"], o["padding"])
                    cnt = _pad_same(torch.ones_like(x[:1, :1]), kh, kw,
                                    o["stride"], o["padding"])
                    y = (F.avg_pool2d(xp, (kh, kw), o["stride"],
                                      divisor_override=1)
                         / F.avg_pool2d(cnt, (kh, kw), o["stride"],
                                        divisor_override=1))
                put_conv(outs[0], _act(y.to(dtype), o["activation"]))
            elif name in ("PAD", "MIRROR_PAD"):
                pads = [(int(a), int(b)) for a, b in np_const(ins[1])]
                planar = nchw and len(pads) == 4
                x = get_planar(ins[0]) if planar else get(ins[0])
                if planar:
                    pads = [pads[0], pads[3], pads[1], pads[2]]
                if name == "MIRROR_PAD":
                    y = _mirror_pad(x, pads)
                else:
                    y = F.pad(x, [v for pair in reversed(pads) for v in pair])
                put(outs[0], y, planar)
            elif name in ("ADD", "SUB", "MUL", "DIV", "MAXIMUM", "MINIMUM",
                          "SQUARED_DIFFERENCE", "PRELU"):
                (a, b), planar = ew_operands([ins[0], ins[1]])
                if name == "SQUARED_DIFFERENCE":
                    y = (a - b) * (a - b)
                elif name == "PRELU":
                    y = torch.where(a >= 0, a, a * b)
                else:
                    y = {"ADD": torch.add, "SUB": torch.subtract,
                         "MUL": torch.multiply, "DIV": torch.divide,
                         "MAXIMUM": torch.maximum,
                         "MINIMUM": torch.minimum}[name](a, b)
                put(outs[0], _act(y, o.get("activation", "NONE")), planar)
            elif name in ("NEG", "SQRT", "RSQRT", "RELU", "RELU6",
                          "LEAKY_RELU", "LOGISTIC", "TANH", "HARD_SWISH",
                          "EXP"):
                x = env[ins[0]]
                y = {
                    "NEG": lambda v: -v,
                    "SQRT": torch.sqrt,
                    "RSQRT": torch.rsqrt,
                    "RELU": lambda v: torch.clamp(v, min=0.0),
                    "RELU6": lambda v: torch.clamp(v, 0.0, 6.0),
                    "LEAKY_RELU": lambda v: torch.where(v >= 0, v, 0.01 * v),
                    "LOGISTIC": torch.sigmoid,
                    "TANH": torch.tanh,
                    "HARD_SWISH": lambda v: v * torch.clamp(v + 3.0, 0.0, 6.0)
                    / 6.0,
                    "EXP": torch.exp,
                }[name](x)
                put(outs[0], y, lay.get(ins[0], False))
            elif name == "SOFTMAX":
                put(outs[0], torch.softmax(get(ins[0]) * o.get("beta", 1.0),
                                           dim=-1))
            elif name == "RESHAPE":
                x = get(ins[0])
                shape = o.get("new_shape")
                if shape is None:
                    shape = tuple(int(v) for v in np_const(ins[1]))
                if (batch_flexible and len(shape) and shape[0] == 1
                        and all(d != -1 for d in shape[1:])):
                    # Every other op in these nets is batch-covariant, so
                    # one compiled fn serves any leading batch and the
                    # kernels see the whole batch in one launch.
                    shape = (-1,) + tuple(shape[1:])
                put(outs[0], x.reshape(shape))
            elif name == "TRANSPOSE":
                perm = tuple(int(v) for v in np_const(ins[1]))
                put(outs[0], get(ins[0]).permute(perm))
            elif name == "CONCATENATION":
                if nchw and any(lay.get(i) for i in ins):
                    axis = _AX[o["axis"] % 4]
                    put(outs[0], torch.cat([get_planar(i) for i in ins],
                                           dim=axis), True)
                else:
                    put(outs[0], torch.cat([get(i) for i in ins],
                                           dim=o["axis"]))
            elif name in ("MEAN", "SUM", "REDUCE_MAX"):
                axes = tuple(int(v) for v in np.atleast_1d(np_const(ins[1])))
                red = {"MEAN": torch.mean, "SUM": torch.sum,
                       "REDUCE_MAX": torch.amax}[name]
                keep = o.get("keep_dims", False)
                ax_set = {a % 4 for a in axes}
                # Planar shortcut only where the squeezed result keeps the
                # NHWC dim order ({H,W} -> [N,C]; {C} -> [N,H,W]), or under
                # keepdims (the result stays rank-4 planar).
                if lay.get(ins[0]) and (keep or ax_set in ({1, 2}, {3})):
                    axes_p = tuple(_AX[a % 4] for a in axes)
                    put(outs[0], red(env[ins[0]], dim=axes_p, keepdim=keep),
                        keep)
                else:
                    put(outs[0], red(get(ins[0]), dim=axes, keepdim=keep))
            elif name == "STRIDED_SLICE":
                x = get(ins[0])
                begin = np_const(ins[1]).astype(int)
                end = np_const(ins[2]).astype(int)
                strides = np_const(ins[3]).astype(int)
                if o["ellipsis_mask"] or o["new_axis_mask"]:
                    raise NotImplementedError("strided_slice masks")
                squeeze = []
                for d in range(len(begin)):
                    if (o["shrink_axis_mask"] >> d) & 1:
                        x = x.narrow(d, int(begin[d]) % x.shape[d], 1)
                        squeeze.append(d)
                        continue
                    b = None if (o["begin_mask"] >> d) & 1 else int(begin[d])
                    e = None if (o["end_mask"] >> d) & 1 else int(end[d])
                    rng = range(*slice(b, e, int(strides[d])).indices(
                        x.shape[d]))
                    if rng.step > 0:
                        x = x[(slice(None),) * d
                              + (slice(rng.start, rng.stop, rng.step),)]
                    else:       # torch slices take no negative step
                        idx = once((n_op, d), lambda r=rng: torch.tensor(
                            list(r), dtype=torch.int64, device=device))
                        x = x.index_select(d, idx)
                for d in reversed(squeeze):
                    x = x.squeeze(d)
                env[outs[0]] = x
            elif name == "SLICE":
                x = get(ins[0])
                begin = np_const(ins[1]).astype(int)
                size = np_const(ins[2]).astype(int)
                idx = tuple(slice(int(b), None if s == -1 else int(b + s))
                            for b, s in zip(begin, size))
                env[outs[0]] = x[idx]
            elif name in ("RESIZE_BILINEAR", "RESIZE_NEAREST_NEIGHBOR"):
                hw = tuple(int(v) for v in np_const(ins[1]))
                planar = bool(nchw and lay.get(ins[0])
                              and (name == "RESIZE_NEAREST_NEIGHBOR"
                                   or o["half_pixel_centers"]))
                x = env[ins[0]] if planar else get(ins[0])
                if name == "RESIZE_NEAREST_NEIGHBOR":
                    in_hw = x.shape[-2:] if planar else x.shape[1:3]
                    mats = once((n_op, "nn"), lambda: tuple(
                        F.one_hot(torch.from_numpy(_nearest_index(
                            n_out, n_in, o["half_pixel_centers"],
                            o["align_corners"])), n_in).to(device)
                        for n_out, n_in in zip(hw, in_hw)))
                    put(outs[0], _resize_nearest_mm(x, mats, planar), planar)
                elif o["half_pixel_centers"]:
                    resized = (warp.resize_bilinear_planar(x, *hw) if planar
                               else warp.resize_bilinear_nhwc(x, *hw))
                    put(outs[0], resized.to(dtype), planar)
                else:
                    put(outs[0], _resize_bilinear_legacy(
                        x, hw, o["align_corners"]).to(dtype))
            elif name == "FULLY_CONNECTED":
                x, w = get(ins[0]), get(ins[1])
                y = (x.to(f32) @ w.to(f32).t()).to(dtype)
                if len(ins) > 2 and ins[2] >= 0:
                    y = y + get(ins[2])
                put(outs[0], _act(y, o["activation"]))
            # --- space_to_depth_pack's pseudo-ops: packed channel
            # (a*2+b)*C + c holds pixel (2i+a, 2j+b) of channel c; planar
            # under NCHW (K1's pack=2 layout); the two packing ops also
            # NHWC, PLANAR_ONLY never ---
            elif name == "SPACE_TO_DEPTH":
                if nchw:
                    put(outs[0], warp_kernel.pack_s2d(get_planar(ins[0])),
                        True)
                else:
                    x = get(ins[0])
                    n, h, w, c = x.shape
                    y = x.reshape(n, h // 2, 2, w // 2, 2, c)
                    y = y.permute(0, 1, 3, 2, 4, 5)
                    put(outs[0], y.reshape(n, h // 2, w // 2, 4 * c))
            elif name == "DEPTH_TO_SPACE":
                if nchw:
                    put(outs[0], warp_kernel.unpack_s2d(get_planar(ins[0])),
                        True)
                else:
                    x = get(ins[0])
                    n, h, w, c4 = x.shape
                    c = c4 // 4
                    y = x.reshape(n, h, w, 2, 2, c)
                    y = y.permute(0, 1, 3, 2, 4, 5)
                    put(outs[0], y.reshape(n, 2 * h, 2 * w, c))
            elif name == "CHANNEL_GROUP_MAX":       # planar only
                g = o["groups"]
                x = get_planar(ins[0])
                n, cg, h, w = x.shape
                put(outs[0], x.reshape(n, g, cg // g, h, w).amax(1), True)
            elif name == "PACKED_CHANNEL_PAD":      # planar only
                g, c_old, padc = o["groups"], o["channels"], o["pad"]
                x = get_planar(ins[0])
                n, _, h, w = x.shape
                y = F.pad(x.reshape(n, g, c_old, h, w), (0, 0, 0, 0, 0, padc))
                put(outs[0], y.reshape(n, g * (c_old + padc), h, w), True)
            elif name == "PALLAS_BN":
                # Fused bottleneck residual unit (fuse_bottlenecks): K5.
                x = get_planar(ins[0]).to(dtype)
                r = get_planar(ins[1]).to(dtype)
                y = bn_s1(
                    x, r, env[ins[2]].to(dtype), env[ins[3]], env[ins[4]],
                    env[ins[5]].to(dtype), env[ins[6]], env[ins[7]],
                    last_act=o["last_act"])
                put(outs[0], y, True)
            elif name == "PALLAS_BN_CHAIN":
                # A whole stage of self-residual units (chain_bottlenecks):
                # K6.
                x = get_planar(ins[0]).to(dtype)
                y = bn_chain(
                    x, env[ins[1]].to(dtype), env[ins[2]], env[ins[3]],
                    env[ins[4]].to(dtype), env[ins[5]], env[ins[6]],
                    last_act=o["last_act"])
                put(outs[0], y, True)
            else:
                raise NotImplementedError(f"TFLite op {name}")
        return [get(i) for i in graph.outputs]

    fn.input_shapes = input_shapes  # type: ignore[attr-defined]
    fn.output_shapes = [graph.tensors[i].shape  # type: ignore[attr-defined]
                        for i in graph.outputs]
    fn.graph = graph                # type: ignore[attr-defined]
    if stem_meta is not None:
        # The externalized stem's weights ride in the params; the caller
        # runs a stem kernel on packed crops and feeds the result as the
        # compiled fn's (planar) input.
        for name in ("w", "b", "alpha"):
            params[f"__stem__:{name}"] = to_param(stem_meta[name])
        fn.external_stem_meta = {      # type: ignore[attr-defined]
            "in_size": stem_meta["in_size"],
            "out_channels": stem_meta["out_channels"],
            "params": {n: f"__stem__:{n}" for n in ("w", "b", "alpha")},
        }
    return fn, params


def compile_tflite(data: bytes, dtype=torch.float32, **kw
                   ) -> tuple[Callable[..., list[Tensor]], dict[str, Tensor]]:
    """``compile_graph`` of a .tflite flatbuffer (parsed with TensorFlow's
    schema); the keywords are ``compile_graph``'s."""
    return compile_graph(parse_tflite(data), dtype, **kw)


def _nearest_index(out_len: int, in_len: int, half_pixel: bool,
                   align_corners: bool) -> np.ndarray:
    """TFLite RESIZE_NEAREST_NEIGHBOR source index per output position
    (reference kernel semantics for each flag combination)."""
    o = np.arange(out_len, dtype=np.float64)
    if align_corners and out_len > 1:
        # TfLiteRound = half away from zero; indices are >= 0 so
        # +0.5 / floor.
        offset = 0.5 if half_pixel else 0.0
        idx = np.floor(
            (o + offset) * (in_len - 1) / (out_len - 1) - offset + 0.5)
    elif half_pixel:
        idx = np.floor((o + 0.5) * in_len / out_len)
    else:
        idx = np.floor(o * in_len / out_len)
    return np.clip(idx.astype(np.int64), 0, in_len - 1)


def _resize_nearest_mm(x: Tensor, mats: tuple[Tensor, Tensor], planar: bool
                       ) -> Tensor:
    """RESIZE_NEAREST_NEIGHBOR as one-hot selection matmuls: ``mats`` are
    the [out, in] one-hot matrices of ``_nearest_index`` for rows and
    columns (exact: every output is one input value)."""
    wy, wx = (m.to(x.dtype) for m in mats)
    if planar:
        t = torch.einsum("...hw,oh->...ow", x, wy)
        return torch.einsum("...hw,pw->...hp", t, wx)
    t = torch.einsum("bhwc,oh->bowc", x, wy)
    return torch.einsum("bhwc,pw->bhpc", t, wx)


def _resize_bilinear_legacy(x: Tensor, hw: tuple[int, int],
                            align_corners: bool) -> Tensor:
    """TFLite RESIZE_BILINEAR without half-pixel centers (align-corners or
    asymmetric coordinates) on NHWC, as edge-clamped interpolation-matrix
    matmuls: the triangular kernel with clamped sample coordinates is the
    clamped floor/floor+1 two-tap blend."""
    _, h, w, _ = x.shape
    nh, nw = hw
    dev = x.device
    if align_corners and nh > 1 and nw > 1:
        ys = torch.linspace(0.0, h - 1.0, nh, device=dev)
        xs = torch.linspace(0.0, w - 1.0, nw, device=dev)
    else:
        ys = torch.arange(nh, device=dev) * (h / nh)
        xs = torch.arange(nw, device=dev) * (w / nw)
    f32 = torch.float32
    wy = warp.interp_matrix(ys, h, "edge").to(x.dtype).to(f32)   # [oh, H]
    wx = warp.interp_matrix(xs, w, "edge").to(x.dtype).to(f32)   # [ow, W]
    t = torch.einsum("bhwc,oh->bowc", x.to(f32), wy).to(x.dtype)
    return torch.einsum("bhwc,pw->bhpc", t.to(f32), wx).to(x.dtype)


# --- asset loading ----------------------------------------------------------------


def load_task_bundle(path: str) -> dict[str, bytes]:
    """Unpack a MediaPipe .task zip bundle into {filename: tflite bytes}."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if name.endswith(".tflite"):
                out[name] = z.read(name)
    return out


def load_tflite_file(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()
