"""The port's graph passes ``fuse_dw_pw_pairs`` and ``space_to_depth_pack``
(``bp_from_video_tpu_torch/models/tflite_compiler.py``) against the
reference package's, op for op, and the graphs they compile to against the
reference's outputs.

Graphs: the TensorFlow-built face mesh of reduced size from
``test_torch_tflite.py`` (64x64, packed from 16x16 up, so that its
downsample units' MAX_POOL and channel PAD become ``CHANNEL_GROUP_MAX`` and
``PACKED_CHANNEL_PAD``) and the faithful palm-detector and segmenter twins
of ``tflite_fixtures.py``.  Tolerances as ``test_torch_tflite.py``: f32
1e-4 and bf16 3e-2 of each output's largest value.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_tflite import (BF16_TOL, F32_TOL, _assert_close,  # noqa: E402
                               _blob, _mesh_blob, assert_same_graph)

from bp_from_video_tpu.models import tflite_compiler as jtc  # noqa: E402
from bp_from_video_tpu_torch.kernels import warp as warp_kernel  # noqa: E402
from bp_from_video_tpu_torch.models import tflite_compiler as ttc  # noqa: E402

# Each graph and the ``pack_s2d`` threshold it is packed at: the mesh from
# its 32x32 stage (64x64 input), the palm detector from its 48x48
# activations, the segmenter from 64x64.
GRAPHS = {"mesh": (_mesh_blob, 16),
          "palm": (lambda: _blob("faithful_palm_detector"), 48),
          "seg": (lambda: _blob("faithful_segmenter"), 64)}


def _opcodes(graph):
    return [op.opcode for op in graph.ops]


@pytest.mark.parametrize("packed_inputs", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_passes_match_reference_op_for_op(name, packed_inputs):
    """fuse_dw_pw_pairs, then space_to_depth_pack (with and without packed
    inputs), then dead-op elimination: the same opcodes, options, wiring,
    tensor shapes and appended constants as the reference's passes."""
    blob, min_hw = GRAPHS[name]
    jg, tg = jtc.parse_tflite(blob()), ttc.parse_tflite(blob())
    jf, tf_ = jtc.fuse_dw_pw_pairs(jg), ttc.fuse_dw_pw_pairs(tg)
    assert_same_graph(tf_, jf)
    jp = jtc.space_to_depth_pack(jf, min_hw=min_hw,
                                 packed_inputs=packed_inputs)
    tp = ttc.space_to_depth_pack(tf_, min_hw=min_hw,
                                 packed_inputs=packed_inputs)
    assert_same_graph(tp, jp)
    assert_same_graph(ttc._dce(tp), jtc._dce(jp))
    ops = _opcodes(tp)
    # With packed inputs no op packs the image input itself.
    assert any(o.opcode == "SPACE_TO_DEPTH" and o.inputs == tg.inputs
               for o in tp.ops) != packed_inputs
    if name == "mesh":
        # Every depthwise conv fused into its up-projection; the
        # downsample units' pool and pad run in the packed domain.
        assert "DEPTHWISE_CONV_2D" not in _opcodes(tf_)
        assert ops.count("CHANNEL_GROUP_MAX") == 2
        assert ops.count("PACKED_CHANNEL_PAD") == 1
        assert any(o.opcode == "CONV_2D" and isinstance(
            o.options["padding"], tuple) for o in tp.ops)
    if packed_inputs:
        ish = tp.tensors[tp.inputs[0]].shape
        assert ish[3] == 12 and ish[1] * 2 == tg.tensors[tg.inputs[0]].shape[1]


def _compile_both(name, dtype, packed_inputs):
    blob, min_hw = GRAPHS[name]
    kw = dict(layout="NCHW", planar_inputs=True, fuse_dw_pw=True,
              pack_s2d=min_hw, packed_inputs=packed_inputs)
    jfn, jp = jtc.compile_tflite(blob(), getattr(jnp, dtype), **kw)
    tfn, tp = ttc.compile_tflite(blob(), getattr(torch, dtype), device="cpu",
                                 batch_flexible=True, **kw)
    return jfn, jp, tfn, tp


def _planar_input(fn, seed, batch):
    """Seeded uniform input in the compiled fn's planar input shape."""
    n, h, w, c = fn.input_shapes[0]
    return np.random.RandomState(seed).uniform(
        0, 1, (batch, c, h, w)).astype(np.float32)


@pytest.mark.parametrize("case", ["mesh-f32", "mesh-f32-packed_inputs",
                                  "palm-f32", "palm-f32-packed_inputs",
                                  "seg-f32", "seg-f32-packed_inputs",
                                  "mesh-bf16-packed_inputs", "seg-bf16"])
def test_compiled_passes_match_reference(case):
    """The rewritten graphs compiled in both packages give the same
    outputs on the same seeded input (the reference maps its batch-1
    graph over the batch, the port runs it batch_flexible)."""
    name, dtype, *rest = case.split("-")
    dtype = {"f32": "float32", "bf16": "bfloat16"}[dtype]
    jfn, jp, tfn, tp = _compile_both(name, dtype, bool(rest))
    assert tfn.input_shapes == jfn.input_shapes
    assert tfn.output_shapes == jfn.output_shapes
    assert set(tp) == set(jp)
    assert [(o.opcode, o.inputs, o.outputs) for o in tfn.graph.ops] == [
        (o.opcode, o.inputs, o.outputs) for o in jfn.graph.ops]
    x = _planar_input(jfn, 7, 2)
    want = [np.stack([np.asarray(o[0], np.float32) for o in outs], 0)
            for outs in zip(*[jfn(jp, jnp.asarray(x[i:i + 1]))
                              for i in range(2)])]
    got = [o.to(torch.float32).numpy() for o in tfn(tp, torch.from_numpy(x))]
    _assert_close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_packed_and_fused_equal_the_plain_graph(name):
    """fuse_dw_pw + pack_s2d compute the plain graph's function (f32, sums
    in another order): the port's rewritten compile against its own plain
    compile."""
    blob, min_hw = GRAPHS[name]
    kw = dict(layout="NCHW", planar_inputs=True, batch_flexible=True,
              device="cpu")
    fn0, p0 = ttc.compile_tflite(blob(), **kw)
    fn1, p1 = ttc.compile_tflite(blob(), fuse_dw_pw=True, pack_s2d=min_hw,
                                 **kw)
    x = torch.from_numpy(_planar_input(fn0, 3, 2))
    _assert_close([o.numpy() for o in fn1(p1, x)],
                  [o.numpy() for o in fn0(p0, x)], F32_TOL)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_packed_input_graph_equals_unpacked(name):
    """A graph compiled with packed inputs, fed K1's packing of a crop
    (``kernels/warp.pack_s2d``, parity-major channels), equals the graph
    that packs the same crop itself: bit for bit in f32."""
    blob, min_hw = GRAPHS[name]
    kw = dict(layout="NCHW", planar_inputs=True, batch_flexible=True,
              fuse_dw_pw=True, pack_s2d=min_hw, device="cpu")
    fn0, p0 = ttc.compile_tflite(blob(), **kw)
    fn1, p1 = ttc.compile_tflite(blob(), packed_inputs=True, **kw)
    n, h, w, c = fn0.input_shapes[0]
    assert fn1.input_shapes == [(n, h // 2, w // 2, 4 * c)]
    x = torch.from_numpy(_planar_input(fn0, 5, 2))
    for a, b in zip(fn0(p0, x), fn1(p1, warp_kernel.pack_s2d(x))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pads", [((1, 2), (0, 1)), ((0, 0), (2, 0))])
def test_pad_same_takes_per_axis_explicit_padding(pads):
    """A CONV_2D whose padding is explicit per axis, ((top, bottom),
    (left, right)) as space_to_depth_pack writes it, pads each axis by its
    own pair (the reference passes it to lax.conv_general_dilated)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)   # NHWC
    w = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)    # OHWI
    t = [ttc.TensorInfo("x", (1, 9, 10, 3), np.float32, None, None),
         ttc.TensorInfo("w", w.shape, np.float32, w, None),
         ttc.TensorInfo("y", (1, 4, 5, 5), np.float32, None, None)]
    g = ttc.Graph(t, [ttc.OpNode("CONV_2D", [0, 1, -1], [2], dict(
        stride=(2, 2), dilation=(1, 1), padding=pads, activation="NONE"))],
        [0], [2])
    fn, p = ttc.compile_graph(g, layout="NCHW", device="cpu")
    got = fn(p, torch.from_numpy(x))[0].numpy()
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w.transpose(1, 2, 3, 0)), (2, 2),
        list(pads), dimension_numbers=("NHWC", "HWIO", "NHWC")))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    xp = ttc._pad_same(torch.zeros((1, 1, 9, 10)), 3, 3, (2, 2), pads)
    assert tuple(xp.shape[2:]) == (9 + sum(pads[0]), 10 + sum(pads[1]))


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_packed_pool_and_pad_run_planar_only(layout):
    """The mesh packed from its 32x32 stage pools and pads channels in the
    packed domain (CHANNEL_GROUP_MAX, PACKED_CHANNEL_PAD): those run in
    planar storage, and an NHWC compile of such a graph raises."""
    kw = dict(layout=layout, batch_flexible=True, fuse_dw_pw=True,
              pack_s2d=GRAPHS["mesh"][1], device="cpu")
    if layout == "NHWC":
        with pytest.raises(ValueError, match="layout='NCHW'"):
            ttc.compile_tflite(_mesh_blob(), **kw)
        return
    fn, _ = ttc.compile_tflite(_mesh_blob(), **kw)
    assert ttc.PLANAR_ONLY <= set(_opcodes(fn.graph))


@pytest.mark.parametrize("shape", [(2, 3, 8, 6), (1, 24, 4, 4)])
def test_unpack_s2d_inverts_pack_s2d(shape):
    """unpack_s2d is pack_s2d's inverse both ways, and packed plane (a, b)
    holds the pixels (2i+a, 2j+b)."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    p = warp_kernel.pack_s2d(x)
    c = shape[1]
    for a in range(2):
        for b in range(2):
            g = a * 2 + b
            assert torch.equal(p[:, g * c:(g + 1) * c], x[:, :, a::2, b::2])
    assert torch.equal(warp_kernel.unpack_s2d(p), x)
    y = torch.randn((shape[0], 4 * c) + tuple(shape[2:]))
    assert torch.equal(warp_kernel.pack_s2d(warp_kernel.unpack_s2d(y)), y)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_fused_units_are_bound_at_compile_by_dtype(dtype, monkeypatch):
    """``fuse_bn``'s units (a lone one and two chains): a graph compiled
    for the card in bf16 calls the K5/K6 wrappers, in float32 the plain
    units (the kernels take bf16 alone), chosen once when it compiles; a
    graph compiled for the CPU calls the wrappers, which run the plain
    units.  The outputs equal the CPU graph's, the plain units' own."""
    from bp_from_video_tpu_torch.kernels import bottleneck as bn
    from bp_from_video_tpu_torch.models.mesh_graph import face_mesh_graph
    wrappers = (bn.bottleneck_s1, bn.bottleneck_chain)
    plain = (bn.bottleneck_s1_plain, bn.bottleneck_chain_plain)
    assert ttc.bottleneck_units(dtype, torch.device("cpu")) == wrappers
    assert ttc.bottleneck_units(dtype, torch.device("cuda")) == (
        wrappers if dtype == torch.bfloat16 else plain)
    graph = face_mesh_graph(3, 32, ((16, 8), (32, 16)), (1, 3))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    kw = dict(layout="NCHW", fuse_bn=True, fuse_bn_min_hw=0,
              batch_flexible=True, device="cpu")
    want_fn, want_p = ttc.compile_graph(graph, dtype, **kw)
    want = want_fn(want_p, x)

    calls = {}
    for name in ("bottleneck_s1", "bottleneck_chain",
                 "bottleneck_chain_plain"):
        def counted(*a, _f=getattr(bn, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(bn, name, counted)
    # The binding a card gets, on CPU tensors.
    rule = ttc.bottleneck_units
    monkeypatch.setattr(ttc, "bottleneck_units",
                        lambda dt, dev: rule(dt, torch.device("cuda")))
    fn, p = ttc.compile_graph(graph, dtype, **kw)
    ops = _opcodes(fn.graph)
    units = (ops.count("PALLAS_BN"), ops.count("PALLAS_BN_CHAIN"))
    assert units == (1, 1)
    got = fn(p, x)
    assert (calls.get("bottleneck_s1", 0), calls.get("bottleneck_chain", 0)
            ) == (units if dtype == torch.bfloat16 else (0, 0))
    # The wrappers take the plain chain on a CPU tensor: called either way.
    assert calls["bottleneck_chain_plain"] == units[1]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
