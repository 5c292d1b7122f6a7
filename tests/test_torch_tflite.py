"""The port's TFLite compiler (``bp_from_video_tpu_torch/models/
tflite_compiler.py``) against the reference package's, on every fixture of
``tflite_fixtures.py`` and on a TensorFlow-built face mesh of reduced size;
and the numpy-only ``mesh_graph.face_mesh_graph`` against the parse of that
TensorFlow-built model.

Both compilers get the same flatbuffer and the same seeded numpy inputs.
The reference's fused ops run in Pallas interpret mode, the port's through
the plain versions of its kernels (CPU tensors).

Tolerances, relative to each output's largest value: f32 1e-4 (the same
convolutions summed in another order by two libraries); bf16 3e-2 (every
op rounds to bf16 in both packages, at the same places, but a sum that
differs in its last f32 bit can round to the neighbouring bf16 value, and
the nets are some twenty ops deep).
"""

import functools
import sys
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu


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
import tflite_fixtures as fx  # noqa: E402

from bp_from_video_tpu.models import tflite_compiler as jtc  # noqa: E402
from bp_from_video_tpu_torch.models import mesh_graph  # noqa: E402
from bp_from_video_tpu_torch.models import tflite_compiler as ttc  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 3e-2

FIXTURES = {
    "palm_detector": fx.build_palm_detector,
    "hand_landmarker": fx.build_hand_landmarker,
    "resize_net": fx.build_resize_net,
    "resize_nearest_net": fx.build_resize_nearest_net,
    "transpose_conv_net": fx.build_transpose_conv_net,
    "per_channel_int8_net": fx.build_per_channel_int8_net,
    "segmenter": fx.build_segmenter,
    "faithful_hand_landmarker": fx.build_faithful_hand_landmarker,
    "faithful_hand_landmarker_q": functools.partial(
        fx.build_faithful_hand_landmarker, quantize=True),
    "faithful_palm_detector": fx.build_faithful_palm_detector,
    "faithful_palm_detector_q": functools.partial(
        fx.build_faithful_palm_detector, quantize=True),
    "faithful_segmenter": fx.build_faithful_segmenter,
    "faithful_segmenter_q": functools.partial(
        fx.build_faithful_segmenter, quantize=True),
}

MODES = {
    "nhwc": dict(layout="NHWC"),
    "nchw": dict(layout="NCHW"),
    "planar_inputs": dict(layout="NCHW", planar_inputs=True),
    "batch_flexible": dict(layout="NCHW", planar_inputs=True,
                           batch_flexible=True),
}


@functools.lru_cache(maxsize=None)
def _blob(name: str) -> bytes:
    return FIXTURES[name]()


def _same_value(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(a, b))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(map(_same_value, a, b))
    return a == b


def assert_same_graph(got, want):
    """Two parsed/rewritten graphs equal field for field (constants too)."""
    assert got.inputs == want.inputs and got.outputs == want.outputs
    assert len(got.tensors) == len(want.tensors)
    for i, (a, b) in enumerate(zip(got.tensors, want.tensors)):
        assert (a.name, tuple(a.shape), np.dtype(a.dtype)) == (
            b.name, tuple(b.shape), np.dtype(b.dtype)), i
        assert (a.data is None) == (b.data is None), (i, a.name)
        assert a.data is None or _same_value(a.data, b.data), (i, a.name)
        assert _same_value(a.quant, b.quant), (i, a.name)
    assert [(o.opcode, o.inputs, o.outputs, o.options) for o in got.ops] == [
        (o.opcode, o.inputs, o.outputs, o.options) for o in want.ops]


def _run_both(jfn, jp, tfn, tp, x):
    want = [np.asarray(o, np.float32) for o in jfn(jp, jnp.asarray(x))]
    got = [o.to(torch.float32).numpy() for o in tfn(tp, torch.from_numpy(x))]
    return got, want


def _assert_close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * float(np.abs(w).max()) + 1e-7)


def _input(fn, seed, planar, batch=1):
    shape = fn.input_shapes[0]
    x = np.random.RandomState(seed).uniform(
        0, 1, (batch,) + tuple(shape[1:])).astype(np.float32)
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2)) if planar else x


# -- every fixture ------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_parse_matches_reference(name):
    assert_same_graph(ttc.parse_tflite(_blob(name)),
                      jtc.parse_tflite(_blob(name)))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_compile_matches_reference(name, mode):
    kw = MODES[mode]
    jfn, jp = jtc.compile_tflite(_blob(name), **kw)
    tfn, tp = ttc.compile_tflite(_blob(name), device="cpu", **kw)
    assert tfn.input_shapes == jfn.input_shapes
    assert tfn.output_shapes == jfn.output_shapes
    assert set(tp) == set(jp)
    x = _input(jfn, 0, kw.get("planar_inputs", False),
               batch=2 if mode == "batch_flexible" else 1)
    _assert_close(*_run_both(jfn, jp, tfn, tp, x), F32_TOL)


@pytest.mark.parametrize("name", ["faithful_hand_landmarker",
                                  "faithful_segmenter"])
def test_compile_bf16_matches_reference(name):
    kw = dict(layout="NCHW", planar_inputs=True)
    jfn, jp = jtc.compile_tflite(_blob(name), jnp.bfloat16, **kw)
    tfn, tp = ttc.compile_tflite(_blob(name), torch.bfloat16, device="cpu",
                                 **kw)
    assert all(t.dtype == torch.bfloat16 for t in tp.values()
               if t.is_floating_point())
    _assert_close(*_run_both(jfn, jp, tfn, tp, _input(jfn, 1, True)),
                  BF16_TOL)


def test_compile_graph_needs_no_flatbuffer_and_rejects_unported_options():
    """A parsed graph compiles as its flatbuffer does; the graph-pass
    options (ported: they raised before) compile to the same function;
    an unknown layout is refused."""
    g = ttc.parse_tflite(_blob("resize_net"))
    fn, p = ttc.compile_graph(g, device="cpu")
    fn2, p2 = ttc.compile_tflite(_blob("resize_net"), device="cpu")
    x = torch.from_numpy(_input(fn, 2, False))
    want = fn(p, x)
    for a, b in zip(want, fn2(p2, x)):
        assert torch.equal(a, b)
    for kw in (dict(fuse_dw_pw=True), dict(pack_s2d=8),
               dict(pack_s2d=8, packed_inputs=True)):
        fn3, p3 = ttc.compile_graph(g, device="cpu", **kw)
        xin = x
        if kw.get("packed_inputs"):
            n, h, w, c = x.shape
            xin = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)
        _assert_close([o.numpy() for o in fn3(p3, xin)],
                      [o.numpy() for o in want], F32_TOL)
    with pytest.raises(ValueError):
        ttc.compile_graph(g, device="cpu", layout="CHWN")


def test_task_bundle_loader(tmp_path):
    path = tmp_path / "hand_landmarker.task"
    path.write_bytes(fx.build_hand_task_bundle())
    blobs = ttc.load_task_bundle(str(path))
    assert set(blobs) == set(jtc.load_task_bundle(str(path)))
    assert blobs["palm_detection.tflite"] == _blob("palm_detector")
    assert ttc.load_tflite_file(str(path)) == path.read_bytes()


# -- a TensorFlow-built face mesh of reduced size -----------------------------------

MESH_SIZE = 64
MESH_WIDTHS = ((16, 8), (32, 16), (64, 32))
MESH_LANDMARKS = 478


def build_face_mesh(input_size=MESH_SIZE, widths=MESH_WIDTHS, units=4,
                    num_landmarks=MESH_LANDMARKS, seed=5,
                    template=None) -> bytes:
    """The face-mesh architecture at a reduced size as a real flatbuffer.
    ``template``: optional [L, 3] landmarks in crop pixels; the landmark
    head then ignores its input (zero weights, the template as bias) and
    the presence logit is 8.

    What it took for the TF 2.21 converter to emit the unit pattern:
    biases written as ``conv + b`` fold into the convs; PRELU is matched
    only from the Keras form ``relu(x) + relu(-x) * neg_alpha`` with
    ``neg_alpha`` a constant of rank 3 ([1, 1, C]); the residual of a
    downsample unit is written before its ADD and comes out as
    MAX_POOL_2D + PAD after the up-projection."""
    import tensorflow as tf

    rng = np.random.default_rng(seed)

    def conv(kh, kw, cin, cout, gain=1.0):
        w = rng.standard_normal((kh, kw, cin, cout)) * gain / np.sqrt(
            kh * kw * cin)
        return tf.constant(w.astype(np.float32))

    def vec(n, lo, hi):
        return tf.constant(rng.uniform(lo, hi, n).astype(np.float32))

    def prelu(x, alpha):
        return tf.nn.relu(x) + tf.nn.relu(-x) * tf.reshape(-alpha, (1, 1, -1))

    def unit(cin, c, d, down):
        return dict(down=down, pad=c - cin,
                    wd=conv(2 if down else 1, 2 if down else 1, cin, d),
                    bd=vec(d, -.1, .1), ad=vec(d, .05, .3),
                    dw=tf.constant((rng.standard_normal((3, 3, d, 1)) / 3
                                    ).astype(np.float32)),
                    bdw=vec(d, -.1, .1), wu=conv(1, 1, d, c, 0.25),
                    bu=vec(c, -.1, .1), au=vec(c, .05, .3))

    c0 = widths[0][0]
    stem_w, stem_b, stem_a = conv(3, 3, 3, c0, 1.5), vec(c0, -.1, .1), \
        vec(c0, .05, .3)
    units_, cprev = [], c0
    for s, (c, d) in enumerate(widths):
        if s:
            units_.append(unit(cprev, c, d, True))
        units_ += [unit(c, c, d, False) for _ in range(units)]
        cprev = c
    k = input_size // 2 // 2 ** (len(widths) - 1)
    lm_b = np.stack([rng.uniform(.25, .75, num_landmarks),
                     rng.uniform(.25, .75, num_landmarks),
                     np.zeros(num_landmarks)], -1) * input_size
    lm_gain = 1.0
    if template is not None:
        lm_b, lm_gain = np.asarray(template), 0.0
    heads = [(conv(k, k, cprev, 3 * num_landmarks, lm_gain),
              tf.constant(lm_b.reshape(-1).astype(np.float32))),
             (conv(k, k, cprev, 1), tf.constant([8.0 if template is not None
                                                 else 4.0])),
             (conv(k, k, cprev, 1), tf.constant([3.0]))]

    class M(tf.Module):
        @tf.function(input_signature=[
            tf.TensorSpec([1, input_size, input_size, 3], tf.float32)])
        def __call__(self, x):
            y = prelu(tf.nn.conv2d(x, stem_w, 2, "SAME") + stem_b, stem_a)
            for u in units_:
                r = y
                if u["down"]:
                    r = tf.nn.max_pool2d(y, 2, 2, "SAME")
                    if u["pad"]:
                        r = tf.pad(r, [[0, 0], [0, 0], [0, 0],
                                       [0, u["pad"]]])
                z = tf.nn.conv2d(y, u["wd"], 2 if u["down"] else 1,
                                 "SAME") + u["bd"]
                z = prelu(z, u["ad"])
                z = tf.nn.depthwise_conv2d(z, u["dw"], [1, 1, 1, 1],
                                           "SAME") + u["bdw"]
                z = tf.nn.conv2d(z, u["wu"], 1, "SAME") + u["bu"]
                y = prelu(z + r, u["au"])
            o = [tf.nn.conv2d(y, w, 1, "VALID") + b for w, b in heads]
            return o[0], tf.sigmoid(o[1]), tf.sigmoid(o[2])

    m = M()
    return fx._faithful_convert(m, m.__call__)


@functools.lru_cache(maxsize=None)
def _mesh_blob() -> bytes:
    return build_face_mesh()


def _counts(graph):
    ops = [op.opcode for op in graph.ops]
    return {k: ops.count(k) for k in ("PALLAS_BN_CHAIN", "PALLAS_BN",
                                      "DEPTHWISE_CONV_2D", "PRELU")}


def test_mesh_parse_and_passes_match_reference():
    """Equal graphs after the parse and after each pass."""
    jg, tg = jtc.parse_tflite(_mesh_blob()), ttc.parse_tflite(_mesh_blob())
    assert_same_graph(tg, jg)
    js, jmeta = jtc._extract_stem(jg)
    ts, tmeta = ttc._extract_stem(tg)
    assert_same_graph(ts, js)
    assert tmeta["in_size"] == jmeta["in_size"] == MESH_SIZE
    assert tmeta["out_channels"] == jmeta["out_channels"] == 16
    for k in ("w", "b", "alpha"):
        np.testing.assert_array_equal(tmeta[k], jmeta[k])
    for min_hw in (0, 24):
        jf = jtc.fuse_bottlenecks(js, min_hw=min_hw)
        tf_ = ttc.fuse_bottlenecks(ts, min_hw=min_hw)
        assert_same_graph(tf_, jf)
        jd, td = jtc._dce(jf), ttc._dce(tf_)
        assert_same_graph(td, jd)
        assert_same_graph(ttc.chain_bottlenecks(td),
                          jtc.chain_bottlenecks(jd))


@pytest.mark.parametrize("min_hw,chains", [(0, 3), (24, 1)])
def test_mesh_fused_matches_reference_and_unfused(min_hw, chains):
    """external_stem + fuse_bn in both packages: the same op list after
    the passes, the same outputs, and fused equals unfused."""
    kw = dict(layout="NCHW", planar_inputs=True, external_stem=True,
              batch_flexible=True)
    jfn, jp = jtc.compile_tflite(_mesh_blob(), fuse_bn=True,
                                 fuse_bn_min_hw=min_hw, **kw)
    tfn, tp = ttc.compile_tflite(_mesh_blob(), device="cpu", fuse_bn=True,
                                 fuse_bn_min_hw=min_hw, **kw)
    tfn0, tp0 = ttc.compile_tflite(_mesh_blob(), device="cpu", **kw)
    assert _counts(tfn.graph) == _counts(jfn.graph)
    assert _counts(tfn.graph)["PALLAS_BN_CHAIN"] == chains
    assert _counts(tfn.graph)["PALLAS_BN"] == 0
    # Only the stride-2 downsample units keep a depthwise conv where every
    # stage fused.
    assert _counts(tfn.graph)["DEPTHWISE_CONV_2D"] == 2 + 4 * (3 - chains)
    assert [(o.opcode, o.inputs, o.outputs) for o in tfn.graph.ops] == [
        (o.opcode, o.inputs, o.outputs) for o in jfn.graph.ops]
    assert set(tp) == set(jp)
    assert tfn.external_stem_meta == jfn.external_stem_meta
    stems = np.random.RandomState(3).uniform(
        -1, 1, (2, 16, MESH_SIZE // 2, MESH_SIZE // 2)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = [np.asarray(o, np.float32)
                for o in jfn(jp, jnp.asarray(stems))]
    got = [o.numpy() for o in tfn(tp, torch.from_numpy(stems))]
    unfused = [o.numpy() for o in tfn0(tp0, torch.from_numpy(stems))]
    _assert_close(got, want, F32_TOL)
    _assert_close(got, unfused, F32_TOL)


def test_mesh_lone_unit_compiles_to_a_single_fused_op():
    """A stage of one unit cannot chain: it stays a lone PALLAS_BN (the
    path of kernel K5), equal to the unfused graph."""
    g = mesh_graph.face_mesh_graph(3, MESH_SIZE, MESH_WIDTHS,
                                   units_per_stage=(1, 4, 4))
    kw = dict(layout="NCHW", planar_inputs=True, batch_flexible=True,
              device="cpu")
    fn, p = ttc.compile_graph(g, fuse_bn=True, fuse_bn_min_hw=0, **kw)
    fn0, p0 = ttc.compile_graph(g, **kw)
    assert _counts(fn.graph)["PALLAS_BN"] == 1
    assert _counts(fn.graph)["PALLAS_BN_CHAIN"] == 2
    x = torch.from_numpy(_input(fn, 4, True, batch=2))
    _assert_close([o.numpy() for o in fn(p, x)],
                  [o.numpy() for o in fn0(p0, x)], F32_TOL)


def test_fuse_bottlenecks_rejects_bounded_add_activation():
    """A unit whose ADD carries RELU6 must stay unfused: the kernel's
    epilogue has no clamp."""
    g = ttc.parse_tflite(_mesh_blob())
    base = ttc.fuse_bottlenecks(g, min_hw=0)
    assert _counts(base)["PALLAS_BN"] == 12
    adds_left = sum(op.opcode == "ADD" for op in base.ops)
    victim = next(op for op in g.ops if op.opcode == "ADD"
                  and g.tensors[op.inputs[1]].shape[1] == 16
                  and g.tensors[op.inputs[0]].shape
                  == g.tensors[op.inputs[1]].shape
                  and not any(o.opcode in ("MAX_POOL_2D", "PAD")
                              and o.outputs[0] == op.inputs[1]
                              for o in g.ops))
    victim.options["activation"] = "RELU6"
    got = ttc.fuse_bottlenecks(g, min_hw=0)
    assert any(op is victim for op in got.ops)
    assert sum(op.opcode == "ADD" for op in got.ops) == adds_left + 1
    assert _counts(got)["PALLAS_BN"] == 11


def test_external_stem_declines_shared_input():
    """When the image feeds a second consumer besides the stem conv,
    extraction must decline."""
    g = ttc.parse_tflite(_mesh_blob())
    _, stem = ttc._extract_stem(g)
    assert stem is not None
    tensors = list(g.tensors)
    tensors.append(ttc.TensorInfo("extra", g.tensors[g.inputs[0]].shape,
                                  np.float32, None, None))
    extra = ttc.OpNode("RELU", [g.inputs[0]], [len(tensors) - 1], {})
    g3 = ttc.Graph(tensors, list(g.ops) + [extra], list(g.inputs),
                   list(g.outputs) + [len(tensors) - 1])
    g4, stem4 = ttc._extract_stem(g3)
    assert stem4 is None and g4 is g3


def test_mesh_graph_matches_the_parsed_model():
    """``face_mesh_graph`` at the reduced size is, op for op, what the
    parse of the TensorFlow-built model returns: opcodes, options, tensor
    shapes and wiring (tensor numbers differ, so the wiring is compared
    through the one-to-one map the walk builds; the converter orders the
    graph outputs its own way, so they are compared as a set)."""
    want = ttc.parse_tflite(_mesh_blob())
    got = mesh_graph.face_mesh_graph(0, MESH_SIZE, MESH_WIDTHS,
                                     num_landmarks=MESH_LANDMARKS)
    assert len(got.ops) == len(want.ops)
    fwd: dict[int, int] = {}

    def same(a: int, b: int) -> bool:
        ta, tb = got.tensors[a], want.tensors[b]
        return (fwd.setdefault(a, b) == b and tuple(ta.shape) == tuple(
            tb.shape) and np.dtype(ta.dtype) == np.dtype(tb.dtype)
            and (ta.data is None) == (tb.data is None))

    assert same(got.inputs[0], want.inputs[0])
    for i, (a, b) in enumerate(zip(got.ops, want.ops)):
        assert (a.opcode, a.options) == (b.opcode, b.options), i
        assert len(a.inputs) == len(b.inputs), i
        assert all(map(same, a.inputs + a.outputs, b.inputs + b.outputs)), (
            i, a.opcode)
    assert len(set(fwd.values())) == len(fwd)
    assert {fwd[t] for t in got.outputs} == set(want.outputs)
    assert [tuple(got.tensors[t].shape) for t in got.outputs] == [
        (1, 1, 1, 3 * MESH_LANDMARKS), (1, 1, 1, 1), (1, 1, 1, 1)]


def test_mesh_graph_full_size_architecture():
    """The default graph: 28 units in 7 stages, 6 downsample units that
    keep their depthwise conv, one chain at the default gate."""
    g = mesh_graph.face_mesh_graph(1)
    assert g.tensors[g.inputs[0]].shape == (1, 256, 256, 3)
    assert [g.tensors[t].shape for t in g.outputs] == [
        (1, 1, 1, 1434), (1, 1, 1, 1), (1, 1, 1, 1)]
    s, meta = ttc._extract_stem(g)
    assert meta["in_size"] == 256 and meta["out_channels"] == 16
    fused = ttc.chain_bottlenecks(ttc._dce(ttc.fuse_bottlenecks(s)))
    assert _counts(fused) == {"PALLAS_BN_CHAIN": 7, "PALLAS_BN": 0,
                              "DEPTHWISE_CONV_2D": 6, "PRELU": 12}
    gated = ttc.chain_bottlenecks(ttc._dce(ttc.fuse_bottlenecks(s, 96)))
    assert _counts(gated)["PALLAS_BN_CHAIN"] == 1
    shapes = [(g.tensors[op.inputs[0]].shape[1],
               g.tensors[op.inputs[0]].shape[3], op.options["cmid"])
              for op in fused.ops if op.opcode == "PALLAS_BN_CHAIN"]
    assert shapes == [(128, 16, 8), (64, 32, 16), (32, 64, 32),
                      (16, 128, 64), (8, 128, 64), (4, 128, 64),
                      (2, 128, 64)]
    with pytest.raises(ValueError):
        mesh_graph.face_mesh_graph(1, units_per_stage=(4, 4))
