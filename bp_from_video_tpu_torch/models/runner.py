"""The batched inference runner — the counterpart of
``bp_from_video_tpu/models/runner.py``: face landmarker (face detector +
landmark net), hand landmarker (palm detector + per-hand landmark net) in
VIDEO detect-then-track mode (or IMAGE mode: detect every frame), and the
person segmenter, over a stream batch, with the tracking state carried
explicitly.

Main path (``use_pallas``, ``fused_stem``, ``fused_trunk``, uint8 frames,
cover rotation): one K1 launch crops every landmark crop of every stream
2x2-packed and pre-scaled, one K3 launch per net runs its 3x3/2 stem, then
a stand-in's trunk is four K3 launches and its dense heads, and a compiled
TFLite graph runs once for the whole batch with its bottleneck stages as
K6 (or K5) launches.  With ``fused_stem`` alone the stem is one K2 launch
per net and the trunk plain convolutions.  With ``pack_s2d`` and no fused
stem, K1 still packs the crops of every net that takes them packed: a
stand-in runs its packed stem twin ``stem_p``, a compiled graph is
compiled to take its input packed (``packed_inputs``).  Without
``use_pallas`` the crops are plain separable resamples and the nets run as
plain convolutions (a net that takes packed crops gets its crop packed in
the graph).  The detectors sit behind one batch-level host branch per
landmarker: a device-to-host read per step of how many streams need
detection (counted as ``sync.face_gate`` / ``sync.hand_gate``).

Stages are named with ``utils/profiling.span`` (``bpv.gate.*``,
``bpv.sync.*``, ``bpv.detect.*``, ``bpv.crop``, ``bpv.net.*``,
``bpv.track.*``, ``bpv.segment``: ranges only while a profiler records;
the engine opens ``bpv.runner`` around them), and the gates count their
syncs and detector rows with ``utils/profiling.count`` from numbers
already on the host.

Rotation modes (``InferenceConfig.resolved_rotation_mode``): ``cover``
crops the axis-aligned cover of each tracking rect; ``exact`` and ``shear``
crop the rotated rect (bilinear gathers; gather-free shears) on the
per-crop path, with no K1; ``hybrid`` crops the cover while a crop's tilt
is within ``hybrid_max_tilt_deg`` and the shear view beyond it.  On the K1
path ``hybrid`` reads the gated counts of both kinds in one host sync a
step: none gated runs K1 alone; up to ``shear_subbatch`` a kind runs K1
and shear-crops the gated crops in a compacted sub-batch padded to a power
of two (``_pow2_ladder``), written over their K1 crops; more runs the
shear crop for the whole batch.

A net is a compiled TFLite graph when its asset resolves (a ``.tflite``
file or a ``.task`` bundle, parsed with TensorFlow) or when ``graphs``
hands the runner an already parsed ``tflite_compiler.Graph`` (or .tflite
bytes) for its key (``"face_det"``, ``"flm_det"``, ``"flm_lm"``,
``"palm_det"``, ``"hand_lm"``, ``"seg"``) — the one keyword the reference
runner does not have, for machines without TensorFlow.  A compiled graph
is always compiled ``batch_flexible`` and with ``fuse_dw_pw``/``pack_s2d``
from the config: the reference maps a batch-1 graph over the crops, the
port feeds the batch.  A detector's regressors are its widest output (by
last dim), its logits the single-channel one; the segmenter's confidences
its largest output (NHWC, made planar at model resolution).

The standalone face detector (``face_detector``) runs on every frame of
every stream, with no tracking gate and no host sync: its detections,
largest first, are ``ModelResults.face_detector``.  The segmenter (the
stand-in, trained or seeded, or a compiled graph) runs on every frame
resized to its input, planar end to end: six class confidences and their
argmax at frame resolution (``seg_full_masks``), or the skin channel alone
at frame resolution with the class map at model resolution.
``graph_calls`` counts the calls of each compiled net.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import zlib
from typing import Any, NamedTuple

import numpy as np
import torch

from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.config import InferenceConfig, RunningMode
from bp_from_video_tpu_torch.kernels import block as block_kernel
from bp_from_video_tpu_torch.kernels import stem as stem_kernel
from bp_from_video_tpu_torch.kernels import warp as warp_kernel
from bp_from_video_tpu_torch.models import anchors as anchors_lib
from bp_from_video_tpu_torch.models import blaze, detection, warp
from bp_from_video_tpu_torch.models import tflite_compiler as tc
from bp_from_video_tpu_torch.ops.roi import Detections, is_planar_frames
from bp_from_video_tpu_torch.utils.profiling import count, span

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

NUM_FACE_LANDMARKS = 478
NUM_HAND_LANDMARKS = 21
NUM_FACE_DET_KPS = 6
NUM_PALM_KPS = 7
MAX_FACE_DETS = 4
# The detector behind each landmarker's gate, as counters name it.
_DETECTOR = {"face": "face", "hand": "palm"}
SEG_CLASSES = 6
# The selfie-multiclass class the live pipeline consumes: face skin.
SEG_SKIN_CLASS = 3
PRESENCE_THRESHOLD = 0.5
# Tracking-rect anchor landmarks: face = outer eye corners, hand = wrist ->
# middle-finger MCP.
FACE_ROT_LANDMARKS = (33, 263)
HAND_ROT_LANDMARKS = (0, 9)


def _rect_iou_matrix(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise IoU of (cx, cy, w, h[, rot]) rects [..., n, 5+] x
    [..., m, 5+], rotation ignored."""
    ax0, ay0 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax1, ay1 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx0, by0 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx1, by1 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    ix = torch.clamp(torch.minimum(ax1[..., :, None], bx1[..., None, :])
                     - torch.maximum(ax0[..., :, None], bx0[..., None, :]),
                     min=0.0)
    iy = torch.clamp(torch.minimum(ay1[..., :, None], by1[..., None, :])
                     - torch.maximum(ay0[..., :, None], by0[..., None, :]),
                     min=0.0)
    inter = ix * iy
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def _associate_hand_dets(tracking: Tensor, t_rects: Tensor,
                         det_rects: Tensor, det_valid: Tensor,
                         iou_thr: float = 0.5) -> tuple[Tensor, Tensor]:
    """Fill LOST hand slots from palm detections (batched over streams):
    detections overlapping an already-tracked rect are suppressed, the rest
    go to lost slots in rank order.  Returns (rects [S, nh, 5],
    slot_ok [S, nh])."""
    ious = _rect_iou_matrix(det_rects, t_rects)             # [S, nd, nt]
    sup = ((ious > iou_thr) & tracking[:, None, :]).any(-1)
    free_det = det_valid & ~sup
    det_rank = torch.cumsum(free_det.to(torch.int32), -1) - 1
    lost = ~tracking
    slot_rank = torch.cumsum(lost.to(torch.int32), -1) - 1
    match = (lost[..., :, None] & free_det[..., None, :]
             & (slot_rank[..., :, None] == det_rank[..., None, :]))
    got = match.any(-1)
    det_clean = torch.where(free_det[..., None], torch.nan_to_num(det_rects),
                            0.0)
    new_rect = match.to(det_rects.dtype) @ det_clean
    rects = torch.where(tracking[..., None], t_rects,
                        torch.where(got[..., None], new_rect, float("nan")))
    return rects, tracking | got


def skin_confidence(seg_conf: Tensor) -> Tensor:
    """The face-skin confidence from ``seg_conf`` in either layout:
    [..., 6, H, W] (``seg_full_masks``) or [..., 1, H, W] (skin only).  A
    view, not a copy: with the full masks its stream stride is 6 H W.  Any
    other channel count raises."""
    c = seg_conf.shape[-3]
    if c not in (1, SEG_CLASSES):
        raise ValueError(f"seg_conf has {c} channels; expected 1 "
                         f"(skin-only) or {SEG_CLASSES} (full masks)")
    return seg_conf[..., min(SEG_SKIN_CLASS, c - 1), :, :]


class TrackState(NamedTuple):
    """Detect-then-track state, every field with a leading stream axis."""

    face_rect: Tensor       # [S, 5] (cx, cy, w, h, rot) in pixels
    face_tracking: Tensor   # bool [S]
    hand_rects: Tensor      # [S, max_hands, 5]
    hand_tracking: Tensor   # bool [S, max_hands]
    face_det_age: Tensor    # int32 [S]: frames waiting for a detection
    hand_det_age: Tensor    # int32 [S]


class ModelResults(NamedTuple):
    """Per-frame outputs of all four models (disabled ones empty)."""

    face_detector: Detections
    face_landmarker: Detections
    hand_landmarker: Detections
    seg_class: Tensor
    seg_conf: Tensor
    seg_valid: Tensor


def _seed(key: str) -> int:
    """Deterministic stand-in weight seed (the reference package's)."""
    return zlib.crc32(key.encode()) % 2**31


def _clip_floor(pts: Tensor, width: int, height: int) -> Tensor:
    """Pixel contract: clip to [0, dim-1], then truncate."""
    x = torch.floor(torch.clamp(pts[..., 0], 0, width - 1))
    y = torch.floor(torch.clamp(pts[..., 1], 0, height - 1))
    return torch.stack([x, y], -1)


def map_leaves(fn, tree):
    """Apply ``fn`` to every tensor of a nest of NamedTuples, tuples, lists
    and dicts (a state, a result, a training state); ``map_leaves(lambda
    x: x[i], state)`` is stream ``i``'s own state, ``map_leaves(lambda x:
    x[None], one)`` a batch of one."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, t) for t in tree)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a nest in :func:`map_leaves` order: fields and items
    in order, dict keys sorted, depth first (the order ``jax.tree``
    flattens the same structure)."""
    leaves = []
    map_leaves(leaves.append, tree)
    return leaves


def _pow2_ladder(m: int) -> list[int]:
    """[1, 2, 4, ...] capped by (and always ending at) ``m``: the sizes a
    compacted shear sub-batch is padded to, so a gated count pays for its
    power of two and the set of shapes stays small."""
    out = []
    p = 1
    while p < m:
        out.append(p)
        p *= 2
    out.append(m)
    return out


def _to_torch(tree, device, dtype=None):
    """Nested dict/list of numpy arrays -> tensors on ``device`` (float
    leaves cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.ascontiguousarray(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


class InferenceRunner:
    """Builds the model set (stand-in or compiled weights, packed kernel
    weights) once and exposes ``predict_batch`` / ``predict``.
    ``device=None`` means ``"cuda"`` (raises without CUDA); pass
    ``device="cpu"`` for the plain versions of the kernels.  ``graphs``:
    optional {key: parsed ``Graph`` or .tflite bytes} for any of
    "face_det", "flm_det", "flm_lm", "palm_det", "hand_lm", "seg", taking
    the place of the asset's blob."""

    def __init__(self, cfg: InferenceConfig, frame_height: int,
                 frame_width: int, asset_dir: str | None = None,
                 dtype=torch.float32, device=None,
                 graphs: dict | None = None) -> None:
        self.cfg = cfg
        self.h, self.w = frame_height, frame_width
        self.dtype = dtype
        self.device = resolve_device(device)
        # The hybrid gate in f32, as the reference computes deg2rad.
        self._gate_rad = float(np.float32(cfg.hybrid_max_tilt_deg)
                               * np.float32(np.pi / 180))
        self.params: dict[str, Any] = {}
        self.sizes: dict[str, int] = {}
        self._trunk_specs: dict[str, tuple] = {}
        # Nets with a fused stem (fed 2x2-packed crops): where its weights
        # are and, with the fused trunk, its packed K3 matrix.
        self._stem_src: dict[str, dict] = {}
        # Landmark nets fed 2x2-packed crops (a fused stem, a stand-in's
        # packed stem twin, or a graph compiled with packed inputs).
        self._packed_in: dict[str, bool] = {}
        self._graph_fns: dict[str, Any] = {}    # compiled nets, batched
        self._det_fns: dict[str, Any] = {}      # detector apply per key
        self._seg_fn = None
        #: calls of each compiled net (host count, no sync)
        self.graph_calls: collections.Counter = collections.Counter()
        self.real_weights: dict[str, bool] = {}
        self.trained_standin: dict[str, bool] = {}
        graphs = dict(graphs or {})
        asset_dir = asset_dir or "."
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))

        def resolve(p):
            if p is None:
                return None
            for cand in (p, os.path.join(asset_dir, p),
                         os.path.join(repo_root, p)):
                if os.path.exists(cand):
                    return cand
            return None

        def bundle(path, is_det, is_lm):
            """(detector blob, landmark blob) of a resolved .task bundle."""
            blobs = tc.load_task_bundle(path) if path else {}
            return (next((v for k, v in blobs.items() if is_det(k)), None),
                    next((v for k, v in blobs.items() if is_lm(k)), None))

        # Built once: a tensor made from host values per step would be a
        # host-to-device copy, which synchronizes the stream.
        self._default_rect = torch.tensor(
            [self.w / 2, self.h / 2, self.w, self.h, 0.0],
            dtype=torch.float32, device=self.device)
        self.face_anchors = torch.from_numpy(anchors_lib.generate_anchors(
            anchors_lib.FACE_SHORT_RANGE)).to(self.device)
        self.palm_anchors = torch.from_numpy(anchors_lib.generate_anchors(
            anchors_lib.PALM)).to(self.device)
        if cfg.face_detector:
            path = resolve(cfg.face_detector_path)
            self._load_detector(
                "face_det", graphs.pop(
                    "face_det", tc.load_tflite_file(path) if path else None),
                128, 896, NUM_FACE_DET_KPS)
        if cfg.face_landmarker:
            det, lm = bundle(resolve(cfg.face_landmarker_path),
                             lambda k: k == "face_detector.tflite",
                             lambda k: k == "face_landmarks_detector.tflite")
            self._load_detector("flm_det", graphs.pop("flm_det", det), 128,
                                896, NUM_FACE_DET_KPS)
            self._load_landmark("flm_lm", graphs.pop("flm_lm", lm), 256,
                                NUM_FACE_LANDMARKS)
        if cfg.hand_landmarker:
            det, lm = bundle(resolve(cfg.hand_landmarker_path),
                             lambda k: "palm" in k,
                             lambda k: "landmark" in k and "palm" not in k)
            self._load_detector("palm_det", graphs.pop("palm_det", det), 192,
                                2016, NUM_PALM_KPS,
                                resolve(cfg.palm_det_standin_path))
            self._load_landmark("hand_lm", graphs.pop("hand_lm", lm), 224,
                                NUM_HAND_LANDMARKS,
                                resolve(cfg.hand_lm_standin_path))
        if cfg.person_segmenter:
            path = resolve(cfg.person_segmenter_path)
            self._load_segmenter(
                "seg", graphs.pop(
                    "seg", tc.load_tflite_file(path) if path else None), 256,
                resolve(cfg.seg_standin_path))
        if graphs:
            raise ValueError(f"graphs for models not enabled: "
                             f"{sorted(graphs)}")

    # -- model loading ---------------------------------------------------

    def _load_trained_standin(self, key: str, standin_path, expect,
                              meta_expect) -> dict | None:
        """A trained stand-in npz when present and matching the
        architecture (leaf shapes) and geometry (``__meta__`` stamp); None
        falls back to random init."""
        self.real_weights[key] = False
        if not standin_path:
            return None
        try:
            cand, meta = blaze.load_standin_npz(standin_path,
                                                return_meta=True)
            for path_keys, shape in expect.items():
                node = cand
                for k in path_keys:
                    node = node[k]
                if tuple(node.shape) != tuple(shape):
                    raise ValueError(f"{'/'.join(path_keys)} shape "
                                     f"{node.shape} != expected {shape}")
            for name, want in meta_expect.items():
                if name not in meta:
                    raise ValueError(f"artifact lacks __meta__/{name} stamp")
                if meta[name] != int(want):
                    raise ValueError(f"__meta__/{name}={meta[name]} != "
                                     f"expected {int(want)}")
        except (OSError, KeyError, ValueError) as e:
            logger.warning("model %r: trained stand-in %r unusable (%s) — "
                           "using RANDOM-INIT stand-in", key, standin_path, e)
            return None
        self.trained_standin[key] = True
        return cand

    def _compile(self, key: str, graph, **kw):
        """Compile a net's graph (parsed ``Graph`` or .tflite bytes) for the
        batch, NCHW, planar inputs: (fn, params)."""
        self.real_weights[key] = True
        if isinstance(graph, (bytes, bytearray)):
            graph = tc.parse_tflite(bytes(graph))
        kw.setdefault("fuse_dw_pw", self.cfg.fuse_dw_pw)
        kw.setdefault("pack_s2d", self.cfg.pack_s2d)
        return tc.compile_graph(graph, self.dtype, layout="NCHW",
                                planar_inputs=True, batch_flexible=True,
                                device=self.device, **kw)

    def _load_detector(self, key, graph, size, num_anchors, num_kps,
                       standin_path=None):
        """A detector from a compiled TFLite graph (parsed ``Graph`` or
        .tflite bytes; its input size is the graph's, its anchors the
        stand-in's layout) or, when None, the blaze stand-in."""
        if graph is not None:
            fn, params = self._compile(key, graph)

            def apply(p, x):
                self.graph_calls[key] += 1
                outs = fn(p, x)
                # regressors: the widest output; logits: single-channel.
                return (max(outs, key=lambda t: t.shape[-1]),
                        min(outs, key=lambda t: t.shape[-1]))
            apply.graph = fn.graph
            self.params[key] = params
            self.sizes[key] = fn.input_shapes[0][1]
            self._det_fns[key] = apply
            return
        box_dim = 4 + 2 * num_kps
        params = self._load_trained_standin(
            key, standin_path,
            {("head8_box", "w"): (1, 1, 96, 2 * box_dim),
             ("head16_box", "w"): (1, 1, 96, 6 * box_dim)},
            {"input_size": size, "anchors": num_anchors, "kps": num_kps})
        if params is None:
            logger.warning("model %r: using a RANDOM-INIT stand-in", key)
            params = blaze.init_blaze_detector(_seed(key), size, num_anchors,
                                               num_kps)
        self.params[key] = _to_torch(params, self.device, self.dtype)
        self.sizes[key] = size
        self._det_fns[key] = (lambda p, x, k=num_kps:
                              blaze.blaze_detector_apply(p, x, k))

    def _load_segmenter(self, key, graph, size, standin_path=None):
        """The segmenter: a compiled TFLite graph (parsed ``Graph`` or
        .tflite bytes; its largest output, NHWC, made planar) or the
        stand-in, the trained npz when it matches, else a seeded init."""
        if graph is not None:
            fn, params = self._compile(key, graph)

            def apply(p, x):
                self.graph_calls[key] += 1
                out = max(fn(p, x), key=lambda t: t.numel())
                return out.permute(0, 3, 1, 2)
            apply.graph = fn.graph
            self.params[key] = params
            self.sizes[key] = fn.input_shapes[0][1]
            self._seg_fn = apply
            return
        params = self._load_trained_standin(
            key, standin_path, {("head", "w"): (1, 1, 12, SEG_CLASSES)},
            {"input_size": size, "classes": SEG_CLASSES})
        if params is None:
            logger.warning("model %r: using a RANDOM-INIT stand-in", key)
            params = blaze.init_segmenter(_seed(key), size, SEG_CLASSES)
        self.params[key] = _to_torch(params, self.device, self.dtype)
        self.sizes[key] = size
        self._seg_fn = (lambda p, x, s=size: blaze.segmenter_apply(p, x, s))

    def _segment(self, params, frames_planar: Tensor
                 ) -> tuple[Tensor, Tensor]:
        """Segmenter over planar frames [S, 3, H, W] -> (class map int32,
        confidences f32): [S, H, W] and [S, 6, H, W] with the full masks,
        else [S, size, size] and the skin channel [S, 1, H, W]."""
        size = self.sizes["seg"]
        # A tensor divisor: IEEE quotients on the card as on the CPU.
        d255 = torch.full((), 255.0, dtype=torch.float32,
                          device=frames_planar.device)
        small = warp.resize_bilinear_planar(
            frames_planar.to(self.dtype), size, size, dtype=self.dtype,
            out_dtype=torch.float32) / d255
        conf = self._seg_fn(params, small.to(self.dtype))       # planar
        if self.cfg.seg_full_masks:
            full = warp.resize_bilinear_planar(
                conf, self.h, self.w, dtype=torch.bfloat16,
                out_dtype=torch.float32)
            return full.argmax(1).to(torch.int32), full
        sk = SEG_SKIN_CLASS
        skin = warp.resize_bilinear_planar(
            conf[:, sk:sk + 1], self.h, self.w, dtype=torch.bfloat16,
            out_dtype=torch.float32)
        return conf.argmax(1).to(torch.int32), skin

    def _load_landmark(self, key, graph, size, num_landmarks,
                       standin_path=None):
        """A landmark net from a compiled TFLite graph (``graph``: parsed
        ``Graph`` or .tflite bytes) or, when None, a blaze stand-in."""
        want_stem = self.cfg.fused_stem and self.cfg.use_pallas
        fused_trunk = self.cfg.fused_trunk and want_stem
        if graph is not None:
            self._load_compiled_landmark(key, graph, num_landmarks,
                                         want_stem, fused_trunk)
            return
        g = size // 32
        params = self._load_trained_standin(
            key, standin_path,
            {("head_lm", "w"): (192 * g * g, 3 * num_landmarks)},
            {"input_size": size, "num_landmarks": num_landmarks})
        if params is not None:
            # Re-derive the packed stem twin from the trained stem.
            params["stem_p"] = blaze._pack_stem(params["stem"], 3, size)
        else:
            logger.warning("model %r: using a RANDOM-INIT stand-in", key)
            params = blaze.init_blaze_landmark(_seed(key), size,
                                               num_landmarks)
        p = _to_torch(params, self.device, self.dtype)
        self.sizes[key] = size
        # Packed crops feed the fused stem, or else the packed stem twin.
        if self.cfg.use_pallas and (bool(self.cfg.pack_s2d)
                                    or self.cfg.fused_stem):
            self._packed_in[key] = True
        if want_stem:
            self._stem_src[key] = {"kind": "standin"}
        if fused_trunk:
            # Each dw+pw block composes into its dense twin; the stem and
            # trunk window-matrix weights are packed host-side from the raw
            # f32 params (bf16 matrices, f32 block biases).  The stem runs
            # through the same kernel (K3) instead of K2.
            arrays, specs = block_kernel.prepare_trunk(params)
            p["trunk"] = [{"wmat": _to_torch(a["wmat"], self.device,
                                             torch.bfloat16),
                           "b": _to_torch(a["b"], self.device)}
                          for a in arrays]
            self._trunk_specs[key] = specs
            wmat, wspec = block_kernel.pack_block_weights(
                params["stem"]["w"], cin=3)
            p["stem_wmat"] = _to_torch(wmat, self.device, torch.bfloat16)
            self._stem_src[key].update(wmat_key="stem_wmat", wspec=wspec)
        self.params[key] = p

    def _load_compiled_landmark(self, key, graph, num_landmarks, want_stem,
                                fused_trunk):
        """Compile a landmark graph: with the fused stem its leading 3x3/2
        conv (+PReLU) is split off and runs as a stem kernel on the packed
        crops; with the fused trunk as well its bottleneck units fuse into
        K5/K6 ops (``fused_bn_min_hw`` gates them by spatial size) and the
        split-off stem goes through K3.  Without the fused stem,
        ``pack_s2d`` (with ``use_pallas``) compiles the graph to take its
        crop packed, as K1 emits it."""
        if isinstance(graph, (bytes, bytearray)):
            graph = tc.parse_tflite(bytes(graph))
        packed_in = (bool(self.cfg.pack_s2d) and self.cfg.use_pallas
                     and not want_stem)
        fn, params = self._compile(
            key, graph, pack_s2d=0 if want_stem else self.cfg.pack_s2d,
            packed_inputs=packed_in, external_stem=want_stem,
            fuse_bn=fused_trunk, fuse_bn_min_hw=self.cfg.fused_bn_min_hw)
        stem_meta = getattr(fn, "external_stem_meta", None)
        if stem_meta is not None:
            size = stem_meta["in_size"]
            self._packed_in[key] = True
            self._stem_src[key] = {"kind": "external",
                                   "params": stem_meta["params"]}
            w_stem = params[stem_meta["params"]["w"]]      # HWIO
            if fused_trunk and w_stem.shape[0] == 3:
                wmat, wspec = block_kernel.pack_block_weights(
                    w_stem.to(torch.float32).cpu().numpy(),
                    cin=w_stem.shape[2])
                params["__stem_wmat__"] = _to_torch(wmat, self.device,
                                                    torch.bfloat16)
                self._stem_src[key].update(wmat_key="__stem_wmat__",
                                           wspec=wspec)
        else:
            size = fn.input_shapes[0][1]
            if packed_in and fn.input_shapes[0][3] == 12:
                self._packed_in[key] = True
                size *= 2

        # Output roles are resolved by size plus, when two outputs could
        # hold the landmarks, a one-time probe: converters order outputs
        # arbitrarily, and the world landmarks ([L, 3] metric, |v| < ~1)
        # in place of the screen landmarks (crop pixels) would zero the
        # pipeline.  The probe is a mid-gray forward pass of a plain f32
        # compile on the CPU; the passes never reorder graph outputs.
        sizes = [int(np.prod(s)) for s in fn.output_shapes]
        cands = [i for i, n in enumerate(sizes) if n >= 3 * num_landmarks]
        if not cands:
            raise ValueError(
                f"model {key!r}: no output holds >= {3 * num_landmarks} "
                f"values (output sizes: {sizes})")
        lm_idx = cands[0]
        if len(cands) > 1:
            pfn, pparams = tc.compile_graph(graph, torch.float32,
                                            layout="NCHW", planar_inputs=True,
                                            device="cpu")
            ish = pfn.input_shapes[0]       # reported NHWC; takes planar
            outs = pfn(pparams, torch.full((ish[0], ish[3], ish[1], ish[2]),
                                           0.5))
            lm_idx = max(cands, key=lambda i: float(outs[i].abs().mean()))
        # Scalar roles (presence first, then handedness / tongueOut) follow
        # graph output order, the contract of every shipped bundle.
        scalar_idx = [i for i, n in enumerate(sizes) if n == 1]

        def apply_batch(p, x, nl=num_landmarks, li=lm_idx,
                        si=tuple(scalar_idx)):
            self.graph_calls[key] += 1
            outs = fn(p, x)
            b = x.shape[0]
            flat = [o.reshape(b, -1) for o in outs]
            lm = flat[li][:, : 3 * nl]
            presence = (flat[si[0]][:, 0] if si else
                        torch.ones((b,), dtype=torch.float32,
                                   device=x.device))
            aux = (flat[si[1]][:, 0] if len(si) > 1 else
                   torch.zeros((b,), dtype=torch.float32, device=x.device))
            return lm, presence, aux
        apply_batch.graph = fn.graph
        self.params[key] = params
        self.sizes[key] = size
        self._graph_fns[key] = apply_batch

    # -- state ---------------------------------------------------------------

    def init_state(self, num_streams: int = 1) -> TrackState:
        s, nh, dev = num_streams, self.cfg.max_hands, self.device
        default = self._default_rect
        return TrackState(
            face_rect=default.expand(s, 5).clone(),
            face_tracking=torch.zeros(s, dtype=torch.bool, device=dev),
            hand_rects=default.expand(s, nh, 5).clone(),
            hand_tracking=torch.zeros((s, nh), dtype=torch.bool, device=dev),
            face_det_age=torch.zeros(s, dtype=torch.int32, device=dev),
            hand_det_age=torch.zeros(s, dtype=torch.int32, device=dev))

    def empty_results(self, num_streams: int) -> ModelResults:
        s, dev = num_streams, self.device
        return ModelResults(
            face_detector=Detections.empty(s, MAX_FACE_DETS,
                                           NUM_FACE_DET_KPS, dev),
            face_landmarker=Detections.empty(s, self.cfg.max_faces,
                                             NUM_FACE_LANDMARKS, dev),
            hand_landmarker=Detections.empty(s, self.cfg.max_hands,
                                             NUM_HAND_LANDMARKS, dev),
            seg_class=torch.zeros((s, 0, 0), dtype=torch.int32, device=dev),
            seg_conf=torch.zeros((s, 0, 0, 0), dtype=torch.float32,
                                 device=dev),
            seg_valid=torch.zeros(s, dtype=torch.bool, device=dev))

    # -- sub-pipelines ---------------------------------------------------------

    def _safe_rect(self, a: Tensor) -> Tensor:
        """Non-finite rect entries -> a frame-centered default (the result
        is masked out downstream)."""
        return torch.where(torch.isfinite(a), a, self._default_rect)

    def _run_detector(self, key: str, decode_cfg: detection.DecodeConfig,
                      anchors: Tensor, params, frames: Tensor, in_range: str,
                      max_out: int) -> detection.NMSOut:
        """Detector over NHWC frames [B, H, W, 3] -> NMS output in frame
        pixels."""
        size = self.sizes[key]
        lb = warp.letterbox(frames, size, dtype=self.dtype)
        x = lb.image / 255.0
        if in_range == "pm1":
            x = x * 2.0 - 1.0
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        reg, log = self._det_fns[key](params, x)
        raw = detection.decode(decode_cfg, reg.to(torch.float32),
                               log.to(torch.float32), anchors)
        nms = detection.weighted_nms(decode_cfg, raw, max_out)
        b = frames.shape[0]
        boxes_px = warp.unletterbox_points(nms.boxes.reshape(b, -1, 2, 2),
                                           lb, size)
        kps_px = warp.unletterbox_points(nms.kps, lb, size)
        return detection.NMSOut(boxes_px.reshape(b, -1, 4), kps_px,
                                nms.scores, nms.count)

    def _face_rects(self, params, frames: Tensor) -> tuple[Tensor, Tensor]:
        """Face detector -> tracking rects [B, 5] and found [B]."""
        nms = self._run_detector("flm_det", detection.FACE_DECODE,
                                 self.face_anchors, params["flm_det"],
                                 frames, "pm1", 1)
        r = warp.detection_to_rect(nms.boxes[:, 0], nms.kps[:, 0], 0, 1, 0.0)
        r = warp.rect_transform(r, scale=1.5)
        return warp.rect_arr(r), nms.count > 0

    def _palm_rects(self, params, frames: Tensor) -> tuple[Tensor, Tensor]:
        """Palm detector -> hand rects [B, nh, 5] and valid [B, nh]."""
        nh = self.cfg.max_hands
        nms = self._run_detector("palm_det", detection.PALM_DECODE,
                                 self.palm_anchors, params["palm_det"],
                                 frames, "zero1", nh)
        r = warp.detection_to_rect(nms.boxes, nms.kps, 0, 2, math.pi / 2)
        r = warp.rect_transform(r, scale=2.6, shift_y=-0.5)
        valid = (torch.arange(nh, device=frames.device)[None]
                 < nms.count[:, None])
        return warp.rect_arr(r), valid

    def _subbatch_detect(self, nhwc_at, need: Tensor, n_need: int,
                         age: Tensor, cur_rects: Tensor, det_batch,
                         k_max: int):
        """Run ``det_batch`` on (up to) ``k_max`` streams — the most-starved
        ones needing detection — instead of all S, when any of the
        ``n_need`` streams of ``need`` does.  Returns the merged
        (det_rects, det_valid, served); unserved streams keep ``cur_rects``
        with valid=False and are retried next frame, oldest first."""
        s = need.shape[0]
        prio = torch.where(need, -age.to(torch.float32), float("inf"))
        idx = torch.argsort(prio, stable=True)[:k_max]
        sub_need = need[idx]
        nd_r = sub_need.reshape((k_max,) + (1,) * (cur_rects.ndim - 1))
        det_rects = cur_rects.clone()
        valid_shape = (s,) + cur_rects.shape[1:-1]
        det_valid = torch.zeros(valid_shape, dtype=torch.bool,
                                device=need.device)
        if n_need:
            sub_rects, sub_valid = det_batch(nhwc_at(idx))
            det_rects[idx] = torch.where(nd_r, sub_rects, cur_rects[idx])
            det_valid[idx] = sub_valid & sub_need.reshape(
                (k_max,) + (1,) * (sub_valid.ndim - 1))
        served = torch.zeros(s, dtype=torch.bool, device=need.device)
        served[idx] = sub_need
        return det_rects, det_valid, served

    def _det_subbatch(self, s: int) -> int:
        k = self.cfg.detector_subbatch
        return s if k <= 0 else min(k, s)

    def _detect_gated(self, kind: str, nhwc_at, need: Tensor, age: Tensor,
                      cur: Tensor, cur_ok: Tensor, det_batch):
        """VIDEO-mode detection for one landmarker (``kind`` "face" or
        "hand"): the bounded sub-batch when it is smaller than the batch,
        else every stream whenever any needs it.  Returns (det_rects,
        det_valid, new_age).  How many streams need detection is the
        gate's one host read; the detector then runs on ``k_max`` rows
        (every stream on the whole-batch path) and, with the priority
        order, serves the first min(n_need, k_max) of them."""
        with span(f"bpv.gate.{kind}"):
            s = need.shape[0]
            k_max = self._det_subbatch(s)
            total = need.sum()
            with span(f"bpv.sync.{kind}_gate"):
                n_need = int(total)         # host sync: sync.<kind>_gate
            count(f"sync.{kind}_gate")
            if n_need:
                det = _DETECTOR[kind]
                count(f"det.{det}.rows", k_max)
                count(f"det.{det}.served", min(n_need, k_max))
            if k_max < s:
                rects, valid, served = self._subbatch_detect(
                    nhwc_at, need, n_need, age, cur, det_batch, k_max)
                return rects, valid, torch.where(need & ~served, age + 1, 0
                                                 ).to(torch.int32)
            if not n_need:
                rects, valid = cur, cur_ok
            else:
                rects, valid = det_batch(nhwc_at(None))
            return rects, valid, torch.zeros_like(age)

    def _stem_operands(self, key: str, params):
        """(w HWIO, bias, PReLU slopes or None) of a net's stem."""
        src = self._stem_src[key]
        if src["kind"] == "standin":
            return params["stem"]["w"], params["stem"]["b"], None
        pk = src["params"]
        return params[pk["w"]], params[pk["b"]], params[pk["alpha"]]

    def _fused_stem_batch(self, key: str, params, crops_packed: Tensor
                          ) -> Tensor:
        """Stem activations of packed crops [B, 12, S/2, S/2] ->
        [B, O, S/2, S/2]: with the fused trunk one K3 launch in its stem
        flavor, otherwise one K2 launch."""
        src = self._stem_src[key]
        w, bi, al = self._stem_operands(key, params)
        wkey = src.get("wmat_key")
        if wkey is not None:
            return block_kernel.dense_s2_block(
                crops_packed, params[wkey], src["wspec"], bi, al,
                cin=w.shape[2], resid=False)
        return stem_kernel.stem_packed(crops_packed, w, bi, al)

    def _fused_trunk_batch(self, key: str, params, stems: Tensor
                           ) -> tuple[Tensor, Tensor]:
        """Whole trunk + heads over a batch of stem activations ->
        (landmarks [B, 3L], presence f32 [B]).  Stand-ins: four K3 launches
        and the dense heads; compiled graphs: one call for the whole batch,
        its fused stages seeing the full batch in one launch each."""
        if key in self._trunk_specs:
            feats = block_kernel.trunk_apply(params["trunk"],
                                             self._trunk_specs[key], stems)
            lm, presence, _aux = blaze.landmark_heads(params, feats,
                                                      self.sizes[key])
            return lm, presence[:, 0].to(torch.float32)
        lm, presence, _aux = self._graph_fns[key](params, stems)
        return lm, presence.to(torch.float32)

    def _landmark_from_stem(self, key: str, params, stems: Tensor
                            ) -> tuple[Tensor, Tensor]:
        """Post-stem trunk as plain convolutions (the fused stem without
        the fused trunk) -> (landmarks [B, 3L], presence f32 [B])."""
        if self._stem_src[key]["kind"] == "standin":
            lm, presence, _aux = blaze.landmark_trunk(params, stems,
                                                      self.sizes[key])
            return lm, presence[:, 0].to(torch.float32)
        lm, presence, _aux = self._graph_fns[key](params, stems)
        return lm, presence.to(torch.float32)

    def _landmark_from_crop(self, key: str, params, crops: Tensor
                            ) -> tuple[Tensor, Tensor]:
        """Net on already scaled planar crops without a fused stem: plain
        [B, 3, S, S] (float frames, ``use_pallas`` off, the per-crop
        rotation modes) or, for a net that takes them, K1's packed crops
        [B, 12, S/2, S/2].  A plain crop for a net that takes packed crops
        is packed here."""
        crops = crops.to(self.dtype)
        if self._stem_src.get(key, {}).get("kind") == "external":
            # The compiled graph was re-rooted at its stem's output: run
            # the stem here as a plain conv (+PReLU) before entering it.
            w, bi, al = self._stem_operands(key, params)
            y = blaze._conv({"w": w, "b": bi}, crops, stride=2)
            al = al.to(y.dtype).reshape(-1, 1, 1)
            return self._landmark_from_stem(
                key, params, torch.where(y >= 0, y, al * y))
        if self._packed_in.get(key) and crops.shape[1] == 3:
            crops = warp_kernel.pack_s2d(crops)
        if key not in self._graph_fns:
            lm, presence, _aux = blaze.blaze_landmark_apply(
                params, crops, self.sizes[key])
            return lm, presence[:, 0].to(torch.float32)
        lm, presence, _aux = self._graph_fns[key](params, crops)
        return lm, presence.to(torch.float32)

    def _project_lm(self, key: str, lm: Tensor, rect: Tensor) -> Tensor:
        """Raw landmark vectors [..., 3L] -> frame pixels [..., L, 2]."""
        # A tensor divisor (IEEE f32 on the card as on the CPU).
        size = torch.full((), float(self.sizes[key]), dtype=torch.float32,
                          device=lm.device)
        pts = lm.to(torch.float32).reshape(lm.shape[:-1] + (-1, 3)
                                           )[..., :2] / size
        return warp.project_landmarks(pts, warp.arr_rect(rect))

    def _landmarks(self, key: str, params, crops: Tensor, packed: bool
                   ) -> tuple[Tensor, Tensor]:
        """Landmark net over a batch of crops -> (raw landmarks [B, 3L],
        presence f32 [B]).  ``crops``: 2x2-packed, pre-scaled crops
        [B, 12, S/2, S/2] (``packed``: K1's crops of a net that takes them
        packed), or planar pre-scaled crops [B, 3, S, S]."""
        with span(f"bpv.net.{key}"):
            if packed and key in self._stem_src:
                stems = self._fused_stem_batch(key, params, crops)
                if self.cfg.fused_trunk:
                    return self._fused_trunk_batch(key, params, stems)
                return self._landmark_from_stem(key, params, stems)
            return self._landmark_from_crop(key, params, crops)

    # -- crops ----------------------------------------------------------------

    def _plain_crops(self, key: str, frames: Tensor, raw: Tensor,
                     cover: Tensor, mode: str) -> tuple[Tensor, Tensor]:
        """The per-crop path (no K1): crops of the rects ``raw`` [S, 5] or
        [S, n, 5] (``cover`` their axis-aligned covers) of NHWC frames
        [S, H, W, 3] in rotation mode ``mode`` -> (f32 planar crops scaled
        to [0, 1] [S*n, 3, s, s], the rects they project with, shaped as
        ``raw``).  ``hybrid`` computes the cover and the shear crop of every
        rect and keeps one per rect by its tilt."""
        size = self.sizes[key]
        n = raw.numel() // 5 // frames.shape[0]
        if n > 1:
            frames = frames.repeat_interleave(n, 0)
        rr, cv = raw.reshape(-1, 5), cover.reshape(-1, 5)
        if mode == "cover":
            crop, pr = warp.crop_rect(frames, warp.arr_rect(cv), size), cv
        elif mode == "exact":
            crop = warp.crop_rect(frames, warp.arr_rect(rr), size,
                                  exact_rotation=True)
            pr = rr
        elif mode == "shear":
            crop, pr = warp.crop_rect_shear(frames, warp.arr_rect(rr),
                                            size), rr
        else:
            ok = (torch.abs(warp.normalize_radians(rr[:, 4]))
                  <= self._gate_rad)
            crop = torch.where(
                ok[:, None, None, None],
                warp.crop_rect(frames, warp.arr_rect(cv), size),
                warp.crop_rect_shear(frames, warp.arr_rect(rr), size))
            pr = torch.where(ok[:, None], cv, rr)
        return crop.permute(0, 3, 1, 2) / 255.0, pr.reshape(raw.shape)

    def _shear_crops(self, key: str, frames: Tensor, rects: Tensor
                     ) -> Tensor:
        """Shear crops of ``rects`` [k, 5] of NHWC frames [k, H, W, 3] (or
        of rects [S, n, 5] of frames [S, 1, H, W, 3]) in K1's output form
        for the same net: planar, scaled to [0, 1], 2x2 packed for a net
        that takes packed crops, in the compute dtype -> [k or S*n, C, s',
        s']."""
        crop = warp.crop_rect_shear(frames, warp.arr_rect(rects),
                                    self.sizes[key])
        x = crop.flatten(0, -4).permute(0, 3, 1, 2) / 255.0
        if self._packed_in.get(key):
            x = warp_kernel.pack_s2d(x)
        return x.to(self.dtype)

    def _k1_crops(self, frames_rgb: Tensor, planar_in: bool,
                  covers: dict) -> dict:
        """One K1 launch for every cover crop of every stream: {key: crops
        [S*n, C, s', s']} (pre-scaled, in the compute dtype, packed for a
        net that takes packed crops)."""
        sizes, packs, parts = [], [], []
        for key, cov in covers.items():
            n = cov.shape[1] if cov.ndim == 3 else 1
            sizes += [self.sizes[key]] * n
            packs += [2 if self._packed_in.get(key) else 1] * n
            parts.append(cov.reshape(cov.shape[0], n, 5)[..., :4])
        planar = (frames_rgb if planar_in
                  else frames_rgb.permute(0, 3, 1, 2).contiguous())
        outs = warp_kernel.multi_crop(
            planar, torch.cat(parts, 1).contiguous(), tuple(sizes),
            dtype=self.dtype, out_dtype=self.dtype, scale=1.0 / 255.0,
            pack=tuple(packs))
        crops, i = {}, 0
        for key, cov in covers.items():
            n = cov.shape[1] if cov.ndim == 3 else 1
            crops[key] = (outs[i] if cov.ndim == 2
                          else torch.stack(outs[i:i + n], 1).flatten(0, 1))
            i += n
        return crops

    def _crop_stage(self, frames_rgb: Tensor, planar_in: bool, nhwc_at,
                    raws: dict, valid: dict) -> dict:
        """Every landmark crop of the batch: {key: (crops, projection
        rects shaped as the key's raw rects, packed)}.  ``raws``: {key:
        safe tracking rects [S, 5] or [S, n, 5]}; ``valid``: {key: the
        rects that are live (a stale rect does not count toward the hybrid
        gate) or None}.  K1 crops the covers when ``use_pallas`` is on, the
        frames are uint8 and the mode is ``cover`` or ``hybrid``; every
        other case takes the per-crop path."""
        mode = self.cfg.resolved_rotation_mode()
        covers = {k: warp.rect_arr(warp.axis_aligned_cover(warp.arr_rect(r)))
                  for k, r in raws.items()}
        if not (self.cfg.use_pallas and frames_rgb.dtype == torch.uint8
                and mode in ("cover", "hybrid")):
            return {k: self._plain_crops(k, nhwc_at(None), raws[k],
                                         covers[k], mode) + (False,)
                    for k in raws}
        gated = {}
        if mode == "hybrid":
            s = frames_rgb.shape[0]
            for k, r in raws.items():
                tilt = torch.abs(warp.normalize_radians(r[..., 4]))
                if valid[k] is not None:
                    tilt = torch.where(valid[k], tilt, 0.0)
                gated[k] = (tilt, tilt > self._gate_rad)
            # host sync: sync.hybrid_gate, both kinds' counts in one read
            totals = torch.stack([g.sum() for _, g in gated.values()])
            with span("bpv.sync.hybrid_gate"):
                counts = dict(zip(gated, totals.tolist()))
            count("sync.hybrid_gate")
            k_sub = self.cfg.shear_subbatch
            caps = {k: min(k_sub, s * (raws[k].shape[1]
                                       if raws[k].ndim == 3 else 1))
                    for k in raws}
            if (any(counts.values()) if k_sub <= 0 else
                    any(counts[k] > caps[k] for k in counts)):
                # Overflow: the shear crop of every rect, both kinds.
                frames = nhwc_at(None)
                return {k: (self._shear_crops(
                    k, frames[:, None] if r.ndim == 3 else frames, r), r,
                    bool(self._packed_in.get(k))) for k, r in raws.items()}
            gated = {k: g for k, g in gated.items() if counts[k]}
        crops = self._k1_crops(frames_rgb, planar_in, covers)
        prect = dict(covers)
        for k, (tilt, gate) in gated.items():
            # The compacted sub-batch: the most tilted crops of this kind,
            # padded to a power of two; the gated ones overwrite their K1
            # crops and project with their rotated rects.
            kk = next(v for v in _pow2_ladder(caps[k]) if v >= counts[k])
            nk = raws[k].shape[1] if raws[k].ndim == 3 else 1
            order = torch.argsort(-tilt.reshape(-1), stable=True)[:kk]
            served = gate.reshape(-1)[order]
            rr = raws[k].reshape(-1, 5)[order]
            sub = self._shear_crops(k, nhwc_at(order // nk), rr)
            base = crops[k]
            base[order] = torch.where(served[:, None, None, None], sub,
                                      base[order])
            pf = prect[k].reshape(-1, 5).clone()
            pf[order] = torch.where(served[:, None], rr, pf[order])
            prect[k] = pf.reshape(raws[k].shape)
        return {k: (crops[k], prect[k], bool(self._packed_in.get(k)))
                for k in raws}

    # -- predict -------------------------------------------------------------

    def predict(self, params: dict, state: TrackState, frame_rgb: Tensor
                ) -> tuple[TrackState, ModelResults]:
        """One frame [H, W, 3] (or planar [3, H, W]) of one stream, whose
        state has no stream axis: the S=1 case of :meth:`predict_batch`."""
        new, res = self.predict_batch(
            params, map_leaves(lambda x: x[None], state), frame_rgb[None])
        return (map_leaves(lambda x: x[0], new),
                map_leaves(lambda x: x[0], res))

    def predict_batch(self, params: dict, state: TrackState,
                      frames_rgb: Tensor) -> tuple[TrackState, ModelResults]:
        """All enabled models over a stream batch: uint8/float frames
        [S, H, W, 3] or planar [S, 3, H, W]; every TrackState field carries
        a leading [S].  The landmarkers' detectors are gated at batch
        level; the standalone face detector runs on every frame."""
        planar_in = is_planar_frames(frames_rgb)

        def nhwc_at(idx):
            f = frames_rgb if idx is None else frames_rgb[idx]
            return f.permute(0, 2, 3, 1) if planar_in else f

        s = frames_rgb.shape[0]
        video = self.cfg.running_mode is RunningMode.VIDEO
        res = self.empty_results(s)

        if self.cfg.face_detector:
            # Every frame of every stream, ungated: one batched detector.
            with span("bpv.detect.face_all"):
                nms = detection.sort_by_area_desc(self._run_detector(
                    "face_det", detection.FACE_DECODE, self.face_anchors,
                    params["face_det"], nhwc_at(None), "pm1", MAX_FACE_DETS))
                res = res._replace(face_detector=Detections(
                    bbox=torch.round(nms.boxes),
                    points=_clip_floor(nms.kps, self.w, self.h),
                    count=nms.count))

        rect_a = det_ok = None
        new_face_rect, new_face_tracking = state.face_rect, state.face_tracking
        new_face_age = state.face_det_age
        if self.cfg.face_landmarker:
            def det_faces(f):
                with span("bpv.detect.face"):
                    return self._face_rects(params, f)
            if video:
                need = ~state.face_tracking
                det_rects, det_ok_d, new_face_age = self._detect_gated(
                    "face", nhwc_at, need, state.face_det_age,
                    state.face_rect, torch.ones_like(need), det_faces)
                rect_a = torch.where(state.face_tracking[:, None],
                                     state.face_rect, det_rects)
                det_ok = state.face_tracking | det_ok_d
            else:
                rect_a, det_ok = det_faces(nhwc_at(None))

        rects_a = slot_ok = None
        new_hand_rects, new_hand_tracking = (state.hand_rects,
                                             state.hand_tracking)
        new_hand_age = state.hand_det_age
        if self.cfg.hand_landmarker:
            def det_palms(f):
                with span("bpv.detect.palm"):
                    return self._palm_rects(params, f)
            if video:
                # A stream re-detects when ANY of its hand slots lost
                # tracking.
                need = ~state.hand_tracking.all(-1)
                det_rects, det_valid, new_hand_age = self._detect_gated(
                    "hand", nhwc_at, need, state.hand_det_age,
                    state.hand_rects, state.hand_tracking, det_palms)
                rects_a, slot_ok = _associate_hand_dets(
                    state.hand_tracking, state.hand_rects, det_rects,
                    det_valid)
            else:
                rects_a, slot_ok = det_palms(nhwc_at(None))

        # --- crop stage: K1 (one launch for every landmark crop) or the
        # per-crop path, per rotation mode ----------------------------------
        raws, valid = {}, {}
        if self.cfg.face_landmarker:
            raws["flm_lm"], valid["flm_lm"] = self._safe_rect(rect_a), det_ok
        if self.cfg.hand_landmarker:
            raws["hand_lm"], valid["hand_lm"] = (self._safe_rect(rects_a),
                                                 slot_ok)
        with span("bpv.crop"):
            crops = self._crop_stage(frames_rgb, planar_in, nhwc_at, raws,
                                     valid)

        if self.cfg.face_landmarker:
            face_crops, face_prect, packed = crops["flm_lm"]
            lm, presences = self._landmarks("flm_lm", params["flm_lm"],
                                            face_crops, packed)
            with span("bpv.track.face"):
                pts = self._project_lm("flm_lm", lm, face_prect)  # [S, L, 2]
                next_rects = warp.rect_arr(warp.rect_transform(
                    warp.landmarks_to_rect(pts, *FACE_ROT_LANDMARKS, 0.0),
                    scale=1.5))
                present = det_ok & (presences > PRESENCE_THRESHOLD)
                new_face_rect = torch.where(present[:, None], next_rects,
                                            state.face_rect)
                new_face_tracking = present
                pts_i = _clip_floor(pts, self.w, self.h)
                bbox = torch.cat([pts_i.amin(1), pts_i.amax(1)], -1)
                res = res._replace(face_landmarker=Detections(
                    bbox=torch.where(present[:, None], bbox,
                                     float("nan"))[:, None],
                    points=torch.where(present[:, None, None], pts_i,
                                       float("nan"))[:, None],
                    count=present.to(torch.int32)))

        if self.cfg.hand_landmarker:
            nh = self.cfg.max_hands
            hand_crops, hand_prect, packed = crops["hand_lm"]
            lm, presences = self._landmarks("hand_lm", params["hand_lm"],
                                            hand_crops, packed)
            with span("bpv.track.hand"):
                lm = lm.reshape(s, nh, -1)
                presences = presences.reshape(s, nh)
                pts = self._project_lm("hand_lm", lm, hand_prect)  # [S,nh,L,2]
                next_rects = warp.rect_arr(warp.rect_transform(
                    warp.landmarks_to_rect(pts, *HAND_ROT_LANDMARKS,
                                           math.pi / 2),
                    scale=2.0, shift_y=-0.1))
                present = slot_ok & (presences > PRESENCE_THRESHOLD)
                new_hand_rects = torch.where(present[..., None], next_rects,
                                             state.hand_rects)
                new_hand_tracking = present
                pts_i = _clip_floor(pts, self.w, self.h)
                bbox = torch.cat([pts_i.amin(2), pts_i.amax(2)],
                                 -1)                              # [S,nh,4]
                area = ((bbox[..., 2] - bbox[..., 0])
                        * (bbox[..., 3] - bbox[..., 1]))
                order = torch.argsort(
                    torch.where(present, -area, float("inf")), dim=-1,
                    stable=True)
                pres_s = torch.gather(present, 1, order)
                bbox_s = torch.gather(bbox, 1,
                                      order[..., None].expand_as(bbox))
                pts_s = torch.gather(pts_i, 1,
                                     order[..., None, None].expand_as(pts_i))
                res = res._replace(hand_landmarker=Detections(
                    bbox=torch.where(pres_s[..., None], bbox_s,
                                     float("nan")),
                    points=torch.where(pres_s[..., None, None], pts_s,
                                       float("nan")),
                    count=present.sum(-1).to(torch.int32)))

        if self.cfg.person_segmenter:
            planar = frames_rgb if planar_in else frames_rgb.permute(0, 3, 1,
                                                                     2)
            with span("bpv.segment"):
                seg_class, seg_conf = self._segment(params["seg"], planar)
            res = res._replace(seg_class=seg_class, seg_conf=seg_conf,
                               seg_valid=torch.ones_like(res.seg_valid))

        new_state = TrackState(new_face_rect, new_face_tracking,
                               new_hand_rects, new_hand_tracking,
                               new_face_age, new_hand_age)
        return new_state, res
