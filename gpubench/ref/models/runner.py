"""The reference's landmark runner — the plain path of the port's
``models/runner.py`` (a frozen copy, trimmed to what the benchmark's
configurations run): the face landmarker (a compiled TFLite graph, run op
by op) and the hand landmarker (the blaze stand-in, as plain
convolutions) in VIDEO detect-then-track mode, over a stream batch whose
every stream and hand slot is tracked, with the tracking state carried
explicitly.

Crops are the axis-aligned covers of the tracking rects, cut by plain
separable resamples (``warp.crop_rect``), scaled to [0, 1], planar.  With
every slot tracked the port's detectors are gated off and its hand
association keeps every slot, so the landmark nets alone set the next
track.  A batch with a stream or slot that needs detection raises: the
benchmark's traffic holds every track by construction (presence logits
pinned), and the detectors are not part of this reference.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from gpubench.ref import resolve_device
from gpubench.ref.config import InferenceConfig, RunningMode
from gpubench.ref.models import blaze, warp
from gpubench.ref.models import tflite_compiler as tc
from gpubench.ref.ops.roi import Detections, is_planar_frames

Tensor = torch.Tensor

NUM_FACE_LANDMARKS = 478
NUM_HAND_LANDMARKS = 21
NUM_FACE_DET_KPS = 6
MAX_FACE_DETS = 4
PRESENCE_THRESHOLD = 0.5
# Tracking-rect anchor landmarks: face = outer eye corners, hand = wrist ->
# middle-finger MCP.
FACE_ROT_LANDMARKS = (33, 263)
HAND_ROT_LANDMARKS = (0, 9)


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
    """Builds the two landmark nets once and exposes ``predict_batch``.
    ``graphs``: {"flm_lm": parsed ``Graph``}, the face landmark net; the
    hand net is the stand-in at ``hand_lm_standin_path``."""

    def __init__(self, cfg: InferenceConfig, frame_height: int,
                 frame_width: int, dtype=torch.float32, device=None,
                 graphs: dict | None = None) -> None:
        if (cfg.use_pallas or cfg.fused_stem or cfg.fused_trunk
                or cfg.fuse_dw_pw or cfg.pack_s2d):
            raise ValueError("the reference runs the plain path only")
        if cfg.face_detector or cfg.person_segmenter:
            raise ValueError("the reference runs the landmarkers only")
        if cfg.running_mode is not RunningMode.VIDEO:
            raise ValueError("the reference runs VIDEO mode only")
        if cfg.resolved_rotation_mode() != "cover":
            raise ValueError("the reference crops the covers only")
        if not (cfg.face_landmarker and cfg.hand_landmarker):
            raise ValueError("the reference runs both landmarkers")
        self.cfg = cfg
        self.h, self.w = frame_height, frame_width
        self.dtype = dtype
        self.device = resolve_device(device)
        self.params: dict[str, Any] = {}
        self.sizes: dict[str, int] = {}
        self._graph_fns: dict[str, Any] = {}    # compiled nets, batched
        graphs = dict(graphs or {})
        # Built once: a tensor made from host values per step would be a
        # host-to-device copy, which synchronizes the stream.
        self._default_rect = torch.tensor(
            [self.w / 2, self.h / 2, self.w, self.h, 0.0],
            dtype=torch.float32, device=self.device)
        self._load_compiled_landmark("flm_lm", graphs.pop("flm_lm"),
                                     NUM_FACE_LANDMARKS)
        self._load_standin_landmark("hand_lm", 224, NUM_HAND_LANDMARKS,
                                    cfg.hand_lm_standin_path)
        if graphs:
            raise ValueError(f"graphs for models not run: {sorted(graphs)}")

    # -- model loading ---------------------------------------------------

    def _load_standin_landmark(self, key, size, num_landmarks, path):
        """The blaze stand-in from its npz (leaf shapes and ``__meta__``
        geometry checked)."""
        params, meta = blaze.load_standin_npz(path, return_meta=True)
        g = size // 32
        want = (192 * g * g, 3 * num_landmarks)
        if (tuple(params["head_lm"]["w"].shape) != want
                or meta.get("input_size") != size
                or meta.get("num_landmarks") != num_landmarks):
            raise ValueError(f"stand-in {path!r} is not a {size} net of "
                             f"{num_landmarks} landmarks")
        self.params[key] = _to_torch(params, self.device, self.dtype)
        self.sizes[key] = size

    def _load_compiled_landmark(self, key, graph, num_landmarks):
        """Compile a landmark graph (planar inputs, no graph pass).  The
        landmarks are the one output of at least 3 L values; presence is
        the first single-value output."""
        fn, params = tc.compile_graph(graph, self.dtype, device=self.device)
        sizes = [int(np.prod(s)) for s in fn.output_shapes]
        cands = [i for i, n in enumerate(sizes) if n >= 3 * num_landmarks]
        scalar_idx = [i for i, n in enumerate(sizes) if n == 1]
        if len(cands) != 1 or not scalar_idx:
            raise ValueError(f"model {key!r}: output sizes {sizes}")

        def apply_batch(p, x, nl=num_landmarks, li=cands[0],
                        si=scalar_idx[0]):
            outs = fn(p, x)
            b = x.shape[0]
            return (outs[li].reshape(b, -1)[:, : 3 * nl],
                    outs[si].reshape(b, -1)[:, 0])
        self.params[key] = params
        self.sizes[key] = fn.input_shapes[0][1]
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

    def _safe_rect(self, a: Tensor) -> Tensor:
        """Non-finite rect entries -> a frame-centered default (the result
        is masked out downstream)."""
        return torch.where(torch.isfinite(a), a, self._default_rect)

    def _project_lm(self, key: str, lm: Tensor, rect: Tensor) -> Tensor:
        """Raw landmark vectors [..., 3L] -> frame pixels [..., L, 2]."""
        # A tensor divisor (IEEE f32 on the card as on the CPU).
        size = torch.full((), float(self.sizes[key]), dtype=torch.float32,
                          device=lm.device)
        pts = lm.to(torch.float32).reshape(lm.shape[:-1] + (-1, 3)
                                           )[..., :2] / size
        return warp.project_landmarks(pts, warp.arr_rect(rect))

    def _landmarks(self, key: str, params, crops: Tensor
                   ) -> tuple[Tensor, Tensor]:
        """Landmark net over planar crops [B, 3, S, S] -> (raw landmarks
        [B, 3L], presence f32 [B])."""
        crops = crops.to(self.dtype)
        if key in self._graph_fns:
            lm, presence = self._graph_fns[key](params, crops)
            return lm, presence.to(torch.float32)
        lm, presence, _aux = blaze.blaze_landmark_apply(params, crops,
                                                        self.sizes[key])
        return lm, presence[:, 0].to(torch.float32)

    def _crops(self, key: str, frames: Tensor, raw: Tensor
               ) -> tuple[Tensor, Tensor]:
        """Crops of the covers of the rects ``raw`` [S, 5] or [S, n, 5] of
        NHWC frames [S, H, W, 3] -> (f32 planar crops scaled to [0, 1]
        [S*n, 3, s, s], the covers they project with, shaped as ``raw``)."""
        size = self.sizes[key]
        n = raw.numel() // 5 // frames.shape[0]
        if n > 1:
            frames = frames.repeat_interleave(n, 0)
        cv = warp.rect_arr(warp.axis_aligned_cover(warp.arr_rect(
            raw.reshape(-1, 5))))
        crop = warp.crop_rect(frames, warp.arr_rect(cv), size)
        return crop.permute(0, 3, 1, 2) / 255.0, cv.reshape(raw.shape)

    # -- predict -------------------------------------------------------------

    def predict_batch(self, params: dict, state: TrackState,
                      frames_rgb: Tensor) -> tuple[TrackState, ModelResults]:
        """Both landmarkers over a stream batch whose every stream and hand
        slot is tracked: uint8/float frames [S, H, W, 3] or planar [S, 3,
        H, W]; every TrackState field carries a leading [S]."""
        if not (bool(state.face_tracking.all())
                and bool(state.hand_tracking.all())):
            raise RuntimeError("a stream lost its track: the reference "
                               "follows tracked streams only")
        nhwc = (frames_rgb.permute(0, 2, 3, 1) if is_planar_frames(frames_rgb)
                else frames_rgb)
        s = frames_rgb.shape[0]
        res = self.empty_results(s)
        det_ok, slot_ok = state.face_tracking, state.hand_tracking
        new_face_age = torch.zeros_like(state.face_det_age)
        new_hand_age = torch.zeros_like(state.hand_det_age)
        crops = {"flm_lm": self._crops("flm_lm", nhwc,
                                       self._safe_rect(state.face_rect)),
                 "hand_lm": self._crops("hand_lm", nhwc,
                                        self._safe_rect(state.hand_rects))}

        face_crops, face_prect = crops["flm_lm"]
        lm, presences = self._landmarks("flm_lm", params["flm_lm"],
                                        face_crops)
        pts = self._project_lm("flm_lm", lm, face_prect)     # [S, L, 2]
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
            bbox=torch.where(present[:, None], bbox, float("nan"))[:, None],
            points=torch.where(present[:, None, None], pts_i,
                               float("nan"))[:, None],
            count=present.to(torch.int32)))

        nh = self.cfg.max_hands
        hand_crops, hand_prect = crops["hand_lm"]
        lm, presences = self._landmarks("hand_lm", params["hand_lm"],
                                        hand_crops)
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
        bbox = torch.cat([pts_i.amin(2), pts_i.amax(2)], -1)  # [S,nh,4]
        area = (bbox[..., 2] - bbox[..., 0]) * (bbox[..., 3] - bbox[..., 1])
        order = torch.argsort(torch.where(present, -area, float("inf")),
                              dim=-1, stable=True)
        pres_s = torch.gather(present, 1, order)
        bbox_s = torch.gather(bbox, 1, order[..., None].expand_as(bbox))
        pts_s = torch.gather(pts_i, 1, order[..., None, None].expand_as(
            pts_i))
        res = res._replace(hand_landmarker=Detections(
            bbox=torch.where(pres_s[..., None], bbox_s, float("nan")),
            points=torch.where(pres_s[..., None, None], pts_s,
                               float("nan")),
            count=present.sum(-1).to(torch.int32)))

        new_state = TrackState(new_face_rect, new_face_tracking,
                               new_hand_rects, new_hand_tracking,
                               new_face_age, new_hand_age)
        return new_state, res
