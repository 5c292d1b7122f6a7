"""The batched inference runner — the counterpart of
``bp_from_video_tpu/models/runner.py``: face landmarker (face detector +
landmark net) and hand landmarker (palm detector + per-hand landmark net)
in VIDEO detect-then-track mode (or IMAGE mode: detect every frame) over a
stream batch, with the tracking state carried explicitly.

Main path (``use_pallas``, ``fused_stem``, ``fused_trunk``, uint8 frames,
cover rotation): one K1 launch crops every landmark crop of every stream
2x2-packed and pre-scaled, one K3 launch per net runs its 3x3/2 stem, four
K3 launches per net run its trunk, then the dense heads.  Without
``use_pallas`` the crops are plain separable resamples and the nets run as
plain convolutions.  The detectors sit behind one batch-level host branch
(a device-to-host sync per step while any stream needs detection is
checked).

Not ported yet (they raise ``NotImplementedError``): real TFLite weights
(ROADMAP Queue 1 item 8), the standalone face detector, the segmenter and
the rotated crop modes (item 10), the fused stem without the fused trunk
(kernel K2) and packed crops without the fused stem.
"""

from __future__ import annotations

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
from bp_from_video_tpu_torch.kernels import warp as warp_kernel
from bp_from_video_tpu_torch.models import anchors as anchors_lib
from bp_from_video_tpu_torch.models import blaze, detection, warp
from bp_from_video_tpu_torch.ops.roi import Detections, is_planar_frames

Tensor = torch.Tensor

logger = logging.getLogger(__name__)

NUM_FACE_LANDMARKS = 478
NUM_HAND_LANDMARKS = 21
NUM_FACE_DET_KPS = 6
NUM_PALM_KPS = 7
MAX_FACE_DETS = 4
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
    """Apply ``fn`` to every tensor of a (nested) NamedTuple state or
    result; ``map_leaves(lambda x: x[i], state)`` is stream ``i``'s own
    state, ``map_leaves(lambda x: x[None], one)`` a batch of one."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, t) for t in tree))
    return fn(tree)


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
    """Builds the model set (stand-in weights, packed kernel weights) once
    and exposes ``predict_batch`` / ``predict``.  ``device=None`` means
    ``"cuda"`` (raises without CUDA); pass ``device="cpu"`` for the plain
    versions of the kernels."""

    def __init__(self, cfg: InferenceConfig, frame_height: int,
                 frame_width: int, asset_dir: str | None = None,
                 dtype=torch.float32, device=None) -> None:
        self.cfg = cfg
        self.h, self.w = frame_height, frame_width
        self.dtype = dtype
        self.device = resolve_device(device)
        if cfg.face_detector or cfg.person_segmenter:
            raise NotImplementedError(
                "face detector / person segmenter: not ported yet (ROADMAP "
                "Queue 1 item 10)")
        if cfg.resolved_rotation_mode() != "cover":
            raise NotImplementedError(
                f"rotation_mode {cfg.resolved_rotation_mode()!r}: not ported "
                "yet (ROADMAP Queue 1 item 10)")
        self._fused = cfg.use_pallas and cfg.fused_stem and cfg.fused_trunk
        if cfg.use_pallas and not self._fused and (cfg.fused_stem
                                                   or cfg.pack_s2d):
            raise NotImplementedError(
                "packed crops without the fused stem+trunk (kernel K2, the "
                "packed stem twin): not ported yet (ROADMAP Queue 2)")
        if cfg.fuse_dw_pw:
            raise NotImplementedError(
                "fuse_dw_pw applies to compiled TFLite graphs: not ported "
                "yet (ROADMAP Queue 1 item 8)")
        self.params: dict[str, Any] = {}
        self.sizes: dict[str, int] = {}
        self._trunk_specs: dict[str, tuple] = {}
        self._stem_wspec: dict[str, str] = {}
        self.real_weights: dict[str, bool] = {}
        self.trained_standin: dict[str, bool] = {}
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

        for flag, path in ((cfg.face_landmarker, cfg.face_landmarker_path),
                           (cfg.hand_landmarker, cfg.hand_landmarker_path)):
            if flag and resolve(path):
                raise NotImplementedError(
                    f"{resolve(path)!r}: real TFLite weights need the TFLite "
                    "compiler, not ported yet (ROADMAP Queue 1 item 8)")

        # Built once: a tensor made from host values per step would be a
        # host-to-device copy, which synchronizes the stream.
        self._default_rect = torch.tensor(
            [self.w / 2, self.h / 2, self.w, self.h, 0.0],
            dtype=torch.float32, device=self.device)
        self.face_anchors = torch.from_numpy(anchors_lib.generate_anchors(
            anchors_lib.FACE_SHORT_RANGE)).to(self.device)
        self.palm_anchors = torch.from_numpy(anchors_lib.generate_anchors(
            anchors_lib.PALM)).to(self.device)
        if cfg.face_landmarker:
            self._load_detector("flm_det", 128, 896, NUM_FACE_DET_KPS)
            self._load_landmark("flm_lm", 256, NUM_FACE_LANDMARKS)
        if cfg.hand_landmarker:
            self._load_detector("palm_det", 192, 2016, NUM_PALM_KPS,
                                resolve(cfg.palm_det_standin_path))
            self._load_landmark("hand_lm", 224, NUM_HAND_LANDMARKS,
                                resolve(cfg.hand_lm_standin_path))

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
        cand.pop("stem_p", None)
        return cand

    def _load_detector(self, key, size, num_anchors, num_kps,
                       standin_path=None):
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

    def _load_landmark(self, key, size, num_landmarks, standin_path=None):
        g = size // 32
        params = self._load_trained_standin(
            key, standin_path,
            {("head_lm", "w"): (192 * g * g, 3 * num_landmarks)},
            {"input_size": size, "num_landmarks": num_landmarks})
        if params is None:
            logger.warning("model %r: using a RANDOM-INIT stand-in", key)
            params = blaze.init_blaze_landmark(_seed(key), size,
                                               num_landmarks)
        p = _to_torch(params, self.device, self.dtype)
        self.sizes[key] = size
        if self._fused:
            # Each dw+pw block composes into its dense twin; the stem and
            # trunk window-matrix weights are packed host-side from the raw
            # f32 params (bf16 matrices, f32 block biases).
            arrays, specs = block_kernel.prepare_trunk(params)
            p["trunk"] = [{"wmat": _to_torch(a["wmat"], self.device,
                                             torch.bfloat16),
                           "b": _to_torch(a["b"], self.device)}
                          for a in arrays]
            self._trunk_specs[key] = specs
            wmat, wspec = block_kernel.pack_block_weights(
                params["stem"]["w"], cin=3)
            p["stem_wmat"] = _to_torch(wmat, self.device, torch.bfloat16)
            self._stem_wspec[key] = wspec
        self.params[key] = p

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
        reg, log = blaze.blaze_detector_apply(params, x,
                                              decode_cfg.num_keypoints)
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

    def _subbatch_detect(self, nhwc_at, need: Tensor, age: Tensor,
                         cur_rects: Tensor, det_batch, k_max: int):
        """Run ``det_batch`` on (up to) ``k_max`` streams — the most-starved
        ones needing detection — instead of all S.  Returns the merged
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
        if bool(need.any()):                    # host sync: batch-level gate
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

    def _detect_gated(self, nhwc_at, tracking_all: Tensor, need: Tensor,
                      age: Tensor, cur: Tensor, cur_ok: Tensor, det_batch):
        """VIDEO-mode detection for one model kind: the bounded sub-batch
        when it is smaller than the batch, else every stream whenever any
        needs it.  Returns (det_rects, det_valid, new_age)."""
        s = need.shape[0]
        k_max = self._det_subbatch(s)
        if k_max < s:
            rects, valid, served = self._subbatch_detect(
                nhwc_at, need, age, cur, det_batch, k_max)
            return rects, valid, torch.where(need & ~served, age + 1, 0
                                             ).to(torch.int32)
        if bool(tracking_all):                  # host sync: batch-level gate
            rects, valid = cur, cur_ok
        else:
            rects, valid = det_batch(nhwc_at(None))
        return rects, valid, torch.zeros_like(age)

    def _fused_stem_batch(self, key: str, params, crops_packed: Tensor
                          ) -> Tensor:
        """Stem activations of packed crops [B, 12, S/2, S/2] ->
        [B, 24, S/2, S/2]: one K3 launch in its stem flavor."""
        return block_kernel.dense_s2_block(
            crops_packed, params["stem_wmat"], self._stem_wspec[key],
            params["stem"]["b"], None, cin=3, resid=False)

    def _fused_trunk_batch(self, key: str, params, stems: Tensor
                           ) -> tuple[Tensor, Tensor]:
        """Trunk (four K3 launches) + heads over a batch of stem
        activations -> (landmarks [B, 3L], presence f32 [B])."""
        feats = block_kernel.trunk_apply(params["trunk"],
                                         self._trunk_specs[key], stems)
        lm, presence, _aux = blaze.landmark_heads(params, feats,
                                                  self.sizes[key])
        return lm, presence[:, 0].to(torch.float32)

    def _project_lm(self, key: str, lm: Tensor, rect: Tensor) -> Tensor:
        """Raw landmark vectors [..., 3L] -> frame pixels [..., L, 2]."""
        size = self.sizes[key]
        pts = lm.to(torch.float32).reshape(lm.shape[:-1] + (-1, 3)
                                           )[..., :2] / size
        return warp.project_landmarks(pts, warp.arr_rect(rect))

    def _landmarks(self, key: str, params, crops: Tensor | None,
                   nhwc_at, rects_cover: Tensor) -> tuple[Tensor, Tensor]:
        """Landmark net over a batch of crops -> (raw landmarks [B, 3L],
        presence f32 [B]).  ``crops``: K1's packed, pre-scaled crops
        [B, 12, S/2, S/2] (fused path), K1's plain pre-scaled crops
        [B, 3, S, S], or None: crop the cover rects [B, 5] of the frames
        ``nhwc_at(None)`` here."""
        if crops is not None and self._fused:
            stems = self._fused_stem_batch(key, params, crops)
            return self._fused_trunk_batch(key, params, stems)
        if crops is None:
            frames = nhwc_at(None)
            n = rects_cover.shape[0] // frames.shape[0]
            if n > 1:
                frames = frames.repeat_interleave(n, 0)
            crop = warp.crop_rect(frames, warp.arr_rect(rects_cover),
                                  self.sizes[key])
            crops = crop.permute(0, 3, 1, 2) / 255.0
        lm, presence, _aux = blaze.blaze_landmark_apply(
            params, crops.to(self.dtype), self.sizes[key])
        return lm, presence[:, 0].to(torch.float32)

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
        a leading [S].  Detectors are gated at batch level."""
        planar_in = is_planar_frames(frames_rgb)

        def nhwc_at(idx):
            f = frames_rgb if idx is None else frames_rgb[idx]
            return f.permute(0, 2, 3, 1) if planar_in else f

        s = frames_rgb.shape[0]
        video = self.cfg.running_mode is RunningMode.VIDEO
        res = self.empty_results(s)

        rect_a = det_ok = None
        new_face_rect, new_face_tracking = state.face_rect, state.face_tracking
        new_face_age = state.face_det_age
        if self.cfg.face_landmarker:
            def det_faces(f):
                return self._face_rects(params, f)
            if video:
                need = ~state.face_tracking
                det_rects, det_ok_d, new_face_age = self._detect_gated(
                    nhwc_at, state.face_tracking.all(), need,
                    state.face_det_age, state.face_rect,
                    torch.ones_like(need), det_faces)
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
                return self._palm_rects(params, f)
            if video:
                # A stream re-detects when ANY of its hand slots lost
                # tracking.
                need = ~state.hand_tracking.all(-1)
                det_rects, det_valid, new_hand_age = self._detect_gated(
                    nhwc_at, state.hand_tracking.all(), need,
                    state.hand_det_age, state.hand_rects,
                    state.hand_tracking, det_palms)
                rects_a, slot_ok = _associate_hand_dets(
                    state.hand_tracking, state.hand_rects, det_rects,
                    det_valid)
            else:
                rects_a, slot_ok = det_palms(nhwc_at(None))

        # --- crop stage: ONE K1 launch for every landmark crop -------------
        face_raw = face_cover = hand_raw = hand_cover = None
        if self.cfg.face_landmarker:
            face_raw = self._safe_rect(rect_a)                       # [S, 5]
            face_cover = warp.rect_arr(warp.axis_aligned_cover(
                warp.arr_rect(face_raw)))
        if self.cfg.hand_landmarker:
            hand_raw = self._safe_rect(rects_a)                  # [S, nh, 5]
            hand_cover = warp.rect_arr(warp.axis_aligned_cover(
                warp.arr_rect(hand_raw)))
        face_crops = hand_crops = None
        if (self.cfg.use_pallas and frames_rgb.dtype == torch.uint8
                and (face_cover is not None or hand_cover is not None)):
            pack = 2 if self._fused else 1
            sizes, parts = [], []
            if face_cover is not None:
                sizes.append(self.sizes["flm_lm"])
                parts.append(face_cover[:, None, :4])
            if hand_cover is not None:
                sizes += [self.sizes["hand_lm"]] * hand_cover.shape[1]
                parts.append(hand_cover[..., :4])
            planar = (frames_rgb if planar_in
                      else frames_rgb.permute(0, 3, 1, 2).contiguous())
            outs = warp_kernel.multi_crop(
                planar, torch.cat(parts, 1).contiguous(), tuple(sizes),
                dtype=self.dtype, out_dtype=self.dtype, scale=1.0 / 255.0,
                pack=pack)
            i = 0
            if face_cover is not None:
                face_crops = outs[0]
                i = 1
            if hand_cover is not None:
                hand_crops = torch.stack(outs[i:], 1).flatten(0, 1)
        elif self.cfg.use_pallas and self._fused:
            raise NotImplementedError(
                "fused landmark path on non-uint8 frames needs the packed "
                "stem twin: not ported yet (ROADMAP Queue 2, K2)")

        if self.cfg.face_landmarker:
            lm, presences = self._landmarks("flm_lm", params["flm_lm"],
                                            face_crops, nhwc_at, face_cover)
            pts = self._project_lm("flm_lm", lm, face_cover)     # [S, L, 2]
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

        if self.cfg.hand_landmarker:
            nh = self.cfg.max_hands
            lm, presences = self._landmarks(
                "hand_lm", params["hand_lm"], hand_crops, nhwc_at,
                hand_cover.flatten(0, 1))
            lm = lm.reshape(s, nh, -1)
            presences = presences.reshape(s, nh)
            pts = self._project_lm("hand_lm", lm, hand_cover)  # [S,nh,L,2]
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
