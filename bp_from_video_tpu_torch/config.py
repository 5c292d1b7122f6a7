"""Configuration dataclasses and enums — field-for-field the JAX package's
``bp_from_video_tpu/config.py``, so one ``EngineConfig`` names the same path
in both packages.  In this package ``use_pallas`` / ``fused_stem`` /
``fused_trunk`` select the hand-written CUDA kernels; ``pallas_interpret``
is kept for field parity and ignored (a CPU tensor always takes a kernel's
plain PyTorch version).

The reference exposes its configuration as module-level UPPER_CASE constants
shadowed by constructor kwargs (reference signal_processor.py:45-72,
inference_runner.py:46-53, roi.py:16-30, video_reader.py:19-29,
drawer.py:34-52).  Here every knob lives in explicit dataclasses so configs
are hashable/static for jit, serializable, and CLI-exposable.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import ClassVar


class ModelType(enum.Enum):
    """Vision model families (reference model.py:4-8)."""

    FACE_DETECTOR = "face_detector"
    FACE_LANDMARKER = "face_landmarker"
    HAND_LANDMARKER = "hand_landmarker"
    PERSON_SEGMENTER = "person_segmenter"


class SignalColorChannel(enum.Enum):
    """Pixel statistic sampled inside each ROI (reference signal_processor.py:23-25)."""

    GREEN = "green"
    CHROM_GREEN = "chrom_green"  # G/2 - B/4 - R/4 + 0.5


class SignalProcessingMethod(enum.Enum):
    """DSP chain elements (reference signal_processor.py:28-36)."""

    DIFF_1 = "diff_1"
    DIFF_2 = "diff_2"
    INTERP_LINEAR = "interp_linear"
    INTERP_CUBIC = "interp_cubic"
    DETREND_CONST = "detrend_const"
    DETREND_LINEAR = "detrend_linear"
    FILTER_BUTTER = "filter_butter"
    FILTER_FIR = "filter_fir"


class SignalSpectrumTransform(enum.Enum):
    """Spectral estimators (reference signal_processor.py:39-42)."""

    DFT_RFFT = "dft_rfft"
    PGRAM_WELCH = "pgram_welch"
    PGRAM_LS = "pgram_ls"


# --- ROI configuration (reference roi.py) ----------------------------------

# Landmark index constants (reference roi.py:16-22).
FACE_DETECTION_NOSE_INDEX = 2
FACE_LANDMARKS_NOSE_INDEX = 4
FACE_LANDMARKS_FOREHEAD_INDEX = 151
FACE_LANDMARKS_CHEEK_INDEX = 330
FACE_LANDMARKS_EYEBROW_INDEX = 337
HAND_LANDMARKS_WRIST_INDEX = 0
HAND_LANDMARKS_MIDDLE_INDEX = 9


@dataclasses.dataclass(frozen=True)
class ROIConfig:
    """Declarative ROI spec: anchor landmarks + margins relative to the
    detection bbox size (reference roi.py:8-13)."""

    model_type: ModelType
    landmark_indices: tuple[int, ...]
    # (left, top, right, bottom) margins as fractions of detection bbox w/h.
    relative_bbox: tuple[float, float, float, float]

    def __post_init__(self):
        object.__setattr__(self, "landmark_indices", tuple(self.landmark_indices))
        object.__setattr__(self, "relative_bbox", tuple(self.relative_bbox))


# Shipped ROI presets (reference roi.py:24-28).
FACE_CHEEK_CONFIG = ROIConfig(
    ModelType.FACE_LANDMARKER, (FACE_LANDMARKS_CHEEK_INDEX,), (-0.05, -0.05, 0.15, 0.05))
FACE_EYEBROW_CONFIG = ROIConfig(
    ModelType.FACE_LANDMARKER, (FACE_LANDMARKS_EYEBROW_INDEX,), (-0.10, -0.15, 0.25, 0.00))
FACE_FOREHEAD_CONFIG = ROIConfig(
    ModelType.FACE_LANDMARKER, (FACE_LANDMARKS_FOREHEAD_INDEX,), (-0.00, -0.10, 0.20, 0.05))
HAND_WRIST_CONFIG = ROIConfig(
    ModelType.HAND_LANDMARKER, (HAND_LANDMARKS_WRIST_INDEX,), (-0.10, -0.10, 0.10, 0.10))
HAND_PALM_CONFIG = ROIConfig(
    ModelType.HAND_LANDMARKER,
    (HAND_LANDMARKS_WRIST_INDEX, HAND_LANDMARKS_MIDDLE_INDEX),
    (-0.10, -0.10, 0.10, 0.10))

# Default ROI selection (reference roi.py:30).
SELECTED_ROI_CONFIGS: tuple[ROIConfig, ...] = (FACE_FOREHEAD_CONFIG, HAND_PALM_CONFIG)


# --- Signal-processing configuration ----------------------------------------


@dataclasses.dataclass(frozen=True)
class SignalConfig:
    """All DSP knobs (defaults mirror reference signal_processor.py:45-72)."""

    roi_configs: tuple[ROIConfig, ...] = SELECTED_ROI_CONFIGS
    roi_max_samples: int = 1          # temporal bbox filter depth (:47)
    signal_max_samples: int = 250     # raw/processed ring depth (:48)
    peak_max_samples: int = 50        # BPM/PTT smoothing ring depth (:49)

    color_channel: SignalColorChannel = SignalColorChannel.GREEN  # (:45)
    processing_methods: tuple[SignalProcessingMethod, ...] = (
        SignalProcessingMethod.FILTER_BUTTER,)                    # (:51-55)
    spectrum_transform: SignalSpectrumTransform = SignalSpectrumTransform.PGRAM_LS  # (:62)

    butter_order: int = 16            # (:57)
    butter_min_bw: float = 0.1        # (:58)
    fir_taps: int = 127               # (:59)
    fir_df: float = 0.3               # (:60)

    min_freq: float = 0.8             # HR band (:64)
    max_freq: float = 4.0             # (:65)
    min_mag: float = 0.0              # spectrum plot range (:66-67)
    max_mag: float = 1.0
    min_lag: float = -0.5             # correlation peak window, seconds (:69-70)
    max_lag: float = 0.5
    min_corr: float = -1.0            # (:71-72)
    max_corr: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "roi_configs", tuple(self.roi_configs))
        object.__setattr__(self, "processing_methods", tuple(self.processing_methods))

    @property
    def num_signals(self) -> int:
        return len(self.roi_configs)

    @property
    def num_pairs(self) -> int:
        return math.comb(self.num_signals, 2)


# --- rPPG net configuration ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhysFormerConfig:
    """PhysFormer (Yu et al., CVPR 2022, arXiv:2111.12082) as rPPG-Toolbox
    (arXiv:2210.00716) runs it under ``PHYSFORMER``:
    ``ViT_ST_ST_Compact3_TDC_gra_sharp`` over ``clip_frames``-frame chunks
    of ``crop``-square face crops (``models/physformer.py``).

    The engine keeps the last ``clip_frames`` crops a stream in a ring
    (``runtime/engine.ClipState``) and runs the net on a stream once the
    ring is full and ``hop`` crops have come in since it last ran
    (``hop == clip_frames``: non-overlapping chunks)."""

    module: ClassVar[str] = "physformer"   # models/<module>.py builds it
    dim: int = 96
    ff_dim: int = 144
    num_heads: int = 4
    num_layers: int = 12
    patch: int = 4            # temporal and spatial patch of the embedding
    theta: float = 0.7        # CDC_T's temporal centre difference
    gra_sharp: float = 2.0    # attention's temperature: softmax(QK^T / it)
    clip_frames: int = 160
    crop: int = 128
    hop: int = 160

    def __post_init__(self):
        # The stem halves the crop three times; the head's two x2
        # upsamples give back ``clip_frames`` samples only at patch 4.
        if self.patch != 4:
            raise ValueError(f"patch={self.patch}: the head restores "
                             "clip_frames samples only at patch 4")
        if self.clip_frames % self.patch or self.crop % (8 * self.patch):
            raise ValueError(
                f"clip_frames={self.clip_frames}, crop={self.crop}: need "
                f"multiples of {self.patch} and {8 * self.patch}")
        if self.dim % self.num_heads or self.dim % 4:
            raise ValueError(f"dim={self.dim}: must divide by num_heads "
                             f"({self.num_heads}) and 4")
        if not 0 < self.hop <= self.clip_frames:
            raise ValueError(f"hop={self.hop}: expected 1..clip_frames")

    @property
    def grid(self) -> int:
        """Tokens along each spatial side: the crop after the stem's three
        halvings and the patch embedding."""
        return self.crop // (8 * self.patch)


@dataclasses.dataclass(frozen=True)
class PhysMambaConfig:
    """PhysMamba (Luo et al., arXiv:2409.12031) as rPPG-Toolbox
    (arXiv:2210.00716) runs it: a 3-D conv stem, a slow pathway at T/4 and
    a fast one at T/2, three temporal-difference Mamba blocks each (a
    ``CDC_T`` conv, a bidirectional selective scan over every (t, h, w)
    token, channel attention), lateral merges of the fast pathway into
    the slow one, over ``clip_frames``-frame chunks of ``crop``-square face
    crops (``models/physmamba.py``).  The engine keeps and gates its clip
    ring as for :class:`PhysFormerConfig`."""

    module: ClassVar[str] = "physmamba"    # models/<module>.py builds it
    slow_dim: int = 64
    fast_dim: int = 32
    d_state: int = 16         # N: the scan's state per channel
    d_conv: int = 4           # the scan's causal depthwise conv
    expand: int = 2           # d_inner = expand * dim
    reduction: int = 2        # channel attention's hidden = dim / it
    head_dim: int = 48        # the head's upsampling convs' width
    theta: float = 0.5        # CDC_T's temporal centre difference
    clip_frames: int = 128
    crop: int = 128
    hop: int = 128

    def __post_init__(self):
        # Slow at T/4; the stem and the blocks halve the crop five times.
        if self.clip_frames % 4 or self.crop % 32:
            raise ValueError(
                f"clip_frames={self.clip_frames}, crop={self.crop}: need "
                "multiples of 4 and 32")
        if self.slow_dim % self.reduction or self.fast_dim % self.reduction:
            raise ValueError(f"reduction={self.reduction} must divide "
                             "slow_dim and fast_dim")
        if not 0 < self.hop <= self.clip_frames:
            raise ValueError(f"hop={self.hop}: expected 1..clip_frames")

    def dt_rank(self, dim: int) -> int:
        """R of a pathway of ``dim`` channels: ceil(dim / 16)."""
        return math.ceil(dim / 16)


# --- Inference configuration -------------------------------------------------


class RunningMode(enum.Enum):
    """IMAGE = stateless per-frame; VIDEO = detect-then-track
    (reference inference_runner.py:53, VisionTaskRunningMode)."""

    IMAGE = "image"
    VIDEO = "video"


# Default per-model enable flags (reference inference_runner.py:46-51).
DEFAULT_MODEL_ENABLED: dict[ModelType, bool] = {
    ModelType.FACE_DETECTOR: False,
    ModelType.FACE_LANDMARKER: True,
    ModelType.HAND_LANDMARKER: True,
    ModelType.PERSON_SEGMENTER: False,
}


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    """Model-selection knobs (reference inference_runner.py:46-76)."""

    face_detector: bool = False
    face_landmarker: bool = True
    hand_landmarker: bool = True
    person_segmenter: bool = False
    running_mode: RunningMode = RunningMode.VIDEO

    # Asset paths; ``None`` disables weight loading (random-init fallback).
    face_detector_path: str | None = "models/blaze_face_short_range.tflite"
    face_landmarker_path: str | None = "models/face_landmarker.task"
    hand_landmarker_path: str | None = "models/hand_landmarker.task"
    person_segmenter_path: str | None = "models/selfie_multiclass.tflite"

    # Trained PROCEDURAL stand-in weights (tools/train_hand_standin.py /
    # tools/train_seg_standin.py artifacts): when the real TFLite blob is
    # absent, these replace the random init for the matching stand-in —
    # same architecture, same compute shape, trained on synthetic
    # SDF-rendered scenes (they only know procedural subjects; the HUD/
    # bench warnings still flag the model as non-real).  None keeps the
    # random init.
    hand_lm_standin_path: str | None = "models/hand_lm_standin_synth.npz"
    palm_det_standin_path: str | None = "models/palm_det_standin_synth.npz"
    seg_standin_path: str | None = "models/seg_standin_synth.npz"

    # Tracked-face capacity.  Only 1 is supported: the VIDEO-mode face
    # tracker carries a single rect (largest face, matching the reference's
    # FaceLandmarker default num_faces=1 and the ROI stage's
    # take-the-largest selection, signal_processor.py:143) — validated in
    # __post_init__ so a larger value fails loudly instead of silently
    # reporting one face in max_faces-shaped outputs.
    max_faces: int = 1
    max_hands: int = 2

    # True (reference parity): the segmenter emits all 6 confidence masks
    # upsampled to frame resolution plus the full-res argmax category mask
    # (reference inference_runner.py:164-165 materializes both every
    # frame).  False (TPU operating point): only the face-skin channel —
    # the one mask the live pipeline consumes (drawer blend, drawer.py:99;
    # skin-weighted ROI sampling) — is upsampled; ``seg_conf`` is [1, H, W]
    # and ``seg_class`` is the MODEL-resolution argmax.  Saves 5 full-res
    # channel upsamples + a full-res 6-way argmax per stream per frame.
    seg_full_masks: bool = True

    # Bounded re-detection sub-batch for VIDEO-mode stream batches: when
    # only k of S streams lost tracking, run the detectors on (up to) this
    # many compacted streams instead of all S (one stream of 64 losing its
    # face re-ran BOTH detectors for all 64 — ~2x step cost; VERDICT.md
    # Weak #4).  Most-starved streams are served first, so nothing starves;
    # 0 disables (detect all S whenever any stream needs it).  Batches with
    # S <= the bound behave identically to all-streams detection.
    detector_subbatch: int = 8

    # True: rotated landmark crops via exact affine gather (MediaPipe
    # semantics; element-serial gathers are slow on TPU).  False (default):
    # crop the axis-aligned cover of the tracking rect with two MXU matmuls
    # — the TPU-native path; landmark projection stays self-consistent, the
    # nets just see an unrotated view (equivalent for near-upright subjects).
    exact_rotation: bool = False

    # Rotated-crop strategy for the landmark nets; "" derives from
    # ``exact_rotation`` (True → "exact", False → "cover").
    #   "cover": axis-aligned cover of the tracking rect, two MXU matmuls
    #            (fastest; nets see an unrotated view — fine near upright).
    #   "exact": rotated affine gather (bit-level MediaPipe semantics;
    #            element-serial gathers, slow on TPU).
    #   "shear": rotated crop with ZERO gathers — cover resample at rect
    #            pitch + 3 FFT-phase-ramp shear passes
    #            (warp.crop_rect_shear); matches "exact" up to
    #            interpolation kernel (sinc vs bilinear, sub-px landmark
    #            agreement) at matmul+FFT speed.
    #   "hybrid": angle-gated cover/shear — the Pallas cover fast path
    #            while every tracked crop's |rotation| stays within
    #            ``hybrid_max_tilt_deg``, the shear rotated view beyond it.
    #            On the batched TPU path the gate is ONE scalar lax.cond
    #            (upright batches never trace into the shear passes); on
    #            the per-stream path it is a per-crop select.  Exact-path
    #            fidelity at every angle without giving up cover-speed on
    #            upright subjects (VERDICT r2 item 2).
    rotation_mode: str = ""

    # "hybrid" tilt gate, degrees.  Measured (tools/rotsweep.py, round 2):
    # within ±15° the cover view adds <= ~2.7 px mean landmark error (vs
    # ~1.3 exact) — under 10% of an rPPG ROI side; beyond it the error
    # grows ~linearly (6.2 px at 30°), so the gate hands off to shear.
    hybrid_max_tilt_deg: float = 15.0

    # Bounded per-step shear budget for the batched "hybrid" path: when
    # only k of S tracked crops tilt past the gate, shear-rotate just
    # those k (compacted sub-batch, same pattern as detector_subbatch)
    # on top of the always-on Pallas cover pass, instead of flipping the
    # WHOLE batch onto the shear branch (one tilted subject cost all 64
    # streams 2.9x — VERDICT r3 Weak #5).  More than this many gated
    # crops of one kind falls back to the whole-batch shear branch, so
    # every gated crop always gets the rotated view (fidelity never
    # degrades; only the batch's speed does).  0 disables the sub-batch
    # (always whole-batch flip).  Default 4: measured 8,884 fps with
    # 1-of-64 tilted vs 8,295 at budget 8 (16 mostly-idle shear crops) —
    # and a batch with >4 tilted subjects of one kind is already deep in
    # whole-batch territory.
    shear_subbatch: int = 4

    # Fused Pallas multi-crop kernel for the batch landmark path: one
    # VMEM-resident pass over each frame produces every landmark crop.
    # TPU-only (Mosaic); leave False on CPU/interpret platforms.
    use_pallas: bool = False

    # Run the Pallas kernels in interpret mode (pure-Python emulation):
    # lets the fused crop/stem/trunk fast path execute on the CPU test
    # platform for coverage of its batch-level control flow (e.g. the
    # hybrid rotation gate).  Never set on TPU.
    pallas_interpret: bool = False

    # Run the stand-in landmark nets' 3x3/2 stem as a Pallas kernel on the
    # 2x2-packed crops (pallas/stem_kernel): one 27-deep contraction per
    # crop instead of XLA's 9 row-streamed conv taps — the stem is most of
    # the stand-in nets' measured cost.  Requires use_pallas (the crop
    # kernel supplies the packed layout); ignored for real-weight models.
    fused_stem: bool = False

    # Run the landmark trunks through Pallas block kernels
    # (pallas/block_kernel).  Stand-ins: each stride-2 dw+pw blaze block
    # composes into ONE dense MXU contraction per crop (requires
    # fused_stem — the trunk consumes the stem kernel's activations).
    # Real TFLite graphs: every bottleneck residual unit
    # (1x1-down -> PReLU -> dw3x3 -> 1x1-up -> add [-> PReLU]) fuses into
    # a two-dot VMEM-resident kernel (tflite_compiler.fuse_bottlenecks).
    # Both bypass XLA's row-streamed conv pipeline for the trunk body.
    fused_trunk: bool = False

    # Only fuse real-graph bottleneck units whose spatial size is at
    # least this (tools/bnprobe.py, v5e: the kernel wins at 128^2,
    # loses below 64^2 where the shift/roll VPU cost dominates).
    # 0 fuses every unit.
    fused_bn_min_hw: int = 96

    # Graph-level conv optimizations in the TFLite->JAX compiler
    # (tflite_compiler.fuse_dw_pw_pairs / space_to_depth_pack).
    # fuse_dw_pw composes depthwise+1x1 pairs into dense convs (exact);
    # pack_s2d stores activations with H,W >= the given value 2x2
    # space-to-depth packed (0 = off).  Packing requires the composition.
    fuse_dw_pw: bool = False
    pack_s2d: int = 0

    def __post_init__(self):
        if self.max_faces != 1:
            raise ValueError(
                f"max_faces={self.max_faces}: the face tracker is "
                "single-face (largest; see the max_faces field comment)")
        if self.rotation_mode not in ("", "cover", "exact", "shear",
                                      "hybrid"):
            raise ValueError(
                f"rotation_mode={self.rotation_mode!r}: expected one of "
                "'', 'cover', 'exact', 'shear', 'hybrid'")
        if not self.hybrid_max_tilt_deg > 0:
            raise ValueError(
                f"hybrid_max_tilt_deg={self.hybrid_max_tilt_deg}: "
                "must be positive")
        if self.shear_subbatch < 0:
            raise ValueError(
                f"shear_subbatch={self.shear_subbatch}: must be >= 0 "
                "(0 disables the sub-batch — always whole-batch shear)")

    def resolved_rotation_mode(self) -> str:
        """The effective crop strategy ('cover' | 'exact' | 'shear' |
        'hybrid'): ``rotation_mode`` when set, else derived from
        ``exact_rotation``."""
        return self.rotation_mode or ("exact" if self.exact_rotation
                                      else "cover")

    def enabled(self, model_type: ModelType) -> bool:
        return {
            ModelType.FACE_DETECTOR: self.face_detector,
            ModelType.FACE_LANDMARKER: self.face_landmarker,
            ModelType.HAND_LANDMARKER: self.hand_landmarker,
            ModelType.PERSON_SEGMENTER: self.person_segmenter,
        }[model_type]


# --- Capture configuration ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """Host-side capture knobs (reference video_reader.py:19-47)."""

    path: int | str = 0
    target_res: tuple[int, int] | None = None  # (height, width)
    crop_portrait: bool | None = None
    flip_horizontally: bool | None = None
    calibration_time: float = 5.0   # (:19)


# --- Rendering configuration --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DrawConfig:
    """Overlay/plot layout knobs (reference drawer.py:44-52)."""

    line_thickness: int = 1
    point_radius: int = 1
    # Stacked plot rows; at most 3 exist (processed / spectra / correlation,
    # reference drawer.py:48-50) — validated in __post_init__ because the
    # packer/unpacker pair would desynchronize past the data row count.
    num_plots: int = 3
    window_size: tuple[int, int] = (640, 720)  # (width, height)
    window_margins: tuple[int, int] = (40, 40)
    graph_default_range: tuple[float, float] = (-1.0, 1.0)
    alpha: float = 0.75
    on_device: bool = True  # rasterize overlays/plots on the TPU
    # Stamp HUD numbers and plot tick/range labels ON DEVICE (bitmap-font
    # glyph selection matmuls, render/glyphs.py) inside the one composition
    # executable, instead of host cv2.putText after download (reference
    # drawer.py:127-150, :177-207).  The host keeps only state-dependent
    # extras (BP line, calibration banner).  Default on: it removes the
    # last per-frame host render stage; set False for the reference's
    # Hershey-font host text.
    device_text: bool = True

    def __post_init__(self):
        if not 1 <= self.num_plots <= 3:
            raise ValueError(
                f"num_plots={self.num_plots}: only 1..3 plot rows exist "
                "(processed / spectra / correlation)")


# --- Top-level engine config ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration of the fused per-frame step."""

    signal: SignalConfig = SignalConfig()
    inference: InferenceConfig = InferenceConfig()
    draw: DrawConfig = DrawConfig()
    frame_height: int = 480
    frame_width: int = 640
    num_streams: int = 1
    compute_dtype: str = "float32"


def flagship_config(streams: int = 64, h: int = 480, w: int = 640
                    ) -> EngineConfig:
    """The flagship measured configuration: face + hand landmarkers, dual
    ROI, Butterworth + Lomb-Scargle, bf16, with the fused crop / stem /
    trunk kernels on — the same config as the JAX ``bench.build_config(
    None, streams, h, w, on_tpu=True)`` with no environment overrides."""
    return EngineConfig(
        frame_height=h, frame_width=w, num_streams=streams,
        compute_dtype="bfloat16",
        inference=InferenceConfig(
            use_pallas=True, fuse_dw_pw=False, pack_s2d=0, fused_stem=True,
            fused_trunk=True, fused_bn_min_hw=96, seg_full_masks=True))


@dataclasses.dataclass(frozen=True)
class RppgEngineConfig(EngineConfig):
    """An engine whose streams' one signal is the BVP of a learned rPPG net
    (``rppg_net``) over a ring of face crops, in place of ROI samples
    (``runtime/engine.py``).  A subclass, so that every other
    configuration keeps the JAX package's fields one for one."""

    # Any net config whose ``module`` names a ``models/`` module giving
    # ``init_params(cfg, seed)`` and ``Net(cfg, params, dtype, device,
    # use_kernel)``.
    rppg_net: PhysFormerConfig | PhysMambaConfig = PhysFormerConfig()


def rppg_config(net: PhysFormerConfig | PhysMambaConfig, streams: int = 64,
                h: int = 480, w: int = 640) -> RppgEngineConfig:
    """An rPPG net ``net`` on the port's path: the face landmarker alone
    (the mesh on the fused kernels, as in :func:`flagship_config`) keeps
    the face rect; K1 crops it at ``net.crop`` into each stream's clip
    ring; the net's BVP is the one signal, detrended, band-passed over
    0.75-2.5 Hz (rPPG-Toolbox's post-processing band; order 2, the even
    order nearest its order-1 design, as the port's filter takes even
    orders only) and read by an rFFT peak.  No ROI, no hand landmarker, no
    detector; bf16."""
    return RppgEngineConfig(
        frame_height=h, frame_width=w, num_streams=streams,
        compute_dtype="bfloat16", rppg_net=net,
        signal=SignalConfig(
            roi_configs=(), signal_max_samples=net.clip_frames,
            processing_methods=(SignalProcessingMethod.DETREND_LINEAR,
                                SignalProcessingMethod.FILTER_BUTTER),
            spectrum_transform=SignalSpectrumTransform.DFT_RFFT,
            butter_order=2, min_freq=0.75, max_freq=2.5),
        inference=InferenceConfig(
            hand_landmarker=False, use_pallas=True, fuse_dw_pw=False,
            pack_s2d=0, fused_stem=True, fused_trunk=True,
            fused_bn_min_hw=96))


def physformer_config(streams: int = 64, h: int = 480, w: int = 640,
                      net: PhysFormerConfig = PhysFormerConfig()
                      ) -> RppgEngineConfig:
    """PhysFormer on the port's path (:func:`rppg_config`)."""
    return rppg_config(net, streams, h, w)


def physmamba_config(streams: int = 64, h: int = 480, w: int = 640,
                     net: PhysMambaConfig = PhysMambaConfig()
                     ) -> RppgEngineConfig:
    """PhysMamba on the port's path (:func:`rppg_config`)."""
    return rppg_config(net, streams, h, w)


def preset_config(name: str, streams: int = 64, h: int = 480, w: int = 640
                  ) -> EngineConfig:
    """One of the five BASELINE presets at the measured scale: the same
    config as the JAX ``bench.build_config(name, streams, h, w,
    on_tpu=True)`` with no environment overrides (the fused crop / stem /
    trunk kernels on, bf16, all six segmenter masks)."""
    base = preset_configs()[name]
    return dataclasses.replace(
        base, frame_height=h, frame_width=w, num_streams=streams,
        compute_dtype="bfloat16",
        inference=dataclasses.replace(
            base.inference, use_pallas=True, fuse_dw_pw=False, pack_s2d=0,
            fused_stem=True, fused_trunk=True, fused_bn_min_hw=96,
            seg_full_masks=True))


def preset_configs() -> dict[str, EngineConfig]:
    """The five BASELINE.json benchmark configurations as presets."""

    return {
        # 0: FaceLandmarker brow ROI, green-mean, Butterworth + Welch HR.
        "butter_welch_face": EngineConfig(signal=SignalConfig(
            roi_configs=(FACE_EYEBROW_CONFIG,),
            processing_methods=(SignalProcessingMethod.FILTER_BUTTER,),
            spectrum_transform=SignalSpectrumTransform.PGRAM_WELCH),
            inference=InferenceConfig(hand_landmarker=False)),
        # 1: Face+hand dual-ROI, chrominance sampling + Lomb-Scargle.
        "dual_roi_ls": EngineConfig(signal=SignalConfig(
            roi_configs=(FACE_FOREHEAD_CONFIG, HAND_PALM_CONFIG),
            color_channel=SignalColorChannel.CHROM_GREEN,
            processing_methods=(SignalProcessingMethod.FILTER_BUTTER,),
            spectrum_transform=SignalSpectrumTransform.PGRAM_LS)),
        # 2: Segmenter skin mask + spline interp + detrend + FIR chain.
        "segmenter_fir": EngineConfig(signal=SignalConfig(
            roi_configs=(FACE_FOREHEAD_CONFIG,),
            processing_methods=(
                SignalProcessingMethod.INTERP_CUBIC,
                SignalProcessingMethod.DETREND_LINEAR,
                SignalProcessingMethod.FILTER_FIR),
            spectrum_transform=SignalSpectrumTransform.PGRAM_LS),
            inference=InferenceConfig(hand_landmarker=False, person_segmenter=True)),
        # 3: Dual-ROI PTT with bbox temporal filtering.
        "ptt_filtered": EngineConfig(signal=SignalConfig(
            roi_configs=(FACE_FOREHEAD_CONFIG, HAND_PALM_CONFIG),
            roi_max_samples=5,
            processing_methods=(SignalProcessingMethod.FILTER_BUTTER,),
            spectrum_transform=SignalSpectrumTransform.PGRAM_LS)),
        # 4: 8× multi-stream, all 4 models, on-device overlays.
        "multistream": EngineConfig(signal=SignalConfig(
            roi_configs=(FACE_FOREHEAD_CONFIG, HAND_PALM_CONFIG)),
            inference=InferenceConfig(
                face_detector=True, face_landmarker=True,
                hand_landmarker=True, person_segmenter=True),
            num_streams=8),
    }
