"""Command-line interface — the counterpart of ``bp_from_video_tpu/cli.py``,
with the same flags and outputs plus ``--device`` (default ``cuda``; pass
``--device cpu`` to run the plain PyTorch versions on the CPU).

The reference has no CLI — configuration is module constants edited in
source ("ajuste os parâmetros dentro dos scripts", reference README.md:58)
shadowed by constructor kwargs (SURVEY.md §5.6).  Every one of those knobs
is exposed here over the config dataclasses, plus the five BASELINE
benchmark configurations as named presets.

    python -m bp_from_video_tpu_torch --source 0          # webcam, live
    python -m bp_from_video_tpu_torch --source clip.mp4 --preset dual_roi_ls
    python -m bp_from_video_tpu_torch --source a.mp4 b.mp4 --pipelined
    python -m bp_from_video_tpu_torch --source a.avi b.avi --offline \
        --headless --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import warnings

import numpy as np
import torch

from bp_from_video_tpu_torch import config as cfg_mod
from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.config import (
    CaptureConfig, EngineConfig, RunningMode, SignalColorChannel,
    SignalProcessingMethod, SignalSpectrumTransform, physformer_config,
    physmamba_config, preset_configs)

ROI_PRESETS = {
    "cheek": cfg_mod.FACE_CHEEK_CONFIG,
    "eyebrow": cfg_mod.FACE_EYEBROW_CONFIG,
    "forehead": cfg_mod.FACE_FOREHEAD_CONFIG,
    "wrist": cfg_mod.HAND_WRIST_CONFIG,
    "palm": cfg_mod.HAND_PALM_CONFIG,
}


# The presets whose one signal is a learned rPPG net's BVP.
RPPG_PRESETS = {"physformer": physformer_config,
                "physmamba": physmamba_config}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bp_from_video_tpu_torch",
        description="rPPG on an NVIDIA GPU (PyTorch + CUDA): heart rate + "
                    "pulse transit time from video (webcam or file).")
    p.add_argument("--source", nargs="+", default=["0"],
                   help="webcam index or video path; several sources -> "
                        "multi-stream (default: webcam 0)")
    p.add_argument("--preset", choices=sorted(preset_configs())
                   + sorted(RPPG_PRESETS),
                   help="start from a named benchmark configuration "
                        "(physformer: the PhysFormer rPPG net on 160-frame "
                        "clips of the face, config.physformer_config; "
                        "physmamba: the PhysMamba rPPG net on 128-frame "
                        "clips, config.physmamba_config)")
    p.add_argument("--pipelined", action="store_true",
                   help="threaded capture pipeline with drop-oldest "
                        "hand-off (reference pbp.py mode)")
    p.add_argument("--offline", action="store_true",
                   help="batch mode: decode whole files, scan the fused "
                        "step over them on the device (no display, max "
                        "throughput); prints the settled HR per stream")
    p.add_argument("--headless", action="store_true",
                   help="no display windows (prints HR/PTT instead)")
    p.add_argument("--micro-batch", type=int, default=None,
                   help="offline mode: lagged-rect temporal micro-batch "
                        "size F (F frames per dispatch, crops use the "
                        "pre-window tracking rects, vitals update once "
                        "per window — throughput operating point)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--asset-dir", default=None,
                   help="directory containing the models/ TFLite assets")
    p.add_argument("--record", default=None, metavar="OUT.npz",
                   help="record per-frame BPM/PTT/fs to an npz file")
    p.add_argument("--bp", default=None, metavar="PREDICTOR.npz",
                   help="trained BP head (python -m "
                        "bp_from_video_tpu_torch.train --predictor, or the "
                        "reference package's file): adds the SBP/DBP "
                        "estimate to the HUD and the printed reports")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs "
                        "the kernels' plain PyTorch versions)")

    cap = p.add_argument_group("capture (reference video_reader.py)")
    cap.add_argument("--target-res", type=int, nargs=2, metavar=("H", "W"))
    cap.add_argument("--crop-portrait", action="store_true")
    cap.add_argument("--flip", dest="flip", action="store_true",
                     default=None)
    cap.add_argument("--no-flip", dest="flip", action="store_false")
    cap.add_argument("--calibration-time", type=float, default=5.0)

    inf = p.add_argument_group("models (reference inference_runner.py)")
    inf.add_argument("--models", nargs="+",
                     choices=["face_detector", "face_landmarker",
                              "hand_landmarker", "person_segmenter"],
                     help="enabled models (default: face+hand landmarkers)")
    inf.add_argument("--running-mode", choices=["image", "video"],
                     default=None)
    inf.add_argument("--max-hands", type=int, default=None)
    inf.add_argument("--exact-rotation", action="store_true",
                     help="exact rotated crops (bilinear gathers, slower; "
                          "default crops the axis-aligned cover)")
    inf.add_argument("--rotation-mode",
                     choices=["cover", "exact", "shear", "hybrid"],
                     default=None,
                     help="landmark crop strategy: axis-aligned cover "
                          "(fastest), exact rotated gather, gather-free "
                          "FFT-shear rotation, or hybrid (cover while "
                          "upright, shear past --hybrid-max-tilt); "
                          "overrides --exact-rotation")
    inf.add_argument("--hybrid-max-tilt", type=float, default=None,
                     metavar="DEG",
                     help="hybrid mode's tilt gate in degrees (default 15)")
    inf.add_argument("--shear-subbatch", type=int, default=None,
                     metavar="K",
                     help="hybrid mode's per-kind shear budget: at most K "
                          "gated crops get the compacted shear sub-batch "
                          "before the whole batch falls back to the shear "
                          "branch (default 4; 0 = always whole-batch)")
    inf.add_argument("--pallas", dest="pallas", action="store_true",
                     default=None,
                     help="force the hand-written crop and ROI kernels")
    inf.add_argument("--no-pallas", dest="pallas", action="store_false",
                     help="disable them (default: auto — on for a CUDA "
                          "device)")

    sig = p.add_argument_group("signal (reference signal_processor.py)")
    sig.add_argument("--rois", nargs="+", choices=sorted(ROI_PRESETS),
                     help="ROI selection (default: forehead palm)")
    sig.add_argument("--channel", choices=["green", "chrom_green"],
                     default=None)
    sig.add_argument("--methods", nargs="*",
                     choices=[m.value for m in SignalProcessingMethod],
                     default=None, help="processing chain, in order")
    sig.add_argument("--transform",
                     choices=[t.value for t in SignalSpectrumTransform],
                     default=None)
    sig.add_argument("--signal-samples", type=int, default=None)
    sig.add_argument("--peak-samples", type=int, default=None)
    sig.add_argument("--roi-samples", type=int, default=None)
    sig.add_argument("--butter-order", type=int, default=None)
    sig.add_argument("--fir-taps", type=int, default=None)
    sig.add_argument("--min-freq", type=float, default=None)
    sig.add_argument("--max-freq", type=float, default=None)
    # NOTE: the reference's lag/mag ranges are set but then clobbered by the
    # SignalGroup auto data range (see engine.signal_post); the knobs are
    # kept for config parity and faithfully have no effect.
    sig.add_argument("--min-lag", type=float, default=None,
                     help="PTT peak window min lag (s); reference quirk: "
                          "overridden by the auto data range")
    sig.add_argument("--max-lag", type=float, default=None,
                     help="PTT peak window max lag (s); reference quirk: "
                          "overridden by the auto data range")

    disp = p.add_argument_group("display (reference drawer.py)")
    disp.add_argument("--display-stream", type=int, default=0,
                      metavar="N",
                      help="which stream's window to show in pipelined "
                           "mode (composition runs only for it; default 0)")
    disp.add_argument("--host-text", action="store_true",
                      help="stamp HUD/labels on the host with cv2 Hershey "
                           "fonts (reference look) instead of the default "
                           "on-device bitmap-font stamping")

    perf = p.add_argument_group("performance")
    perf.add_argument("--dtype", choices=["float32", "bfloat16"],
                      default=None)
    return p


def _source(s: str):
    return int(s) if s.isdigit() else s


def config_from_args(args) -> tuple[EngineConfig, list[CaptureConfig]]:
    if args.preset in RPPG_PRESETS:
        cfg = RPPG_PRESETS[args.preset](1)
    else:
        cfg = preset_configs()[args.preset] if args.preset else EngineConfig()

    sig_kw = {}
    if args.rois:
        sig_kw["roi_configs"] = tuple(ROI_PRESETS[r] for r in args.rois)
    if args.channel:
        sig_kw["color_channel"] = SignalColorChannel(args.channel)
    if args.methods is not None:
        sig_kw["processing_methods"] = tuple(
            SignalProcessingMethod(m) for m in args.methods)
    if args.transform:
        sig_kw["spectrum_transform"] = SignalSpectrumTransform(args.transform)
    for arg, field in [("signal_samples", "signal_max_samples"),
                       ("peak_samples", "peak_max_samples"),
                       ("roi_samples", "roi_max_samples"),
                       ("butter_order", "butter_order"),
                       ("fir_taps", "fir_taps"),
                       ("min_freq", "min_freq"), ("max_freq", "max_freq"),
                       ("min_lag", "min_lag"), ("max_lag", "max_lag")]:
        v = getattr(args, arg)
        if v is not None:
            sig_kw[field] = v
    if sig_kw:
        cfg = dataclasses.replace(
            cfg, signal=dataclasses.replace(cfg.signal, **sig_kw))

    inf_kw = {}
    if args.models is not None:
        for m in ["face_detector", "face_landmarker", "hand_landmarker",
                  "person_segmenter"]:
            inf_kw[m] = m in args.models
    if args.running_mode:
        inf_kw["running_mode"] = RunningMode(args.running_mode)
    if args.max_hands is not None:
        inf_kw["max_hands"] = args.max_hands
    if args.exact_rotation:
        inf_kw["exact_rotation"] = True
    if args.rotation_mode is not None:
        inf_kw["rotation_mode"] = args.rotation_mode
    if args.hybrid_max_tilt is not None:
        inf_kw["hybrid_max_tilt_deg"] = args.hybrid_max_tilt
    if args.shear_subbatch is not None:
        inf_kw["shear_subbatch"] = args.shear_subbatch
    if args.pallas is not None:
        inf_kw["use_pallas"] = args.pallas
    else:
        # Auto: the CUDA kernels run on a CUDA device; a CPU tensor takes
        # their plain versions either way.
        inf_kw["use_pallas"] = torch.device(args.device).type == "cuda"
    if inf_kw:
        cfg = dataclasses.replace(
            cfg, inference=dataclasses.replace(cfg.inference, **inf_kw))
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)

    if args.host_text:
        cfg = dataclasses.replace(
            cfg, draw=dataclasses.replace(cfg.draw, device_text=False))

    captures = [CaptureConfig(
        path=_source(s),
        target_res=tuple(args.target_res) if args.target_res else None,
        crop_portrait=args.crop_portrait or None,
        flip_horizontally=args.flip,
        calibration_time=args.calibration_time) for s in args.source]
    return cfg, captures


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg, captures = config_from_args(args)
    show = not args.headless

    recorder = None
    if args.record:
        from bp_from_video_tpu_torch.runtime.recorder import SignalRecorder
        recorder = SignalRecorder(args.record)

    bp_predictor = None
    if args.bp:
        from bp_from_video_tpu_torch.train.bp_regressor import load_predictor
        bp_predictor = load_predictor(args.bp)

    if args.offline:
        from bp_from_video_tpu_torch.runtime import offline
        paths = [c.path for c in captures]
        if any(isinstance(p, int) for p in paths):
            raise SystemExit("--offline requires video files, not cameras")
        out, clip_ts = offline.process_videos(
            paths, cfg, asset_dir=args.asset_dir,
            max_frames=args.max_frames, target_res=captures[0].target_res,
            crop_portrait=captures[0].crop_portrait,
            flip_horizontally=captures[0].flip_horizontally,
            micro_batch=args.micro_batch, device=device)
        if recorder is not None:
            rec_ts = clip_ts[:, 0]
            rec_out = out
            if args.micro_batch and args.micro_batch > 1:
                # Micro-batch outputs are per window; record window-end
                # timestamps so rows stay aligned (a trailing partial
                # window has no in-range end frame — drop it).
                rec_ts = rec_ts[args.micro_batch - 1::args.micro_batch]
                n = min(rec_ts.shape[0], out.bpm.shape[0])
                rec_ts = rec_ts[:n]
                rec_out = type(out)(*(getattr(out, f)[:n]
                                      for f in out._fields))
            recorder.add_clip(rec_ts, rec_out)
            print(f"recorded clip -> {recorder.save()}")
        settled = out.bpm[out.bpm.shape[0] // 2:]
        settled_ptt = out.ptt[out.ptt.shape[0] // 2:]
        for s in range(settled.shape[1]):
            with np.errstate(all="ignore"), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                means = np.nanmean(settled[:, s, :], axis=0)
            print(f"stream {s}: settled mean BPM per ROI:",
                  [round(float(v), 1) if np.isfinite(v) else None
                   for v in means])
            if bp_predictor is not None:
                # Per-step estimates over the settled half, then a NaN-safe
                # mean, as the HUD smooths vitals.
                bp = bp_predictor(settled[:, s, :], settled_ptt[:, s, :])
                with np.errstate(all="ignore"), warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    sbp, dbp = np.nanmean(bp, axis=0)
                print(f"stream {s}: settled mean BP: "
                      + (f"{sbp:.0f}/{dbp:.0f} mmHg"
                         if np.isfinite(sbp) and np.isfinite(dbp)
                         else "NaN"))
        return 0

    if args.pipelined or len(captures) > 1:
        from bp_from_video_tpu_torch.drivers import pipelined
        out = pipelined.run(cfg, captures, asset_dir=args.asset_dir,
                            show=show, max_frames=args.max_frames,
                            display_stream=args.display_stream,
                            recorder=recorder, bp_predictor=bp_predictor,
                            device=device)
    else:
        from bp_from_video_tpu_torch.drivers import sequential
        out = sequential.run(cfg, captures[0], asset_dir=args.asset_dir,
                             show=show, max_frames=args.max_frames,
                             recorder=recorder, bp_predictor=bp_predictor,
                             device=device)
    if recorder is not None and len(recorder):
        print(f"recorded {len(recorder)} frames -> {recorder.save()}")
    if out is not None and args.headless:
        bpm = out.bpm.float().cpu().numpy().reshape(-1)
        ptt = out.ptt.float().cpu().numpy().reshape(-1)
        print("mean BPM per ROI:", [round(float(b), 1) for b in bpm])
        print("mean PTT per pair (ms):", [round(float(t), 1) for t in ptt])
        if bp_predictor is not None:
            # The last frame's vitals -> mmHg, a row per stream.
            bp = bp_predictor(out.bpm.float().cpu().numpy(),
                              out.ptt.float().cpu().numpy())
            for row in np.atleast_2d(bp):
                print("BP estimate:", f"{row[0]:.0f}/{row[1]:.0f} mmHg"
                      if np.isfinite(row).all() else "NaN")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
