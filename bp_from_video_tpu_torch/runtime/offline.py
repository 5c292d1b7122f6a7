"""Offline / batch video processing — the counterpart of
``bp_from_video_tpu/runtime/offline.py``: decode whole clips on the host,
run the batched step over them on the device in blocks.

The reference only has a live loop (recorded videos replay through the same
real-time path, reference bp.py:11-15).  The batch API is the throughput-
oriented counterpart: decode → [T, S, H, W, 3] uint8 blocks → one upload
and one planar transpose on the device a block → ``run_clip`` →
per-frame BPM/PTT series, read back once a block.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from bp_from_video_tpu_torch.config import EngineConfig
from bp_from_video_tpu_torch.exceptions import CaptureError
from bp_from_video_tpu_torch.parallel import ClipOutputs, MultiStreamEngine
from bp_from_video_tpu_torch.runtime.capture import VideoReader


def decode_clip(path: str, max_frames: int | None = None,
                target_res: tuple[int, int] | None = None,
                crop_portrait: bool = False,
                flip_horizontally: bool | None = None
                ) -> tuple[np.ndarray, np.ndarray]:
    """Decode a video file into (frames_rgb uint8 [T, H, W, 3],
    timestamps [T]).  ``crop_portrait``/``flip_horizontally`` apply the
    same geometry the live capture path would (offline results must match
    a live run with identical flags)."""
    reader = VideoReader(path, target_res=target_res,
                         crop_portrait=crop_portrait,
                         flip_horizontally=flip_horizontally)
    frames, ts = [], []
    try:
        while max_frames is None or len(frames) < max_frames:
            fd = reader.read_frame()
            frames.append(fd.frame[..., ::-1])  # BGR -> RGB on host
            ts.append(fd.timestamp)
    except CaptureError:
        pass
    finally:
        reader.cleanup()
    if not frames:
        raise CaptureError(f"no frames decoded from {path!r}")
    return np.stack(frames), np.asarray(ts, np.float32)


def _pad_windows(fb: np.ndarray, tb: np.ndarray, f_n: int):
    """Pad a block to a whole number of F-frame windows with its last frame
    and NaN timestamps (the NaN gates the ring pushes off)."""
    pad = -fb.shape[0] % f_n
    if pad:
        fb = np.concatenate([fb, np.repeat(fb[-1:], pad, axis=0)])
        tb = np.concatenate(
            [tb, np.full((pad,) + tb.shape[1:], np.nan, np.float32)])
    return fb, tb


def process_videos(paths: Sequence[str], config: EngineConfig | None = None,
                   *, asset_dir: str | None = None,
                   max_frames: int | None = None, chunk: int = 256,
                   target_res: tuple[int, int] | None = None,
                   crop_portrait: bool = False,
                   flip_horizontally: bool | None = None,
                   micro_batch: int | None = None, device=None
                   ) -> tuple[ClipOutputs, np.ndarray]:
    """Run the full pipeline over recorded videos in batch; ``device=None``
    means ``"cuda"`` (raises without CUDA unless ``device="cpu"``).

    All videos are decoded (truncated to the shortest, resized to
    ``target_res`` when given — required for mixed-resolution inputs),
    stacked as streams, and stepped through in ``chunk``-frame device
    blocks.  Returns (time-major numpy ClipOutputs [T, S, ...],
    timestamps [T, S] seconds).

    ``micro_batch=F`` switches to the lagged-rect temporal micro-batch
    operating point (``Engine.batch_step_lagged``): F frames per step with
    pre-window tracking rects, one analysis per window — output rows are
    per WINDOW (ceil(T / F) of them, each at its window-end frame; the last,
    partial window's frames are padded with the last frame at NaN
    timestamps), trading vitals update rate for throughput.

    Unlike the JAX package, a tail block shorter than ``chunk`` is not
    padded to ``chunk``: there it only avoids a recompile, and its pad
    steps ran after the kept ones."""
    config = config or EngineConfig()
    decoded = [decode_clip(p, max_frames=max_frames, target_res=target_res,
                           crop_portrait=crop_portrait,
                           flip_horizontally=flip_horizontally)
               for p in paths]
    t_len = min(f.shape[0] for f, _ in decoded)
    frames = np.stack([f[:t_len] for f, _ in decoded], axis=1)  # [T, S, ...]
    ts = np.stack([t[:t_len] for _, t in decoded], axis=1)      # [T, S]

    h, w = frames.shape[2], frames.shape[3]
    config = dataclasses.replace(config, frame_height=h, frame_width=w,
                                 num_streams=len(paths))
    ms = MultiStreamEngine(config, asset_dir=asset_dir, device=device)
    dev = ms.device
    state = ms.init_states()
    f_n = micro_batch if micro_batch and micro_batch > 1 else 1
    # Window-align the chunk so every block reshapes to [chunk // F, F, ...].
    chunk = max(f_n, chunk - chunk % f_n)
    outs = []
    for i in range(0, t_len, chunk):
        fb, tb = frames[i:i + chunk], ts[i:i + chunk]
        rem = fb.shape[0]
        fb, tb = _pad_windows(fb, tb, f_n)
        # One upload a block, then planar [.., S, 3, H, W] on the device
        # (the layout the crop and ROI kernels read).
        fd = torch.from_numpy(fb).to(dev).permute(0, 1, 4, 2, 3).contiguous()
        td = torch.from_numpy(tb).to(dev)
        if f_n > 1:
            fd = fd.reshape((fd.shape[0] // f_n, f_n) + fd.shape[1:])
            td = td.reshape((td.shape[0] // f_n, f_n) + td.shape[1:])
            state, out = ms.run_clip_lagged(ms.params, state, fd, td)
            kept = (rem + f_n - 1) // f_n
        else:
            state, out = ms.run_clip(ms.params, state, fd, td)
            kept = rem
        outs.append([getattr(out, f)[:kept].cpu().numpy()
                     for f in ClipOutputs._fields])
    return ClipOutputs(*(np.concatenate(col) for col in zip(*outs))), ts
