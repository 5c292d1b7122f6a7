"""The one traffic generator: every mix is a data file under ``traffic/``
whose parameters this module reads.

A mix gives the scene (``texture``: an 8x8-block texture), the clip length in frames (a whole number of pulse
periods, played in a loop while timestamps keep rising by 1/30 s), the
pulse, the share of streams tracked at the start, the frames a stream per
engine call (1: ``batch_step``; F > 1: ``batch_step_lagged``), and the
harness's counts (warm-up calls, checked calls, the calls the reference
runs by itself from the start, profiled calls), and the keys the cell's
system declares (``TRAFFIC_KEYS``) in ``params``.

``pulse_clip`` and ``tracked_state`` are copies of the helpers of
``chip_smoke.py``, so that later changes there do not move the
yardstick.
"""

from __future__ import annotations

import dataclasses
import math

import torch

FPS = 30.0


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    scene: str              # "texture"
    clip_frames: int        # a whole number of pulse periods
    pulse_hz: float
    delay_frames: int       # the lower rows pulse this many frames later
    split_frac: float       # rows below this share of the height are late
    tracked: float          # share of streams tracked at the start
    frames_per_call: int    # F: 1 = batch_step, > 1 = batch_step_lagged
    warmup_calls: int
    check_calls: int        # calls whose outputs the reference checks
    own_calls: int          # calls the reference runs by itself from call 0
    profile_calls: int      # calls traced by the profiler (--trace 1)
    sync_calls: int         # calls counted in CUDA sync debug mode
    params: dict = dataclasses.field(default_factory=dict)  # the system's

    @classmethod
    def from_dict(cls, name: str, d: dict, extra=()) -> "Traffic":
        """The mix ``d``; ``extra`` names the keys the cell's system reads
        (``TRAFFIC_KEYS``), kept in ``params``."""
        fields = {f.name for f in dataclasses.fields(cls)} - {"name",
                                                               "params"}
        unknown = set(d) - fields - set(extra) - {"why"}
        if unknown:
            raise ValueError(f"traffic {name}: unknown keys {sorted(unknown)}")
        t = cls(name=name, params={k: d[k] for k in extra},
                **{k: d[k] for k in fields})
        period = FPS / t.pulse_hz
        if abs(t.clip_frames / period - round(t.clip_frames / period)) > 1e-9:
            raise ValueError(f"traffic {name}: {t.clip_frames} frames is not "
                             f"a whole number of {period}-frame periods")
        if t.clip_frames % t.frames_per_call:
            raise ValueError(f"traffic {name}: the clip does not split into "
                             f"calls of {t.frames_per_call} frames")
        return t


def pulse_clip(t: Traffic, s: int, h: int, w: int, seed: int, device
               ) -> torch.Tensor:
    """uint8 [frames, S, 3, H, W] made on ``device`` from ``seed``: the
    mix's scene whose green channel pulses at ``pulse_hz`` (rows below
    ``split_frac`` of the height ``delay_frames`` later), plus pixel
    noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if t.scene == "texture":
        base = torch.randint(60, 180, (s, 3, h // 8, w // 8), generator=gen,
                             device=device).to(torch.float32)
        base = base.repeat_interleave(8, 2).repeat_interleave(8, 3)
    else:
        raise ValueError(f"traffic {t.name}: unknown scene {t.scene!r}")
    split = int(h * t.split_frac)
    rows = torch.arange(h, device=device)[:, None]
    out = torch.empty((t.clip_frames, s, 3, h, w), dtype=torch.uint8,
                      device=device)
    for i in range(t.clip_frames):
        tt = i / FPS
        ph = torch.where(rows < split, tt, tt - t.delay_frames / FPS)
        f = base.clone()
        f[:, 1] += 6.0 * torch.sin(2 * math.pi * t.pulse_hz * ph)
        noise = torch.randn(f.shape, generator=gen, device=device) * 0.5
        out[i] = torch.clamp(torch.round(f + noise), 0, 255).to(torch.uint8)
    return out


def start_track(h: int, w: int, tracked: torch.Tensor) -> dict:
    """The starting track of every stream as plain tensors: the
    ``tracked`` streams locked on a face in the upper part of the frame
    and two hands below it (``chip_smoke.tracked_state``'s rects)."""
    k = h / 96.0
    dev = tracked.device
    face = torch.tensor([64 * k, 40 * k, 56 * k, 56 * k, 0.0], device=dev)
    hands = torch.tensor([[30 * k, 72 * k, 40 * k, 40 * k, 0.0],
                          [98 * k, 72 * k, 40 * k, 40 * k, 0.0]], device=dev)
    return {"face": face, "hands": hands}


def tracked_state(init_state, h: int, w: int, tracked: torch.Tensor):
    """``init_state`` (an engine's fresh state) with the ``tracked``
    streams started on :func:`start_track`'s rects."""
    r = start_track(h, w, tracked)
    tr = init_state.track
    tr = tr._replace(
        face_rect=torch.where(tracked[:, None], r["face"], tr.face_rect),
        face_tracking=tracked.clone(),
        hand_rects=torch.where(tracked[:, None, None], r["hands"],
                               tr.hand_rects),
        hand_tracking=tracked[:, None].expand(-1, 2).clone())
    return init_state._replace(track=tr)


def tracked_mask(t: Traffic, s: int, device) -> torch.Tensor:
    """The streams tracked at the start: the first ``tracked`` share."""
    return torch.arange(s, device=device) < round(s * t.tracked)


def call_frames(t: Traffic, clip: torch.Tensor, call: int) -> torch.Tensor:
    """The frames of engine call ``call``: [S, ...] (F = 1) or a window
    [F, S, ...], a view into the looped clip."""
    f = t.frames_per_call
    i = (call * f) % t.clip_frames
    return clip[i] if f == 1 else clip[i:i + f]
