"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile DIR]

Phases (each fatal on failure):

1. build the hand-written CUDA kernels from ``bp_from_video_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card at the
   flagship shapes (64 streams of 480x640, bf16), and time the kernel, the
   plain version and a one-call PyTorch yardstick with CUDA events;
3. run the flagship ``Engine.batch_step`` (``flagship_config()``) over a
   synthetic pulsing clip long enough to fill the 250-sample ring, with the
   kernels' launch counters set to 0 just before and read just after;
4. run a small f32 config on the card and on the CPU (plain versions) over
   the same clip: BPM equal, PTT within one sample period.

Prints the card's name and power limit first, one JSON line with every
kernel's numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card.
``--profile DIR`` also traces a few flagship steps with ``torch.profiler``
(kernel time by name, device busy share) and writes the trace to DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12
BF16_ULP = 2.0 ** -7          # relative spacing of bf16 values (8-bit mantissa)
# Engine steps per run: enough to fill the 250-sample signal ring.
STEPS = 260


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


def time_ms(fn, reps: int = 10, inner: int = 5, warm: int = 3) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls of ``fn``, per call, in ms.  A ~2.5 ms sleep kernel queued first
    lets the host enqueue the calls before the card reaches them, so a
    kernel shorter than its launch overhead is timed on the card, not on
    the host."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# -- synthetic clip and template heads ------------------------------------------


def pulse_clip(steps: int, s: int, h: int, w: int, split: int, seed: int,
               device, hz: float = 1.2, delay_frames: int = 3) -> torch.Tensor:
    """uint8 [steps, S, 3, H, W] made on ``device`` from a seeded generator:
    8x8-block texture whose green channel pulses at ``hz`` (rows < split in
    phase, rows >= split ``delay_frames`` later), plus pixel noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randint(60, 180, (s, 3, h // 8, w // 8), generator=gen,
                         device=device).to(torch.float32)
    base = base.repeat_interleave(8, 2).repeat_interleave(8, 3)
    rows = torch.arange(h, device=device)[:, None]
    out = torch.empty((steps, s, 3, h, w), dtype=torch.uint8, device=device)
    for i in range(steps):
        t = i / 30.0
        ph = torch.where(rows < split, t, t - delay_frames / 30.0)
        f = base.clone()
        f[:, 1] += 6.0 * torch.sin(2 * math.pi * hz * ph)
        noise = torch.randn(f.shape, generator=gen, device=device) * 0.5
        out[i] = torch.clamp(torch.round(f + noise), 0, 255).to(torch.uint8)
    return out


def _logit(p):
    return np.log(p / (1.0 - p)).astype(np.float32)


def template_heads(params: dict) -> dict:
    """Landmark heads that put every landmark at a fixed place in its crop
    (zero readout weights, the place in the bias) and report presence, so
    the trackers hold still on the synthetic clip.  Face: a grid over the
    middle 2/3 of the crop, eye corners level; hand: wrist low,
    middle-finger knuckle high."""
    rng = np.random.default_rng(11)
    for key, n, lo, hi, fixed in (
            ("flm_lm", 478, (1 / 6, 1 / 6), (5 / 6, 5 / 6),
             {33: (0.3, 0.4), 263: (0.7, 0.4), 151: (0.5, 0.3)}),
            ("hand_lm", 21, (0.25, 0.3), (0.75, 0.8),
             {0: (0.5, 0.8), 9: (0.5, 0.3)})):
        pts = np.stack([rng.uniform(lo[0], hi[0], n),
                        rng.uniform(lo[1], hi[1], n), np.full(n, 0.5)], -1)
        pts[-2, :2], pts[-1, :2] = lo, hi       # the bbox corners
        for i, xy in fixed.items():
            pts[i, :2] = xy
        p = params[key]
        p["head_lm"]["w"] = torch.zeros_like(p["head_lm"]["w"])
        p["head_lm"]["b"] = torch.from_numpy(_logit(pts.reshape(-1))).to(
            p["head_lm"]["b"])
        p["head_presence"]["w"] = torch.zeros_like(p["head_presence"]["w"])
        p["head_presence"]["b"] = torch.full_like(p["head_presence"]["b"],
                                                  8.0)
    return params


def tracked_state(engine, h: int, w: int, tracked: torch.Tensor):
    """Fresh state whose ``tracked`` streams start locked on a face in the
    upper part of the frame and two hands below it."""
    st = engine.init_state()
    k = h / 96.0
    face = torch.tensor([64 * k, 40 * k, 56 * k, 56 * k, 0.0],
                        device=engine.device)
    hands = torch.tensor([[30 * k, 72 * k, 40 * k, 40 * k, 0.0],
                          [98 * k, 72 * k, 40 * k, 40 * k, 0.0]],
                         device=engine.device)
    tr = st.track
    tr = tr._replace(
        face_rect=torch.where(tracked[:, None], face, tr.face_rect),
        face_tracking=tracked.clone(),
        hand_rects=torch.where(tracked[:, None, None], hands, tr.hand_rects),
        hand_tracking=tracked[:, None].expand(-1, 2).clone())
    return st._replace(track=tr)


# -- phase 2: kernels against their plain versions -----------------------------


def _union_pixels(rows: torch.Tensor, cols: torch.Tensor) -> int:
    """Pixels of each stream covered by any of its rects: rows [S, R, H],
    cols [S, R, W] bool -> total count over streams."""
    return int((rows[:, :, :, None] & cols[:, :, None, :]).any(1).sum())


def _crop_spans(center, extent, size, length):
    """[S, C, length] bool: frame pixels a crop's bilinear taps touch."""
    lo = center + ((0.5 / size) - 0.5) * extent - 0.5
    hi = center + (((size - 0.5) / size) - 0.5) * extent - 0.5
    g = torch.arange(length, device=center.device)
    ok = torch.isfinite(center) & torch.isfinite(extent)
    return ((g >= torch.floor(lo)[..., None])
            & (g <= torch.floor(hi)[..., None] + 1) & ok[..., None])


def check_multi_crop(gen, dev, s: int = 64):
    from bp_from_video_tpu_torch.kernels import warp as wk
    h, w, sizes = 480, 640, (256, 224, 224)
    frames = torch.randint(0, 256, (s, 3, h, w), generator=gen, device=dev,
                           dtype=torch.uint8)
    u = torch.rand((s, 3, 4), generator=gen, device=dev)
    rects = torch.stack([u[..., 0] * 560 + 40, u[..., 1] * 400 + 40,
                         u[..., 2] * 200 + 120, u[..., 3] * 200 + 120], -1)
    rects[1, 1] = float("nan")                       # a lost hand: zero crop
    rects[2, 0, :2] = torch.tensor([10.0, 470.0])    # mostly off the frame
    args = (frames, rects, sizes)
    kw = dict(dtype=torch.bfloat16, out_dtype=torch.bfloat16,
              scale=1.0 / 255.0, pack=2)
    got = wk.multi_crop(*args, **kw)
    want = wk.multi_crop_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    tol = 2.0 ** -8                 # one bf16 ulp at the crops' [0, 1) scale
    if not torch.equal(got[1][1], torch.zeros_like(got[1][1])):
        fail("multi_crop: NaN rect did not give a zero crop")
    log(f"K1 multi_crop {sizes} pack=2 bf16: max_abs_err {err:.3g} "
        f"(tol {tol:.3g})")
    if not err <= tol:
        fail("multi_crop disagrees with its plain version")
    # Yardstick: the same resample as dense matmuls, weights prepared
    # outside the timed call.
    dense = [(wk._weights(sz, 0, 1, sz, rects[:, c, 1], rects[:, c, 3], h,
                          torch.bfloat16).to(torch.bfloat16)[:, None],
              wk._weights(sz, 0, 1, sz, rects[:, c, 0], rects[:, c, 2], w,
                          torch.bfloat16).to(torch.bfloat16)[:, None]
              .transpose(-1, -2))
             for c, sz in enumerate(sizes)]
    fb = frames.to(torch.bfloat16)

    def library():
        return [torch.matmul(torch.matmul(wy, fb), wx) for wy, wx in dense]
    ms = time_ms(lambda: wk.multi_crop(*args, **kw))
    plain = time_ms(lambda: wk.multi_crop_plain(*args, **kw), reps=5)
    lib = time_ms(library)
    rows = _crop_spans(rects[..., 1], rects[..., 3], 256, h)
    cols = _crop_spans(rects[..., 0], rects[..., 2], 256, w)
    out_elems = sum(s * 3 * sz * sz for sz in sizes)
    nbytes = 3 * _union_pixels(rows, cols) + rects.numel() * 4 + 2 * out_elems
    b, by = bound_ms(nbytes, 12.0 * out_elems, F32_FLOPS)
    log(f"K1 times: kernel {ms:.4f} ms, plain {plain:.4f} ms, two matmuls "
        f"per crop {lib:.4f} ms, bound {b:.4f} ms ({by}; {nbytes} bytes)")
    return dict(name="multi_crop", route="cuda",
                source="bp_from_video_tpu_torch/csrc/multi_crop.cu",
                replaces="bp_from_video_tpu/pallas/warp_kernel.py:127",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b,
                bound_by=by, library_ms=lib)


def _dense_from_wmat(wmat, wspec, cin):
    """Packed [cout, K] window matrix -> the dense conv weight
    [cout, cin, 3, 3] it was packed from."""
    wm = wmat.float()
    wd = torch.zeros((wm.shape[0], cin, 3, 3), device=wm.device)
    pad = -(-4 * cin // 8) * 8
    for dy in range(3):
        for dx in range(3):
            if wspec == "sliced":
                off = (dy * 3 + dx) * cin
            else:
                off = ((dy // 2) * 2 + dx // 2) * pad + (
                    (dy % 2) * 2 + dx % 2) * cin
            wd[:, :, dy, dx] = wm[:, off:off + cin]
    return wd


def _unpack_s2d(x):
    b, c4, h, w = x.shape
    c = c4 // 4
    return x.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2).reshape(
        b, c, 2 * h, 2 * w)


def check_dense_s2_block(engine, gen, dev, s: int = 64):
    from bp_from_video_tpu_torch.kernels import block as bk
    runner, params = engine.runner, engine.params
    rows, errs = [], []
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0, flops=0)
    for key, bsz in (("flm_lm", s), ("hand_lm", 2 * s)):
        p, size = params[key], runner.sizes[key]
        x = torch.rand((bsz, 12, size // 2, size // 2), generator=gen,
                       device=dev).to(torch.bfloat16)
        layers = [("stem", p["stem_wmat"], runner._stem_wspec[key],
                   p["stem"]["b"], 3, False)]
        layers += [(f"b{i + 1}", blk["wmat"], spec, blk["b"], cin, True)
                   for i, (blk, (spec, cin)) in enumerate(
                       zip(p["trunk"], runner._trunk_specs[key]))]
        for name, wmat, spec, b, cin, resid in layers:
            if name != "stem":
                x = bk.pack_s2d(x).contiguous()

            def kern(x=x, wmat=wmat, spec=spec, b=b, cin=cin, resid=resid):
                return bk.dense_s2_block(x, wmat, spec, b, None, cin=cin,
                                         resid=resid)

            def plain(x=x, wmat=wmat, spec=spec, b=b, cin=cin, resid=resid):
                return bk.dense_s2_block_plain(x, wmat, spec, b, None,
                                               cin=cin, resid=resid)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = BF16_ULP * float(want.float().abs().max()) + 1e-6
            _, c4, h, w = x.shape
            cout = wmat.shape[0]
            wd = _dense_from_wmat(wmat, spec, cin).to(torch.bfloat16)
            bd = b.to(torch.bfloat16)
            xu = torch.nn.functional.pad(_unpack_s2d(x), (0, 1, 0, 1))

            def library(xu=xu, wd=wd, bd=bd):
                return torch.nn.functional.conv2d(xu, wd, bd, stride=2)
            ms, pl, lib = time_ms(kern), time_ms(plain, reps=5), \
                time_ms(library)
            nbytes = (x.numel() + got.numel()) * x.element_size() + \
                wmat.numel() * 2 + cout * 4
            flops = 2.0 * bsz * cout * 9 * cin * h * w
            bnd, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
            log(f"K3 {key}.{name} x{tuple(x.shape)} ({spec}, cout {cout}): "
                f"max_abs_err {err:.3g} (tol {tol:.3g}); kernel {ms:.4f} ms, "
                f"plain {pl:.4f} ms, conv2d {lib:.4f} ms, bound {bnd:.4f} ms "
                f"({by})")
            if not err <= tol:
                fail(f"dense_s2_block {key}.{name} disagrees with its plain "
                     "version")
            errs.append(err)
            tot["ms"] += ms
            tot["plain"] += pl
            tot["lib"] += lib
            tot["bytes"] += nbytes
            tot["flops"] += flops
            rows.append(name)
            x = want
    b, by = bound_ms(tot["bytes"], tot["flops"], BF16_TENSOR_FLOPS)
    log(f"K3 per step ({len(rows)} launches): kernel {tot['ms']:.4f} ms, "
        f"plain {tot['plain']:.4f} ms, conv2d {tot['lib']:.4f} ms, bound "
        f"{b:.4f} ms ({by})")
    return dict(name="dense_s2_block", route="cuda",
                source="bp_from_video_tpu_torch/csrc/dense_s2_block.cu",
                replaces="bp_from_video_tpu/pallas/block_kernel.py:180",
                max_abs_err=max(errs), ms=tot["ms"], plain_ms=tot["plain"],
                bound_ms=b, bound_by=by, library_ms=tot["lib"])


def check_roi_sums(gen, dev, s: int = 64):
    from bp_from_video_tpu_torch.kernels import roi as rk
    h, w = 480, 640
    frames = torch.full((s, 3, h, w), 255, dtype=torch.uint8, device=dev)
    frames[1:] = torch.randint(0, 256, (s - 1, 3, h, w), generator=gen,
                               device=dev, dtype=torch.uint8)
    u = torch.rand((s, 2, 4), generator=gen, device=dev)
    x0 = torch.floor(u[..., 0] * 560)
    y0 = torch.floor(u[..., 1] * 400)
    x1 = x0 + torch.floor(u[..., 2] * 60 + 10)
    y1 = y0 + torch.floor(u[..., 3] * 60 + 10)
    rois = torch.stack([x0, y0, x0, y0, x1, y1], -1)
    rois[0, 0] = torch.tensor([0.0, 0, 0, 0, w, h])  # full frame of 255s
    rois[2, 1] = torch.tensor([0.0, 0, -40, -30, -1, -2])   # wrap, clamp
    rois[3, 1] = torch.tensor([0.0, 0, 50, 50, 50, 80])     # empty
    weights = torch.rand((s, h, w), generator=gen, device=dev)
    out = {}
    for wt, rtol in ((None, 1e-6), (weights, 1e-5)):
        got, want = rk.roi_sums(frames, rois, wt), \
            rk.roi_sums_plain(frames, rois, wt)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ok = all(bool(((a - b).abs() <= rtol * b.abs() + 1e-6).all())
                 for a, b in zip(got, want))
        tag = "weighted" if wt is not None else "unweighted"
        log(f"K4 roi_sums {tag}: max_abs_err {err:.3g} (rtol {rtol:g}: f32 "
            f"sums past 2^24 round in another order)")
        if not ok:
            fail(f"roi_sums ({tag}) disagrees with its plain version")
        out[tag] = err
    # Main-path shapes: two ROIs of up to ~70x70 per stream, unweighted.
    main = rois.clone()
    main[0, 0] = rois[1, 0]
    main[2, 1], main[3, 1] = rois[1, 1], rois[4, 1]

    def library():
        return [frames[i, :, int(r[3]):int(r[5]), int(r[2]):int(r[4])]
                .sum((1, 2)) for i, rr in enumerate(main_host)
                for r in rr]
    main_host = main.cpu().tolist()
    ms = time_ms(lambda: rk.roi_sums(frames, main))
    plain = time_ms(lambda: rk.roi_sums_plain(frames, main))
    lib = time_ms(library, reps=5)
    g = torch.arange(h, device=dev)
    rows = (g >= main[..., 3, None]) & (g < main[..., 5, None])
    g = torch.arange(w, device=dev)
    cols = (g >= main[..., 2, None]) & (g < main[..., 4, None])
    npx = _union_pixels(rows, cols)
    nbytes = 3 * npx + main.numel() * 4 + s * 2 * 4 * 4
    b, by = bound_ms(nbytes, 3.0 * npx, F32_FLOPS)
    log(f"K4 times (unweighted, 2 ROIs/stream): kernel {ms:.4f} ms, plain "
        f"{plain:.4f} ms, slice sums {lib:.4f} ms, bound {b:.6f} ms ({by})")
    return dict(name="roi_sums", route="cuda",
                source="bp_from_video_tpu_torch/csrc/roi_sums.cu",
                replaces="bp_from_video_tpu/pallas/roi_kernel.py:114",
                max_abs_err=max(out.values()), ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=lib)


# -- phases 3 and 4: the engine ------------------------------------------------


def counters():
    from bp_from_video_tpu_torch.kernels import block, roi, warp
    return {"multi_crop": warp.multi_crop, "dense_s2_block":
            block.dense_s2_block, "roi_sums": roi.roi_sums}


def run_clip(engine, params, state, clip, t0: int = 0):
    out = None
    s = clip.shape[1]
    for i in range(clip.shape[0]):
        ts = torch.full((s,), (t0 + i + 1) / 30.0, dtype=torch.float32,
                        device=engine.device)
        state, out = engine.batch_step(params, state, clip[i], ts)
    return state, out


def flagship(steps: int, dev, profile_dir: str | None, card: str,
             streams: int = 64):
    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.runtime.engine import Engine
    cfg = flagship_config(streams)
    s, h, w = cfg.num_streams, cfg.frame_height, cfg.frame_width
    engine = Engine(cfg)
    params = template_heads(engine.params)
    tracked = torch.arange(s, device=dev) < s // 2
    state = tracked_state(engine, h, w, tracked)
    t = time.perf_counter()
    clip = pulse_clip(steps, s, h, w, split=300, seed=3, device=dev)
    torch.cuda.synchronize()
    log(f"flagship clip {tuple(clip.shape)} made on the card in "
        f"{time.perf_counter() - t:.2f} s")
    warm = 10
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = run_clip(engine, params, state, clip[:warm])
    torch.cuda.synchronize()
    t_mid = time.perf_counter()
    state, out = run_clip(engine, params, state, clip[warm:], t0=warm)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: fn.launches for k, fn in counters().items()}
    want = {"multi_crop": steps, "dense_s2_block": 10 * steps,
            "roi_sums": steps}
    log(f"flagship launches over {steps} steps: {launches} (expected "
        f"{want})")
    if launches != want:
        fail("a kernel of the main path was not launched once per step as "
             "expected")
    sps = (steps - warm) / (t_end - t_mid)
    log(f"flagship S={s} {h}x{w} bf16 on {card}: first {warm} steps "
        f"{t_mid - t:.3f} s; steady {sps:.3f} steps/s = {sps * s:.1f} "
        f"frames/s ({1e3 / sps:.3f} ms/step, host clock, synchronized)")
    bpm, ptt = out.bpm.float().cpu(), out.ptt.float().cpu()
    n_fin = int(torch.isfinite(bpm).all(-1).sum())
    tr = tracked.cpu()
    if not (bool(torch.isfinite(bpm[tr]).all())
            and bool(torch.isfinite(ptt[tr]).all())):
        fail("flagship: BPM/PTT not finite on the tracked streams")
    # The clip pulses at 72 BPM, the palm 3 frames (100 ms) after the face.
    if not bool(((bpm[tr] - 72).abs() <= 6).all()):
        fail(f"flagship: BPM {bpm[tr].tolist()} not near 72")
    if not bool(((ptt[tr] + 100).abs() <= 1000.0 / 30.0).all()):
        fail(f"flagship: PTT {ptt[tr].tolist()} not near -100 ms")
    if tuple(out.proc_y.shape) != (s, 2, cfg.signal.signal_max_samples):
        fail(f"flagship: proc_y shape {tuple(out.proc_y.shape)}")
    log(f"flagship outputs on tracked streams: BPM "
        f"{sorted(set(bpm[tr].flatten().tolist()))}, PTT ms "
        f"{sorted(set(ptt[tr].flatten().tolist()))}; streams with finite "
        f"BPM {n_fin}/{s}; tracking face "
        f"{int(state.track.face_tracking.sum())}/{s}")
    if profile_dir:
        profile(engine, params, state, clip[:9], steps, profile_dir)
    del clip
    return launches


def profile(engine, params, state, clip, t0, out_dir):
    """Trace ``clip`` through the engine: device time by kernel (and copy),
    the device's busy share of the wall time, and the host sync points of
    one more step (CUDA sync debug mode)."""
    import collections
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof
    os.makedirs(out_dir, exist_ok=True)
    n = clip.shape[0] - 1
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t = time.perf_counter()
        state, _ = run_clip(engine, params, state, clip[:n], t0=t0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    p.export_chrome_trace(os.path.join(out_dir, "flagship_trace.json"))
    evs = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
    evs.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    launches = sum(e.count for e in evs) / n
    log(f"profile: {n} steps, wall {wall * 1e3:.3f} ms (profiled), device "
        f"time {busy * 1e3:.3f} ms, busy share {busy / wall:.4f}, "
        f"{launches:.1f} kernels and copies per step")
    for e in evs[:20]:
        log(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/step "
            f"x{e.count / n:6.1f}  {e.key[:100]}")
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_clip(engine, params, state, clip[n:], t0=t0 + n)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    here = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    log(f"host syncs in one step: {sum(sites.values())} {dict(sites)}")


def card_vs_cpu(steps: int, dev):
    from bp_from_video_tpu_torch.config import (EngineConfig,
                                                InferenceConfig)
    from bp_from_video_tpu_torch.runtime.engine import Engine
    s, h, w = 2, 96, 128
    cfg = EngineConfig(frame_height=h, frame_width=w, num_streams=s,
                       compute_dtype="float32",
                       inference=InferenceConfig(use_pallas=True,
                                                 fused_stem=True,
                                                 fused_trunk=True))
    outs = {}
    clip = pulse_clip(steps, s, h, w, split=60, seed=4, device=dev)
    for where in ("cuda", "cpu"):
        eng = Engine(cfg, device=where)
        params = template_heads(eng.params)
        st = tracked_state(eng, h, w, torch.ones(s, dtype=torch.bool,
                                                 device=eng.device))
        t = time.perf_counter()
        _, outs[where] = run_clip(eng, params, st, clip.to(where))
        log(f"small f32 S={s} {h}x{w} on {where}: {steps} steps in "
            f"{time.perf_counter() - t:.2f} s")
    a, b = outs["cuda"], outs["cpu"]
    bpm_a, bpm_b = a.bpm.cpu(), b.bpm
    ptt_a, ptt_b = a.ptt.cpu(), b.ptt
    log(f"card vs CPU: BPM {bpm_a.tolist()} / {bpm_b.tolist()}; PTT ms "
        f"{ptt_a.tolist()} / {ptt_b.tolist()}")
    if not (bool(torch.isfinite(bpm_a).all())
            and torch.equal(bpm_a, bpm_b)):
        fail("card and CPU BPM differ")
    if not bool(((ptt_a - ptt_b).abs() <= 1000.0 / 30.0).all()):
        fail("card and CPU PTT differ by more than one sample period")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None,
                    help="directory for a torch.profiler trace of the "
                    "flagship step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA card (torch.cuda.is_available() is false)")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from bp_from_video_tpu_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    t = time.perf_counter()
    secs = build.build_all()
    log(f"phase 1: built {list(secs)} in {time.perf_counter() - t:.2f} s")
    for name in build.SOURCES:
        build.load(name)
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.runtime.engine import Engine
    gen = torch.Generator(device=dev).manual_seed(0)
    kernels = [check_multi_crop(gen, dev),
               check_dense_s2_block(Engine(flagship_config()), gen, dev),
               check_roi_sums(gen, dev)]
    log("phase 2: every kernel agrees with its plain version")
    torch.cuda.empty_cache()

    launches = flagship(STEPS, dev, args.profile, card)
    log("phase 3: flagship engine ran through every kernel")
    torch.cuda.empty_cache()

    card_vs_cpu(STEPS, dev)
    log("phase 4: card and CPU agree")

    for k in kernels:
        k["launches"] = launches[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: d[k] for k in keys} for d in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
