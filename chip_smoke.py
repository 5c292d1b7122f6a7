"""Drive the PyTorch + CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--profile DIR]

Phases (each fatal on failure):

1. build the hand-written CUDA kernels from ``bp_from_video_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold each of the six kernels against its plain PyTorch version on the
   card at the flagship shapes (64 streams of 480x640, bf16; K3 at its 11
   launch shapes; K5/K6 at all seven face-mesh stage shapes, K6 also at
   3l's batch of 8; both SASS checked for tensor-core HMMA instructions;
   K4 through both its entries, at the flagship ROI sizes, also weighted
   by the segmenter's skin view read in place), and time the kernel, the
   plain version and a PyTorch yardstick with CUDA events;
3. run the flagship ``Engine.batch_step`` (``flagship_config()``) over a
   synthetic pulsing clip long enough to fill the 250-sample ring, with the
   kernels' launch counters set to 0 just before and read just after:
   (3) with stand-in landmark nets; (3b) with the face landmark net a
   compiled TFLite graph (``compile_graph(face_mesh_graph(seed))``: its
   128x128 stage is one K6 launch); (3c) the same with ``fused_trunk`` off
   (both stems through K2), then a few steps with every stage fused
   (``fused_bn_min_hw=0``: 7 K6 launches); (3d) a mesh graph whose first
   stage has one unit, which compiles to a lone fused unit (K5), against
   the same graph compiled unfused; (3e) the ``butter_welch_face`` preset
   (``preset_config``: face net alone, eyebrow ROI, Butterworth then
   Welch) and (3f) the ``segmenter_fir`` preset (the trained segmenter
   stand-in, K4 weighted by its skin confidence, cubic interpolation,
   linear detrend, least-squares FIR, Lomb-Scargle), both at 64 streams of
   480x640 bf16, 3e on the same clip, 3f on one whose frames are person
   scenes (``person_scene``) pulsing the same way, so that the segmenter
   finds skin in every forehead ROI; (3g) ``dual_roi_ls`` (CHROM_GREEN
   sampling) and (3h) ``ptt_filtered`` (a 5-deep ROI filter), 64 streams
   on the texture clip; (3i) ``multistream`` (all four models: the
   standalone face detector on every frame, both landmarkers, the
   segmenter weighting both ROIs) at 8 streams on the person scenes, each
   step followed by ``Drawer.compose`` of all 8 streams, then one
   headless ``present``; (3j) the same through ``batch_step_lagged`` in
   windows of 4 frames, composing stream 0 alone (the display point);
   (3k) the rotation modes at the flagship scale (``rotation_modes``): the
   track pinned to a centered square at 0 or 25 degrees, ``cover``, then
   ``hybrid`` upright (K1 alone), with every stream tilted (the
   whole-batch shear), with stream 0 alone tilted (the shear sub-batch),
   ``shear`` and ``exact``: each path's host clock, CUDA-event time,
   launches and host syncs a step and BPM; hybrid upright equal to cover,
   the sub-batch's tilted stream (crops within a bf16 ulp) and untouched
   streams, the whole-batch shear within a mean 3 px of ``shear``; and the
   shear crop (cuFFT and DFT matmuls), one shear pass, the exact gather
   and the BP head timed alone; (3l) ``multistream`` at 8 streams of
   person scenes with every net compiled that the repo has a graph for
   (``compiled_graphs``: numpy-built face and palm detectors, the face
   mesh, the segmenter; the hand net a stand-in), every stream composed,
   130 steps, then 20 with ``fuse_dw_pw`` and ``pack_s2d=64``: each
   compiled net ran, K1/K3/K4 (weighted)/K6 a step, host syncs, the
   segmenter's confidences summing to 1, the face ROI's BPM; (3m) the
   flagship with the fused stem and trunk off, ``fuse_dw_pw`` and
   ``pack_s2d=64``, 130 steps with stand-ins (K1 packs their crops for the
   packed stem twins) and with the compiled mesh taking packed crops, then
   both unpacked as a control, and each landmark net's device time alone,
   packed and unpacked (3l and 3m also log BPM at step 60, not held);
4. run a small f32 config on the card and on the CPU (plain versions) over
   the same clips, with stand-ins, with a compiled face graph, with both
   earlier presets, with ``multistream`` (plain and lagged, composed),
   through ``exact``, ``shear`` and ``hybrid`` (upright, whole-batch and
   sub-batch) with the track pinned, on 3m's packed paths (landmarks
   within 1 px) and with 3l's compiled nets (the face detectors firing on
   one anchor, a reduced mesh: boxes and landmarks within 1 px every step,
   segmenter confidences within 1e-4 but where the bf16 upsample rounds):
   BPM equal (from row 10 on the rotation runs), PTT within one sample
   period, landmarks within 1 px, composed images within the renderer's
   tolerance; the FIR taps designed on the card beside those designed on
   the CPU;
5. the host runtime on the card, through the normal entry points: 8 MJPG
   files of 260 person scenes at 480x640 written with ``cv2.VideoWriter``
   (the run fails if it does not open one), then ``cli.main`` in this
   process with ``--preset multistream --dtype bfloat16 --device cuda
   --headless`` (the CLI's own config: the kernels on, the fused stem and
   trunk off): (5a) ``--offline``, (5b) ``--offline --micro-batch 4``, (5c)
   ``--pipelined --max-frames 120``, (5d) the sequential driver on one
   file for 120 frames; each logs its host clock, frames/s, every kernel's
   launches (K1 and K4 must launch once a step), the tracked count, the
   BPM it read and (5c) the frames the feeder dropped.  BPM is not held:
   the entry points start untracked, with the random-init face net.
   (5e) ``process_videos`` of two files at 96x128 f32, plain and with
   micro-batch 4, on the card and on the CPU, its engine with template
   heads and a tracked start as in phase 4: BPM equal, PTT within one
   sample period, ``curr_fs`` equal.
6. the BP head: (6a) ``models/bp_e2e_predictor.npz`` through
   ``Drawer.present`` on the vitals of a composed 3k step, against numpy;
   (6b) ``bp_from_video_tpu_torch.train`` ``main`` with ``--synthetic
   4096``: 500 steps on the card (held-out MAE under 5 mmHg, the head
   exported), 250 + 250 resumed equal to it, the first 20 losses equal to
   the CPU's at rtol 1e-4; (6c) 5a runs with ``--bp`` set to that head and
   must report mmHg for every stream; (6d) ``make_e2e_train_step`` over
   the flagship engine (64 streams) for 30 steps after 10: the engine's
   BPM and PTT equal to an inference-only run's, losses finite, K1, K3
   and K4 launched every step.  6a and 6d run after 3k, 6b before 5.
7. several ranks, after 5 (``parallel``): (7a) a world of one rank over
   NCCL (``distributed.global_mesh({"dp": 1, "tp": 1})``): the flagship
   through ``MultiStreamEngine(mesh=...)`` for 130 steps, its state and
   outputs equal to ``mesh=None`` bit for bit, K1/K3/K4 1/10/1 a step,
   BPM 72; ``run_clip`` and ``run_clip_lagged`` (F = 4) equal; 6d's e2e
   step over the mesh equal to 6d's (rtol 1e-6); (7b) two ranks sharing
   the card over gloo, started by ``parallel.dryrun.spawn``: dp = 2, 32
   streams a rank, each rank's launches and host clock a step, its
   outputs and state equal to a 32-stream engine run here on its half,
   the gathered outputs in stream order, BPM 72, and one e2e step over
   dp = 2 within rtol 1e-5 of the unsharded head step.

Prints the card's name and power limit first, one JSON line with every
kernel's numbers before the last line, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card.
``--profile DIR`` also traces a few steps of phases 3, 3b and 3e-3j with
``torch.profiler`` (kernel time by name, device busy share; on 3i and 3j
the compose's share of device time) and writes the traces to DIR.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
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
# Steps of phase 4's card-against-CPU runs.
PHASE4_STEPS = 130
# The BASELINE presets this port runs end to end on the card: phases 3e,
# 3f, 3g and 3h (and 4 for the first two); ``multistream`` in 3i and 3j.
PRESETS = ("butter_welch_face", "segmenter_fir", "dual_roi_ls",
           "ptt_filtered", "multistream")
# Frames a stream per lagged step (phase 3j, the JAX bench's
# ``multistream_mb4``).
LAGGED = 4


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


def ptxas_entries(name: str) -> list[str]:
    """One line per kernel entry of a built source: its registers, static
    shared bytes and spills, from the ``ptxas -v`` log of the build."""
    import re
    from bp_from_video_tpu_torch.kernels import build
    out, fn = [], None
    for line in build.ptxas_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line and fn:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{fn}: {regs} registers, "
                       f"{smem.group(1) if smem else 0} bytes static shared, "
                       f"{spill}")
            fn = None
    return out


def fp32_floor_ms(n_instr: float) -> float:
    """Time for the card's FP32 lanes (128 an SM) to execute ``n_instr``
    single-lane instructions at the card's highest SM clock."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_instr / (sms * 128 * float(mhz.stdout.split()[0]) * 1e6) * 1e3


# -- synthetic clip and template heads ------------------------------------------


def person_scene(s: int, h: int, w: int, gen, device) -> torch.Tensor:
    """f32 [S, 3, H, W] in 0..255: a frontal upper-body scene of the kind
    the segmenter stand-in was trained on (``tools/train_seg_standin.py``
    ``render_person``), one a stream: a skin face ellipse on the face box
    that ``tracked_state`` locks on, hair behind it, a neck and clothes
    below, over a grey background with a vertical ramp and static noise;
    skin, hair and clothes colours, background level and shading period
    drawn per stream.  The face ellipse, seen by the segmenter at 256x256,
    is as large as the largest in its training (half-widths 0.2 and 0.29
    of the frame), so the forehead ROI lies well inside it."""
    k = h / 96.0

    def u(lo, hi, c=1):                     # [S, c, 1, 1]
        return lo + (hi - lo) * torch.rand((s, c, 1, 1), generator=gen,
                                           device=device)
    yf = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xf = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    cx, cy, rx, ry = 64 * k, 36 * k, 25 * k, 27 * k

    def ellipse(x0, y0, ax, ay):
        return ((xf - x0) / ax) ** 2 + ((yf - y0) / ay) ** 2 <= 1.0
    face = ellipse(cx, cy, rx, ry)
    hair = ellipse(cx, cy - 0.30 * ry, 1.22 * rx, 1.12 * ry)
    neck = ((xf - cx).abs() < 0.45 * rx) & (yf > cy) & (yf < cy + 1.9 * ry)
    torso = ellipse(cx, cy + 2.6 * ry, 2.6 * rx, 2.1 * ry)
    skin = (torch.tensor([205.0, 170.0, 140.0], device=device)[:, None, None]
            + u(-40.0, 40.0, 3))
    img = (u(40.0, 200.0) + 0.15 * yf / h * 60.0
           + torch.randn((s, 1, h, w), generator=gen, device=device) * 6.0)
    img = img.expand(s, 3, h, w)
    shade = 1.0 + 0.12 * torch.sin(yf / u(25.0, 70.0))
    for mask, col in ((torso, u(30.0, 220.0, 3)), (neck, skin),
                      (hair, u(20.0, 90.0, 3)), (face, skin)):
        img = torch.where(mask, col * shade, img)
    return img + torch.randn((s, 3, h, w), generator=gen,
                             device=device) * 3.0


def pulse_clip(steps: int, s: int, h: int, w: int, split: int, seed: int,
               device, hz: float = 1.2, delay_frames: int = 3,
               person: bool = False) -> torch.Tensor:
    """uint8 [steps, S, 3, H, W] made on ``device`` from a seeded generator:
    8x8-block texture (with ``person``, a ``person_scene``) whose green
    channel pulses at ``hz`` (rows < split in phase, rows >= split
    ``delay_frames`` later), plus pixel noise."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if person:
        base = person_scene(s, h, w, gen, device)
    else:
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


def _template_points() -> dict:
    """Fixed landmark places in normalized crop coordinates.  Face: a grid
    over the middle 2/3 of the crop, eye corners level; hand: wrist low,
    middle-finger knuckle high."""
    rng = np.random.default_rng(11)
    out = {}
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
        out[key] = pts
    return out


def template_heads(params: dict, keys=("flm_lm", "hand_lm")) -> dict:
    """Stand-in landmark heads that put every landmark at a fixed place in
    its crop (zero readout weights, the place in the bias) and report
    presence, so the trackers hold still on the synthetic clip."""
    for key in keys:
        pts = _template_points()[key]
        p = params[key]
        p["head_lm"]["w"] = torch.zeros_like(p["head_lm"]["w"])
        p["head_lm"]["b"] = torch.from_numpy(_logit(pts.reshape(-1))).to(
            p["head_lm"]["b"])
        p["head_presence"]["w"] = torch.zeros_like(p["head_presence"]["w"])
        p["head_presence"]["b"] = torch.full_like(p["head_presence"]["b"],
                                                  8.0)
    return params


def template_mesh(graph):
    """The same for a face-mesh ``Graph`` (edited in place, returned): its
    landmark conv gets zero weights and the template in crop pixels as
    bias, its presence logit 8.  The trunk still runs at full width; only
    the readout ignores it."""
    prod = {t: op for op in graph.ops for t in op.outputs}
    size = graph.tensors[graph.inputs[0]].shape[1]
    lm = prod[graph.outputs[0]]
    logit = prod[prod[graph.outputs[1]].inputs[0]]
    pts = _template_points()["flm_lm"] * size
    for op, bias in ((lm, pts.reshape(-1)), (logit, [8.0])):
        w, b = graph.tensors[op.inputs[1]], graph.tensors[op.inputs[2]]
        w.data = np.zeros_like(w.data)
        b.data = np.asarray(bias, np.float32)
    return graph


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
    for sz in sorted(set(sizes), reverse=True):
        pick = [c for c, z in enumerate(sizes) if z == sz]
        sub = (frames, rects[:, pick].contiguous(), (sz,) * len(pick))
        log(f"K1 {len(pick)} crop(s) of {sz} alone: kernel "
            f"{time_ms(lambda: wk.multi_crop(*sub, **kw)):.4f} ms")
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


def _k3_launch(tag, x, wmat, spec, b, alpha, cin, resid):
    """One K3 launch held against its plain version and timed beside
    ``F.conv2d`` of the composed dense conv; returns its numbers and the
    plain version's output."""
    from bp_from_video_tpu_torch.kernels import block as bk
    from bp_from_video_tpu_torch.kernels import warp as wk
    args = (x, wmat, spec, b, alpha)

    def kern():
        return bk.dense_s2_block(*args, cin=cin, resid=resid)

    def plain():
        return bk.dense_s2_block_plain(*args, cin=cin, resid=resid)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = BF16_ULP * float(want.float().abs().max()) + 1e-6
    bsz, c4, h, w = x.shape
    cout = wmat.shape[0]
    wd = _dense_from_wmat(wmat, spec, cin).to(torch.bfloat16)
    bd = b.to(torch.bfloat16)
    xu = torch.nn.functional.pad(wk.unpack_s2d(x), (0, 1, 0, 1))

    def library():
        return torch.nn.functional.conv2d(xu, wd, bd, stride=2)
    ms, pl, lib = time_ms(kern), time_ms(plain, reps=5), time_ms(library)
    nbytes = (x.numel() + got.numel()) * x.element_size() + \
        wmat.numel() * 2 + cout * 4 * (1 if alpha is None else 2)
    flops = 2.0 * bsz * cout * 9 * cin * h * w
    bnd, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
    plan = bk.block_plan(bsz, h, w, cin, cout, spec)
    log(f"K3 {tag} x{tuple(x.shape)} ({spec}, cout {cout}): max_abs_err "
        f"{err:.3g} (tol {tol:.3g}); kernel {ms:.4f} ms, plain {pl:.4f} ms, "
        f"conv2d {lib:.4f} ms, bound {bnd:.4f} ms ({by}), share of bound "
        f"{bnd / ms:.3f}; plan rows {plan.rows} x {plan.bands} bands, "
        f"{plan.m_tiles} M-tiles of {16 * plan.mf}, {plan.warps} warps, "
        f"{plan.smem} B shared")
    if not err <= tol:
        fail(f"dense_s2_block {tag} disagrees with its plain version")
    return dict(err=err, ms=ms, plain=pl, lib=lib, bytes=nbytes,
                flops=flops), want


def sass_hmma(name: str) -> int:
    """HMMA (tensor-core) instructions in a built kernel library's SASS,
    read with ``cuobjdump -sass`` (the toolkit's, else Triton's copy)."""
    from bp_from_video_tpu_torch.kernels import build
    tool = [os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")]
    try:
        import triton
        tool.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                 "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    exe = next((t for t in tool if os.path.exists(t)), None)
    if exe is None:
        fail("cuobjdump not found")
    sass = subprocess.run([exe, "-sass", build.lib_path(name)],
                          capture_output=True, text=True, check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def check_dense_s2_block(engine, gen, dev, s: int = 64):
    """K3 at its 11 flagship launch shapes: the stand-in face (B = 64) and
    hand (B = 128) nets' stems and four blocks, and the compiled face
    mesh's stem (cout 16, PReLU; seeded weights of its shape).  The per
    step numbers are the stand-in path's 10 launches."""
    from bp_from_video_tpu_torch.kernels import block as bk
    runner, params = engine.runner, engine.params
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0, flops=0)
    errs = []
    for key, bsz in (("flm_lm", s), ("hand_lm", 2 * s)):
        p, size = params[key], runner.sizes[key]
        x = torch.rand((bsz, 12, size // 2, size // 2), generator=gen,
                       device=dev).to(torch.bfloat16)
        layers = [("stem", p["stem_wmat"], runner._stem_src[key]["wspec"],
                   p["stem"]["b"], 3, False)]
        layers += [(f"b{i + 1}", blk["wmat"], spec, blk["b"], cin, True)
                   for i, (blk, (spec, cin)) in enumerate(
                       zip(p["trunk"], runner._trunk_specs[key]))]
        for name, wmat, spec, b, cin, resid in layers:
            if name != "stem":
                x = bk.pack_s2d(x).contiguous()
            r, x = _k3_launch(f"{key}.{name}", x, wmat, spec, b, None, cin,
                              resid)
            errs.append(r["err"])
            for k in tot:
                tot[k] += r[k]
    rng = np.random.default_rng(16)
    wmat, spec = bk.pack_block_weights(
        rng.standard_normal((3, 3, 3, 16)) * (2.0 / 27) ** 0.5, cin=3)
    x = torch.rand((s, 12, 128, 128), generator=gen, device=dev).to(
        torch.bfloat16)
    mesh, _ = _k3_launch(
        "mesh stem (PReLU)", x,
        torch.from_numpy(wmat).to(dev).to(torch.bfloat16), spec,
        torch.from_numpy(rng.uniform(-0.1, 0.1, 16)).float().to(dev),
        torch.from_numpy(rng.uniform(0.05, 0.3, 16)).float().to(dev), 3,
        False)
    errs.append(mesh["err"])
    b, by = bound_ms(tot["bytes"], tot["flops"], BF16_TENSOR_FLOPS)
    log(f"K3 per step, stand-in path (10 launches): kernel {tot['ms']:.4f} "
        f"ms, plain {tot['plain']:.4f} ms, conv2d {tot['lib']:.4f} ms, bound "
        f"{b:.4f} ms ({by}), share of bound {b / tot['ms']:.3f}")
    hmma = sass_hmma("dense_s2_block")
    log(f"K3 SASS: {hmma} HMMA instructions (cuobjdump -sass)")
    if hmma == 0:
        fail("dense_s2_block: no tensor-core (HMMA) instruction in its SASS")
    return dict(name="dense_s2_block", route="cuda",
                source="bp_from_video_tpu_torch/csrc/dense_s2_block.cu",
                replaces="bp_from_video_tpu/pallas/block_kernel.py:180",
                max_abs_err=max(errs), ms=tot["ms"], plain_ms=tot["plain"],
                bound_ms=b, bound_by=by, library_ms=tot["lib"])


def _roi_terms(frames, rois, weights, channel):
    """The plain version's sums [S, R, 3] of ``rois`` (non-finite rows as
    empty rects) and the magnitude of the terms the sample mixes from their
    means [S, R]: a sample's rounding is set against it."""
    from bp_from_video_tpu_torch.kernels import roi as rk
    safe = torch.where(torch.isfinite(rois).all(-1, keepdim=True),
                       torch.nan_to_num(rois), 0.0)
    sums, den = rk.roi_sums_plain(frames, safe, weights)
    m = sums / torch.where(den > 0, den, 1.0)[..., None]
    m = m.abs()
    if channel.name == "GREEN":
        return sums, m[..., 1]
    return sums, m[..., 1] / 2 + m[..., 2] / 4 + m[..., 0] / 4


def check_roi(gen, dev, s: int = 64):
    """K4's two entries: ``roi_sums`` on random rects (the full frame of
    255s among them), and ``roi_samples`` (the main path's entry) on those
    and on the flagship ROI sizes with lost rows, both channels, weighted
    and not, against their plain versions; then both timed at the flagship
    ROI sizes and on the random rects."""
    from bp_from_video_tpu_torch.config import SignalColorChannel
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
        out[f"roi_sums {tag}"] = err
    # The flagship ROI sizes: a 56x42 forehead and a 40x40 palm per stream
    # (0.20 x 0.15 of a 280-pixel face box; the palm config) at random
    # places, every residue of x0 and x1 modulo 4 among them.
    size = torch.tensor([[56.0, 42.0], [40.0, 40.0]], device=dev)
    room = torch.tensor([w, h], device=dev) - size
    lo = torch.floor(torch.rand((s, 2, 2), generator=gen, device=dev) * room)
    flag = torch.cat([lo + size // 2, lo, lo + size], -1)      # [S, 2, 6]
    lost = flag.clone()
    lost[5, 0] = float("nan")                       # a lost face
    lost[6, 1, 0] = float("nan")                    # one non-finite entry
    lost[7, 1, 4] = float("inf")
    def hold_samples(tag, rr, ch, wt):
        got = rk.roi_samples(frames, rr, ch, wt)
        want = rk.roi_samples_plain(frames, rr, ch, wt)
        sums, terms = _roi_terms(frames, rr, wt, ch)
        torch.cuda.synchronize()
        # Bit-equal below 2^24 unweighted; past it, and weighted, each mean
        # to the sums' rtol.
        rtol = (torch.where(sums.amax(-1) >= 2 ** 24, 1e-6, 0.0)
                if wt is None else 1e-5)
        nan = torch.isnan(want)
        d = (got.masked_fill(nan, 0) - want.masked_fill(nan, 0)).abs()
        ok = (torch.equal(torch.isnan(got), nan)
              and bool((d <= rtol * terms.masked_fill(nan, 0)).all()))
        log(f"K4 roi_samples {tag}: max_abs_err {float(d.max()):.3g}, NaN "
            f"rows {int(nan.sum())} (bit-equal below 2^24 unweighted; rtol "
            f"of the mixed means past it 1e-6, weighted 1e-5)")
        if not ok:
            fail(f"roi_samples ({tag}) disagrees with its plain version")
        out[f"roi_samples {tag}"] = float(d.max())

    for name, rr in (("flagship ROIs with lost rows", lost),
                     ("random rects", rois)):
        for wt in (None, weights):
            for ch in SignalColorChannel:
                hold_samples(f"{name}, {ch.name}, "
                             f"{'weighted' if wt is not None else 'unweighted'}",
                             rr, ch, wt)
    # The segmenter's skin view exactly as the engine passes it
    # (``skin_confidence`` of the full-mask confidences [S, 6, H, W]): a
    # channel view with stream stride 6 H W, read in place on the word
    # route, at the flagship ROI sizes.
    from bp_from_video_tpu_torch.models.runner import skin_confidence
    conf = torch.softmax(torch.randn((s, 6, h, w), generator=gen,
                                     device=dev), 1)
    skin = skin_confidence(conf)
    if not (rk.weights_in_place(skin) and rk.word_route(frames, skin)):
        fail("roi_samples: the skin view would be copied or take the byte "
             "route")
    for ch in SignalColorChannel:
        hold_samples(f"flagship ROIs with lost rows, {ch.name}, skin view "
                     f"(stride {skin.stride(0)})", lost, ch, skin)
    green = SignalColorChannel.GREEN

    def sums_then_epilogue(rr):
        """The main path's route before the sample entry: K4's sums and the
        caller's ten PyTorch kernels around them."""
        finite = torch.isfinite(rr).all(-1)
        safe = torch.where(finite[..., None], torch.nan_to_num(rr), 0.0)
        sums, den = rk.roi_sums(frames, safe.contiguous())
        means = sums / torch.where(den > 0, den, 1.0)[..., None]
        return torch.where(finite & (den > 0), rk.mix_channel(means, green),
                           float("nan"))

    def library(host_rois):
        return [frames[i, :, int(r[3]):int(r[5]), int(r[2]):int(r[4])]
                .sum((1, 2)) for i, row in enumerate(host_rois) for r in row]

    def bound(rr, ch, weighted):
        """The sample entry's bound on ``rr``: each ROI pixel of the planes
        the sample needs (green alone for GREEN, all three for CHROM_GREEN)
        and, weighted, its f32 weight read once, the ROIs read, the samples
        written; an add a plane and pixel, weighted a multiply and an add a
        plane and the weight sum's add."""
        g = torch.arange(h, device=dev)
        rows = (g >= rr[..., 3, None]) & (g < rr[..., 5, None])
        g = torch.arange(w, device=dev)
        cols = (g >= rr[..., 2, None]) & (g < rr[..., 4, None])
        npx = _union_pixels(rows, cols)
        planes = 1 if ch is green else 3
        nbytes = ((planes + 4 * weighted) * npx + rr.numel() * 4
                  + rr.shape[0] * rr.shape[1] * 4)
        ops = (2 * planes + 1 if weighted else planes) * npx
        return (*bound_ms(nbytes, ops, F32_FLOPS), nbytes)
    t = {}
    main = rois.clone()                  # PR 7's timing set: no 2^24 rect
    main[0, 0] = rois[1, 0]
    main[2, 1], main[3, 1] = rois[1, 1], rois[4, 1]
    for key, rr in (("flagship", flag), ("random", main)):
        host = rr.cpu().tolist()
        t[key] = dict(
            samples=time_ms(lambda: rk.roi_samples(frames, rr, green)),
            samples_plain=time_ms(
                lambda: rk.roi_samples_plain(frames, rr, green)),
            sums=time_ms(lambda: rk.roi_sums(frames, rr)),
            sums_plain=time_ms(lambda: rk.roi_sums_plain(frames, rr)),
            sums_then_epilogue=time_ms(lambda: sums_then_epilogue(rr)),
            library=time_ms(lambda: library(host), reps=5))
        t[key]["bound"], t[key]["by"], nbytes = bound(rr, green, False)
        log(f"K4 times ({key} ROIs, 2 a stream, unweighted, GREEN): "
            f"roi_samples {t[key]['samples']:.4f} ms (plain "
            f"{t[key]['samples_plain']:.4f}), roi_sums {t[key]['sums']:.4f} "
            f"ms (plain {t[key]['sums_plain']:.4f}), roi_sums + the ten-op "
            f"epilogue {t[key]['sums_then_epilogue']:.4f} ms, slice sums "
            f"{t[key]['library']:.4f} ms, bound {t[key]['bound']:.6f} ms "
            f"({t[key]['by']}; {nbytes} bytes)")
    f = t["flagship"]
    lost_all = torch.full_like(flag, float("nan"))
    log(f"K4 roi_samples with every ROI row lost (no pixel read): "
        f"{time_ms(lambda: rk.roi_samples(frames, lost_all, green)):.4f} ms")
    skin_ms = time_ms(lambda: rk.roi_samples(frames, flag, green, skin))
    skin_plain = time_ms(
        lambda: rk.roi_samples_plain(frames, flag, green, skin), reps=5)
    copy_ms = time_ms(lambda: rk.roi_samples(frames, flag, green,
                                             skin.contiguous()))
    sb, sby, _ = bound(flag, green, True)
    log(f"K4 roi_samples skin-weighted (flagship ROIs, GREEN, the view read "
        f"in place): {skin_ms:.4f} ms (plain {skin_plain:.4f}), with a "
        f"contiguous copy of the view first {copy_ms:.4f} ms, bound "
        f"{sb:.6f} ms ({sby})")
    return dict(name="roi_sums", route="cuda",
                source="bp_from_video_tpu_torch/csrc/roi_sums.cu",
                replaces="bp_from_video_tpu/pallas/roi_kernel.py:114",
                max_abs_err=max(out.values()), ms=f["samples"],
                plain_ms=f["samples_plain"], bound_ms=f["bound"],
                bound_by=f["by"], library_ms=f["library"],
                entries={"roi_samples": dict(ms=f["samples"],
                                             plain_ms=f["samples_plain"],
                                             weighted_ms=skin_ms,
                                             weighted_plain_ms=skin_plain,
                                             weighted_bound_ms=sb),
                         "roi_sums": dict(ms=f["sums"],
                                          plain_ms=f["sums_plain"])})


def check_stem_packed(gen, dev, s: int = 64):
    """K2 at the two flagship stem shapes: the face mesh's (64 crops of 256,
    16 channels, PReLU) and the hand stand-in's (128 crops of 224, 24
    channels, ReLU)."""
    from bp_from_video_tpu_torch.kernels import stem as sk
    from bp_from_video_tpu_torch.kernels import warp as wk
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0, flops=0, floor=0.0)
    errs = []
    for name, bsz, size, cout, prelu in (("face", s, 256, 16, True),
                                         ("hand", 2 * s, 224, 24, False)):
        half = size // 2
        crops = torch.rand((bsz, 12, half, half), generator=gen,
                           device=dev).to(torch.bfloat16)
        w = (torch.randn((3, 3, 3, cout), generator=gen, device=dev)
             * (2.0 / 27) ** 0.5).to(torch.bfloat16)
        b = torch.randn((cout,), generator=gen, device=dev) * 0.1
        alpha = (torch.rand((cout,), generator=gen, device=dev) * 0.3
                 if prelu else None)
        got = sk.stem_packed(crops, w, b, alpha)
        want = sk.stem_packed_plain(crops, w, b, alpha)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        # Both take the taps in one order with every multiply and add
        # rounded on its own: the tolerance is zero.
        log(f"K2 stem_packed {name} x{tuple(crops.shape)} cout {cout}: "
            f"max_abs_err {err:.3g} (tol 0: bit-equal)")
        if err != 0.0:
            fail(f"stem_packed ({name}) disagrees with its plain version")
        errs.append(err)
        wc = w.permute(3, 2, 0, 1).contiguous()
        xu = torch.nn.functional.pad(wk.unpack_s2d(crops), (0, 1, 0, 1))
        bc = b.to(torch.bfloat16)

        def library(xu=xu, wc=wc, bc=bc, alpha=alpha):
            y = torch.nn.functional.conv2d(xu, wc, bc, stride=2)
            return (torch.relu(y) if alpha is None else
                    torch.nn.functional.prelu(y, alpha.to(y.dtype)))
        ms = time_ms(lambda: sk.stem_packed(crops, w, b, alpha))
        pl = time_ms(lambda: sk.stem_packed_plain(crops, w, b, alpha),
                     reps=3, inner=2, warm=1)
        lib = time_ms(library)
        nbytes = (crops.numel() + got.numel()) * 2 + w.numel() * 2 + cout * 8
        flops = 2.0 * bsz * cout * 27 * half * half
        bnd, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
        # A bit-equal stem runs one FMUL and one FADD per tap and output.
        floor = fp32_floor_ms(flops)
        log(f"K2 {name} times: kernel {ms:.4f} ms, plain {pl:.4f} ms, "
            f"conv2d+act {lib:.4f} ms ({ms / lib:.3f}x), bound {bnd:.4f} ms "
            f"({by}), FP32 instruction floor {floor:.4f} ms")
        for k, v in (("ms", ms), ("plain", pl), ("lib", lib),
                     ("bytes", nbytes), ("flops", flops), ("floor", floor)):
            tot[k] += v
    b, by = bound_ms(tot["bytes"], tot["flops"], BF16_TENSOR_FLOPS)
    log(f"K2 per step (2 launches): kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain']:.4f} ms, conv2d+act {tot['lib']:.4f} ms, bound "
        f"{b:.4f} ms ({by}), FP32 instruction floor {tot['floor']:.4f} ms")
    return dict(name="stem_packed", route="cuda",
                source="bp_from_video_tpu_torch/csrc/stem_packed.cu",
                replaces="bp_from_video_tpu/pallas/stem_kernel.py:136",
                max_abs_err=max(errs), ms=tot["ms"], plain_ms=tot["plain"],
                bound_ms=b, bound_by=by, library_ms=tot["lib"])


# The face mesh's seven stages: (spatial size, C, D).
MESH_STAGES = ((128, 16, 8), (64, 32, 16), (32, 64, 32), (16, 128, 64),
               (8, 128, 64), (4, 128, 64), (2, 128, 64))


def _bn_operands(rng, units, c, d, cout, dev):
    """Stacked packed operands of ``units`` bottleneck units (bf16 weights,
    f32 biases and slopes) and their raw conv weights for the yardstick."""
    from bp_from_video_tpu_torch.kernels import bottleneck as bn
    raw = [(rng.standard_normal((1, 1, c, d)) / np.sqrt(c),
            rng.standard_normal((3, 3, 1, d)) / 3.0,
            rng.standard_normal((1, 1, d, cout)) * 0.25 / np.sqrt(d))
           for _ in range(units)]
    wds, wus = zip(*(bn.pack_bottleneck_weights(*r) for r in raw))

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev).to(dt)
    return (t(np.stack(wds), torch.bfloat16),
            t(rng.uniform(-0.1, 0.1, (units, d))),
            t(rng.uniform(0.05, 0.3, (units, d))),
            t(np.stack(wus), torch.bfloat16),
            t(rng.uniform(-0.1, 0.1, (units, cout))),
            t(rng.uniform(0.05, 0.3, (units, cout))))


def _bn_library(ops, last_act):
    """The unit as PyTorch library calls: 1x1 conv, PReLU, 3x3 conv of the
    composed weight, add, activation — per unit."""
    fn = torch.nn.functional
    wd, bd, ad, wu, bu, au = ops
    units, d, c = wd.shape
    cout = wu.shape[1]
    w1 = wd.reshape(units, d, c, 1, 1)
    w3 = wu.reshape(units, cout, 3, 3, d).permute(0, 1, 4, 2, 3).contiguous()
    bd, ad, bu, au = (v.to(torch.bfloat16) for v in (bd, ad, bu, au))

    def run(x, r=None):
        y = x
        for u in range(units):
            z = fn.prelu(fn.conv2d(y, w1[u], bd[u]), ad[u])
            z = fn.conv2d(z, w3[u], bu[u], padding=1) + (y if r is None
                                                         else r)
            y = (fn.prelu(z, au[u]) if last_act == "prelu" else
                 torch.relu(z) if last_act == "relu" else z)
        return y
    return run


def check_bottleneck(gen, dev, s: int = 64, stages=MESH_STAGES,
                     lone: bool = True):
    """K6 (four units, one kernel launch each) and, with ``lone``, K5 (also
    with C' != C and with relu / no last activation) at the face-mesh
    ``stages`` with B = ``s``, bf16: the tensor-core route, its SASS
    checked for HMMA instructions.  Returns the K5 row (None without
    ``lone``) and the K6 row."""
    from bp_from_video_tpu_torch.kernels import bottleneck as bn
    rng = np.random.default_rng(5)
    rows = {}
    kinds = (("bottleneck_chain", 4), ("bottleneck_s1", 1))
    for kern, units in kinds if lone else kinds[:1]:
        cases = [(hw, c, d, c, "prelu") for hw, c, d in stages]
        if units == 1:
            cases += [(128, 16, 8, 32, "prelu"), (64, 32, 16, 32, "relu"),
                      (32, 64, 32, 64, "none")]
        errs, main = [], None
        for hw, c, d, cout, act in cases:
            ops = _bn_operands(rng, units, c, d, cout, dev)
            x = torch.randn((s, c, hw, hw), generator=gen, device=dev).to(
                torch.bfloat16)
            r = x if cout == c else torch.randn(
                (s, cout, hw, hw), generator=gen, device=dev).to(
                    torch.bfloat16)
            if units == 1:
                one = [o[0] for o in ops]
                if act != "prelu":
                    one[5] = None

                def k(x=x, r=r, one=one, act=act):
                    return bn.bottleneck_s1(x, r, *one, last_act=act)

                def pl(x=x, r=r, one=one, act=act):
                    return bn.bottleneck_s1_plain(x, r, *one, last_act=act)
                lib_run = _bn_library(ops, act)

                def lib(x=x, r=r, lib_run=lib_run):
                    return lib_run(x, r)
            else:
                def k(x=x, ops=ops):
                    return bn.bottleneck_chain(x, *ops, last_act="prelu")

                def pl(x=x, ops=ops):
                    return bn.bottleneck_chain_plain(x, *ops,
                                                     last_act="prelu")
                lib_run = _bn_library(ops, "prelu")

                def lib(x=x, lib_run=lib_run):
                    return lib_run(x)
            got, want = k(), pl()
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            # f32 sums in another order, rounded to bf16: one bf16 ulp of
            # the output's largest value; in a chain a rounding that lands
            # on the neighbouring value is carried on, one ulp per unit.
            tol = units * BF16_ULP * float(want.float().abs().max()) + 1e-6
            ms = time_ms(k)
            pms = time_ms(pl, reps=3, inner=2, warm=1)
            lms = time_ms(lib)
            nbytes = ((x.numel() + got.numel()) * 2
                      + (0 if r is x else r.numel() * 2)
                      + sum(o.numel() * o.element_size() for o in ops))
            flops = 2.0 * units * s * hw * hw * (d * c + cout * 9 * d)
            bnd, by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
            p = bn.bottleneck_plan(s, hw, hw, c, d, cout)
            log(f"{'K6' if units > 1 else 'K5'} {kern} x{tuple(x.shape)} "
                f"D {d} C' {cout} U {units} {act}: max_abs_err {err:.3g} "
                f"(tol {tol:.3g}); kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                f"conv2d units {lms:.4f} ms, bound {bnd:.4f} ms ({by}); "
                f"plan G {p.g} x R {p.rows} x {p.cb} ch, "
                f"{p.groups * p.bands * p.nsplit} blocks of "
                f"{p.wm * p.wn} warps, {p.smem} B shared")
            if not err <= tol:
                fail(f"{kern} at {tuple(x.shape)} disagrees with its plain "
                     "version")
            errs.append(err)
            if main is None:        # the 128x128 stage: the main path's
                main = dict(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bnd,
                            bound_by=by)
        line = {"bottleneck_chain": 461, "bottleneck_s1": 350}[kern]
        if kern == "bottleneck_chain":
            hmma = sass_hmma("bottleneck")
            log(f"K5/K6 SASS: {hmma} HMMA instructions (cuobjdump -sass)")
            if hmma == 0:
                fail("bottleneck: no tensor-core (HMMA) instruction in its "
                     "SASS")
        rows[kern] = dict(
            name=kern, route="cuda",
            source="bp_from_video_tpu_torch/csrc/bottleneck.cu",
            replaces=f"bp_from_video_tpu/pallas/block_kernel.py:{line}",
            max_abs_err=max(errs), **main)
    return rows.get("bottleneck_s1"), rows["bottleneck_chain"]


# -- phases 3 and 4: the engine ------------------------------------------------


def counters():
    from bp_from_video_tpu_torch.kernels import (block, bottleneck, roi, stem,
                                                 warp)
    return {"multi_crop": warp.multi_crop, "stem_packed": stem.stem_packed,
            "dense_s2_block": block.dense_s2_block,
            "roi_sums": roi.roi_sums, "roi_samples": roi.roi_samples,
            "bottleneck_s1": bottleneck.bottleneck_s1,
            "bottleneck_chain": bottleneck.bottleneck_chain}


def zero_counters():
    for fn in counters().values():
        fn.launches = 0
    counters()["roi_samples"].weighted_launches = 0


def run_clip(engine, params, state, clip, t0: int = 0, render=None,
             lagged: int = 0):
    """Step ``engine`` over ``clip`` [T, S, ...] (frame ``t0 + i`` stamped
    (t0 + i + 1) / 30 s): ``batch_step`` a frame, or with ``lagged`` = F
    ``batch_step_lagged`` a window of F frames; ``render(frames, out)``,
    when given, after each step with its last frame of every stream."""
    out = None
    s = clip.shape[1]
    f = lagged or 1
    for i in range(0, clip.shape[0] - f + 1, f):
        ts = torch.stack([torch.full((s,), (t0 + i + j + 1) / 30.0,
                                     dtype=torch.float32,
                                     device=engine.device)
                          for j in range(f)])
        if lagged:
            state, out = engine.batch_step_lagged(params, state,
                                                  clip[i:i + f], ts)
        else:
            state, out = engine.batch_step(params, state, clip[i], ts[0])
        if render is not None:
            render(clip[i + f - 1], out)
    return state, out


# Launches per step of each path: K1 crops and K4 samples once (through its
# sample entry; its sums entry 0 times); on the flagship paths K3 runs the
# hand net's stem and four blocks, plus the face net's stem and, for the
# stand-in face net, its four blocks.
PER_STEP = {
    "standin": {"multi_crop": 1, "dense_s2_block": 10, "roi_samples": 1},
    # The presets run the face net alone: its stem and four blocks.  K4
    # samples weighted by the skin confidence where the segmenter runs.
    "butter_welch_face": {"multi_crop": 1, "dense_s2_block": 5,
                          "roi_samples": 1},
    "segmenter_fir": {"multi_crop": 1, "dense_s2_block": 5,
                      "roi_samples": 1},
    # Both landmarkers, as the flagship.  The lagged step crops every frame
    # of its window in one K1 launch, runs each net once at batch F*S, and
    # samples the window's frames in one K4 launch (each (stream, ROI)
    # block sums alone, so it is bit-equal to F launches): the counts are
    # per window.
    "dual_roi_ls": {"multi_crop": 1, "dense_s2_block": 10, "roi_samples": 1},
    "ptt_filtered": {"multi_crop": 1, "dense_s2_block": 10,
                     "roi_samples": 1},
    "multistream": {"multi_crop": 1, "dense_s2_block": 10, "roi_samples": 1},
    "multistream, lagged": {"multi_crop": 1, "dense_s2_block": 10,
                            "roi_samples": 1},
    "mesh": {"multi_crop": 1, "dense_s2_block": 6, "roi_samples": 1,
             "bottleneck_chain": 1},
    "mesh, fused_trunk off": {"multi_crop": 1, "stem_packed": 2,
                              "roi_samples": 1},
    "mesh, every stage fused": {"multi_crop": 1, "dense_s2_block": 6,
                                "roi_samples": 1, "bottleneck_chain": 7},
    # 3l: ``multistream`` with every net compiled but the hand net (a
    # stand-in): K3 runs the hand net's stem and blocks and the mesh's
    # split-off stem, K6 the mesh's 128x128 stage; the detectors and the
    # segmenter are plain convolutions.  The graph passes leave the
    # kernels as they are.
    "multistream, compiled nets": {"multi_crop": 1, "dense_s2_block": 6,
                                   "roi_samples": 1, "bottleneck_chain": 1},
    "multistream, compiled nets, fuse_dw_pw + pack_s2d": {
        "multi_crop": 1, "dense_s2_block": 6, "roi_samples": 1,
        "bottleneck_chain": 1},
    # 3m: the packed path, the fused stem and trunk off: K1 crops packed,
    # the nets plain convolutions.
    "packed, stand-ins": {"multi_crop": 1, "roi_samples": 1},
    "packed, compiled mesh": {"multi_crop": 1, "roi_samples": 1},
    # 3m's control: the same config unpacked (no pass, K1 plain crops).
    "unpacked, stand-ins": {"multi_crop": 1, "roi_samples": 1},
    "unpacked, compiled mesh": {"multi_crop": 1, "roi_samples": 1},
}


def flagship(path: str, clip, dev, card: str, profile_dir: str | None = None,
             check_signal: bool = True, **infer):
    """Drive ``flagship_config()`` (with ``infer`` overrides; the face
    landmark net the compiled mesh graph unless ``path`` is "standin") over
    ``clip``; returns the launch counts."""
    import dataclasses

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.models.mesh_graph import face_mesh_graph
    from bp_from_video_tpu_torch.runtime.engine import Engine
    cfg = flagship_config(clip.shape[1])
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, **infer))
    if path == "standin":
        engine = Engine(cfg)
        params = template_heads(engine.params)
    else:
        engine = Engine(cfg, graphs={"flm_lm": template_mesh(
            face_mesh_graph(7))})
        params = template_heads(engine.params, keys=("hand_lm",))
    return drive(path, engine, params, clip, dev, card, profile_dir,
                 check_signal)[0]


def preset_engine(name: str, streams: int):
    """``preset_config(name)`` at ``streams`` streams of 480x640 bf16 and its
    params: template heads on its landmark nets (stand-ins), the trained
    segmenter stand-in where the preset runs one."""
    from bp_from_video_tpu_torch.config import preset_config
    from bp_from_video_tpu_torch.runtime.engine import Engine
    engine = Engine(preset_config(name, streams))
    if (engine.config.inference.person_segmenter
            and not engine.runner.trained_standin.get("seg")):
        fail(f"preset [{name}]: the trained segmenter stand-in did not load")
    keys = [k for k in ("flm_lm", "hand_lm") if k in engine.params]
    return engine, template_heads(engine.params, keys=keys)


def preset(name: str, clip, dev, card: str, profile_dir: str | None = None):
    """Drive a preset at the flagship scale over ``clip``; returns the
    launch counts."""
    engine, params = preset_engine(name, clip.shape[1])
    return drive(name, engine, params, clip, dev, card, profile_dir)[0]


def multistream(clip, dev, card: str, profile_dir: str | None = None,
                lagged: int = 0):
    """Drive ``preset_config("multistream")`` over ``clip`` (person scenes),
    each step followed by ``Drawer.compose``: of every stream (the JAX
    bench's ``render=True``), or with ``lagged`` = F through
    ``batch_step_lagged`` in windows of F frames, of stream 0 alone (its
    display point).  The face ROI's BPM is held to 72 on the tracked
    streams; the palm ROI lies on clothes, where its skin-weighted sample
    follows the weights, so its BPM and the PTT are logged (phase 4 holds
    them to the CPU).  Then the outputs' shapes, the forehead ROI's colour
    on the composed frames and one headless ``present``.  Returns the
    launch counts."""
    from bp_from_video_tpu_torch.models.runner import map_leaves
    from bp_from_video_tpu_torch.render.drawer import Drawer
    engine, params = preset_engine("multistream", clip.shape[1])
    drawer = Drawer(engine.config, show=False)
    if lagged:
        path = "multistream, lagged"

        def render(frames, out):
            return drawer.compose(frames[:1], map_leaves(lambda a: a[:1], out))
    else:
        path = "multistream"

        def render(frames, out):
            return drawer.compose(frames, out)
    launches, out = drive(path, engine, params, clip, dev, card, profile_dir,
                          render=render, lagged=lagged, held=(0,))
    check_composed(path, drawer, clip[-1], out, render)
    return launches


def check_composed(path: str, drawer, frames, out, render) -> None:
    """The standalone face detector's output shapes; on the composed frames
    of the tracked streams, the forehead ROI's outline (where no later
    layer or the HUD covers it) carries its colour blended with the frame
    as the alpha blend does; one headless ``present``."""
    from bp_from_video_tpu_torch.render import overlay
    s, h, w = out.rois.shape[0], frames.shape[-2], frames.shape[-1]
    fd = out.models.face_detector
    shapes = (tuple(fd.bbox.shape), tuple(fd.points.shape),
              tuple(fd.count.shape))
    if shapes != ((s, 4, 4), (s, 4, 6, 2), (s,)):
        fail(f"[{path}]: face detector output shapes {shapes}")
    img, plot, packed = render(frames, out)
    k = img.shape[0]
    tracked = (torch.arange(s, device=frames.device) < s // 2)[:k]
    rois = out.rois[:k]
    outline = overlay.rect_mask(rois[:, 0:1, 2:6], h, w) > 0.5
    later = (overlay.rect_mask(rois[:, 1:2, 2:6], h, w)
             + overlay.cross_mask(rois[:, 1:2, :2], h, w)) > 0.5
    lines, slots = drawer._hud["idx"].shape
    hud = torch.zeros((h, w), dtype=torch.bool, device=frames.device)
    hud[:30 + 30 * lines, :15 + slots * 12] = True
    pick = outline & ~later & ~hud & tracked[:, None, None]
    color = torch.tensor(drawer.sig_colors[0], dtype=torch.float32,
                         device=frames.device)
    want = torch.round(0.75 * color + 0.25 * frames[:k].permute(0, 2, 3, 1)
                       .float()).to(torch.uint8)
    per_stream = pick.sum((1, 2)).tolist()
    ok = bool((img[pick] == want[pick]).all())
    log(f"[{path}] composed {k} stream(s): frames {tuple(img.shape)}, plots "
        f"{tuple(plot.shape)}, packed {tuple(packed.shape)}; forehead ROI "
        f"outline pixels checked on tracked streams {per_stream}, all carry "
        f"its colour {drawer.sig_colors[0]} blended: {ok}")
    if not ok or min(n for n, t in zip(per_stream, tracked.tolist())
                     if t) == 0:
        fail(f"[{path}]: the forehead ROI's outline is not drawn in its "
             "colour on every tracked stream")
    rc = drawer.present(img[0], plot[0], packed[0])
    log(f"[{path}] present (headless, OpenCV "
        f"{'absent' if drawer.cv2 is None else 'present'}): returned {rc}, "
        f"last frame {drawer.last_frame.shape}, last plot "
        f"{drawer.last_plot.shape}")
    if rc != -1 or drawer.last_frame.shape != (h, w, 3):
        fail(f"[{path}]: headless present failed")


def drive(path: str, engine, params, clip, dev, card: str,
          profile_dir: str | None = None, check_signal: bool = True,
          render=None, lagged: int = 0, held=None, syncs: bool = False,
          early: int = 0):
    """Run ``engine`` over ``clip`` (half the streams start tracked; with
    ``lagged`` = F in windows of F frames; ``render`` after each step) with
    the launch counters set to 0 just before and read just after, check the
    counts against ``PER_STEP[path]`` and, with ``check_signal``, BPM of
    the ROIs ``held`` (default all; PTT too where every ROI of two or more
    is held) on the tracked streams; with ``early``, log (not hold) the BPM
    of every ROI on the tracked streams after that many steps; with
    ``syncs``, log the host syncs of one more step (outside the counted
    run); returns the counts and the last step's outputs."""
    f = lagged or 1
    steps, s = clip.shape[0] // f, clip.shape[1]
    cfg = engine.config
    h, w = cfg.frame_height, cfg.frame_width
    ns = cfg.signal.num_signals
    held = tuple(range(ns)) if held is None else held
    tag = (f"{'preset' if path.split(',')[0] in PRESETS else 'flagship'} "
           f"[{path}]")
    tracked = torch.arange(s, device=dev) < s // 2
    state = tracked_state(engine, h, w, tracked)
    warm = min(10, steps // 2)
    kw = dict(render=render, lagged=lagged)
    zero_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, _ = run_clip(engine, params, state, clip[:warm * f], **kw)
    torch.cuda.synchronize()
    t_mid = time.perf_counter()
    cut = early if warm < early < steps else warm
    state, out_early = run_clip(engine, params, state,
                                clip[warm * f:cut * f], t0=warm * f, **kw)
    state, out = run_clip(engine, params, state, clip[cut * f:steps * f],
                          t0=cut * f, **kw)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k: fn.launches for k, fn in counters().items()}
    weighted = counters()["roi_samples"].weighted_launches
    want = {k: PER_STEP[path].get(k, 0) * steps for k in launches}
    want_w = steps if cfg.inference.person_segmenter else 0
    log(f"{tag} launches over {steps} steps: {launches}, roi_samples "
        f"weighted {weighted} (expected {want}, weighted {want_w})")
    if launches != want or weighted != want_w:
        fail(f"{tag}: a kernel of the path was not launched as often per "
             "step as expected")
    launches["roi_samples weighted"] = weighted
    sps = (steps - warm) / (t_end - t_mid)
    log(f"{tag} S={s} {h}x{w} bf16{f' F={f}' if lagged else ''}"
        f"{' composed' if render else ''} on {card}: first {warm} steps "
        f"{t_mid - t:.3f} s; steady {sps:.3f} steps/s = {sps * s * f:.1f} "
        f"frames/s ({1e3 / sps:.3f} ms/step, host clock, synchronized)")
    n_track = int(state.track.face_tracking.sum())
    if n_track < int(tracked.sum()):
        fail(f"{tag}: only {n_track} faces still tracked")
    if cut > warm:
        eb = out_early.bpm.float().cpu()[tracked.cpu()]
        for r in range(ns):
            log(f"{tag} ROI {r} BPM at step {cut} (logged, not held) on "
                f"tracked streams: {eb[:, r].tolist()}")
    del out_early
    if check_signal:
        bpm, ptt = out.bpm.float().cpu(), out.ptt.float().cpu()
        n_fin = int(torch.isfinite(bpm).all(-1).sum())
        tr = tracked.cpu()
        if cfg.inference.person_segmenter:
            log_roi_skin(out, tag, tr)
        hb = bpm[tr][:, list(held)]
        if not bool(torch.isfinite(hb).all()):
            fail(f"{tag}: BPM not finite on the tracked streams")
        # The clip pulses at 72 BPM, the palm 3 frames (100 ms) after the
        # face.
        if not bool(((hb - 72).abs() <= 6).all()):
            fail(f"{tag}: BPM {hb.tolist()} not near 72")
        if ns > 1 and len(held) == ns and not (
                bool(torch.isfinite(ptt[tr]).all())
                and bool(((ptt[tr] + 100).abs() <= 1000.0 / 30.0).all())):
            fail(f"{tag}: PTT {ptt[tr].tolist()} not near -100 ms")
        if tuple(out.proc_y.shape) != (s, ns, cfg.signal.signal_max_samples):
            fail(f"{tag}: proc_y shape {tuple(out.proc_y.shape)}")
        for r in range(ns):
            log(f"{tag} ROI {r} ({'held to 72' if r in held else 'logged'}) "
                f"BPM on tracked streams: {bpm[tr][:, r].tolist()}")
        log(f"{tag} outputs on tracked streams: BPM "
            f"{sorted(set(hb.flatten().tolist()))} (held ROIs), PTT ms "
            f"{sorted(set(ptt[tr].flatten().tolist()))}; streams with "
            f"finite BPM {n_fin}/{s}; tracking face {n_track}/{s}; proc_y "
            f"{tuple(out.proc_y.shape)}")
    if syncs:
        n = count_syncs(lambda: run_clip(engine, params, state,
                                         clip[-f:], t0=steps * f, **kw))
        log(f"{tag} host syncs a step: {n}")
    if profile_dir:
        profile(engine, params, state, clip[:10 * f], steps * f, profile_dir,
                path, **kw)
    return launches, out


def log_roi_skin(out, tag: str, tracked) -> None:
    """Log the mean skin confidence over each tracked stream's ROI at the
    last step: the weights K4 sampled with."""
    from bp_from_video_tpu_torch.models.runner import skin_confidence
    skin = skin_confidence(out.models.seg_conf)
    r = out.rois[:, 0].cpu()
    mean = [round(float(skin[i, int(r[i, 3]):int(r[i, 5]),
                             int(r[i, 2]):int(r[i, 4])].mean()), 4)
            for i in range(r.shape[0])
            if tracked[i] and bool(torch.isfinite(r[i]).all())]
    log(f"{tag}: mean skin confidence over the ROI of each tracked stream "
        f"(least {min(mean)}): {mean}")


def lone_unit_graph(dev, s: int = 64):
    """Phase 3d, K5's path: a mesh graph whose first stage has ONE unit
    (which cannot chain) compiles to a lone fused unit.  Its fused compile
    runs on ``s`` stem activations at full width and is held against the
    same graph compiled unfused.  Returns K5's launches in that run."""
    from bp_from_video_tpu_torch.models import tflite_compiler as tc
    from bp_from_video_tpu_torch.models.mesh_graph import face_mesh_graph
    graph = face_mesh_graph(9, units_per_stage=(1, 4, 4, 4, 4, 4, 4))
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand((s, 16, 128, 128), generator=gen, device=dev) * 2 - 0.5
    launches = 0
    # f32: fused and unfused differ by the order of f32 sums (the composed
    # 3x3 against depthwise then 1x1), 1e-3 of each output's scale over 25
    # units.  bf16: the unfused graph rounds after each of a unit's five
    # ops, the fused one twice: 1e-1 of the scale (the tongueOut output, a
    # sigmoid far in its tail, reads 3e-2 of its own small scale).
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1e-1)):
        kw = dict(dtype=dtype, layout="NCHW", planar_inputs=True,
                  external_stem=True, batch_flexible=True, device=dev)
        fused, pf = tc.compile_graph(graph, fuse_bn=True, fuse_bn_min_hw=0,
                                     **kw)
        plain, pp = tc.compile_graph(graph, **kw)
        ops = [op.opcode for op in fused.graph.ops]
        if (ops.count("PALLAS_BN"), ops.count("PALLAS_BN_CHAIN")) != (1, 6):
            fail(f"lone-unit graph compiled to {ops}")
        zero_counters()
        got = fused(pf, x)
        torch.cuda.synchronize()
        n = {k: fn.launches for k, fn in counters().items()}
        want = plain(pp, x)
        torch.cuda.synchronize()
        if n["bottleneck_s1"] != 1 or n["bottleneck_chain"] != 6:
            fail(f"lone-unit graph launched {n}")
        launches += n["bottleneck_s1"]
        for i, (g, w) in enumerate(zip(got, want)):
            err = float((g.float() - w.float()).abs().max())
            scale = float(w.float().abs().max())
            log(f"lone-unit graph {dtype} output {i} {tuple(g.shape)}: fused "
                f"vs unfused max_abs_err {err:.3g} (tol {tol * scale:.3g})")
            if not (bool(torch.isfinite(g).all()) and err <= tol * scale):
                fail("lone-unit graph: fused and unfused compiles disagree")
    return launches


# -- phase 3k: the rotation modes at full width -------------------------------

# Steps a rotation path runs (the first ``ROT_WARM`` untimed), and the tilt
# of its tilted streams (the reference bench's ``hybrid_tilt25`` points).
ROT_STEPS = 60
ROT_WARM = 5
ROT_TILT = 25.0
# Phase 3k's paths: (tag, rotation mode, streams tilted (None: all), tilt,
# K1 launches a step, K3 launches a step).  ``hybrid`` crops with K1 and
# runs both nets' stems and trunks through K3 (10 a step), except when more
# crops of a kind are gated than ``shear_subbatch``: then every crop of the
# batch is a shear crop (the reference's whole-batch branch, which runs no
# K1).  ``shear`` and ``exact`` take the per-crop path: no K1, plain nets,
# no K3.  K4 samples once a step on every path.
ROT_PATHS = (("cover", "cover", 0, 0.0, 1, 10),
             ("hybrid upright", "hybrid", None, 0.0, 1, 10),
             ("hybrid tilt 25", "hybrid", None, ROT_TILT, 0, 10),
             ("hybrid tilt 25 k1", "hybrid", 1, ROT_TILT, 1, 10),
             ("shear tilt 25", "shear", None, ROT_TILT, 0, 0),
             ("exact tilt 25", "exact", None, ROT_TILT, 0, 0))


def pinned_track(engine, deg: float, tilted):
    """Every stream tracking a centered square of side min(h, w) / 3 (face
    and hands alike), the first ``tilted`` streams (None: all) at ``deg``
    degrees, the rest upright (the reference bench's pinned rects)."""
    cfg = engine.config
    h, w, s = cfg.frame_height, cfg.frame_width, cfg.num_streams
    nh = cfg.inference.max_hands
    side = min(h, w) / 3.0
    rect = torch.tensor([w / 2.0, h / 2.0, side, side, 0.0],
                        device=engine.device).repeat(s, 1)
    rect[:s if tilted is None else tilted, 4] = math.radians(deg)
    tr = engine.init_state().track
    return tr._replace(
        face_rect=rect, face_tracking=torch.ones_like(tr.face_tracking),
        hand_rects=rect[:, None].expand(s, nh, 5).contiguous(),
        hand_tracking=torch.ones_like(tr.hand_tracking))


def count_syncs(fn) -> int:
    """Host syncs ``fn()`` makes (CUDA sync debug mode; no synchronize of
    its own inside the window)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


def rotation_run(engine, params, clip, pinned, steps: int,
                 warm: int = ROT_WARM):
    """``steps`` engine steps over ``clip`` with the track pinned before
    each: (per-step landmarks and ROIs on the device, last outputs,
    host-clock and CUDA-event ms a step over the steps after ``warm``)."""
    s = clip.shape[1]
    ts = [torch.full((s,), (i + 1) / 30.0, device=clip.device)
          for i in range(steps)]
    state = engine.init_state()
    rows, out = [], None
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for i in range(steps):
        if i == warm:
            torch.cuda.synchronize()
            t = time.perf_counter()
            a.record()
        state, out = engine.batch_step(params, state._replace(track=pinned),
                                       clip[i], ts[i])
        m = out.models
        rows.append((m.face_landmarker.points, m.hand_landmarker.points,
                     out.rois))
    b.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t) * 1e3 / (steps - warm)
    return rows, out, host, a.elapsed_time(b) / (steps - warm), state


def rotation_crops(engine, frames, pinned):
    """The crop stage of one step (``InferenceRunner._crop_stage``) on
    planar frames [S, 3, H, W] with the track ``pinned``."""
    run = engine.runner
    raws = {"flm_lm": run._safe_rect(pinned.face_rect),
            "hand_lm": run._safe_rect(pinned.hand_rects)}
    valid = {"flm_lm": pinned.face_tracking,
             "hand_lm": pinned.hand_tracking}

    def nhwc_at(idx):
        return (frames if idx is None else frames[idx]).permute(0, 2, 3, 1)
    return run._crop_stage(frames, True, nhwc_at, raws, valid)


def _same(x, y) -> bool:
    return torch.equal(x.nan_to_num(-1.0), y.nan_to_num(-1.0))


def rotation_costs(frames, dev, card: str) -> None:
    """The work of the rotation paths that is not a kernel of the port,
    timed with CUDA events on 64 streams of ``frames`` [S, 3, H, W]: the
    shear crop (``crop_rect_shear``: the separable resample and three
    shear passes) with cuFFT (``fft``) and with f32 DFT matmuls (``dft``)
    at the canvas sizes of a 192 and a 256 crop (320 and 384 a side: 64
    face crops) and of a 224 crop (384: 128 hand crops); one shear pass
    (``fract_shift`` along a row) alone at each; the exact gather at the
    stand-ins' sizes; and the BP head (``mlp_apply`` on 64 streams' vitals
    on the card, ``BPPredictor`` in numpy on the host for one stream)."""
    from bp_from_video_tpu_torch.models import warp
    from bp_from_video_tpu_torch.train import bp_regressor as bpr
    s, _, h, w = frames.shape
    nhwc = frames.permute(0, 2, 3, 1)
    side = min(h, w) / 3.0
    rect = torch.tensor([w / 2.0, h / 2.0, side, side,
                         math.radians(ROT_TILT)], device=dev)
    for size, n in ((192, 1), (256, 1), (224, 2)):
        rr = warp.arr_rect(rect.repeat(s, n, 1))
        f = nhwc[:, None]
        t = int(-(-int(size * 1.5) // 64) * 64)
        canvas = torch.rand((s * n, t, t, 3), device=dev) * 255
        sh = torch.rand((s * n, t, 1), device=dev) * 4 - 2
        times = {}
        for method in ("fft", "dft"):
            times[method] = (
                time_ms(lambda m=method: warp.crop_rect_shear(
                    f, rr, size, method=m), reps=5, inner=2),
                time_ms(lambda m=method: warp.fract_shift(
                    canvas, sh, -2, m), reps=5, inner=2))
        exact = time_ms(lambda: warp.crop_rect(
            f.expand(s, n, h, w, 3), rr, size, exact_rotation=True),
            reps=5, inner=2)
        log(f"[3k cost] {s * n} crops of {size} (canvas {t}x{t}) on {card}: "
            f"shear crop fft {times['fft'][0]:.3f} ms, dft "
            f"{times['dft'][0]:.3f} ms; one shear pass fft "
            f"{times['fft'][1]:.3f} ms, dft {times['dft'][1]:.3f} ms; exact "
            f"gather {exact:.3f} ms")
    state, _ = bpr.init_train_state(torch.Generator().manual_seed(0), 6,
                                    device=dev)
    x = torch.randn((s, 6), device=dev)
    with torch.no_grad():
        head = time_ms(lambda: bpr.mlp_apply(state.params, x))
    pred = bpr.BPPredictor([p.detach().cpu().numpy()
                            for p in state.params.weights],
                           [p.detach().cpu().numpy()
                            for p in state.params.biases],
                           np.zeros(6), np.ones(6), np.zeros(2), np.ones(2))
    vit = (np.array([72.0, 70.0], np.float32), np.array([30.0], np.float32))
    t = time.perf_counter()
    for _ in range(1000):
        pred(*vit)
    host = (time.perf_counter() - t) * 1e3 / 1000
    log(f"[3k cost] BP head: mlp_apply on {s} streams' vitals on the card "
        f"{head:.4f} ms (CUDA events); BPPredictor on one stream on the "
        f"host {host:.4f} ms (host clock, mean of 1000)")


def rotation_modes(clip, dev, card: str) -> collections.Counter:
    """Phase 3k: the flagship config (64 streams, 480x640, bf16, K1, the
    fused stem and trunk, stand-ins with template heads) through each
    rotation path of ``ROT_PATHS`` for ``ROT_STEPS`` steps of ``clip``, the
    track pinned (``pinned_track``).  Logs each path's host clock and
    frames/s, its CUDA-event ms a step, K1/K3/K4 launches and host syncs a
    step and its BPM; fails unless hybrid upright equals cover, the
    sub-batch path's tilted stream matches the whole-batch shear path's
    (its crops within one bf16 ulp: cuFFT runs a batch of 1 there and of
    all the crops here) and its other streams equal hybrid upright's, the
    whole-batch shear path's landmarks lie within a mean 3 px of shear's,
    and each path launched K1 and K3 as ``ROT_PATHS`` says.  Returns the
    launch counts, and the outputs of the last hybrid upright step and
    their config."""
    import dataclasses

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.runtime.engine import Engine
    cfg = dataclasses.replace(flagship_config(clip.shape[1]),
                              frame_height=clip.shape[-2],
                              frame_width=clip.shape[-1])
    total = collections.Counter()
    runs, engines, outs = {}, {}, {}
    for tag, mode, tilted, deg, k1, k3 in ROT_PATHS:
        if mode not in engines:
            engines[mode] = Engine(dataclasses.replace(
                cfg, inference=dataclasses.replace(cfg.inference,
                                                   rotation_mode=mode)),
                device=dev)
            engines[mode].params = template_heads(engines[mode].params)
        eng = engines[mode]
        pinned = pinned_track(eng, deg, tilted)
        zero_counters()
        rows, out, host, dev_ms, state = rotation_run(
            eng, eng.params, clip[:ROT_STEPS], pinned, ROT_STEPS)
        launches = {k: fn.launches for k, fn in counters().items()}
        total.update(launches)
        syncs = count_syncs(lambda: eng.batch_step(
            eng.params, state._replace(track=pinned), clip[ROT_STEPS],
            torch.full((cfg.num_streams,), (ROT_STEPS + 1) / 30.0,
                       device=dev)))
        per = {k: launches[k] / ROT_STEPS for k in ("multi_crop",
                                                     "dense_s2_block",
                                                     "roi_samples")}
        bpm = out.bpm.float().cpu()
        s = cfg.num_streams
        log(f"[3k {tag}] S={s} {cfg.frame_height}x{cfg.frame_width} bf16 on "
            f"{card}: {host:.3f} ms/step host clock = "
            f"{s * 1e3 / host:.1f} frames/s; {dev_ms:.3f} ms/step between "
            f"CUDA events; launches a step K1 {per['multi_crop']:g}, K3 "
            f"{per['dense_s2_block']:g}, K4 {per['roi_samples']:g}; host "
            f"syncs a step {syncs}; BPM stream 0 {bpm[0].tolist()}, forehead "
            f"BPM over the streams {sorted(set(bpm[:, 0].tolist()))}")
        if (per["multi_crop"], per["dense_s2_block"],
                per["roi_samples"]) != (k1, k3, 1):
            fail(f"[3k {tag}]: K1/K3/K4 launched {per} a step, expected "
                 f"{k1}/{k3}/1")
        if not bool(torch.isfinite(bpm[:, 0]).all()):
            fail(f"[3k {tag}]: forehead BPM not finite on every stream")
        runs[tag], outs[tag] = rows, out
    rotation_costs(clip[ROT_STEPS], dev, card)
    up, cov = runs["hybrid upright"], runs["cover"]
    if not all(_same(x, y) for ra, rb in zip(up, cov)
               for x, y in zip(ra, rb)):
        fail("[3k] hybrid upright differs from cover")
    k1, full = runs["hybrid tilt 25 k1"], runs["hybrid tilt 25"]
    d0 = max(float((x[:1] - y[:1]).abs().nan_to_num(0).max())
             for ra, rb in zip(k1, full) for x, y in zip(ra[:2], rb[:2]))
    rest = all(_same(x[1:], y[1:]) for ra, rb in zip(k1, up)
               for x, y in zip(ra, rb))
    # The crops of one step, sub-batch (stream 0 gated) and whole batch.
    eng = engines["hybrid"]
    frames = clip[ROT_STEPS]
    sub = rotation_crops(eng, frames, pinned_track(eng, ROT_TILT, 1))
    whole = rotation_crops(eng, frames, pinned_track(eng, ROT_TILT, None))
    upr = rotation_crops(eng, frames, pinned_track(eng, 0.0, None))
    nh = cfg.inference.max_hands
    crop_err, crop_rest = 0.0, True
    for key, n in (("flm_lm", 1), ("hand_lm", nh)):
        a, b, c = sub[key][0].float(), whole[key][0].float(), upr[key][0]
        tol = BF16_ULP * torch.maximum(a[:n].abs(), b[:n].abs()) + 1e-6
        crop_err = max(crop_err, float(((a[:n] - b[:n]).abs() / tol).max()))
        crop_rest &= torch.equal(sub[key][0][n:], c[n:])
    log(f"[3k] sub-batch vs whole-batch shear, stream 0: landmarks differ "
        f"by up to {d0:.3g} px over {ROT_STEPS} steps, crops by up to "
        f"{crop_err:.3g} bf16 ulps (tolerance 1); the other streams' "
        f"landmarks, ROIs and crops equal hybrid upright's: "
        f"{rest and crop_rest}")
    if d0 > 1.0 or crop_err > 1.0 or not (rest and crop_rest):
        fail("[3k] the shear sub-batch differs from the whole-batch shear "
             "or touched an upright stream")
    sh = runs["shear tilt 25"]
    dists = []
    for ra, rb in zip(full, sh):
        for x, y in zip(ra[:2], rb[:2]):
            d = (x - y).norm(dim=-1)
            dists.append(d[torch.isfinite(d)])
    mean = float(torch.cat(dists).mean())
    log(f"[3k] whole-batch hybrid vs shear: landmarks a mean {mean:.4g} px "
        "apart (bound 3)")
    if not mean < 3.0:
        fail("[3k] the whole-batch hybrid landmarks are not shear's")
    return total, outs["hybrid upright"], engines["hybrid"].config


def rotation_card_vs_cpu(clip, devices=("cuda", "cpu")) -> None:
    """Phase 4's rotation runs: a small f32 config (stand-ins with template
    heads, K1 and the fused stem and trunk) on the card and on the CPU,
    the track pinned (``pinned_track``), through ``exact`` and ``shear``
    at 25 degrees and ``hybrid`` upright, tilted past its budget (all
    streams at 25 degrees, ``shear_subbatch`` 1: the whole-batch shear) and
    with stream 0 alone tilted (the sub-batch): landmarks within 1 px (f32
    coordinates summed in another order land within roundoff of a pixel
    edge), BPM equal from row ``SETTLED`` on (the periodogram's first few
    samples pick a peak by roundoff), PTT within one sample period on
    every row."""
    import dataclasses

    from bp_from_video_tpu_torch.config import EngineConfig, InferenceConfig
    from bp_from_video_tpu_torch.runtime.engine import Engine
    settled = 10
    s, h, w = clip.shape[1], clip.shape[-2], clip.shape[-1]
    for mode, tilted, deg, k in (("exact", None, ROT_TILT, 4),
                                 ("shear", None, ROT_TILT, 4),
                                 ("hybrid", None, 0.0, 4),
                                 ("hybrid", None, ROT_TILT, 1),
                                 ("hybrid", 1, ROT_TILT, 4)):
        cfg = EngineConfig(frame_height=h, frame_width=w, num_streams=s,
                           compute_dtype="float32",
                           inference=InferenceConfig(
                               use_pallas=True, fused_stem=True,
                               fused_trunk=True, rotation_mode=mode,
                               shear_subbatch=k))
        name = (f"{mode} {'upright' if deg == 0 else f'tilt {deg:g}'}"
                f"{' stream 0' if tilted else ''}, shear_subbatch {k}")
        res = {}
        for where in devices:
            eng = Engine(cfg, device=where)
            params = template_heads(eng.params)
            pinned = pinned_track(eng, deg, tilted)
            state = eng.init_state()
            pts, bpm, ptt = [], [], []
            t = time.perf_counter()
            for i in range(clip.shape[0]):
                state, out = eng.batch_step(
                    params, state._replace(track=pinned), clip[i].to(where),
                    torch.full((s,), (i + 1) / 30.0, device=eng.device))
                m = out.models
                pts.append(torch.cat([m.face_landmarker.points.flatten(1),
                                      m.hand_landmarker.points.flatten(1)],
                                     1).cpu())
                bpm.append(out.bpm.cpu())
                ptt.append(out.ptt.cpu())
            res[where] = tuple(torch.stack(x) for x in (pts, bpm, ptt))
            log(f"small f32 [{name}] S={s} {h}x{w} on {where}: "
                f"{clip.shape[0]} steps in {time.perf_counter() - t:.2f} s")
        (pa, ba, ta), (pb, bb, tb) = (res[d] for d in devices)
        dp = float((pa - pb).abs().nan_to_num(0).max())
        same_nan = torch.equal(pa.isnan(), pb.isnan())
        bpm_ok = _same(ba[settled:], bb[settled:])
        ptt_ok = bool((((ta - tb).abs() <= 1000.0 / 30.0)
                       | (ta.isnan() & tb.isnan())).all())
        log(f"card vs CPU [{name}]: landmarks differ by up to {dp:g} px "
            f"(NaN pattern equal {same_nan}); BPM equal from row {settled} "
            f"{bpm_ok}, last {ba[-1].tolist()} / {bb[-1].tolist()}; PTT "
            f"within a sample period on every row {ptt_ok}")
        if not (dp <= 1.0 and same_nan and bpm_ok and ptt_ok
                and bool(torch.isfinite(ba[-1, :, 0]).all())):
            fail(f"card and CPU differ [{name}]")


# -- phase 6: the BP head -----------------------------------------------------

PREDICTOR = os.path.join("models", "bp_e2e_predictor.npz")


def bp_hud(out, cfg, frames, here: str) -> None:
    """6a: the repository's trained head through ``Drawer.present`` on a
    pulse clip's HUD vitals (stream 0 of ``out``, composed on the card):
    ``last_bp`` against a numpy recomputation (features, standardization,
    the tanh GELU MLP) at rtol 1e-6, and the BP line drawn in magenta."""
    from bp_from_video_tpu_torch.models.runner import map_leaves
    from bp_from_video_tpu_torch.render.drawer import Drawer
    from bp_from_video_tpu_torch.train.bp_regressor import load_predictor
    pred = load_predictor(os.path.join(here, PREDICTOR))
    drawer = Drawer(cfg, show=False, bp_predictor=pred, device=frames.device)
    img, plot, packed = drawer.compose(frames[:1],
                                       map_leaves(lambda a: a[:1], out))
    drawer.present(img[0], plot[0], packed[0])
    bpm = out.bpm[0].float().cpu().numpy()
    ptt = out.ptt[0].float().cpu().numpy()
    with np.load(os.path.join(here, PREDICTOR)) as d:
        x = np.concatenate([bpm, ptt])
        ok = np.isfinite(x)
        hh = (np.concatenate([np.where(ok, x, 0.0), ok]) - d["f_mu"]) / d[
            "f_sd"]
        n = sum(k.startswith("w_") for k in d.files)
        for i in range(n):
            hh = hh @ d[f"w_{i}"] + d[f"b_{i}"]
            if i < n - 1:
                hh = 0.5 * hh * (1 + np.tanh(np.sqrt(2 / np.pi)
                                             * (hh + 0.044715 * hh ** 3)))
        want = hh * d["l_sd"] + d["l_mu"]
    f = drawer.last_frame
    magenta = int(((f[..., 0] > 150) & (f[..., 1] < 90)
                   & (f[..., 2] > 150)).sum()) if drawer.cv2 else -1
    log(f"[6a] bp_e2e_predictor on stream 0's HUD vitals BPM {bpm.tolist()} "
        f"PTT {ptt.tolist()}: Drawer.present last_bp {drawer.last_bp.tolist()}"
        f", numpy {want.tolist()}; magenta BP-line pixels {magenta}")
    if not (np.allclose(drawer.last_bp, want, rtol=1e-6)
            and np.isfinite(want).all() and magenta != 0):
        fail("[6a] the BP head on the HUD differs from its numpy "
             "recomputation, or its line is not drawn")


def train_cli(tmp: str, dev, card: str) -> str:
    """6b: ``python -m bp_from_video_tpu_torch.train --synthetic 4096`` on
    the card, through its ``main``: 500 steps (exporting the head), then
    250 + 250 resumed, then 20 steps on the CPU.  Fails unless the
    held-out MAE is under 5 mmHg, the resumed run's head equals the
    uninterrupted run's, and the card's first 20 losses equal the CPU's
    at rtol 1e-4 (f32 matmuls summed in another order, 20 AdamW steps).
    Returns the exported head's path."""
    import contextlib
    import io

    from bp_from_video_tpu_torch.train import __main__ as tmain
    from bp_from_video_tpu_torch.train import bp_regressor as bpr
    base = ["--synthetic", "4096"]
    orig = bpr.train_step

    def run(argv):
        losses = []

        def spy(*a, **k):
            st, loss = orig(*a, **k)
            losses.append(loss)
            return st, loss
        bpr.train_step = spy
        buf = io.StringIO()
        try:
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = tmain.main(base + argv)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t
        finally:
            bpr.train_step = orig
        if rc != 0:
            fail(f"[6b] train main({argv}) returned {rc}")
        return buf.getvalue(), [float(x) for x in losses], secs
    head = os.path.join(tmp, "head.npz")
    out, losses, secs = run(["--steps", "500", "--device", dev.type,
                             "--predictor", head])
    last = [ln for ln in out.splitlines() if "eval MAE" in ln][-1]
    mae = (float(last.split("SBP")[1].split()[0]),
           float(last.split("DBP")[1].split()[0]))
    log(f"[6b] train --synthetic 4096 --steps 500 on {card}: {secs:.2f} s "
        f"({secs / 500 * 1e3:.3f} ms a step, host clock, the whole call); "
        f"{last.strip()}")
    ck = os.path.join(tmp, "ck")
    run(["--steps", "250", "--device", dev.type, "--checkpoint", ck])
    out2, _, _ = run(["--steps", "500", "--device", dev.type,
                      "--checkpoint", ck, "--resume"])
    with np.load(head) as a, np.load(ck + "_predictor.npz") as b:
        resumed = sorted(a.files) == sorted(b.files) and all(
            np.array_equal(a[k], b[k]) for k in a.files)
    _, cpu_losses, _ = run(["--steps", "20", "--device", "cpu"])
    err = max(abs(x - y) / abs(y) for x, y in zip(losses[:20], cpu_losses))
    log(f"[6b] 250 + 250 resumed ({'resumed at step 250' in out2}) equals "
        f"the uninterrupted head: {resumed}; first 20 losses card vs CPU: "
        f"largest relative difference {err:.3g} (rtol 1e-4); card "
        f"{losses[:3]} ..., CPU {cpu_losses[:3]} ...")
    if not (max(mae) < 5.0 and resumed and err <= 1e-4
            and "resumed at step 250" in out2):
        fail("[6b] training on the card: MAE, resume or CPU parity failed")
    return head


def bp_report(tag: str, out: str, streams: int) -> None:
    """6c: the offline CLI's report with ``--bp``: a settled mean BP line
    in mmHg for every stream."""
    lines = [ln for ln in out.splitlines() if "settled mean BP:" in ln]
    log(f"[{tag}] --bp report: {lines}")
    if len(lines) != streams or not all("mmHg" in ln for ln in lines):
        fail(f"[{tag}] the --bp report has no mmHg for every stream")


def e2e_train(clip, dev, card: str, head: str, steps: int = 30,
              warm: int = 10, mesh=None, tag: str = "6d"):
    """6d: ``make_e2e_train_step`` over the flagship engine (64 streams,
    stand-ins with template heads, half the streams tracked) on ``clip``:
    ``warm`` plain steps, then ``steps`` end-to-end steps (the engine
    under no_grad through its kernels, the head's AdamW update, labels
    from a seeded generator), with the launch counters set to 0 just
    before those and read just after; with ``mesh`` (7a) the engine is
    ``MultiStreamEngine(mesh=...)`` and the head placed by
    ``mesh.shard_params``.  Fails unless the engine's BPM and PTT on every
    step equal an inference-only run's, every loss is finite and K1, K3
    and K4 launched every step.  Returns the launch counts, the losses
    and the updated head (on the host)."""
    import dataclasses

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.models.runner import tree_leaves
    from bp_from_video_tpu_torch.parallel import mesh as mesh_lib
    from bp_from_video_tpu_torch.parallel.streams import MultiStreamEngine
    from bp_from_video_tpu_torch.train import bp_regressor as bpr
    cfg = dataclasses.replace(flagship_config(clip.shape[1]),
                              frame_height=clip.shape[-2],
                              frame_width=clip.shape[-1])
    ms = MultiStreamEngine(cfg, mesh=mesh, device=dev)
    eng = ms.engine
    params = template_heads(eng.params)
    s, h, w = cfg.num_streams, cfg.frame_height, cfg.frame_width
    tracked = torch.arange(s, device=dev) < s // 2
    ts = [torch.full((s,), (i + 1) / 30.0, device=dev)
          for i in range(warm + steps)]
    state = tracked_state(eng, h, w, tracked)
    plain = []
    for i in range(warm + steps):
        state, out = eng.batch_step(params, state, clip[i], ts[i])
        plain.append((out.bpm, out.ptt))
    sig = cfg.signal
    with np.load(head) as d:
        norm = {k: torch.from_numpy(d[k]).to(dev)
                for k in ("f_mu", "f_sd", "l_mu", "l_sd")}
    tstate, opt = bpr.init_train_state(
        torch.Generator().manual_seed(0), 2 * (sig.num_signals
                                                + sig.num_pairs),
        device=dev)
    if mesh is not None:
        tstate = mesh_lib.shard_params(tstate, mesh)
        opt = bpr.make_optimizer(tstate)
    seen = []

    def engine_step(*a):
        st, o = ms.step(*a)
        seen.append(ms.gather((o.bpm, o.ptt)))
        return st, o
    step = bpr.make_e2e_train_step(engine_step, opt, norm, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    labels = torch.stack([120 + 10 * torch.rand(s, generator=gen, device=dev),
                          80 + 6 * torch.rand(s, generator=gen, device=dev)],
                         -1)
    state = tracked_state(eng, h, w, tracked)
    for i in range(warm):
        state, _ = eng.batch_step(params, state, clip[i], ts[i])
    state, params = ms.shard_state(state), ms.shard_params(params)
    zero_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    losses = []
    for i in range(warm, warm + steps):
        state, tstate, loss = step(params, state, tstate, clip[i], ts[i],
                                   labels)
        losses.append(loss)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t) * 1e3 / steps
    launches = {k: fn.launches for k, fn in counters().items()}
    losses = torch.stack(losses).cpu()
    same = all(_same(a, b) and _same(c, d) for (a, c), (b, d)
               in zip(seen, plain[warm:]))
    where = "" if mesh is None else f" over the mesh {mesh_axes(mesh)}"
    log(f"[{tag}] make_e2e_train_step over the flagship engine{where}, "
        f"S={s} {h}x{w} bf16 on {card}: {steps} steps after {warm} warm, "
        f"{ms_step:.3f} ms a step (host clock); losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; engine BPM and PTT equal the inference-only "
        f"run's on every step: {same}; launches {launches}")
    per = {k: launches[k] / steps for k in ("multi_crop", "dense_s2_block",
                                            "roi_samples")}
    if not (same and bool(torch.isfinite(losses).all())
            and per == {"multi_crop": 1, "dense_s2_block": 10,
                        "roi_samples": 1}
            and int(tstate.step) == steps):
        fail(f"[{tag}] the end-to-end training step failed")
    return (collections.Counter(launches), losses,
            [x.detach().cpu()
             for x in tree_leaves(mesh_lib.gather(tstate.params))])


# -- phase 7: the mesh on the card ----------------------------------------------

# Steps of 7a's and 7b's runs (BPM is held after them, as after 3l's and
# 3m's ``HELD_STEPS``), the clip rows of 7a's run_clip comparisons, and
# 7b's per-rank clip seeds.
MESH_STEPS = 130
MESH_CLIP = 40
MESH_SEEDS = (30, 31)
# 7a's timing: alternating rounds of the one-rank mesh and mesh=None.
MESH_ROUNDS = 8
MESH_ROUND = 20


def mesh_axes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def hold_bpm(tag: str, bpm, tracked) -> None:
    """Every ROI of every tracked stream within 6 of the clip's 72 BPM."""
    hb = bpm.float().cpu()[tracked.cpu()]
    log(f"[{tag}] BPM on the tracked streams: "
        f"{sorted(set(hb.flatten().tolist()))}")
    if not (bool(torch.isfinite(hb).all()) and bool(((hb - 72).abs() <= 6)
                                                   .all())):
        fail(f"[{tag}] BPM {hb.tolist()} not near 72 on the tracked streams")


def mesh_one_rank(dev, card: str, head: str, e2e_losses, e2e_head
                  ) -> collections.Counter:
    """7a: ``distributed.global_mesh({"dp": 1, "tp": 1})`` on the card (a
    world of one rank over NCCL, on a local store).  The flagship (64
    streams, stand-ins with template heads, half tracked) through
    ``MultiStreamEngine(mesh=...).step`` over ``MESH_STEPS`` frames of
    phase 3's clip, counters set to 0 just before and read just after,
    then the same through ``mesh=None``: state and outputs equal bit for
    bit, K1/K3/K4 1/10/1 a step, BPM 72 on the tracked streams;
    ``run_clip`` and ``run_clip_lagged`` (F = 4) over the first
    ``MESH_CLIP`` frames equal their ``mesh=None`` runs; the e2e step over
    the mesh (6d's, head placed by ``mesh.shard_params``) equals 6d's
    losses and head within rtol 1e-6.  The host clock of both paths is
    compared in ``MESH_ROUNDS`` alternating rounds.  Returns the mesh
    run's launches."""
    import torch.distributed as dist

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.parallel import distributed
    from bp_from_video_tpu_torch.parallel.streams import MultiStreamEngine
    mesh = distributed.global_mesh({"dp": 1, "tp": 1})
    log(f"[7a] world of {dist.get_world_size()} rank, backend "
        f"{dist.get_backend()}, mesh {mesh_axes(mesh)} on {card}")
    cfg = flagship_config()
    s, h, w = cfg.num_streams, cfg.frame_height, cfg.frame_width
    clip = pulse_clip(MESH_STEPS, s, h, w, split=300, seed=3, device=dev)
    plain = MultiStreamEngine(cfg)
    ms = MultiStreamEngine(cfg, mesh=mesh)
    params = template_heads(plain.params)
    tracked = torch.arange(s, device=dev) < s // 2
    start = tracked_state(plain.engine, h, w, tracked)
    ts = [torch.full((s,), (i + 1) / 30.0, device=dev)
          for i in range(MESH_STEPS)]

    def run(engine, p, state, n=MESH_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(n):
            state, out = engine.step(p, state, clip[i], ts[i])
        torch.cuda.synchronize()
        return state, out, (time.perf_counter() - t) * 1e3 / n
    placed = ms.shard_params(params)
    zero_counters()
    st_m, out_m, ms_mesh = run(ms, placed, ms.shard_state(start))
    launches = {k: fn.launches for k, fn in counters().items()}
    st_p, out_p, ms_plain = run(plain, params, start)
    same = (np_trees_equal(host_tree(ms.gather(st_m)), host_tree(st_p))
            and np_trees_equal(host_tree(ms.gather(out_m)),
                               host_tree(out_p)))
    per = {k: v / MESH_STEPS for k, v in launches.items() if v}
    log(f"[7a] MultiStreamEngine(mesh=1x1).step, S={s} {h}x{w} bf16, "
        f"{MESH_STEPS} steps on {card}: {ms_mesh:.3f} ms a step = "
        f"{s * 1e3 / ms_mesh:.1f} frames/s (host clock, synchronized, the "
        f"first steps included); mesh=None {ms_plain:.3f} ms; launches a "
        f"step {per}; state and outputs equal mesh=None bit for bit: {same}")
    # The host clock drifts by several ms a step between runs of one path:
    # alternate the two paths in short rounds (ABBA) from the start state
    # and compare the medians with the rounds' spread.
    rounds = {"mesh=None": [], "mesh": []}
    pair = (("mesh=None", plain, params, lambda: start),
            ("mesh", ms, placed, lambda: ms.shard_state(start)))
    for k in range(MESH_ROUNDS):
        for name, engine, p, st in (pair if k % 2 == 0 else pair[::-1]):
            rounds[name].append(run(engine, p, st(), MESH_ROUND)[2])
    log(f"[7a] host clock in {MESH_ROUNDS} alternating rounds of "
        f"{MESH_ROUND} steps (ABBA) on {card}: " + "; ".join(
            f"{k} median {statistics.median(v):.3f} ms a step (rounds "
            f"{min(v):.3f}-{max(v):.3f})" for k, v in rounds.items()))
    if not same or per != {"multi_crop": 1, "dense_s2_block": 10,
                           "roi_samples": 1}:
        fail("[7a] the one-rank mesh step differs from mesh=None or did not "
             "launch K1/K3/K4 1/10/1 a step")
    hold_bpm("7a", ms.gather(out_m.bpm), tracked)
    del st_m, out_m, st_p, out_p
    n, f = MESH_CLIP, LAGGED
    tsc = torch.stack(ts[:n])
    a = ms.run_clip(ms.shard_params(params), ms.shard_state(start), clip[:n],
                    tsc)
    b = plain.run_clip(params, start, clip[:n], tsc)
    win = clip[:n].reshape((n // f, f) + clip.shape[1:])
    c = ms.run_clip_lagged(ms.shard_params(params), ms.shard_state(start),
                           win, tsc.reshape(n // f, f, s))
    d = plain.run_clip_lagged(params, start, win,
                              tsc.reshape(n // f, f, s))
    clips = tuple(np_trees_equal(host_tree((ms.gather(x[0]),
                                            ms.gather(x[1], dim=1))),
                                 host_tree(y)) for x, y in ((a, b), (c, d)))
    log(f"[7a] run_clip over {n} frames and run_clip_lagged (F={f}) over "
        f"{n // f} windows through the mesh equal mesh=None: {clips}")
    if not all(clips):
        fail("[7a] run_clip or run_clip_lagged through the mesh differs")
    del a, b, c, d, win
    _, losses, head_m = e2e_train(clip, dev, card, head, mesh=mesh,
                                  tag="7a e2e")
    err = max(float(((x - y).abs() / y.abs().clamp_min(1e-30)).max())
              for x, y in zip([losses] + head_m, [e2e_losses] + e2e_head))
    log(f"[7a] e2e step over the 1x1 mesh against 6d's: largest relative "
        f"difference of the losses and the head {err:.3g} (rtol 1e-6)")
    if not all(torch.allclose(x, y, rtol=1e-6, atol=0) for x, y in
               zip([losses] + head_m, [e2e_losses] + e2e_head)):
        fail("[7a] the e2e step over the mesh differs from 6d's")
    dist.destroy_process_group()
    return collections.Counter(launches)


def mesh_rank(steps: int, labels: np.ndarray, head: str) -> dict:
    """7b, one of two ranks sharing the card (gloo): the flagship's 64
    streams split over dp = 2, this rank's 32 from ``pulse_clip`` of its
    own seed, half of them tracked; ``steps`` steps timed with the launch
    counters set to 0 just before and read just after, then one e2e step
    (the head replicated, its gradient averaged over dp).  Returns the
    launches, host clock, local state and last outputs, the gathered
    outputs (stream order) and the e2e loss and head."""
    import torch.distributed as dist

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.models.runner import tree_leaves
    from bp_from_video_tpu_torch.parallel import distributed
    from bp_from_video_tpu_torch.parallel.streams import MultiStreamEngine
    from bp_from_video_tpu_torch.train import bp_regressor as bpr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = dist.get_rank()
    mesh = distributed.global_mesh({"dp": 2})
    cfg = flagship_config()
    s, h, w = cfg.num_streams, cfg.frame_height, cfg.frame_width
    ms = MultiStreamEngine(cfg, mesh=mesh)
    dev = ms.device
    lo, hi = ms.stream_slice
    params = template_heads(ms.params)
    clip = pulse_clip(steps + 1, hi - lo, h, w, split=300,
                      seed=MESH_SEEDS[rank], device=dev)
    state = ms.shard_state(tracked_state(
        ms.engine, h, w, torch.arange(s, device=dev) % (s // 2) < s // 4))
    placed = ms.shard_params(params)
    ts = [torch.full((hi - lo,), (i + 1) / 30.0, device=dev)
          for i in range(steps + 1)]
    zero_counters()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(steps):
        state, out = ms.step(placed, state, clip[i], ts[i])
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t) * 1e3 / steps
    launches = {k: fn.launches for k, fn in counters().items()}
    gathered = ms.gather(_compact_out(out))
    sig = cfg.signal
    with np.load(head) as d:
        norm = {k: torch.from_numpy(d[k]).to(dev)
                for k in ("f_mu", "f_sd", "l_mu", "l_sd")}
    tstate, opt = bpr.init_train_state(
        torch.Generator().manual_seed(0),
        2 * (sig.num_signals + sig.num_pairs), device=dev)
    e2e = bpr.make_e2e_train_step(ms.step, opt, norm, mesh=mesh)
    state, tstate, loss = e2e(placed, state, tstate, clip[steps], ts[steps],
                              ms.shard_frames(labels))

    return dict(rank=rank, slice=(lo, hi), launches=launches,
                ms=ms_step, state=host_tree(state), out=host_tree(out),
                gathered=host_tree(gathered), loss=float(loss),
                head=host_tree(tree_leaves(tstate.params)))


def host_tree(tree):
    """A nest of tensors (DTensors: their local shards) as numpy on the
    host, bf16 as f32 (exact; numpy has no bf16)."""
    from bp_from_video_tpu_torch.models.runner import map_leaves
    from bp_from_video_tpu_torch.parallel import mesh as mesh_lib

    def host(x):
        if not isinstance(x, torch.Tensor):
            return x
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return map_leaves(host, mesh_lib.to_local(tree))


def np_trees_equal(a, b) -> bool:
    """Two nests of numpy arrays equal leaf for leaf, NaN pattern
    included."""
    from bp_from_video_tpu_torch.models.runner import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        (x is None and y is None) or (
            x.dtype == y.dtype and np.array_equal(
                x, y, equal_nan=x.dtype.kind == "f"))
        for x, y in zip(la, lb))


def _compact_out(out):
    from bp_from_video_tpu_torch.parallel.streams import ClipOutputs
    return ClipOutputs(out.bpm, out.ptt, out.curr_fs)


def mesh_two_ranks(dev, card: str, head: str) -> collections.Counter:
    """7b: two ranks sharing the card over gloo (NCCL refuses two ranks on
    one device), started by ``parallel.dryrun.spawn``: dp = 2, 32 streams a
    rank (``mesh_rank``).  Each rank's state and outputs after
    ``MESH_STEPS`` steps, and after one more e2e step, equal a one-rank
    ``MultiStreamEngine`` of 32 streams run here on the same half (the
    per-shard semantics: ``detector_subbatch`` acts per shard); the
    gathered outputs are in stream order; BPM 72 on the tracked streams;
    K1/K3/K4 1/10/1 a step on each rank; the e2e step's loss and head
    within rtol 1e-5 of the unsharded head step on the same features.
    Returns both ranks' launches."""
    import dataclasses

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.models.runner import map_leaves, tree_leaves
    from bp_from_video_tpu_torch.parallel.dryrun import spawn
    from bp_from_video_tpu_torch.parallel.streams import MultiStreamEngine
    from bp_from_video_tpu_torch.train import bp_regressor as bpr
    cfg = flagship_config()
    s, h, w = cfg.num_streams, cfg.frame_height, cfg.frame_width
    labels = np.random.default_rng(1).uniform(
        [110.0, 70.0], [130.0, 86.0], (s, 2)).astype(np.float32)
    t = time.perf_counter()
    ranks = spawn(mesh_rank, 2, (MESH_STEPS, labels, head), device="cuda",
                  backend="gloo", deadline=600)
    log(f"[7b] two ranks over gloo on one {card}: spawned, ran and "
        f"returned in {time.perf_counter() - t:.1f} s")
    total = collections.Counter()
    half = dataclasses.replace(cfg, num_streams=s // 2)
    feats = []
    for r in ranks:
        lo, hi = r["slice"]
        per = {k: v / MESH_STEPS for k, v in r["launches"].items() if v}
        log(f"[7b] rank {r['rank']} streams [{lo}, {hi}) on {card}: "
            f"{r['ms']:.3f} ms a step = {(hi - lo) * 1e3 / r['ms']:.1f} "
            f"frames/s (host clock, {MESH_STEPS} steps, the first "
            f"included; the card time-shared with the other rank); "
            f"launches a step {per}")
        if per != {"multi_crop": 1, "dense_s2_block": 10, "roi_samples": 1}:
            fail(f"[7b] rank {r['rank']} did not launch K1/K3/K4 1/10/1 a "
                 "step")
        total.update(r["launches"])
        one = MultiStreamEngine(half)
        params = template_heads(one.params)
        clip = pulse_clip(MESH_STEPS + 1, hi - lo, h, w, split=300,
                          seed=MESH_SEEDS[r["rank"]], device=dev)
        tracked = torch.arange(hi - lo, device=dev) < (hi - lo) // 2
        state = tracked_state(one.engine, h, w, tracked)
        for i in range(MESH_STEPS):
            state, out = one.step(params, state, clip[i], torch.full(
                (hi - lo,), (i + 1) / 30.0, device=dev))
        same_out = np_trees_equal(r["out"], host_tree(out))
        order = np_trees_equal(
            map_leaves(lambda x: x[lo:hi], r["gathered"]),
            host_tree(_compact_out(out)))
        hold_bpm(f"7b rank {r['rank']}", out.bpm, tracked)
        state, out = one.step(params, state, clip[MESH_STEPS], torch.full(
            (hi - lo,), (MESH_STEPS + 1) / 30.0, device=dev))
        same_state = np_trees_equal(r["state"], host_tree(state))
        log(f"[7b] rank {r['rank']}: outputs after {MESH_STEPS} steps and "
            f"state after the e2e step equal the one-rank engine of "
            f"{hi - lo} streams on its half, bit for bit: {same_out}, "
            f"{same_state}; its rows of the gathered [{s}, ...] outputs: "
            f"{order}")
        if not (same_out and same_state and order):
            fail(f"[7b] rank {r['rank']} differs from its per-shard run")
        feats.append(bpr.features_from_outputs(out.bpm, out.ptt))
        del clip, state, out, one
        torch.cuda.empty_cache()
    with np.load(head) as d:
        norm = {k: torch.from_numpy(d[k]).to(dev)
                for k in ("f_mu", "f_sd", "l_mu", "l_sd")}
    tstate, opt = bpr.init_train_state(torch.Generator().manual_seed(0),
                                       feats[0].shape[-1], device=dev)
    _, loss = bpr.train_step(
        opt, tstate, (torch.cat(feats) - norm["f_mu"]) / norm["f_sd"],
        (torch.from_numpy(labels).to(dev) - norm["l_mu"]) / norm["l_sd"])
    want = [loss.cpu()] + [x.detach().cpu() for x in
                           tree_leaves(tstate.params)]
    errs = [max(float(((torch.as_tensor(x) - y).abs()
                       / y.abs().clamp_min(1e-30)).max())
                for x, y in zip([r["loss"]] + r["head"], want))
            for r in ranks]
    log(f"[7b] e2e step over dp=2: loss {ranks[0]['loss']:.6f} / "
        f"{ranks[1]['loss']:.6f}, unsharded {want[0]:.6f}; largest relative "
        f"difference of loss and head per rank {errs} (rtol 1e-5)")
    if max(errs) > 1e-5:
        fail("[7b] the e2e step over dp=2 differs from the unsharded step")
    return total


def profile(engine, params, state, clip, t0, out_dir, path, render=None,
            lagged: int = 0):
    """Trace all but the last two steps of ``clip`` through the engine (as
    ``run_clip`` steps it): device time by kernel (and copy) and the
    device's busy share of the wall time; with ``render``, then the compose
    alone on the last step's outputs, its device time against the step's;
    then one step traced with its operators' shapes (kept out of the timed
    window: recording them costs host time), to find copies of frame-sized
    f32 maps; then the host sync points of the last step (CUDA sync debug
    mode)."""
    import collections
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof
    os.makedirs(out_dir, exist_ok=True)
    f = lagged or 1
    n = clip.shape[0] // f - 2
    kw = dict(render=render, lagged=lagged)
    name = path.replace(", ", "_").replace(" ", "_")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def device_events(p):
        evs = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
        evs.sort(key=lambda e: -e.self_device_time_total)
        return evs, sum(e.self_device_time_total for e in evs) / 1e6
    torch.cuda.synchronize()
    with prof(activities=acts) as p:
        t = time.perf_counter()
        state, out = run_clip(engine, params, state, clip[:n * f], t0=t0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    p.export_chrome_trace(os.path.join(out_dir, f"flagship_{name}_trace.json"))
    evs, busy = device_events(p)
    launches = sum(e.count for e in evs) / n
    log(f"profile [{path}]: {n} steps, wall {wall * 1e3:.3f} ms (profiled), "
        f"device time {busy * 1e3:.3f} ms, busy share {busy / wall:.4f}, "
        f"{launches:.1f} kernels and copies per step")
    for e in evs[:20]:
        log(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/step "
            f"x{e.count / n:6.1f}  {e.key[:100]}")
    if render is not None:
        last = clip[n * f - 1]
        with prof(activities=acts) as p:
            for _ in range(n):
                render(last, out)
            torch.cuda.synchronize()
        revs, rbusy = device_events(p)
        log(f"profile [{path}]: the compose alone, {n} calls: "
            f"{rbusy / n * 1e3:.3f} ms device time and "
            f"{sum(e.count for e in revs) / n:.1f} kernels and copies a "
            f"call, {rbusy / busy:.4f} of the composed step's device time")
        for e in revs[:8]:
            log(f"  {e.self_device_time_total / 1e3 / n:9.4f} ms/call "
                f"x{e.count / n:6.1f}  {e.key[:100]}")
    # Copies of a frame-sized f32 map: a copy of the skin weights, which K4
    # reads in place, would be one (78.6 MB at the flagship).
    with prof(activities=acts, record_shapes=True) as p:
        state, _ = run_clip(engine, params, state, clip[n * f:(n + 1) * f],
                            t0=t0 + n * f, **kw)
        torch.cuda.synchronize()
    trace = os.path.join(out_dir, f"flagship_{name}_shapes.json")
    p.export_chrome_trace(trace)
    cfg = engine.config
    plane = [cfg.num_streams * f, cfg.frame_height, cfg.frame_width]
    with open(trace) as fh:
        copies = [e.get("args", {}) for e in json.load(fh)["traceEvents"]
                  if e.get("name") == "aten::copy_"]
    if not any("Input Dims" in a and "Input type" in a for a in copies):
        fail(f"profile [{path}]: the trace records no copy's shapes")
    maps = [a["Input type"][1] for a in copies
            if a.get("Input Dims", [])[1:2] == [plane]]
    log(f"profile [{path}]: copies of an {plane} map in one step: "
        f"{len(maps)} (f32 {maps.count('float')})")
    if "float" in maps:
        fail(f"profile [{path}]: a frame-sized f32 map was copied")
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run_clip(engine, params, state, clip[(n + 1) * f:(n + 2) * f],
                 t0=t0 + (n + 1) * f, **kw)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    here = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter(
        f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))
    log(f"host syncs in one step [{path}]: {sum(sites.values())} "
        f"{dict(sites)}")


# -- phases 3l and 3m: compiled detectors and segmenter; the packed path ------

# Steps of 3l (then of its run with the graph passes on) and of each of
# 3m's runs.  BPM is held after ``HELD_STEPS`` and logged after
# ``EARLY_STEPS``: 60 samples do not settle the spectrum's peak, packed or
# not (each run logs its reading there beside the held one).
HELD_STEPS = 130
COMPILED_PASS_STEPS = 20
EARLY_STEPS = 60
COMPILED_KEYS = ("face_det", "flm_det", "flm_lm", "palm_det", "seg")
# The anchor phase 4's face detectors fire on: stride-8 cell (8, 6) of the
# 128 input, where a 96x128 person scene's face lies once letterboxed.
FACE_HOT = (6 * 16 + 8) * 2


def compiled_graphs(reduced: bool = False, hot: bool = False) -> dict:
    """Numpy-built graphs of every net the repo has a graph for: the two
    face detectors (BlazeFace twins at 128), the face mesh with its
    template head (full size, or reduced to 64x64 and three stages), the
    palm detector (192) and the segmenter (256).  ``hot``: the face
    detectors fire on ``FACE_HOT`` (a 50-pixel box)."""
    from bp_from_video_tpu_torch.models.mesh_graph import face_mesh_graph
    from bp_from_video_tpu_torch.models.twin_graphs import (detector_graph,
                                                            segmenter_graph)
    face = dict(hot_anchor=FACE_HOT, hot_box=50.0) if hot else {}
    mesh = (face_mesh_graph(7, 64, ((16, 8), (32, 16), (64, 32))) if reduced
            else face_mesh_graph(7))
    return {"face_det": detector_graph(11, 128, (2, 6), 6, **face),
            "flm_det": detector_graph(12, 128, (2, 6), 6, **face),
            "flm_lm": template_mesh(mesh),
            "palm_det": detector_graph(13, 192, (2, 6), 7),
            "seg": segmenter_graph(14, 256, 6)}


def _graph_ops(runner) -> str:
    """Op counts of the compiled detectors' and segmenter's graphs."""
    out = []
    for key in ("face_det", "palm_det", "seg"):
        fn = runner._seg_fn if key == "seg" else runner._det_fns[key]
        ops = collections.Counter(op.opcode for op in fn.graph.ops)
        out.append(f"{key} {sum(ops.values())} ops ("
                   + ", ".join(f"{k} {v}" for k, v in sorted(ops.items()))
                   + ")")
    return "; ".join(out)


def compiled_nets(clip, dev, card: str) -> collections.Counter:
    """Phase 3l: ``preset_config("multistream")`` over ``clip`` (8 streams
    of person scenes, 480x640 bf16) with every net compiled that the repo
    has a graph for (``compiled_graphs``; the hand net stays the stand-in,
    as the reference mixes a compiled palm detector with a stand-in hand
    net), template heads, half the streams tracked, every stream composed:
    ``HELD_STEPS`` steps, then ``COMPILED_PASS_STEPS`` with
    ``fuse_dw_pw`` and ``pack_s2d=64`` (the detectors and the segmenter
    rewritten; the mesh keeps its fused stem).  Fails unless each compiled
    net ran, the kernels launched as ``PER_STEP`` says, the face ROI's BPM
    is near 72 on the tracked streams (the first run; its reading at
    ``EARLY_STEPS`` logged) and the segmenter's
    confidences sum to 1 within 2e-2 at every pixel.  Returns the launch
    counts."""
    import dataclasses

    from bp_from_video_tpu_torch.config import preset_config
    from bp_from_video_tpu_torch.render.drawer import Drawer
    from bp_from_video_tpu_torch.runtime.engine import Engine
    total = collections.Counter()
    base = preset_config("multistream", clip.shape[1])
    for path, steps, infer in (
            ("multistream, compiled nets", HELD_STEPS, {}),
            ("multistream, compiled nets, fuse_dw_pw + pack_s2d",
             COMPILED_PASS_STEPS, dict(fuse_dw_pw=True, pack_s2d=64))):
        cfg = dataclasses.replace(base, inference=dataclasses.replace(
            base.inference, **infer))
        t = time.perf_counter()
        engine = Engine(cfg, graphs=compiled_graphs())
        run = engine.runner
        want = dict.fromkeys(COMPILED_KEYS, True) | {"hand_lm": False}
        if run.real_weights != want:
            fail(f"[{path}]: compiled nets {run.real_weights}")
        log(f"[{path}] engine built in {time.perf_counter() - t:.2f} s; "
            f"{_graph_ops(run)}")
        params = template_heads(engine.params, keys=("hand_lm",))
        drawer = Drawer(cfg, show=False)
        launches, out = drive(
            path, engine, params, clip[:steps], dev, card,
            check_signal=steps == HELD_STEPS,
            render=lambda f, o: drawer.compose(f, o), held=(0,), syncs=True,
            early=EARLY_STEPS)
        total.update(launches)
        calls = dict(run.graph_calls)
        conf = out.models.seg_conf
        err = float((conf.sum(1) - 1).abs().max())
        log(f"[{path}] compiled-net calls {calls}; segmenter confidences "
            f"{tuple(conf.shape)}: largest |sum - 1| {err:.3g} (bound 2e-2)")
        if any(not calls.get(k) for k in COMPILED_KEYS):
            fail(f"[{path}]: a compiled net did not run")
        if not err <= 2e-2:
            fail(f"[{path}]: the segmenter's confidences do not sum to 1")
        del engine, out
        torch.cuda.empty_cache()
    return total


def net_ms(engine, params, frames, calls: int = 10) -> dict:
    """Each landmark net on one step's K1 crops of ``frames`` (the tracked
    rects of ``tracked_state``), the crops made once outside the timing:
    (device ms a call, kernels and copies a call, CUDA-event ms a call).
    The device time is the sum of its kernels' times over ``calls`` calls
    under ``torch.profiler``, the card's own work; the CUDA-event time
    behind ``time_ms``'s sleep kernel also holds the gaps where the card
    waits for the host to launch the next of the net's ~100-200 ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof
    run = engine.runner
    h, w = frames.shape[-2:]
    st = tracked_state(engine, h, w, torch.ones(frames.shape[0],
                                                dtype=torch.bool,
                                                device=frames.device)).track
    covers = {"flm_lm": st.face_rect, "hand_lm": st.hand_rects}
    crops = run._k1_crops(frames, True, covers)
    out = {}
    with torch.no_grad():
        for key, c in crops.items():
            def call(k=key, c=c, p=bool(run._packed_in.get(key))):
                return run._landmarks(k, params[k], c, p)
            ev = time_ms(call, reps=5, inner=2)
            torch.cuda.synchronize()
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                for _ in range(calls):
                    call()
                torch.cuda.synchronize()
            evs = [e for e in p.key_averages()
                   if e.device_type == DeviceType.CUDA]
            dev_ms = sum(e.self_device_time_total for e in evs) / 1e3 / calls
            if not dev_ms > 0:
                fail(f"net_ms [{key}]: the profiler saw no device time")
            out[key] = (dev_ms, sum(e.count for e in evs) / calls, ev)
    return out


def packed_path(clip, dev, card: str) -> collections.Counter:
    """Phase 3m: ``flagship_config()`` with the fused stem and trunk off,
    ``fuse_dw_pw`` and ``pack_s2d=64`` (the JAX bench's flagship with
    ``BENCH_FUSE=1 BENCH_S2D=64`` and its fused stem off) over
    ``HELD_STEPS`` steps of ``clip`` (64 streams): (i) stand-in nets, K1
    packing their crops for their packed stem twins; (ii) the face net the
    compiled mesh, compiled to take its crop packed (a 12-channel input).
    BPM near 72 on every held ROI and PTT as in phase 3 (the readings at
    ``EARLY_STEPS`` logged); K1 and K4 once a step.  Then the same two with
    the passes off (``unpacked``, the control, held the same way), and each
    landmark net's device time alone on one step's crops, packed and
    unpacked (``net_ms``).  Returns the launch counts."""
    import dataclasses

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.models.mesh_graph import face_mesh_graph
    from bp_from_video_tpu_torch.runtime.engine import Engine
    base = flagship_config(clip.shape[1])
    total = collections.Counter()
    nets = {}
    for path, mesh, passes in (
            ("packed, stand-ins", False, True),
            ("packed, compiled mesh", True, True),
            ("unpacked, stand-ins", False, False),
            ("unpacked, compiled mesh", True, False)):
        cfg = dataclasses.replace(base, inference=dataclasses.replace(
            base.inference, fused_stem=False, fused_trunk=False,
            fuse_dw_pw=passes, pack_s2d=64 if passes else 0))
        graphs = {"flm_lm": template_mesh(face_mesh_graph(7))} if mesh \
            else None
        engine = Engine(cfg, graphs=graphs)
        run = engine.runner
        params = template_heads(engine.params, keys=(
            ("hand_lm",) if mesh else ("flm_lm", "hand_lm")))
        packs = {k: 2 if run._packed_in.get(k) else 1 for k in run.sizes
                 if k.endswith("_lm")}
        note = ""
        if mesh:
            g = run._graph_fns["flm_lm"].graph
            ish = g.tensors[g.inputs[0]].shape
            ops = collections.Counter(op.opcode for op in g.ops)
            note = (f"; the mesh graph takes {ish} (crop {run.sizes['flm_lm']}"
                    f"), {sum(ops.values())} ops: {dict(sorted(ops.items()))}")
            if ish[3] != (12 if passes else 3):
                fail(f"[{path}]: the mesh graph takes {ish}")
        log(f"[{path}] K1 packs per net {packs}, fused stems "
            f"{sorted(run._stem_src)}{note}")
        if set(packs.values()) != {2 if passes else 1} or run._stem_src:
            fail(f"[{path}]: the nets do not take K1's crops as configured")
        launches, _ = drive(path, engine, params, clip[:HELD_STEPS], dev,
                            card, syncs=True, early=EARLY_STEPS)
        total.update(launches)
        nets[path] = net_ms(engine, params, clip[-1])
        del engine
        torch.cuda.empty_cache()
    for what in ("stand-ins", "compiled mesh"):
        a, b = nets[f"packed, {what}"], nets[f"unpacked, {what}"]
        log(f"[3m {what}] landmark nets alone on one step's K1 crops "
            f"({clip.shape[1]} streams, bf16) on {card}: "
            + "; ".join(
                f"{k} device ms packed {a[k][0]:.4f} ({a[k][1]:.1f} "
                f"kernels), unpacked {b[k][0]:.4f} ({b[k][1]:.1f}): "
                f"{a[k][0] / b[k][0]:.3f}x; CUDA events packed "
                f"{a[k][2]:.4f}, unpacked {b[k][2]:.4f}" for k in a))
    return total


def _hold_seg_conf(a, b, tag: str) -> None:
    """Segmenter confidences within 1e-4, but for at most 1e-3 of the
    pixels, where a bf16 operand of the full-resolution upsample rounded
    to a neighbouring value: there within one bf16 ulp of a confidence
    below 1 (2^-8)."""
    d = (a - b).abs()
    off = float((d > 1e-4).float().mean())
    top = float(d.max())
    log(f"card vs CPU [{tag}]: segmenter confidences differ by up to "
        f"{top:.3g}; share beyond 1e-4 {off:.3g}")
    if off > 1e-3 or top > 2.0 ** -8:
        fail(f"card and CPU segmenter confidences differ [{tag}]")


def compiled_card_vs_cpu(steps: int, dev, devices=("cuda", "cpu")) -> None:
    """Phase 4's compiled-net run: ``multistream`` at S = 2, 96x128, f32
    with ``compiled_graphs(reduced=True, hot=True)`` (stream 1 starts
    untracked: the compiled face-landmarker detector acquires it) on the
    card and on the CPU over person scenes: the face detector's boxes and
    every landmark within 1 px at every step, the segmenter's confidences
    (last step) as ``_hold_seg_conf``, BPM equal, PTT within one sample
    period (last step)."""
    import dataclasses

    from bp_from_video_tpu_torch.config import preset_config
    from bp_from_video_tpu_torch.runtime.engine import Engine
    s, h, w = 2, 96, 128
    clip = pulse_clip(steps, s, h, w, split=60, seed=6, device=dev,
                      person=True)
    cfg = dataclasses.replace(preset_config("multistream", s, h, w),
                              compute_dtype="float32")
    res = {}
    for where in devices:
        eng = Engine(cfg, device=where,
                     graphs=compiled_graphs(reduced=True, hot=True))
        params = template_heads(eng.params, keys=("hand_lm",))
        st = tracked_state(eng, h, w, torch.tensor([True, False],
                                                   device=eng.device))
        rows = []
        t = time.perf_counter()
        for i in range(steps):
            st, out = eng.batch_step(params, st, clip[i].to(where),
                                     torch.full((s,), (i + 1) / 30.0,
                                                device=eng.device))
            m = out.models
            rows.append(torch.cat([m.face_detector.bbox.flatten(1),
                                   m.face_landmarker.points.flatten(1),
                                   m.hand_landmarker.points.flatten(1)],
                                  1).cpu())
        res[where] = (torch.stack(rows), out, dict(eng.runner.graph_calls))
        log(f"small f32 [compiled nets] S={s} {h}x{w} on {where}: {steps} "
            f"steps in {time.perf_counter() - t:.2f} s; calls "
            f"{res[where][2]}; faces found by the face detector "
            f"{out.models.face_detector.count.tolist()}, tracked "
            f"{st.track.face_tracking.tolist()}")
    (pa, a, ca), (pb, b, cb) = (res[d] for d in devices)
    dp = float((pa - pb).abs().nan_to_num(0).max())
    same_nan = torch.equal(pa.isnan(), pb.isnan())
    bpm_a, bpm_b = a.bpm.cpu(), b.bpm
    ptt_a, ptt_b = a.ptt.cpu(), b.ptt
    log(f"card vs CPU [compiled nets]: boxes and landmarks differ by up to "
        f"{dp:g} px over {steps} steps (NaN pattern equal {same_nan}); BPM "
        f"{bpm_a.tolist()} / {bpm_b.tolist()}; PTT ms {ptt_a.tolist()} / "
        f"{ptt_b.tolist()}")
    if not (dp <= 1.0 and same_nan and ca == cb
            and all(ca.get(k) for k in COMPILED_KEYS)):
        fail("card and CPU detections or landmarks differ [compiled nets]")
    if int(a.models.face_detector.count.min()) < 1:
        fail("[compiled nets]: the hot face detector found no face")
    _hold_seg_conf(a.models.seg_conf.cpu(), b.models.seg_conf,
                   "compiled nets")
    if not (bool(torch.isfinite(bpm_a[:, 0]).all())
            and torch.equal(bpm_a.nan_to_num(-1), bpm_b.nan_to_num(-1))):
        fail("card and CPU BPM differ [compiled nets]")
    if not bool((((ptt_a - ptt_b).abs() <= 1000.0 / 30.0)
                 | (ptt_a.isnan() & ptt_b.isnan())).all()):
        fail("card and CPU PTT differ by more than one sample period "
             "[compiled nets]")


def card_vs_cpu(steps: int, dev):
    """A small f32 config on the card (kernels) and on the CPU (plain
    versions) over one clip (person scenes for ``segmenter_fir`` and
    ``multistream``): with stand-in nets, with the face net a compiled mesh
    graph of reduced size, every stage fused, the two single-ROI presets
    (BPM equal; the FIR taps designed on each device side by side) and
    ``multistream``, plain and lagged, composed."""
    import dataclasses

    from bp_from_video_tpu_torch.config import (EngineConfig,
                                                InferenceConfig,
                                                preset_config)
    from bp_from_video_tpu_torch.models.mesh_graph import face_mesh_graph
    from bp_from_video_tpu_torch.ops import fir
    from bp_from_video_tpu_torch.runtime.engine import Engine
    s, h, w = 2, 96, 128
    clip = pulse_clip(steps, s, h, w, split=60, seed=4, device=dev)
    fused = dict(fused_stem=True, fused_trunk=True, fused_bn_min_hw=0)
    # 3m's paths at this size: the reduced mesh packed from 16x16 up.
    packed = dict(fused_stem=False, fused_trunk=False, fuse_dw_pw=True,
                  pack_s2d=16)
    for name, mesh, kw in (("stand-ins", False, fused),
                           ("compiled face graph", True, fused),
                           ("packed stand-ins", False, packed),
                           ("packed compiled face graph", True, packed)):
        cfg = EngineConfig(frame_height=h, frame_width=w, num_streams=s,
                           compute_dtype="float32",
                           inference=InferenceConfig(use_pallas=True, **kw))
        outs = {}
        # The packed paths on the first half of the clip.
        on = clip[:steps // 2] if kw is packed else clip
        for where in ("cuda", "cpu"):
            graphs = ({"flm_lm": template_mesh(face_mesh_graph(
                7, 64, ((16, 8), (32, 16), (64, 32))))} if mesh else None)
            eng = Engine(cfg, device=where, graphs=graphs)
            params = template_heads(eng.params, keys=(
                ("hand_lm",) if mesh else ("flm_lm", "hand_lm")))
            st = tracked_state(eng, h, w, torch.ones(s, dtype=torch.bool,
                                                     device=eng.device))
            t = time.perf_counter()
            _, outs[where] = run_clip(eng, params, st, on.to(where))
            log(f"small f32 [{name}] S={s} {h}x{w} on {where}: "
                f"{on.shape[0]} steps in {time.perf_counter() - t:.2f} s")
        a, b = outs["cuda"], outs["cpu"]
        bpm_a, bpm_b = a.bpm.cpu(), b.bpm
        ptt_a, ptt_b = a.ptt.cpu(), b.ptt
        log(f"card vs CPU [{name}]: BPM {bpm_a.tolist()} / {bpm_b.tolist()}; "
            f"PTT ms {ptt_a.tolist()} / {ptt_b.tolist()}")
        if not (bool(torch.isfinite(bpm_a).all())
                and torch.equal(bpm_a, bpm_b)):
            fail(f"card and CPU BPM differ [{name}]")
        if not bool(((ptt_a - ptt_b).abs() <= 1000.0 / 30.0).all()):
            fail(f"card and CPU PTT differ by more than one sample period "
                 f"[{name}]")
        if kw is packed:
            dp = max(float((getattr(a.models, d).points.cpu()
                            - getattr(b.models, d).points).abs()
                           .nan_to_num(0).max())
                     for d in ("face_landmarker", "hand_landmarker"))
            log(f"card vs CPU [{name}]: landmarks differ by up to {dp:g} px")
            if not dp <= 1.0:
                fail(f"card and CPU landmarks differ [{name}]")
    person = pulse_clip(steps, s, h, w, split=60, seed=6, device=dev,
                        person=True)
    for name in PRESETS[:2]:
        cfg = dataclasses.replace(preset_config(name, s, h, w),
                                  compute_dtype="float32")
        on = person if name == "segmenter_fir" else clip
        outs, taps = {}, {}
        for where in ("cuda", "cpu"):
            eng = Engine(cfg, device=where)
            params = template_heads(eng.params, keys=("flm_lm",))
            st = tracked_state(eng, h, w, torch.ones(s, dtype=torch.bool,
                                                     device=eng.device))
            t = time.perf_counter()
            _, out = run_clip(eng, params, st, on.to(where))
            log(f"small f32 [{name}] S={s} {h}x{w} on {where}: {steps} "
                f"steps in {time.perf_counter() - t:.2f} s")
            outs[where] = out
            # The FIR design at the clip's sampling rate, on each device.
            fs = torch.full((s,), 30.0, device=eng.device)
            bands, desired = fir.reference_fir_bands(
                cfg.signal.min_freq, cfg.signal.max_freq, cfg.signal.fir_df,
                fs)
            taps[where] = fir.firls_bandpass(cfg.signal.fir_taps, bands,
                                             desired, fs)[0].cpu()
        a, b = outs["cuda"], outs["cpu"]
        bpm_a, bpm_b = a.bpm.cpu(), b.bpm
        log(f"card vs CPU [{name}]: BPM {bpm_a.tolist()} / {bpm_b.tolist()}")
        if not (bool(torch.isfinite(bpm_a).all())
                and torch.equal(bpm_a, bpm_b)):
            fail(f"card and CPU BPM differ [{name}]")
        m = cfg.signal.fir_taps // 2
        d = float((taps["cuda"] - taps["cpu"]).abs().max())
        log(f"FIR taps at 30 fps, card / CPU: centre "
            f"{taps['cuda'][m]:.9g} / {taps['cpu'][m]:.9g}, first "
            f"{taps['cuda'][0]:.9g} / {taps['cpu'][0]:.9g}; largest "
            f"difference {d:.3g} (taps' largest {taps['cpu'].abs().max():.3g})")
    for lagged in (0, LAGGED):
        multistream_card_vs_cpu(person, lagged)
    rotation_card_vs_cpu(clip[:40])
    compiled_card_vs_cpu(steps // 2, dev)


def _layer_mask(det, h: int, w: int):
    """[S, H, W] bool: the pixels a model's boxes and landmarks draw."""
    from bp_from_video_tpu_torch.render import overlay
    pts = det.points.reshape(det.points.shape[0], -1, 2)
    return (overlay.rect_mask(det.bbox, h, w)
            + overlay.points_mask(pts, h, w)) > 0.5


def _images_close(a, b, where=None, frac: float = 1e-3) -> tuple[int, int]:
    """Pixels of two uint8 image batches that differ (outside ``where``):
    fails unless each differs by at most 1 and at most ``frac`` of them
    do (the CPU tests' tolerance).  Returns (differing, largest)."""
    d = (a.int() - b.int()).abs().amax(-1)
    if where is not None:
        d = d.masked_fill(where, 0)
    n, top = int((d > 0).sum()), int(d.max())
    if top > 1 or n > frac * d.numel():
        fail(f"composed images differ at {n} pixels, by up to {top}")
    return n, top


def multistream_card_vs_cpu(clip, lagged: int, devices=("cuda", "cpu")
                            ) -> None:
    """``multistream`` at S = 2, 96x128, f32 on the card and on the CPU over
    ``clip`` (person scenes), plain or lagged, each composed after its last
    step: BPM equal, PTT within one sample period; each device's compose of
    the CPU's outputs: frames within the CPU tests' tolerance, plots and
    packed vectors equal; each device's compose of its own outputs: frames
    within it where the two devices' hand drawings agree."""
    import dataclasses

    from bp_from_video_tpu_torch.config import preset_config
    from bp_from_video_tpu_torch.models.runner import map_leaves
    from bp_from_video_tpu_torch.render.drawer import Drawer
    from bp_from_video_tpu_torch.runtime.engine import Engine
    s, h, w = clip.shape[1], clip.shape[-2], clip.shape[-1]
    name = "multistream" + (f", lagged F={lagged}" if lagged else "")
    cfg = dataclasses.replace(preset_config("multistream", s, h, w),
                              compute_dtype="float32")
    card, cpu = devices
    outs, own, drawers = {}, {}, {}
    for where in devices:
        eng = Engine(cfg, device=where)
        params = template_heads(eng.params)
        st = tracked_state(eng, h, w, torch.ones(s, dtype=torch.bool,
                                                 device=eng.device))
        t = time.perf_counter()
        _, outs[where] = run_clip(eng, params, st, clip.to(where),
                                  lagged=lagged)
        drawers[where] = Drawer(cfg, show=False, device=where)
        own[where] = drawers[where].compose(clip[-1].to(where), outs[where])
        log(f"small f32 [{name}] S={s} {h}x{w} on {where}: "
            f"{clip.shape[0]} frames in {time.perf_counter() - t:.2f} s")
    a, b = outs[card], outs[cpu]
    bpm_a, bpm_b = a.bpm.cpu(), b.bpm
    ptt_a, ptt_b = a.ptt.cpu(), b.ptt
    log(f"card vs CPU [{name}]: BPM {bpm_a.tolist()} / {bpm_b.tolist()}; "
        f"PTT ms {ptt_a.tolist()} / {ptt_b.tolist()}")
    if not (bool(torch.isfinite(bpm_a[:, 0]).all())
            and torch.equal(bpm_a.nan_to_num(-1), bpm_b.nan_to_num(-1))):
        fail(f"card and CPU BPM differ [{name}]")
    if not bool((((ptt_a - ptt_b).abs() <= 1000.0 / 30.0)
                 | (ptt_a.isnan() & ptt_b.isnan())).all()):
        fail(f"card and CPU PTT differ by more than one sample period "
             f"[{name}]")
    cpu_on_card = drawers[card].compose(
        clip[-1].to(card), map_leaves(lambda x: x.to(card), b))
    f_img, p_img, packed = (x.cpu() for x in cpu_on_card)
    n, top = _images_close(f_img, own[cpu][0])
    if not (torch.equal(p_img, own[cpu][1])
            and torch.equal(packed.nan_to_num(-7), own[cpu][2].nan_to_num(-7))):
        fail(f"[{name}] the card's compose of the CPU's outputs: plots or "
             "packed vectors differ from the CPU's")
    log(f"[{name}] the CPU's outputs composed on the card and on the CPU: "
        f"frames differ at {n} pixels (by up to {top}), plots and packed "
        f"vectors equal")
    moved = (_layer_mask(map_leaves(lambda x: x.cpu(),
                                    a.models.hand_landmarker), h, w)
             ^ _layer_mask(b.models.hand_landmarker, h, w))
    n, top = _images_close(own[card][0].cpu(), own[cpu][0], moved)
    log(f"[{name}] each device's compose of its own outputs: frames differ "
        f"at {n} pixels (by up to {top}) where the hand drawings agree; "
        f"they are apart at {int(moved.sum())} pixels")
    if int(moved.sum()) > 1e-2 * moved.numel():
        fail(f"[{name}] the two devices' hand drawings are far apart")


# -- phase 5: the host runtime on the card ---------------------------------------

# Phase 5's clips: frames a file, and the entry points' frame cap on the
# pipelined and sequential drivers.
RUNTIME_FRAMES = 260
RUNTIME_MAX = 120
# The clips' seeds: every file of 5a-5d is made from the first; 5e runs
# card against CPU on two files of each.
RUNTIME_SEEDS = (7, 11)


@contextlib.contextmanager
def spy_runtime():
    """Observe the normal entry points from outside: each engine step (its
    count, the time of the first, the last state and outputs) and each
    feeder the pipelined driver builds.  Launch counts stay with the
    kernels' own counters.  The pipelined driver's readers deliver each
    file as a camera would (``Paced``), the traffic that driver is for."""
    import cv2

    from bp_from_video_tpu_torch.drivers import pipelined
    from bp_from_video_tpu_torch.exceptions import CaptureError
    from bp_from_video_tpu_torch.runtime.engine import Engine
    seen = {"steps": 0, "frames": 0, "t_first": None, "state": None,
            "out": None, "feeders": []}
    orig = {n: getattr(Engine, n) for n in ("batch_step", "batch_step_lagged")}

    def wrap(fn):
        def step(self, params, state, frames, ts):
            if seen["t_first"] is None:
                seen["t_first"] = time.perf_counter()
            state, out = fn(self, params, state, frames, ts)
            seen["steps"] += 1
            seen["frames"] += ts.numel()
            seen["state"], seen["out"] = state, out
            return state, out
        return step

    class Feeder(pipelined.DeviceFeeder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["feeders"].append(self)

    class Paced(pipelined.VideoReader):
        """A recorded file read as a camera delivers it: frame k no sooner
        than k / fps after the first read, the file from its start again
        after its last frame, timestamps running on."""

        def read_frame(self):
            fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
            if not hasattr(self, "t0"):
                self.t0, self.k = time.perf_counter(), 0
                self.offset, self.last = 0.0, float("nan")
            wait = self.t0 + self.k / fps - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.k += 1
            try:
                fd = super().read_frame()
            except CaptureError:
                self.cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                self.offset = self.last + 1.0 / fps
                fd = super().read_frame()
            fd.timestamp += self.offset
            fd.sampling_freq = 1.0 / (fd.timestamp - self.last)
            self.last = fd.timestamp
            return fd

    orig_mods = {"DeviceFeeder": pipelined.DeviceFeeder,
                 "VideoReader": pipelined.VideoReader}
    for n, fn in orig.items():
        setattr(Engine, n, wrap(fn))
    pipelined.DeviceFeeder, pipelined.VideoReader = Feeder, Paced
    try:
        yield seen
    finally:
        for n, fn in orig.items():
            setattr(Engine, n, fn)
        for n, cls in orig_mods.items():
            setattr(pipelined, n, cls)


def write_runtime_clips(dirname: str, dev, s: int, h: int, w: int,
                        steps: int, seed: int = 7) -> list[str]:
    """``s`` MJPG files of ``steps`` person scenes pulsing at 72 BPM (the
    lower part 3 frames late), made on the card from ``seed``, written as
    BGR; fails unless ``cv2.VideoWriter`` opens an MJPG ``.avi``."""
    import cv2
    clip = pulse_clip(steps, s, h, w, split=300 * h // 480, seed=seed,
                      device=dev, person=True)
    paths = []
    for i in range(s):
        path = os.path.join(dirname, f"seed{seed}_stream{i}.avi")
        wr = cv2.VideoWriter(path, cv2.VideoWriter.fourcc(*"MJPG"), 30.0,
                             (w, h))
        if not wr.isOpened():
            fail(f"cv2.VideoWriter (OpenCV {cv2.__version__}) does not "
                 "open an MJPG .avi")
        for f in clip[:, i].flip(1).permute(0, 2, 3, 1).cpu().numpy():
            wr.write(f)
        wr.release()
        paths.append(path)
    return paths


def run_cli(tag: str, argv: list[str], card: str, steps: int):
    """``cli.main(argv)`` in this process with the kernels' counters set to
    0 just before and read just after: logs the host clock (the whole call:
    decode, engine build, steps) and frames/s, the drivers' stage times,
    every kernel's launches, the tracked count and the BPM of the last
    step, and for the pipelined driver the frames its feeder dropped; fails
    unless the call ran ``steps`` engine steps and K1 and K4 (its sample
    entry, skin-weighted: the segmenter runs) launched once a step.
    Returns the launch counts and what the call printed."""
    import io

    from bp_from_video_tpu_torch import cli
    from bp_from_video_tpu_torch.utils.profiling import profiler
    profiler.clear()
    buf = io.StringIO()
    with spy_runtime() as seen, contextlib.redirect_stdout(buf):
        zero_counters()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    printed = buf.getvalue()
    for line in printed.splitlines():
        log(f"[{tag}] | {line}")
    launches = {k: fn.launches for k, fn in counters().items()}
    launches["roi_samples weighted"] = counters()["roi_samples"
                                                  ].weighted_launches
    n, frames = seen["steps"], seen["frames"]
    shown = " ".join(os.path.basename(a) if os.sep in a else a for a in argv)
    log(f"[{tag}] cli.main({shown}) returned {rc}")
    log(f"[{tag}] {n} engine steps, {frames} frames on {card}: host clock "
        f"{t_end - t:.3f} s = {frames / (t_end - t):.1f} frames/s end to end "
        f"(decode and engine build {seen['t_first'] - t:.3f} s; first step "
        f"to return {t_end - seen['t_first']:.3f} s = "
        f"{frames / (t_end - seen['t_first']):.1f} frames/s)")
    for name, st in profiler.stats.items():
        log(f"[{tag}] stage {name}: {st.calls} calls, mean "
            f"{st.total / st.calls * 1e3:.3f} ms, min {st.best * 1e3:.3f}, "
            f"max {st.worst * 1e3:.3f}")
    log(f"[{tag}] launches: {launches}")
    if rc != 0 or n != steps:
        fail(f"[{tag}] the entry point ran {n} engine steps, not {steps}")
    if any(launches[k] != n for k in ("multi_crop", "roi_samples",
                                      "roi_samples weighted")):
        fail(f"[{tag}] K1 and K4 did not launch once a step ({n} steps)")
    tr = seen["state"].track
    out = seen["out"]
    log(f"[{tag}] last step: faces tracked {int(tr.face_tracking.sum())}/"
        f"{tr.face_tracking.numel()}, hands tracked "
        f"{int(tr.hand_tracking.sum())}/{tr.hand_tracking.numel()}; BPM "
        f"{out.bpm.float().cpu().tolist()}, PTT ms "
        f"{out.ptt.float().cpu().tolist()}")
    for f in seen["feeders"]:
        log(f"[{tag}] feeder dropped {f.dropped.tolist()} frames a stream "
            f"({int(f.dropped.sum())} of {int(f._seq.sum())} captured, "
            f"{f._seq.sum() / f._seq.size / (t_end - seen['t_first']):.1f} "
            "frames/s a stream from the first step)")
    return launches, printed


def runtime_card_vs_cpu(paths: list[str], micro_batch: int | None,
                        seed: int, devices=("cuda", "cpu")) -> None:
    """``process_videos`` of two files at 96x128 (resized on the host),
    f32, the ``multistream`` preset, on the card and on the CPU, its engine
    given template heads and a tracked start as in phase 4 (so the ROIs do
    not depend on roundoff in the nets: with free nets f32 convolutions
    summed in another order move a landmark, and a ROI, by a pixel): BPM
    equal (NaN pattern included), PTT within one sample period,
    ``curr_fs`` and the timestamps equal.  Per-frame rows are held once
    settled: over the first few samples the periodogram is nearly flat and
    roundoff picks its peak, and the BPM of a row is the mean of the peak
    ring (``peak_max_samples`` rows), so BPM is held from the first row
    whose ring holds only peaks of row 10 on.  The micro-batched run's
    rows are windows, whose first analysis already sees F samples: every
    row is held.  The rows that differ are logged."""
    import dataclasses

    from bp_from_video_tpu_torch.config import preset_config
    from bp_from_video_tpu_torch.runtime import offline

    class Held(offline.MultiStreamEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.params = self.engine.params = template_heads(self.params)

        def init_states(self):
            cfg = self.config
            return tracked_state(self.engine, cfg.frame_height,
                                 cfg.frame_width,
                                 torch.ones(cfg.num_streams, dtype=torch.bool,
                                            device=self.device))

    cfg = dataclasses.replace(preset_config("multistream", 2, 96, 128),
                              compute_dtype="float32")
    name = (f"process_videos seed {seed}"
            f"{f', micro-batch {micro_batch}' if micro_batch else ''}")
    outs = {}
    free = offline.MultiStreamEngine
    offline.MultiStreamEngine = Held
    try:
        for where in devices:
            t = time.perf_counter()
            outs[where] = offline.process_videos(
                paths, cfg, target_res=(96, 128), micro_batch=micro_batch,
                device=where)
            log(f"[5e {name}] S=2 96x128 f32 on {where}: "
                f"{time.perf_counter() - t:.2f} s")
    finally:
        offline.MultiStreamEngine = free
    (a, ta), (b, tb) = (outs[d] for d in devices)
    settled = 0 if micro_batch else 10 + cfg.signal.peak_max_samples - 1
    same = np.isclose(a.bpm, b.bpm, rtol=0, atol=0, equal_nan=True).all(
        (1, 2))
    differ = np.flatnonzero(~same).tolist()
    ptt_ok = (np.abs(a.ptt - b.ptt) <= 1000.0 / 30.0) | (
        np.isnan(a.ptt) & np.isnan(b.ptt))
    fs_same = np.array_equal(a.curr_fs, b.curr_fs, equal_nan=True)
    log(f"[5e {name}] card vs CPU: {a.bpm.shape[0]} rows; BPM finite "
        f"{int(np.isfinite(a.bpm).sum())}/{a.bpm.size}, last row "
        f"{a.bpm[-1].tolist()} / {b.bpm[-1].tolist()}; rows whose BPM "
        f"differs {differ} (held from row {settled}); PTT within a sample "
        f"period {int(ptt_ok.sum())}/{ptt_ok.size}, last row "
        f"{a.ptt[-1].tolist()} / {b.ptt[-1].tolist()}; curr_fs equal "
        f"{fs_same}, timestamps equal {np.array_equal(ta, tb)}")
    if not (same[settled:].all() and ptt_ok.all() and fs_same
            and np.isfinite(a.bpm[-1, :, 0]).all()
            and np.array_equal(ta, tb)):
        fail(f"[5e {name}] the card's outputs differ from the CPU's")


def host_runtime(dev, card: str, bp_head: str, s: int = 8, h: int = 480,
                 w: int = 640, frames: int = RUNTIME_FRAMES
                 ) -> collections.Counter:
    """Phase 5: the normal entry points on the card (``cli.main`` in this
    process, ``--preset multistream --dtype bfloat16 --device cuda``) over
    ``s`` recorded files of ``frames`` person scenes at ``h``x``w``: (5a)
    ``--offline``, (5b) ``--offline --micro-batch 4``, (5c) ``--pipelined``
    headless, its readers paced at the files' frame rate, (5d) the
    sequential driver on one file, headless; (5e) ``process_videos`` card
    against CPU on two clips of each of ``RUNTIME_SEEDS``.  5a also loads
    the BP head ``bp_head`` (``--bp``); its report must give mmHg for every
    stream (6c).  The CLI's config is its own
    mapping: the kernels on (a CUDA device), the fused stem and trunk at
    their defaults (off).  BPM is logged, not held: the face net is a
    random-init stand-in and the entry points start untracked.  Returns
    the launch counts of 5a-5d."""
    import cv2
    log(f"[5] OpenCV {cv2.__version__}")
    total = collections.Counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    try:
        t = time.perf_counter()
        paths = write_runtime_clips(tmp, dev, s, h, w, frames,
                                    RUNTIME_SEEDS[0])
        torch.cuda.empty_cache()
        log(f"[5] cv2.VideoWriter opened an MJPG .avi: wrote {s} files of "
            f"{frames} frames {h}x{w} in {time.perf_counter() - t:.2f} s "
            f"({sum(os.path.getsize(p) for p in paths) / 1e6:.1f} MB)")
        base = ["--preset", "multistream", "--dtype", "bfloat16",
                "--device", dev.type, "--headless"]
        for tag, argv, steps in (
                ("5a offline", ["--source", *paths, "--offline", "--bp",
                                bp_head], frames),
                ("5b offline, micro-batch 4",
                 ["--source", *paths, "--offline", "--micro-batch", "4"],
                 -(-frames // 4)),
                ("5c pipelined, paced at the files' 30 fps",
                 ["--source", *paths, "--pipelined", "--max-frames",
                  str(RUNTIME_MAX)], RUNTIME_MAX),
                ("5d sequential", ["--source", paths[0], "--max-frames",
                                   str(RUNTIME_MAX)], RUNTIME_MAX)):
            launches, printed = run_cli(tag, argv + base, card, steps)
            total.update(launches)
            if tag.startswith("5a"):
                bp_report("6c, 5a offline --bp", printed, s)
            torch.cuda.empty_cache()
        # 5e on two of the files, then on two files of a second seed.
        for seed in RUNTIME_SEEDS:
            two = (paths[:2] if seed == RUNTIME_SEEDS[0] else
                   write_runtime_clips(tmp, dev, 2, h, w, frames, seed))
            for mb in (None, 4):
                runtime_card_vs_cpu(two, mb, seed, (dev.type, "cpu"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler traces of the steps "
                    "of phases 3, 3b and 3e-3j")
    args = ap.parse_args()
    t_start = time.perf_counter()
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
        for line in ptxas_entries(name):
            log(f"  {name}: {line}")

    from bp_from_video_tpu_torch.config import flagship_config
    from bp_from_video_tpu_torch.runtime.engine import Engine
    gen = torch.Generator(device=dev).manual_seed(0)
    k5, k6 = check_bottleneck(gen, dev)
    flag_engine = Engine(flagship_config())
    kernels = [check_multi_crop(gen, dev), check_stem_packed(gen, dev),
               check_dense_s2_block(flag_engine, gen, dev),
               check_roi(gen, dev), k5, k6]
    # K1 and K3 at the multistream batches: 8 streams a step, and 32 (8
    # streams x 4 frames) in the lagged step.
    for s in (8, 8 * LAGGED):
        log(f"-- K1 and K3 at {s} streams (multistream"
            f"{', lagged' if s > 8 else ''})")
        check_multi_crop(gen, dev, s)
        check_dense_s2_block(flag_engine, gen, dev, s)
    del flag_engine
    # K6 at 3l's batch: the compiled mesh's 128x128 stage on 8 streams'
    # crops (bottleneck_plan takes the batch: another launch plan than at
    # 64).
    log("-- K6 at 8 streams (3l: the compiled mesh's 128x128 stage)")
    check_bottleneck(gen, dev, 8, stages=MESH_STAGES[:1], lone=False)
    log("phase 2: every kernel agrees with its plain version")
    torch.cuda.empty_cache()

    cfg = flagship_config()
    t = time.perf_counter()
    clip = pulse_clip(STEPS, cfg.num_streams, cfg.frame_height,
                      cfg.frame_width, split=300, seed=3, device=dev)
    torch.cuda.synchronize()
    log(f"flagship clip {tuple(clip.shape)} made on the card in "
        f"{time.perf_counter() - t:.2f} s")
    total = collections.Counter()
    launches = flagship("standin", clip, dev, card, args.profile)
    total.update(launches)
    log("phase 3: flagship engine (stand-in nets) ran through K1, K3, K4")
    t = time.perf_counter()
    launches, rot_out, rot_cfg = rotation_modes(clip, dev, card)
    total.update(launches)
    log(f"phase 3k: the rotation modes ran at full width "
        f"({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    bp_hud(rot_out, rot_cfg, clip[ROT_STEPS - 1], here)
    del rot_out
    launches, e2e_losses, e2e_head = e2e_train(clip, dev, card,
                                               os.path.join(here, PREDICTOR))
    total.update(launches)
    log(f"phase 6a, 6d: the BP head on the HUD, end-to-end training over the "
        f"flagship engine through K1, K3, K4 ({time.perf_counter() - t:.1f} "
        "s)")
    total.update(flagship("mesh", clip, dev, card, args.profile))
    log("phase 3b: flagship engine with the compiled face mesh ran through "
        "K6")
    total.update(flagship("mesh, fused_trunk off", clip, dev, card,
                          fused_trunk=False))
    total.update(flagship("mesh, every stage fused", clip[:8], dev, card,
                          check_signal=False, fused_bn_min_hw=0))
    log("phase 3c: both stems ran through K2; every mesh stage ran fused")
    t = time.perf_counter()
    total.update(packed_path(clip, dev, card))
    log(f"phase 3m: the packed path (K1 pack=2 into the stand-ins' packed "
        f"stems and a packed-input mesh graph) ran through K1 and K4 "
        f"({time.perf_counter() - t:.1f} s)")
    for phase, name in (("3e", "butter_welch_face"), ("3g", "dual_roi_ls"),
                        ("3h", "ptt_filtered"), ("3f", "segmenter_fir")):
        if name == "segmenter_fir":
            # The segmenter weights by skin: a clip of person scenes, each
            # stream's face on the face box the trackers hold.
            del clip
            torch.cuda.empty_cache()
            clip = pulse_clip(STEPS, cfg.num_streams, cfg.frame_height,
                              cfg.frame_width, split=300, seed=5, device=dev,
                              person=True)
        n = preset(name, clip, dev, card, args.profile)
        total.update(n)
        log(f"phase {phase}: preset {name} ran through K1, K3 and K4"
            f"{' (weighted)' if n['roi_samples weighted'] else ''}")
    # Multistream: 8 of the person scenes.
    clip = clip[:, :8].contiguous()
    torch.cuda.empty_cache()
    total.update(multistream(clip, dev, card, args.profile))
    log("phase 3i: multistream (all four models, every stream composed) ran "
        "through K1, K3 and K4 (weighted)")
    total.update(multistream(clip, dev, card, args.profile, lagged=LAGGED))
    log(f"phase 3j: multistream through batch_step_lagged (F={LAGGED}, "
        "stream 0 composed) ran through K1, K3 and K4 (weighted)")
    t = time.perf_counter()
    total.update(compiled_nets(clip, dev, card))
    log(f"phase 3l: multistream with compiled detectors, mesh and segmenter "
        f"ran through K1, K3, K4 (weighted) and K6, plain and with the graph "
        f"passes ({time.perf_counter() - t:.1f} s)")
    del clip
    torch.cuda.empty_cache()
    total["bottleneck_s1"] += lone_unit_graph(dev)
    log("phase 3d: the lone-unit graph ran through K5")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    card_vs_cpu(PHASE4_STEPS, dev)
    log(f"phase 4: card and CPU agree ({time.perf_counter() - t:.1f} s)")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t = time.perf_counter()
        head = train_cli(tmp, dev, card)
        log(f"phase 6b: the trainer ran on the card, resumed, and agrees "
            f"with the CPU ({time.perf_counter() - t:.1f} s)")
        t = time.perf_counter()
        total.update(host_runtime(dev, card, head))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 5: the CLI ran offline (6c: with --bp), micro-batched, "
        "pipelined and sequential through K1 and K4 (weighted); "
        f"process_videos card and CPU agree ({time.perf_counter() - t:.1f} "
        "s)")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    total.update(mesh_one_rank(dev, card, os.path.join(here, PREDICTOR),
                               e2e_losses, e2e_head))
    log(f"phase 7a: one rank over NCCL: the mesh step, run_clip, "
        f"run_clip_lagged and the e2e step equal mesh=None through K1, K3, "
        f"K4 ({time.perf_counter() - t:.1f} s)")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    total.update(mesh_two_ranks(dev, card, os.path.join(here, PREDICTOR)))
    log(f"phase 7b: two ranks over gloo on the one card: each rank equals "
        f"its per-shard run through K1, K3, K4; the e2e step over dp=2 "
        f"equals the unsharded one ({time.perf_counter() - t:.1f} s)")
    launches = dict(total)

    # Each kernel's launches summed over every path of phases 3 and 5.
    for k in kernels:
        k["launches"] = launches.get(k["name"], 0)
        for name, entry in k.get("entries", {}).items():
            entry["launches"] = launches.get(name, 0)
    # K4's sample entry: its launches and, of those, the skin-weighted ones.
    k4 = next(k for k in kernels if "entries" in k)
    k4["entries"]["roi_samples"]["weighted_launches"] = launches[
        "roi_samples weighted"]
    # K4's row counts the launches of both its entries.
    k4["launches"] = sum(e["launches"] for e in k4["entries"].values())
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "entries")
    log(json.dumps({"kernels": [{k: d[k] for k in keys if k in d}
                                for d in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
