"""The physformer system: ``bp_from_video_tpu_torch`` built with
``config.physformer_config`` (the face mesh keeps the face rect, K1 crops
it at 128 into each stream's clip ring, PhysFormer turns a full ring into
the stream's BVP, the signal half reads BPM from it), driven through
``MultiStreamEngine`` (``Engine.batch_step_lagged`` for F > 1 frames a
call), judged by the plain reference beside this file (``ref.py``).

The face mesh and the tracked start are the flagship's
(``gpubench/nets.py``, ``systems/flagship.py``); the net's weights and
BatchNorm statistics are drawn from the seed (``ref.init_params``).

Judged stage by stage on each kept call, on data the port prepared:

- ``face_lm_gap_px``, ``rect_gap_px``: the face mesh on the last frame and
  the next rect, as the flagship judges them;
- ``crop_gap``: the port's ring after the call against the reference's
  ring, which pushes the reference's crops of the call's frames at the
  same rects into the port's ring from before the call: per crop, mean
  |reference - port| over mean |reference|, the largest (a ring whose
  timestamps differ reads infinite): K1 at 128 and the push;
- ``bvp_gap``: on the streams the reference finds due, the reference
  net's BVP of the port's clip (standardised by the reference) against
  the raw ring the port pushed, per stream max |gap| over max |reference|,
  the largest; a stream the port ran on and the reference did not, or the
  reverse, reads infinite: the net and its gate;
- ``proc_gap``, ``spec_gap`` (``bpm_gap`` logged): the reference's DSP on
  the port's pushed raw rings, as the flagship's.

And on the reference's own run from the start (its own tracker, crops,
ring and net): ``own_crop_gap``, the clip rings after it, as ``crop_gap``
(the tracker, K1 and the push over the run).  Logged, not compared:
``own_raw_gap`` (the BVP of the rings, as the flagship's), ``own_proc_gap``,
``own_bpm_gap``, ``bpm_gap``.  With random weights the BVP of the
reference's own f32 crops moves with the last bit of a bf16 crop (whose
step is about the frames' pixel noise): on 12 seeds the port read
0.002-0.145 and the fp8 control 0.33-22.5, no margin a fresh seed can be
held to; and the spectrum's peak can move to another bin on rounding.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from gpubench import check, nets
from gpubench.precision import Rounding
from gpubench.systems import flagship

from . import ref as ref_mod

TRAFFIC_KEYS: tuple[str, ...] = ()
INF = float("inf")
# The stream blocks the judge compares clips in (bounded memory).
_JUDGE_ROWS = 8

start_state = flagship.start_state
ref_start_state = flagship.ref_start_state
call = flagship.call
launch_counts = flagship.launch_counts


@dataclasses.dataclass
class Inputs:
    """The seeded face mesh and PhysFormer weights, handed to both sides."""

    graphs: dict      # {"flm_lm": Graph}
    params: dict      # the net's unfolded weights, f32 on the CPU

    def close(self) -> None:
        pass


def make_inputs(spec: dict, traffic, seed: int, workdir: str) -> Inputs:
    e = spec["engine"]
    crops = nets.calibration_crops(traffic.scene, e["height"], e["width"],
                                   seed)
    return Inputs(nets.graphs_for(spec["nets"], seed, crops),
                  ref_mod.init_params(spec["net"], nets.sub_seed(seed, 20)))


def _to(params: dict, device) -> dict:
    return ref_mod._map(lambda t: t.to(device), params)


def build_port(spec: dict, inputs: Inputs, device):
    """(MultiStreamEngine, its config) of the port."""
    from bp_from_video_tpu_torch import config as port_config
    from bp_from_video_tpu_torch.parallel import streams
    e = spec["engine"]
    cfg = port_config.physformer_config(
        e["streams"], e["height"], e["width"],
        port_config.PhysFormerConfig(**spec["net"]))
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, **e.get("inference", {})))
    if "compute_dtype" in e:
        cfg = dataclasses.replace(cfg, compute_dtype=e["compute_dtype"])
    engine_cls = streams.Engine
    streams.Engine = functools.partial(
        engine_cls, graphs=nets.copy_graphs(inputs.graphs),
        rppg_params=_to(inputs.params, device))
    try:
        ms = streams.MultiStreamEngine(cfg, device=device)
    finally:
        streams.Engine = engine_cls
    return ms, cfg


def build_reference(spec: dict, inputs: Inputs, device):
    """The reference in float32, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    e = spec["engine"]
    return ref_mod.Reference(spec["net"], _to(inputs.params, device),
                             nets.copy_graphs(inputs.graphs)["flm_lm"],
                             e["height"], e["width"], device)


def ref_step(ref, state, frames, ts):
    return ref.step(state, frames, ts)


def same_start(ref_state, port_state) -> bool:
    """The tracks, the signal rings and the (empty) clip rings agree."""
    rc, pc = ref_state.clip, port_state.clip
    return (flagship.same_start((ref_state.signals, ref_state.track),
                                (port_state.signals, port_state.track))
            and flagship.same_start((rc.ts, rc.crops, rc.new),
                                    (pc.ordered_ts(), pc.ordered(), pc.new)))


def limits(spec: dict, traffic) -> dict:
    return dict(spec["limits"])


def _ref_clip(clip) -> ref_mod.Clip:
    """The port's clip ring as the reference keeps it (oldest first, f32)."""
    return ref_mod.Clip(clip.ordered().to(torch.float32), clip.ordered_ts(),
                        clip.new.to(torch.int64))


def _rings_gap(ref, c: check.Checked, rows: slice) -> tuple[float, float,
                                                            torch.Tensor]:
    """(crop_gap, bvp_gap, the reference's due streams) on ``rows``."""
    st_in, st_out = c.state_in, c.state_out
    frames, ts = (c.frames, c.ts) if c.ts.ndim == 2 else (c.frames[None],
                                                           c.ts[None])

    def pick(a):
        return a[rows]
    clip_in = ref_mod.Clip(*(pick(a) for a in _ref_clip(st_in.clip)))
    want, due = ref.push(clip_in, frames[:, rows], ts[:, rows],
                         st_in.track.face_rect[rows])
    got_crops = pick(st_out.clip.ordered()).to(torch.float32)
    got_ts = pick(st_out.clip.ordered_ts())
    if not torch.equal(torch.nan_to_num(want.ts, nan=-1.0),
                       torch.nan_to_num(got_ts, nan=-1.0)):
        crop = INF
    else:
        crop = check._mean_rel_gap(want.crops.flatten(2),
                                   got_crops.flatten(2))
    # A stream the port ran the net on has the ring's timestamps as its
    # raw ring's (they rise call by call, while a looped clip can give the
    # same BVP again).
    x_in, x_out = pick(st_in.signals.raw_x), pick(st_out.signals.raw_x)
    ran = ~(torch.nan_to_num(x_in, nan=-1.0)
            == torch.nan_to_num(x_out, nan=-1.0)).all(-1)
    if not torch.equal(ran, due):
        return crop, INF, due
    bvp = 0.0
    if bool(due.any()):
        r = torch.nonzero(due)[:, 0]
        bvp = check._rel_gap(ref.bvp(got_crops[r]),
                             pick(st_out.signals.raw_y)[r, 0])
        if not torch.equal(torch.nan_to_num(got_ts[r], nan=-1.0),
                           torch.nan_to_num(x_out[r], nan=-1.0)):
            bvp = INF
    return crop, bvp, due


def judge(ref, c: check.Checked) -> dict:
    """The numbers of one kept call (the module's docstring)."""
    st_in, st_out, out = c.state_in, c.state_out, c.out
    last = c.frames[-1] if c.ts.ndim == 2 else c.frames
    s = st_in.track.face_rect.shape[0]
    res = {}
    with torch.no_grad():
        tr_r, m_r = ref.tracker.predict_face(st_in.track, last)
        res["face_lm_gap_px"] = check._mean_gap(
            m_r.face_landmarker.points, out.models.face_landmarker.points,
            (-2, -1))
        res["rect_gap_px"] = (
            check._rect_gap(tr_r.face_rect, st_out.track.face_rect)
            if bool((tr_r.face_tracking == st_out.track.face_tracking).all())
            else INF)
        crop, bvp, due = 0.0, 0.0, []
        for i in range(0, s, _JUDGE_ROWS):
            cg, bg, d = _rings_gap(ref, c, slice(i, i + _JUDGE_ROWS))
            crop, bvp = max(crop, cg), max(bvp, bg)
            due.append(d)
        res["crop_gap"], res["bvp_gap"] = crop, bvp
        due = torch.cat(due)
        st = st_out.signals._replace(
            bpm_x=st_in.signals.bpm_x, bpm_y=st_in.signals.bpm_y,
            ptt_x=st_in.signals.ptt_x, ptt_y=st_in.signals.ptt_y)
        _, out_r = ref.analyze(st, out.models, st.raw_x[:, -1], due)
        res["proc_gap"] = check._rel_gap(out_r.proc_y, out.proc_y)
        res["spec_gap"] = check._rel_gap(out_r.spec_y, out.spec_y)
        res["bpm_gap"] = check._max_gap(out_r.bpm.float(), out.bpm.float())
    return res


def _own_crop_gap(ref_clip, clip) -> float:
    """``crop_gap`` of two whole rings (the reference's own and the
    port's), a block of streams at a time."""
    if not torch.equal(torch.nan_to_num(ref_clip.ordered_ts(), nan=-1.0),
                       torch.nan_to_num(clip.ordered_ts(), nan=-1.0)):
        return INF
    want, got = ref_clip.ordered(), clip.ordered()
    return max(check._mean_rel_gap(want[i:i + _JUDGE_ROWS].flatten(2),
                                   got[i:i + _JUDGE_ROWS].float().flatten(2))
               for i in range(0, want.shape[0], _JUDGE_ROWS))


def judge_own(cfg, ref_state, ref_out, state, out) -> dict:
    with torch.no_grad():
        return {"own_crop_gap": _own_crop_gap(ref_state.clip, state.clip),
                "own_raw_gap": check._mean_rel_gap(ref_state.signals.raw_y,
                                                   state.signals.raw_y),
                "own_proc_gap": check._rel_gap(ref_out.proc_y, out.proc_y),
                "own_bpm_gap": check._max_gap(ref_out.bpm.float(),
                                              out.bpm.float())}


class Control:
    """The reference in the port's place a step below the configuration's
    precisions: the face mesh and PhysFormer (bf16 stated) in fp8 (every
    operation's inputs and outputs at 3 mantissa bits), the crop's
    resample (bf16 operands stated) with its operands in float8 e4m3, the
    DSP (f32, TF32 off) with its products in TF32; crop and tracking
    geometry f32."""

    def __init__(self, spec: dict, inputs: Inputs, device):
        self.ref = build_reference(spec, inputs, device)
        self.mode = Rounding()
        at = self.mode.at

        def under(prec, fn):
            @functools.wraps(fn)
            def wrapped(*a, **k):
                with at(prec):
                    return fn(*a, **k)
            return wrapped
        r = self.ref
        r.tracker._landmarks = under("fp8", r.tracker._landmarks)
        r.crops = functools.partial(r.crops, dtype=torch.float8_e4m3fn)
        r.bvp = under("fp8", r.bvp)
        r.analyze = under("tf32", r.analyze)

    def step(self, state, frames, ts):
        """One call from the port's state (its clip ring read as the
        reference keeps it) or from the reference's own."""
        if hasattr(state.clip, "head"):
            state = ref_mod.State(state.signals, state.track,
                                  _ref_clip(state.clip))
        with self.mode:
            return self.ref.step(state, frames, ts)


control = Control


def faults(ref, checked: list, traffic) -> dict:
    """Frame F - 1's crop pushed for every frame of the call: the port's
    kept calls with that fault planted in their rings, judged."""
    f_n = traffic.frames_per_call
    readings = []
    for c in checked:
        clip = c.state_out.clip
        t = clip.ts.shape[1] - 1
        slots = (clip.head[:, None] + torch.arange(t, device=clip.head.device)
                 ) % t
        rows = torch.arange(slots.shape[0], device=slots.device)[:, None]
        crops = clip.crops.clone()
        crops[rows, slots[:, -f_n:]] = clip.crops[rows, slots[:, -1:]]
        st = c.state_out._replace(clip=clip._replace(crops=crops))
        readings.append(judge(ref, dataclasses.replace(c, state_out=st)))
    return check.worst(readings)


# -- counts -------------------------------------------------------------------


def stem_layer(b: int, cin: int, cout: int, kt: int, k: int, t: int,
               hw: int) -> tuple[float, float]:
    """(operations, bytes) of one stem layer over ``b`` clips: a kt x k x k
    conv (padding keeps the size) of ``cin`` -> ``cout`` at ``t`` frames
    of ``hw`` squared, then the 1x2x2 max-pool; bf16 input read once,
    pooled output written once, weights read once."""
    flops = 2.0 * b * t * hw * hw * cout * cin * kt * k * k
    nbytes = (b * t * hw * hw * cin + b * t * (hw // 2) ** 2 * cout
              + cout * cin * kt * k * k + cout) * 2
    return flops, nbytes


def trunk(b: int, dim: int, ff_dim: int, layers: int, t: int, grid: int,
          patch: int) -> tuple[float, float]:
    """(operations, bytes) of the patch embedding, the ``layers`` blocks
    and the head over ``b`` clips of ``t`` frames (P = t/patch x grid^2
    tokens): per block the fused Q/K 3x3x3 conv (2 dim outputs), V, QK^T
    and AV over P tokens, the projection, the feed-forward's two 1x1x1
    convs and its depthwise 3x3x3; the head's two [3, 1, 1] convs at 2x
    and 4x the tokens' frames and the last projection.  Bytes: the stem's
    output read once, the BVP written once (f32), every weight once."""
    p = (t // patch) * grid * grid
    per_block = (2 * p * 2 * dim * dim * 27 + 2 * p * dim * dim
                 + 4 * p * p * dim + 2 * p * dim * dim + 4 * p * dim * ff_dim
                 + 2 * p * ff_dim * 27)
    g2 = grid * grid
    head = (2 * (t // 2) * g2 * dim * dim * 3
            + 2 * t * g2 * (dim // 2) * dim * 3 + 2 * t * (dim // 2))
    flops = b * (2.0 * p * dim * dim * patch ** 3 + layers * per_block
                 + head)
    weights = (dim * dim * patch ** 3 + layers * (
        2 * dim * dim * 27 + 2 * dim * dim + 2 * dim * ff_dim
        + ff_dim * 27) + dim * dim * 3 + dim * (dim // 2) * 3)
    nbytes = (b * t * (grid * patch) ** 2 * dim * 2 + b * t * 4
              + weights * 2)
    return flops, nbytes


KERNELS = {"pf_stem": stem_layer, "pf_trunk": trunk}


def clips_per_call(cfg, traffic) -> int:
    """Clips through the net a call in the steady state: every stream
    every ``hop`` frames."""
    return cfg.num_streams * traffic.frames_per_call // cfg.rppg_net.hop


def batch_of(net: str, cfg, traffic) -> int:
    return clips_per_call(cfg, traffic)


def net_flops(ref, spec: dict, traffic, cfg) -> float:
    """PhysFormer's operations a call (the stem layers and the trunk as
    the configuration's ``kernels`` lists them)."""
    b = clips_per_call(cfg, traffic)
    total = 0.0
    for kernel, launches in spec["kernels"].items():
        for launch in launches:
            shape = {k: v for k, v in launch.items() if k != "net"}
            total += KERNELS[kernel](b, **shape)[0]
    return total


def tracked(state) -> tuple[int, int]:
    """(tracked face slots, streams whose clip ring is full)."""
    return (int(state.track.face_tracking.sum()),
            int(torch.isfinite(state.clip.ordered_ts()).all(1).sum()))
