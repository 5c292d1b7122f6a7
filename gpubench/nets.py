"""The nets every cell runs, made from ``--seed``: seeded trunks from the
reference's graph makers and blaze init, and landmark readouts that hold
the track still while the trunk sets every other landmark.

The seed's template heads (``chip_smoke.template_heads``/``template_mesh``)
zero the landmark readout, so no trunk reaches an output.  Here the
template is the readout's bias and a seeded random readout adds a term the
trunk sets, except on the landmarks that fix the tracking rect: the bbox
corners and the two rotation landmarks, whose readout rows are zero.  Those
rows are values the compute dtype holds exactly (bf16 on the card, f32 in
the reference), chosen so that the next rect equals the current one: the
face by a 170-pixel bbox centred in the 256 crop, turned by the angle whose
cover widens it back to 256; the hand by bf16 logits found by a search
(:func:`hand_template`).  The track then holds still in every precision
that holds those values, as the harness's long windows need.
"""

from __future__ import annotations

import copy
import math
import os

import numpy as np

from gpubench.ref.models import blaze, mesh_graph

FACE_SIZE, FACE_LANDMARKS = 256, 478
HAND_SIZE, HAND_LANDMARKS = 224, 21
FACE_ROT = (33, 263)
# The readout term's standard deviation across crops, in crop pixels, set
# per seed on calibration crops of the cell's own scene
# (:func:`calibration_crops`): large against the bf16 rounding of the
# outputs (about 0.3 frame pixels), so that a trunk that is skipped,
# degraded or fed another crop moves the compared landmarks by several.
TERM_PX = 5.0


def sub_seed(seed: int, *key: int) -> int:
    """A 32-bit seed for one net, derived from the run's ``seed``."""
    return int(np.random.SeedSequence([seed % 2**63, *key]
                                      ).generate_state(1)[0])


def face_template() -> np.ndarray:
    """Face landmarks in crop pixels [478, 3] (z 0).  The corners (43, 43)
    and (213, 213) make a 170-pixel bbox centred at 128; landmark 33 at
    (43.75, 100.5) and 263 at (171, 101) turn the rect by atan(0.5 /
    127.25), whose cover widens 1.5 * 170 back to 256 * (1 + 4e-8).  Every
    value is exact in bf16.  The rest lie in [80, 176], 7 term deviations inside."""
    rng = np.random.default_rng(11)
    pts = np.zeros((FACE_LANDMARKS, 3))
    pts[:, :2] = rng.uniform(80.0, 176.0, (FACE_LANDMARKS, 2))
    pts[-2, :2], pts[-1, :2] = (43.0, 43.0), (213.0, 213.0)
    pts[FACE_ROT[0], :2] = (43.75, 100.5)
    pts[FACE_ROT[1], :2] = (171.0, 101.0)
    return pts


def _fixed_face() -> list[int]:
    return [FACE_ROT[0], FACE_ROT[1], FACE_LANDMARKS - 2, FACE_LANDMARKS - 1]


# The pinned hand logits (x, y) by landmark: bf16 values found by a search
# over bf16 logits (p = sigmoid(b)) for the fixed point below; landmark 9
# is the top (y0), 0 the bottom (y1), 4 the left (x0), 20 the right (x1).
HAND_PINNED = {0: (-0.059814453125, 1.234375),
               9: (0.11767578125, -0.76953125),
               4: (-0.921875, 0.0),
               20: (0.87890625, 0.0)}


def hand_template() -> tuple[np.ndarray, tuple[int, ...]]:
    """Hand readout biases (logits) [21, 3] and the landmarks they pin.

    The hand rect is the landmarks' bbox, turned by the wrist (0) to
    middle knuckle (9) direction against vertical, shifted up by 0.1 of
    its height, squared on its long side and doubled; the crop is its
    cover.  In crop units (p = sigmoid(b)) it holds still when

        (x0 + x1) / 2 + 0.1 h sin(t) = 1/2,
        (y0 + y1) / 2 - 0.1 h cos(t) = 1/2,
        2 max(w, h) (|cos t| + |sin t|) = 1,

    which ``HAND_PINNED`` meets to within 6e-6 of the crop (t = 0.097:
    landmark 9 lies right of 0 by h tan(t)); the rect moves by about 0.002
    pixels a call.  The unpinned landmarks lie 0.12 of the crop (5 term
    deviations) inside the pinned bbox."""
    logit = lambda q: np.log(q / (1.0 - q))
    sig = lambda b: 1.0 / (1.0 + np.exp(-b))
    x0, x1 = sig(HAND_PINNED[4][0]), sig(HAND_PINNED[20][0])
    y0, y1 = sig(HAND_PINNED[9][1]), sig(HAND_PINNED[0][1])
    rng = np.random.default_rng(12)
    margin = 0.12
    out = np.zeros((HAND_LANDMARKS, 3))
    out[:, 0] = logit(rng.uniform(x0 + margin, x1 - margin, HAND_LANDMARKS))
    out[:, 1] = logit(rng.uniform(y0 + margin, y1 - margin, HAND_LANDMARKS))
    for k, xy in HAND_PINNED.items():
        out[k, :2] = xy
    return out, tuple(HAND_PINNED)


def calibration_crops(scene: str, h: int, w: int, seed: int,
                      n: int = 8) -> dict:
    """{net: f32 crops [n, 3, size, size] in [0, 1]}: ``n`` frames of the
    cell's scene (the block texture, drawn on the CPU from the seed), each cropped on the starting face and first
    hand rect (``traffic.start_track``) and resized bilinearly."""
    import torch
    import torch.nn.functional as F

    from gpubench import traffic
    if scene != "texture":
        raise ValueError(f"unknown scene {scene!r}")
    gen = torch.Generator().manual_seed(sub_seed(seed, 9))
    base = torch.randint(60, 180, (n, 3, h // 8, w // 8), generator=gen)
    frames = base.float().repeat_interleave(8, 2).repeat_interleave(8, 3)
    r = traffic.start_track(h, w, torch.ones(n, dtype=torch.bool))
    out = {}
    for net, rect, size in (("flm_lm", r["face"], FACE_SIZE),
                            ("hand_lm", r["hands"][0], HAND_SIZE)):
        cx, cy, side = (float(v) for v in (rect[0], rect[1], rect[2]))
        x0, y0 = int(round(cx - side / 2)), int(round(cy - side / 2))
        x1, y1 = x0 + int(round(side)), y0 + int(round(side))
        pad = F.pad(frames, (max(-x0, 0), max(x1 - w, 0), max(-y0, 0),
                             max(y1 - h, 0)))
        region = pad[..., y0 + max(-y0, 0):y1 + max(-y0, 0),
                     x0 + max(-x0, 0):x1 + max(-x0, 0)]
        out[net] = F.interpolate(region, size=(size, size), mode="bilinear",
                                 align_corners=False) / 255.0
    return out


def _off_mean(w: np.ndarray, feats: np.ndarray) -> np.ndarray:
    """``w`` [fan, outputs] less its component along the crops' mean
    feature: the readout then answers to what sets one crop apart, not to
    what every crop shares (which would only add to the output's size and
    its rounding)."""
    m = feats.mean(0)
    return w - np.outer(m, m @ w) / float(m @ m)


def _centre_and_scale(terms: np.ndarray) -> tuple[np.ndarray, float]:
    """(mean term per output, scale) that make the calibration terms
    [n, outputs] zero-mean with a std of ``TERM_PX`` across crops."""
    mean = terms.mean(0)
    return mean, TERM_PX / float((terms - mean).std())


def face_mesh(seed: int, crops) -> object:
    """The compiled face landmark net: ``face_mesh_graph`` (MediaPipe
    ``face_landmarks_detector`` architecture at 256, 478 landmarks) with
    seeded weights; a seeded readout on every landmark's x and y but the
    pinned ones, made blind to the calibration ``crops``' mean feature,
    centred and scaled on them so that its term has a std of ``TERM_PX``
    crop pixels across crops, with the template (less the centre) as the
    landmark bias; a presence logit of 8 with no readout."""
    import torch

    from gpubench.ref.models import tflite_compiler as tc
    g = mesh_graph.face_mesh_graph(sub_seed(seed, 1))
    prod = {t: op for op in g.ops for t in op.outputs}
    lm = prod[g.outputs[0]]
    logit = prod[prod[g.outputs[1]].inputs[0]]
    w, b = g.tensors[lm.inputs[1]], g.tensors[lm.inputs[2]]
    rng = np.random.default_rng(sub_seed(seed, 2))
    fan = int(np.prod(w.data.shape[1:]))
    wt = (rng.standard_normal(w.data.shape) / math.sqrt(fan)
          ).astype(np.float32)
    wt = wt.reshape(FACE_LANDMARKS, 3, *w.data.shape[1:])
    wt[:, 2] = 0.0                                  # z: no term
    wt[_fixed_face(), :2] = 0.0
    w.data = wt.reshape(w.data.shape)
    b.data = np.zeros(3 * FACE_LANDMARKS, np.float32)
    lw, lb = g.tensors[logit.inputs[1]], g.tensors[logit.inputs[2]]
    lw.data = np.zeros_like(lw.data)
    lb.data = np.asarray([8.0], np.float32)
    # The readout is a k x k VALID conv over the last map: a dense layer
    # over its flattened features, which a one-hot readout reads out.
    wr = w.data.reshape(3 * FACE_LANDMARKS, fan).T.astype(np.float64)
    w.data = np.eye(3 * FACE_LANDMARKS, fan, dtype=np.float32).reshape(
        w.data.shape)
    fn, params = tc.compile_graph(g, torch.float32, device="cpu")
    with torch.no_grad():
        feats = fn(params, crops)[0].reshape(crops.shape[0], -1)[:, :fan]
    feats = feats.numpy().astype(np.float64)
    wr = _off_mean(wr, feats)
    mean, scale = _centre_and_scale(feats @ wr)
    w.data = (wr.T * scale).astype(np.float32).reshape(w.data.shape)
    b.data = (face_template().reshape(-1) - scale * mean).astype(np.float32)
    return g


def hand_standin(seed: int, crops) -> dict:
    """The hand landmark stand-in (blaze blocks, the net K3 runs) at 224:
    seeded trunk; a seeded readout on every unpinned landmark's x and y,
    made blind to the calibration ``crops``' mean feature, centred and
    scaled on them (in logits, at the
    template's slope) so that its term has a std of ``TERM_PX`` crop pixels
    across crops, with the template logits (less the centre) as the
    landmark bias; presence logit 8 with no readout."""
    import torch
    p = blaze.init_blaze_landmark(sub_seed(seed, 3), HAND_SIZE,
                                  HAND_LANDMARKS)
    tmpl, pinned = hand_template()
    rng = np.random.default_rng(sub_seed(seed, 4))
    fan = p["head_lm"]["w"].shape[0]
    w = (rng.standard_normal((fan, HAND_LANDMARKS, 3)) / math.sqrt(fan)
         ).astype(np.float32)
    w[:, :, 2] = 0.0
    w[:, list(pinned), :2] = 0.0
    w = w.reshape(fan, -1)
    p["head_presence"]["w"] = np.zeros_like(p["head_presence"]["w"])
    p["head_presence"]["b"] = np.full_like(p["head_presence"]["b"], 8.0)
    # The trunk's flattened features of the crops, then the readout's
    # logits; a logit's pixels per unit is the sigmoid's slope there.
    from gpubench.ref.models.runner import _to_torch
    pt = _to_torch(p, "cpu")
    with torch.no_grad():
        y = torch.relu(blaze._conv(pt["stem"], crops, stride=2))
        for name in ("b1", "b2", "b3", "b4"):
            y = blaze._blaze_block(pt[name], y, stride=2)
    feats = y.reshape(crops.shape[0], -1).numpy().astype(np.float64)
    w = _off_mean(w.astype(np.float64), feats)
    q = 1.0 / (1.0 + np.exp(-tmpl.reshape(-1)))
    slope = HAND_SIZE * q * (1.0 - q)
    mean, scale = _centre_and_scale((feats @ w) * slope)
    p["head_lm"] = {"w": (w * scale).astype(np.float32),
                    "b": (tmpl.reshape(-1) - scale * mean / slope
                          ).astype(np.float32)}
    return p


def save_standin(params: dict, path: str, input_size: int,
                 num_landmarks: int) -> str:
    """Write stand-in params as the flat npz the runners load (with its
    ``__meta__`` geometry stamp); returns ``path``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)
    walk({k: v for k, v in params.items() if k != "stem_p"}, "")
    flat["__meta__/input_size"] = np.asarray(input_size)
    flat["__meta__/num_landmarks"] = np.asarray(num_landmarks)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def graphs_for(nets: dict, seed: int, crops: dict) -> dict:
    """{runner key: Graph} for a configuration's ``nets`` entry."""
    out = {}
    if nets.get("flm_lm") == "face_mesh":
        out["flm_lm"] = face_mesh(seed, crops["flm_lm"])
    return out


def copy_graphs(graphs: dict) -> dict:
    """A deep copy, so that a compiler that edits a graph in place reaches
    no other side's copy."""
    return copy.deepcopy(graphs)
