"""The port's renderer (``bp_from_video_tpu_torch/render``) against the
reference package's (``bp_from_video_tpu/render``), on the same inputs from
a seeded numpy generator, NaN coordinates and missing detections included.

The reference runs one stream at a time under ``jax.vmap`` and ``jax.jit``
(as its drawer does); the port draws the whole batch at once, on the CPU.
Masks, traces, ticks, glyph indices and packed vectors must be equal, and
uint8 images equal, except where a test says otherwise: the alpha blend
rounds ``0.75 * drawn + 0.25 * frame`` twice in the port and once in the
reference (XLA contracts it into a fused multiply-add), so at most 0.1 % of
frame pixels may differ, by at most 1, and the test counts them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bp_from_video_tpu.config import DrawConfig as JDrawConfig
from bp_from_video_tpu.config import preset_configs as jpreset_configs
from bp_from_video_tpu.render import glyphs as jglyphs
from bp_from_video_tpu.render import overlay as joverlay
from bp_from_video_tpu.render import plotter as jplotter
from bp_from_video_tpu.render.drawer import Drawer as JDrawer
from bp_from_video_tpu.runtime.engine import Engine as JEngine
from bp_from_video_tpu_torch.config import DrawConfig, preset_configs
from bp_from_video_tpu_torch.models.runner import ModelResults
from bp_from_video_tpu_torch.ops.roi import Detections
from bp_from_video_tpu_torch.render import glyphs, overlay, plotter
from bp_from_video_tpu_torch.render.drawer import Drawer
from bp_from_video_tpu_torch.runtime.engine import StepOutputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU steps on one thread: the suite runs several test
    processes at once, and PyTorch's default (a thread a core in each)
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, H, W = 3, 48, 64
COLORS = [(31, 119, 180), (255, 127, 14)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _vjit(fn):
    return jax.jit(jax.vmap(fn))


def assert_images_close(got, want, frac=1e-3):
    """uint8 images equal, or at most ``frac`` of the pixels off by 1."""
    d = np.abs(np.asarray(got).astype(np.int32)
               - np.asarray(want).astype(np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).sum() <= frac * d.size, (d > 0).sum()


def _coords(rng, shape, lo=-5.0, hi=70.0, nan=0.15):
    a = rng.uniform(lo, hi, shape).astype(np.float32)
    a[rng.random(shape[:-1]) < nan] = np.nan
    return a


@pytest.mark.parametrize("name", ["rect_mask", "points_mask", "cross_mask"])
def test_overlay_masks_match_reference(name):
    rng = np.random.default_rng(1)
    arg = {"rect_mask": _coords(rng, (S, 5, 4)),
           "points_mask": _coords(rng, (S, 40, 2)),
           "cross_mask": _coords(rng, (S, 4, 2))}[name]
    arg[0] = np.nan                                   # nothing to draw
    want = _vjit(lambda a: getattr(joverlay, name)(a, H, W))(arg)
    got = getattr(overlay, name)(_t(arg), H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    assert got[0].sum() == 0 and got.sum() > 0


@pytest.mark.parametrize("seg", [True, False], ids=["segmenter", "plain"])
def test_compose_overlay_matches_reference(seg):
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (S, H, W, 3), dtype=np.uint8)
    layers = [(_coords(rng, (S, 4, 4)), _coords(rng, (S, 4, 6, 2)),
               (0, 128, 255)),
              (_coords(rng, (S, 1, 4)), _coords(rng, (S, 1, 30, 2)),
               (0, 255, 128))]
    rois = np.concatenate([_coords(rng, (S, 2, 2), 5, 55),
                           _coords(rng, (S, 2, 4), 0, 60)], -1)
    rois[1, 0] = np.nan                               # a lost ROI
    conf = rng.uniform(0, 1, (S, H, W)).astype(np.float32) if seg else None

    def one(f, boxes0, pts0, boxes1, pts1, r, c):
        return joverlay.compose_overlay(
            f, [(boxes0, pts0, layers[0][2]), (boxes1, pts1, layers[1][2])],
            r, COLORS, c, 0.75)
    jargs = [frame, layers[0][0], layers[0][1], layers[1][0], layers[1][1],
             rois, conf if seg else np.zeros((S,), np.float32)]
    if seg:
        want = _vjit(one)(*jargs)
    else:
        want = _vjit(lambda *a: one(*a[:-1], None))(*jargs)
    got = overlay.compose_overlay(
        _t(frame), [(_t(b), _t(p), c) for b, p, c in layers], _t(rois),
        COLORS, _t(conf) if seg else None, 0.75)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (S, H, W, 3)
    assert_images_close(got.numpy(), want)


def _series(rng, s, n, length):
    """Monotone x with NaN-prefilled heads and NaN gaps in y."""
    x = (np.cumsum(rng.uniform(0.02, 0.1, (s, n, length)), -1)
         + rng.uniform(0, 50, (s, 1, 1))).astype(np.float32)
    y = (rng.normal(0, 1, (s, n, length))
         * rng.uniform(0.01, 100, (s, 1, 1))).astype(np.float32)
    y[rng.random(y.shape) < 0.1] = np.nan
    y[:, :, length // 3:length // 3 + 5] = np.nan
    x[0, :, :length // 2] = np.nan
    y[-1, -1] = np.nan                                # an all-NaN series
    return x, y


def test_trace_cols_matches_reference():
    rng = np.random.default_rng(3)
    gw = 57
    x, y = _series(rng, S, 2, 40)
    w = np.isfinite(x) & np.isfinite(y)
    lo = np.where(w, x, np.inf).min(-1)
    hi = np.where(w, x, -np.inf).max(-1)
    lo, hi = np.where(w.any(-1), lo, 0.0), np.where(w.any(-1), hi, 1.0)
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    fn = _vjit(_vjit(lambda a, b, c, d: jplotter._trace_cols(a, b, c, d, gw)))
    jv, jok = map(np.asarray, fn(x, y, lo, hi))
    tv, tok = plotter._trace_cols(_t(x), _t(y), _t(lo), _t(hi), gw)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_array_equal(np.where(jok, tv.numpy(), 0),
                                  np.where(jok, jv, 0))
    assert jok.any() and not jok.all()


def _plot_groups(rng, s=S, length=120):
    x, y = _series(rng, s, 2, length)
    fx = np.broadcast_to(np.linspace(0.5, 5, length, dtype=np.float32),
                         (s, 2, length)).copy()
    fy = rng.uniform(0, 3, (s, 2, length)).astype(np.float32)
    lag = np.broadcast_to(np.linspace(-2, 2, 2 * length - 1,
                                      dtype=np.float32),
                          (s, 1, 2 * length - 1)).copy()
    ly = rng.normal(0, 1, (s, 1, 2 * length - 1)).astype(np.float32)

    def rng4(a, b):
        fin = lambda v, f: np.where(np.isfinite(v), v, f)
        return np.stack([fin(a, np.inf).min((1, 2)), fin(a, -np.inf).max((1, 2)),
                         fin(b, np.inf).min((1, 2)), fin(b, -np.inf).max((1, 2))],
                        -1).astype(np.float32)
    groups = [(x, y, rng4(x, y)), (fx, fy, rng4(fx, fy)),
              (lag, ly, rng4(lag, ly))]
    groups[2][2][1, 2] = np.nan                       # an unset range
    return groups


def test_rasterize_plots_matches_reference():
    """Canvas and per-graph ticks of three graphs (two signals, two
    signals, one pair)."""
    groups = _plot_groups(np.random.default_rng(4))

    def one(*a):
        g = [(a[0], a[1], a[2]), (a[3], a[4], a[5]), (a[6], a[7], a[8])]
        return jplotter.rasterize_plots(JDrawConfig(), g, COLORS)
    want_img, want_ticks = _vjit(one)(*[a for g in groups for a in g])
    img, ticks = plotter.rasterize_plots(
        DrawConfig(), [tuple(_t(a) for a in g) for g in groups], COLORS)
    assert tuple(img.shape) == (S, 720, 640, 3)
    np.testing.assert_array_equal(img.numpy(), np.asarray(want_img))
    for got, want in zip(ticks, want_ticks):
        for f in want._fields:
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)), f)
    # Every trace colour is on the canvas.
    for c in COLORS:
        assert (img.numpy() == c).all(-1).any()


VALUES = np.array([0.0, -3.456, 12.5, np.nan, np.inf, 999.99, 1e9, -0.004,
                   72.0, -100.0, 0.125, 59.995], np.float32)


@pytest.mark.parametrize("digits", [(3, 2), (2, 2), (3, 0), (1, 0)])
def test_format_fixed_and_render_line_match_reference(digits):
    int_d, frac = digits
    ji, js = _vjit(lambda v: jglyphs.format_fixed(v, int_d, frac))(VALUES)
    ti, ts = glyphs.format_fixed(_t(VALUES).reshape(3, 4), int_d, frac)
    np.testing.assert_array_equal(ti.reshape(len(VALUES), -1).numpy(),
                                  np.asarray(ji))
    np.testing.assert_array_equal(ts.reshape(len(VALUES), -1).numpy(),
                                  np.asarray(js))
    for scale in (1, 2):
        want = _vjit(lambda i, s: jglyphs.render_line(i, s, scale))(ji, js)
        got = glyphs.render_line(ti, ts, scale)
        np.testing.assert_array_equal(
            got.reshape((len(VALUES),) + tuple(got.shape[-2:])).numpy(),
            np.asarray(want))


def test_stamp_block_matches_reference():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (S, 60, 100, 3), dtype=np.uint8)
    vals = rng.uniform(-50, 150, (S, 4)).astype(np.float32)
    vals[1, 2] = np.nan
    colors = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (9, 9, 9)]

    def one(im, v):
        i, s = jax.vmap(lambda q: jglyphs.format_fixed(q, 3, 2))(v)
        return jglyphs.stamp_block(im, i, s, jnp.asarray(colors, jnp.uint8),
                                   5, 6, 16, 2)
    want = _vjit(one)(img, vals)
    i, s = glyphs.format_fixed(_t(vals), 3, 2)
    got = glyphs.stamp_block(_t(img), i, s, colors, 5, 6, 16, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_row_matches_reference():
    """Tick labels at data-dependent columns, off the strip at both ends,
    overlapping and hidden."""
    rng = np.random.default_rng(6)
    vals = rng.uniform(-10, 10, (S, 32)).astype(np.float32)
    xs = rng.uniform(-30, 230, (S, 32)).astype(np.float32)
    xs[0, 3] = np.nan
    show = rng.random((S, 32)) < 0.6

    def one(v, x, sh):
        i, s = jax.vmap(lambda q: jglyphs.format_fixed(q, 2, 2))(v)
        lines = jax.vmap(lambda a, b: jglyphs.render_line(a, b, 1))(i, s)
        return jglyphs.scatter_row(lines, x, sh, 200, 2)
    want = _vjit(one)(vals, xs, show)
    i, s = glyphs.format_fixed(_t(vals), 2, 2)
    got = glyphs.scatter_row(glyphs.render_line(i, s, 1), _t(xs), _t(show),
                             200, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stamp_and_stamp_dyn_match_reference():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (S, 40, 80, 3), dtype=np.uint8)
    i, s = jglyphs.format_fixed(jnp.float32(-12.25), 2, 2)
    line = np.asarray(jglyphs.render_line(i, s, 1))
    x0 = np.array([3.7, 70.0, -4.0], np.float32)
    show = np.array([True, True, False])
    for y0 in (9, 37):
        want = _vjit(lambda im, x, sh: jglyphs.stamp_dyn(
            im, jnp.asarray(line), x, y0, (1, 2, 3), sh))(img, x0, show)
        got = glyphs.stamp_dyn(_t(img), _t(line), _t(x0), y0, (1, 2, 3),
                               _t(show))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for x in (0, 70):
            want = _vjit(lambda im: jglyphs.stamp(im, jnp.asarray(line), x,
                                                  y0, (9, 9, 9)))(img)
            got = glyphs.stamp(_t(img), _t(line), x, y0, (9, 9, 9))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the Drawer on a whole step of the reference engine --------------------


def _engine_cfg(base, device_text=True):
    return dataclasses.replace(
        base, frame_height=96, frame_width=128, num_streams=2,
        draw=dataclasses.replace(base.draw, device_text=device_text),
        signal=dataclasses.replace(base.signal, signal_max_samples=64,
                                   peak_max_samples=8))


def _to_port(tree):
    """A reference ``StepOutputs`` (numpy leaves) -> the port's."""
    kinds = {"StepOutputs": StepOutputs, "ModelResults": ModelResults,
             "Detections": Detections}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return kinds[type(tree).__name__](*[_to_port(v) for v in tree])
    return _t(tree)


@pytest.fixture(scope="module")
def multistream_step():
    """The reference engine's ``multistream`` preset (all four models,
    plain crops) after 24 steps of random frames at S = 2, 96x128: its
    last frames and outputs, with a face in each stream's tracked rect so
    that the landmark layer and the ROIs are drawn."""
    base = jpreset_configs()["multistream"]
    cfg = _engine_cfg(base)
    cfg = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, use_pallas=False))
    eng = JEngine(cfg)
    st = jax.tree.map(lambda x: jnp.broadcast_to(x, (2,) + x.shape),
                      eng.init_state())
    params = jax.tree.map(np.array, eng.params)
    params["flm_lm"]["head_presence"]["b"][:] = 8.0
    params["hand_lm"]["head_presence"]["b"][:] = 8.0
    st = st._replace(track=st.track._replace(
        face_rect=jnp.asarray([[64, 40, 56, 56, 0]] * 2, jnp.float32),
        face_tracking=jnp.asarray([True, False])))
    step = jax.jit(eng.batch_step)
    rng = np.random.default_rng(8)
    for i in range(24):
        frames = rng.integers(0, 256, (2, 96, 128, 3), dtype=np.uint8)
        st, out = step(params, st, jnp.asarray(frames),
                       jnp.full((2,), (i + 1) / 30.0, jnp.float32))
    return frames, jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("device_text", [True, False],
                         ids=["device-text", "host-text"])
def test_drawer_compose_matches_reference(multistream_step, device_text):
    """``Drawer.compose`` of both streams at once against the reference's
    ``_compose_fn`` under ``vmap``: frame images (overlays of all four
    models, ROIs, segmenter blend, HUD) and packed vectors, and the plot
    canvases.  With device text, the reference's compiled compose places
    some tick labels from tick columns it recomputes inside the label
    fusion, one column off the columns it returns (75.0 returned, the label
    at 74.99.. truncated); the port places each label at the tick it
    returns.  So the labels are held to the reference's
    ``_stamp_plot_labels`` given the returned ticks."""
    frames, out = multistream_step
    base = jpreset_configs()["multistream"]
    jd = JDrawer(_engine_cfg(base, device_text), show=False)
    td = Drawer(_engine_cfg(preset_configs()["multistream"], device_text),
                show=False, device="cpu")
    jf, jp, jk = _vjit(jd._compose_fn)(jnp.asarray(frames), out)
    tf, tp, tk = td.compose(_t(frames), _to_port(out))
    assert tuple(tf.shape) == (2, 96, 128, 3) and tf.dtype == torch.uint8
    assert tuple(tp.shape) == (2, 720, 640, 3) and tp.dtype == torch.uint8
    assert_images_close(tf.numpy(), jf)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    # The face landmarker's layer and the forehead ROI are drawn.
    for c in ((0, 255, 128), COLORS[0]):
        want = np.clip(np.round(0.75 * np.asarray(c)[None]
                                + 0.25 * frames.reshape(-1, 3)), 0, 255)
        assert (tf.numpy().reshape(-1, 3) == want).all(-1).any(), c
    if not device_text:
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        return

    groups = lambda o: [(o.proc_x, o.proc_y, o.proc_range),
                        (o.spec_x, o.spec_y, o.spec_range),
                        (o.corr_x, o.corr_y, o.corr_range)]

    def raster(o):
        return jplotter.rasterize_plots(jd.draw_cfg, groups(o),
                                        jd.sig_colors)
    canvas, ticks = _vjit(raster)(out)
    want = _vjit(jd._stamp_plot_labels)(canvas, ticks)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(want))
    assert (tp.numpy() != np.asarray(canvas)).any()   # labels were drawn


def test_drawer_unpack_and_headless_present(multistream_step):
    """``_unpack`` of one stream's packed vector equals the reference's, and
    ``present`` downloads, flips to BGR and returns -1 without a window."""
    frames, out = multistream_step
    base = preset_configs()["multistream"]
    td = Drawer(_engine_cfg(base), show=False, device="cpu")
    jd = JDrawer(_engine_cfg(jpreset_configs()["multistream"]), show=False)
    tf, tp, tk = td.compose(_t(frames), _to_port(out))
    for s in range(2):
        hud, ticks = td._unpack(tk[s].numpy())
        jhud, jticks = jd._unpack(tk[s].numpy())
        for k in jhud:
            np.testing.assert_array_equal(hud[k], jhud[k])
        for a, b in zip(ticks, jticks):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(hud["bpm"], out.bpm[s])
    assert td.present(tf[1], tp[1], tk[1]) == -1
    np.testing.assert_array_equal(td.last_frame, tf[1].numpy()[..., ::-1])
    np.testing.assert_array_equal(td.last_plot, tp[1].numpy()[..., ::-1])
