"""Signal plots rasterized on the card — the counterpart of
``bp_from_video_tpu/render/plotter.py`` (reference drawer.py:166-240),
batched over streams and, within a graph, over its signals.

Three stacked graphs (processed signals, spectra, correlations): borders,
magnitude-spaced gridlines, zero axes and the signal traces, all as masks
over the whole canvas, composited once.  Trace rasterization: each
signal's x axis is monotone (time, frequency, lag), so a polyline is
single-valued per canvas column.  Column c's value is the linear
interpolation of the data there, and the stroke is the vertical span
between adjacent columns' values.  NaN gaps in the data blank their
columns (the reference splits polylines on NaN, drawer.py:222-226).  The
column brackets come from ``ops/signal.bracket_matrix`` and its selections
are gathers (``select_rows`` + ``selmm``).

The multiply-adds that place gridlines, axes and trace rows round once
(``_muladd``), as XLA compiles them into fused multiply-adds for the
reference package: a trace row is the floor or ceiling of one, so a second
rounding would move strokes by a pixel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from bp_from_video_tpu_torch.config import DrawConfig
from bp_from_video_tpu_torch.ops import signal as sig
from bp_from_video_tpu_torch.render import colors as C
from bp_from_video_tpu_torch.render.overlay import composite

Tensor = torch.Tensor

MAX_VLINES = 32


class GraphLayout(NamedTuple):
    origin_x: int
    origin_y: int
    width: int
    height: int


def graph_layouts(cfg: DrawConfig) -> list[GraphLayout]:
    """Stacked-graph layout (reference drawer.py:71-76)."""
    w, h = cfg.window_size
    mx, my = cfg.window_margins
    gw = w - 2 * mx
    gh = (h - (cfg.num_plots + 1) * my) // cfg.num_plots
    return [GraphLayout(mx, i * gh + (i + 1) * my, gw, gh)
            for i in range(cfg.num_plots)]


class PlotTicks(NamedTuple):
    """Per-graph tick data of a stream batch, for the labels."""

    vline_px: Tensor    # [S, MAX_VLINES] canvas x of each gridline
    vline_val: Tensor   # [S, MAX_VLINES] data value of each gridline
    vline_n: Tensor     # [S] int32 count
    range_x: Tensor     # [S, 2]
    range_y: Tensor     # [S, 2]


def _muladd(a, b, c) -> Tensor:
    """``a * b + c`` (f32 tensors or numbers) rounded once to f32: in f64
    the product of two f32 values is exact, so only the sum rounds (to f64,
    then to f32; the two roundings differ from one only on an f32 halfway
    case)."""
    def f64(v):
        return v.double() if isinstance(v, Tensor) else float(v)
    return (f64(a) * f64(b) + f64(c)).float()


def _resolve_range(rng4: Tensor, default: tuple[float, float]
                   ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """[..., 4] auto ranges, non-finite ones -> ``default`` (reference
    drawer.py:233-235); returns (min_x, max_x, min_y, max_y) [...]."""
    d0, d1 = default
    ok_x = torch.isfinite(rng4[..., 0]) & torch.isfinite(rng4[..., 1])
    ok_y = torch.isfinite(rng4[..., 2]) & torch.isfinite(rng4[..., 3])
    min_x = torch.where(ok_x, rng4[..., 0], d0)
    max_x = torch.where(ok_x, rng4[..., 1], d1)
    min_y = torch.where(ok_y, rng4[..., 2], d0)
    max_y = torch.where(ok_y, rng4[..., 3], d1)
    span = torch.clamp(max_x - min_x, min=1e-9)
    spany = torch.clamp(max_y - min_y, min=1e-9)
    return min_x, min_x + span, min_y, min_y + spany


def _vlines(min_x: Tensor, max_x: Tensor) -> tuple[Tensor, Tensor]:
    """Gridline values [..., MAX_VLINES] with order-of-magnitude spacing
    (reference drawer.py:171-175) and their count [...] int32."""
    span = torch.clamp(max_x - min_x, min=1e-9)
    order_mag = 10.0 ** torch.floor(torch.clamp(torch.log10(span), max=1.0))
    half = order_mag / 2.0
    dist = torch.where(span / half < 10.0, half, order_mag)
    lower = torch.ceil(min_x / dist) * dist
    upper = torch.ceil(max_x / dist) * dist
    k = torch.arange(MAX_VLINES, dtype=torch.float32, device=min_x.device)
    vals = _muladd(k, dist[..., None], lower[..., None])
    n = torch.clamp(torch.ceil((upper - lower) / dist), 0, MAX_VLINES
                    ).to(torch.int32)
    return vals, n


class _Canvas(NamedTuple):
    """The plot canvas's static parts on a device (every graph shares its
    columns: ``origin_x``, ``width``)."""

    border: Tensor      # [H, W] bool: every graph's border
    in_y: Tensor        # [G, H] bool: each graph's rows
    in_x: Tensor        # [W] bool: the graphs' columns
    origin_y: Tensor    # [G] f32
    height: Tensor      # [G] f32


@functools.cache
def _canvas(cfg: DrawConfig, device: torch.device) -> _Canvas:
    """Built once a configuration and device (read only)."""
    w, h = cfg.window_size
    layouts = graph_layouts(cfg)
    gl = layouts[0]
    i = torch.arange(h, dtype=torch.float32, device=device)
    j = torch.arange(w, dtype=torch.float32, device=device)
    oy = torch.tensor([g.origin_y for g in layouts], dtype=torch.float32,
                      device=device)
    gh = torch.tensor([g.height for g in layouts], dtype=torch.float32,
                      device=device)
    in_x = (j >= gl.origin_x) & (j <= gl.origin_x + gl.width)
    in_y = (i >= oy[:, None]) & (i <= (oy + gh)[:, None])
    on_x = (j == gl.origin_x) | (j == gl.origin_x + gl.width)
    on_y = (i == oy[:, None]) | (i == (oy + gh)[:, None])
    border = ((in_x & in_y[:, :, None]) & (on_x | on_y[:, :, None])).any(0)
    return _Canvas(border, in_y, in_x, oy, gh)


def _vline_mask(cols: Tensor, valid: Tensor, in_y: Tensor, w: int
                ) -> Tensor:
    """[..., H, W] bool: vertical lines across a graph's rows ``in_y``
    [..., H] at canvas columns ``cols`` [..., n] where ``valid``."""
    j = torch.arange(w, dtype=torch.float32, device=cols.device)
    col_hit = ((j == torch.round(cols)[..., None])
               & valid[..., None]).any(-2)                     # [..., W]
    return col_hit[..., None, :] & in_y[..., :, None]


def _hline_mask(row: Tensor, on: Tensor, in_x: Tensor, h: int) -> Tensor:
    """[..., H, W] bool: the horizontal line at canvas row ``row`` [...]
    across the graphs' columns ``in_x`` [W] where ``on``."""
    i = torch.arange(h, dtype=torch.float32, device=row.device)
    hit = (i == torch.round(row)[..., None]) & on[..., None]    # [..., H]
    return hit[..., :, None] & in_x


def _trace_cols(x: Tensor, y: Tensor, min_x: Tensor, max_x: Tensor,
                gw: int) -> tuple[Tensor, Tensor]:
    """Interpolate the series (x, y) [..., n] at each of ``gw`` graph
    columns over [min_x, max_x] [...].  Returns (vals [..., gw], col_ok
    [..., gw]); columns outside the data's x extent, or bridging a NaN gap
    of the series, are masked out."""
    n = x.shape[-1]
    dev = x.device
    w = sig.valid_x(x) & sig.valid_y(y)
    idx = torch.arange(n, dtype=torch.float32, device=dev).expand_as(x)
    cols3 = sig.compact(w.expand((3,) + w.shape), torch.stack([x, y, idx]))
    cx, cy, cidx = cols3.values.unbind(0)
    k = cols3.count[0]
    # Column centres as the reference compiles them: times the f32
    # reciprocal of gw (XLA's rewrite of a division by a constant), then
    # one fused multiply-add.
    inv_gw = float(np.float32(1.0) / np.float32(gw))
    frac = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * inv_gw
    grid = _muladd(frac, (max_x - min_x)[..., None], min_x[..., None])
    # Segment i spans [x0s_i, x1s_i): at most one per column, so each
    # selection picks one value.
    m, x0s, x1s = sig.bracket_matrix(cx, k, grid)
    sel = sig.select_rows(m)
    y1s = torch.cat([cy[..., 1:], cy[..., -1:]], -1)
    gap_s = (torch.cat([cidx[..., 1:], cidx[..., -1:]], -1) - cidx) > 1.5
    x0 = sig.selmm(sel, sig.zero_infs(x0s))
    x1 = sig.selmm(sel, sig.zero_infs(x1s))
    y0 = sig.selmm(sel, cy)
    y1 = sig.selmm(sel, y1s)
    gap_c = sig.selmm(sel, gap_s.to(torch.float32)) > 0.5
    t = torch.clamp((grid - x0) / torch.where(x1 == x0, 1.0, x1 - x0),
                    0.0, 1.0)
    vals = _muladd(t, y1 - y0, y0)
    first = x0s[..., :1]
    last = sig.take_at(cx, -1, k)[..., None]
    y_last = sig.take_at(cy, -1, k)[..., None]
    # grid == last hits no segment (half-open brackets): the last sample,
    # with the final segment's gap flag.
    at_end = grid >= last
    gap_end = (sig.take_at(gap_s, -2, k) & (k >= 2))[..., None]
    vals = torch.where(at_end, y_last, vals)
    gap_c = torch.where(at_end, gap_end, gap_c)
    col_ok = ((grid >= first) & (grid <= last) & ~gap_c
              & (k >= 2)[..., None] & torch.isfinite(vals))
    return vals, col_ok


def trace_mask(gl: GraphLayout, x: Tensor, y: Tensor, min_x: Tensor,
               max_x: Tensor, min_y: Tensor, max_y: Tensor, h: int, w: int
               ) -> Tensor:
    """[..., H, W] stroke masks of the polylines (x, y) [..., n] inside
    the graph, ranges [...].  ``gl.origin_y`` and ``gl.height`` may be
    tensors [..., 1], a graph for each polyline."""
    vals, col_ok = _trace_cols(x, y, min_x, max_x, gl.width)
    # Data -> graph rows (y inverted, reference drawer.py:217).
    denom = torch.where(min_y == max_y, -1.0, min_y - max_y)[..., None]
    rows = _muladd((vals - max_y[..., None]) / denom, gl.height, gl.origin_y)
    rows = torch.clamp(rows, gl.origin_y, gl.origin_y + gl.height)
    # Vertical span between adjacent columns = connected stroke.
    prev = torch.cat([rows[..., :1], rows[..., :-1]], -1)
    prev_ok = torch.cat([col_ok[..., :1], col_ok[..., :-1]], -1)
    lo = torch.where(prev_ok, torch.minimum(rows, prev), rows)
    hi = torch.where(prev_ok, torch.maximum(rows, prev), rows)
    # Graph columns placed at their static canvas offset.
    place = (gl.origin_x, w - gl.origin_x - gl.width)
    pad = torch.nn.functional.pad
    lo_row = pad(torch.floor(lo), place, value=0.0)
    hi_row = pad(torch.ceil(hi), place, value=-1.0)
    ok_row = pad(col_ok.to(torch.float32), place, value=0.0) > 0.5
    i = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    stroke = ((i >= lo_row[..., None, :]) & (i <= hi_row[..., None, :])
              & ok_row[..., None, :])
    return stroke.to(torch.float32)


def rasterize_plots(cfg: DrawConfig, groups, sig_colors
                    ) -> tuple[Tensor, list[PlotTicks]]:
    """Render the plot canvases of a stream batch: every graph and every
    signal at once.

    groups: [(xs [S, n, L], ys [S, n, L], range4 [S, 4])], one per graph
    row (processed, spectra, correlations; reference drawer.py:231).
    Returns (uint8 RGB canvases [S, Hp, Wp, 3], [PlotTicks] per graph).
    """
    w, h = cfg.window_size
    groups = groups[:cfg.num_plots]
    gl = graph_layouts(cfg)[0]
    s, dev = groups[0][0].shape[0], groups[0][0].device
    fr = _canvas(cfg, dev)
    min_x, max_x, min_y, max_y = _resolve_range(
        torch.stack([g[2] for g in groups], 1), cfg.graph_default_range)
    # Gridlines (light gray) under everything.  The graphs' row ranges are
    # disjoint, so a union over graphs is each graph's own mask.
    vvals, vn = _vlines(min_x, max_x)                       # [S, G, 32]
    vcols = _muladd((vvals - min_x[..., None]) / (max_x - min_x)[..., None],
                    gl.width, gl.origin_x)
    vok = torch.arange(MAX_VLINES, device=dev) < vn[..., None]
    grid_m = _vline_mask(vcols, vok, fr.in_y, w).any(1)
    # Border + zero axes (black).  x is not screen-inverted (unlike y
    # below): col(v) = (v - min_x).
    zero_col = _muladd(-min_x / (max_x - min_x), gl.width, gl.origin_x)
    on_x = (min_x <= 0.0) & (0.0 <= max_x)
    zero_row = _muladd(max_y / (max_y - min_y), fr.height, fr.origin_y)
    on_y = (min_y <= 0.0) & (0.0 <= max_y)
    axes_m = (fr.border
              | _vline_mask(zero_col[..., None], on_x[..., None], fr.in_y,
                            w).any(1)
              | _hline_mask(zero_row, on_y, fr.in_x, h).any(1))
    # Traces: the graphs' signals side by side (NaN-padded to one length:
    # padding adds no valid sample), one stroke mask each.
    length = max(g[0].shape[-1] for g in groups)
    pad = torch.nn.functional.pad

    def signals(k):
        return torch.cat([pad(g[k], (0, length - g[k].shape[-1]),
                              value=float("nan")) for g in groups], 1)
    of_graph = [gi for gi, g in enumerate(groups) for _ in range(g[0].shape[1])]
    graph = C.const(tuple(of_graph), dev, torch.int64)

    def per_signal(v):                                     # [S, G] -> [S, n]
        return v.index_select(1, graph)
    layout = GraphLayout(gl.origin_x, fr.origin_y.index_select(0, graph)[:, None],
                         gl.width, fr.height.index_select(0, graph)[:, None])
    strokes = trace_mask(layout, signals(0), signals(1), per_signal(min_x),
                         per_signal(max_x), per_signal(min_y),
                         per_signal(max_y), h, w) > 0.5     # [S, n, H, W]
    # One union a colour: a graph's j-th signal takes colour j.
    colour = [j % len(sig_colors) for g in groups
              for j in range(g[0].shape[1])]
    layers = [(grid_m, C.LIGHT_GRAY), (axes_m, C.BLACK)]
    for i, c in enumerate(sig_colors):
        pick = C.const(tuple(n for n, k in enumerate(colour) if k == i), dev,
                       torch.int64)
        layers.append((strokes.index_select(1, pick).any(1), c))
    canvas = composite(torch.full((s, h, w, 3), 255.0, device=dev), layers)
    range_x = torch.stack([min_x, max_x], -1)
    range_y = torch.stack([min_y, max_y], -1)
    ticks = [PlotTicks(vcols[:, g], vvals[:, g], vn[:, g], range_x[:, g],
                       range_y[:, g]) for g in range(len(groups))]
    return torch.clamp(torch.round(canvas), 0, 255).to(torch.uint8), ticks
