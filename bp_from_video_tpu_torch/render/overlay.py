"""Frame overlays on the card — the counterpart of
``bp_from_video_tpu/render/overlay.py`` (reference drawer.py:83-113,
:152-162), batched over streams: every mask is [S, H, W].

Everything is rasterized from coordinates without branches.  A mask is a
union of outer products of a row band and a column band: a rectangle edge
is a one-pixel band (the one-hot at y0) times a span (x0..x1), a landmark
dot a 3-pixel band times a 3-pixel band, a cross marker two such products.
Every band of every layer is built in one pass (``_bands``), and each
layer's mask is one batched matmul [S, H, M] @ [S, M, W] of its bands.
The bands are {0, 1}, so the products count hits exactly and the masks,
clipped to 1, are exact {0, 1}.  A band's bounds are rounded coordinates
(half to even, as the reference's ``jnp.round``); a NaN coordinate gives
an empty band and draws nothing.
"""

from __future__ import annotations

import torch

from bp_from_video_tpu_torch.render.colors import const

Tensor = torch.Tensor


def _bands(lo: Tensor, hi: Tensor, size: int) -> Tensor:
    """[..., M] rounded bounds -> [..., M, size] {0, 1} rows, 1 where
    lo <= pixel <= hi (a NaN bound gives an empty row)."""
    grid = torch.arange(size, dtype=torch.float32, device=lo.device)
    return ((grid >= lo[..., None]) & (grid <= hi[..., None])).to(
        torch.float32)


def _rect_bounds(bboxes: Tensor, thickness: int = 1):
    """Band bounds (rows lo, rows hi, cols lo, cols hi), each [..., 4K], of
    the outlines of [..., K, 4] (x0, y0, x1, y1) rects: the horizontal
    edges (one-hots at y0 and y1 across x0..x1), then the vertical edges
    (y0..y1 at the one-hots x0 and x1)."""
    x0, y0, x1, y1 = torch.round(bboxes).unbind(-1)
    r = thickness // 2
    ya, yb, xa, xb = (y0, y1, x0, x1) if r == 0 else (y0 - r, y1 - r,
                                                      x0 - r, x1 - r)
    yc, yd, xc, xd = (y0, y1, x0, x1) if r == 0 else (y0 + r, y1 + r,
                                                      x0 + r, x1 + r)
    return (torch.cat([ya, yb, y0, y0], -1), torch.cat([yc, yd, y1, y1], -1),
            torch.cat([x0, x0, xa, xb], -1), torch.cat([x1, x1, xc, xd], -1))


def _point_bounds(points: Tensor, radius: int = 1):
    """Band bounds of (2r+1)-square dots at [..., P, 2] (x, y) points."""
    x, y = torch.round(points).unbind(-1)
    return y - radius, y + radius, x - radius, x + radius


def _cross_bounds(centers: Tensor, arm: int = 5):
    """Band bounds of cross markers at [..., K, 2] (x, y) (reference
    drawMarker MARKER_CROSS, drawer.py:112): a horizontal arm (the one-hot
    at y across round(x - arm)..round(x + arm)) and a vertical arm."""
    x, y = centers.unbind(-1)
    xr, yr = torch.round(x), torch.round(y)
    return (torch.cat([yr, torch.round(y - arm)], -1),
            torch.cat([yr, torch.round(y + arm)], -1),
            torch.cat([torch.round(x - arm), xr], -1),
            torch.cat([torch.round(x + arm), xr], -1))


def _masks(layers, h: int, w: int) -> list[Tensor]:
    """Each layer's [..., H, W] mask, a layer being a list of band bounds
    (rows lo, rows hi, cols lo, cols hi): the union of its bands' outer
    products.  Every band of every layer in one pass, then one matmul a
    layer."""
    parts = [b for layer in layers for b in layer]
    lo_r, hi_r, lo_c, hi_c = (torch.cat([b[i] for b in parts], -1)
                              for i in range(4))
    rows = _bands(lo_r, hi_r, h).transpose(-1, -2)      # [..., H, M]
    cols = _bands(lo_c, hi_c, w)                        # [..., M, W]
    out, at = [], 0
    for layer in layers:
        m = sum(b[0].shape[-1] for b in layer)
        out.append(torch.clamp(rows[..., at:at + m] @ cols[..., at:at + m, :],
                               0.0, 1.0))
        at += m
    return out


def rect_mask(bboxes: Tensor, h: int, w: int, thickness: int = 1) -> Tensor:
    """[..., K, 4] (x0, y0, x1, y1) -> [..., H, W] mask of the outlines."""
    return _masks([[_rect_bounds(bboxes, thickness)]], h, w)[0]


def points_mask(points: Tensor, h: int, w: int, radius: int = 1) -> Tensor:
    """[..., P, 2] (x, y) pixel points -> [..., H, W] mask of (2r+1)-square
    dots."""
    return _masks([[_point_bounds(points, radius)]], h, w)[0]


def cross_mask(centers: Tensor, h: int, w: int, arm: int = 5) -> Tensor:
    """[..., K, 2] (x, y) -> [..., H, W] cross markers."""
    return _masks([[_cross_bounds(centers, arm)]], h, w)[0]


def composite(base_f: Tensor, layers) -> Tensor:
    """Apply ``[(mask [..., H, W], color)]`` in order (later wins) over the
    float canvas ``base_f`` [..., H, W, 3]: equal to painting each layer
    ``frame*(1-mask) + mask*color`` when every mask is {0, 1}."""
    out = base_f
    for mask, color in layers:
        c = const(tuple(color), base_f.device)
        out = torch.where((mask > 0.5)[..., None], c, out)
    return out


def compose_overlay(frame_rgb: Tensor, model_layers, roi_rois: Tensor,
                    roi_colors, seg_conf_skin: Tensor | None,
                    alpha: float = 0.75) -> Tensor:
    """The whole overlay (reference draw_results drawer.py:152-162) of a
    stream batch: detections, ROI rects and crosses, the segmenter mask,
    alpha-blended over the raw frames.  Returns uint8 RGB [S, H, W, 3].

    frame_rgb: uint8 [S, H, W, 3].
    model_layers: [(bboxes [S, K, 4], points [S, K, P, 2], color)] per
        enabled model.
    roi_rois: [S, ns, 6] (x, y, x0, y0, x1, y1) integral ROIs.
    seg_conf_skin: [S, H, W] face-skin confidence, or None.
    """
    h, w = frame_rgb.shape[-3], frame_rgb.shape[-2]
    base = frame_rgb.to(torch.float32)
    drawn = base
    if seg_conf_skin is not None:
        # reference drawer.py:99: frame *= conf_masks[3]
        drawn = drawn * seg_conf_skin[..., None]
    bounds, colors = [], []
    for bboxes, points, color in model_layers:
        pts = points.reshape(points.shape[:-3] + (-1, 2))
        bounds.append([_rect_bounds(bboxes), _point_bounds(pts)])
        colors.append(color)
    for r in range(roi_rois.shape[-2]):
        roi = roi_rois[..., r:r + 1, :]
        bounds.append([_rect_bounds(roi[..., 2:6]),
                       _cross_bounds(roi[..., :2])])
        colors.append(roi_colors[r])
    drawn = composite(drawn, list(zip(_masks(bounds, h, w), colors)))
    out = alpha * drawn + (1.0 - alpha) * base
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
