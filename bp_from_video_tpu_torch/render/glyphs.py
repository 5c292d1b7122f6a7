"""On-device text: a 5x7 bitmap font stamped for the HUD lines and the
plot labels — the counterpart of ``bp_from_video_tpu/render/glyphs.py``.

* the font lives as a ``[n_chars, 7, 6]`` atlas constant (each glyph with
  its spacing column), built once per device;
* glyph selection is a gather from the atlas (the reference package's
  one-hot matmul gives the same {0, 1} coverage);
* number formatting (fixed point, leading-zero blanking, sign, NaN) is
  elementwise integer arithmetic;
* placement is a slice assignment at a static position, or, for labels
  whose x position is data (plot gridline ticks), a scatter of every
  label of a row into one strip.

Every function takes leading batch dimensions (streams, lines) and works
on all of them at once.  ``stamp``, ``stamp_block`` and ``stamp_dyn``
write into the image they are given and return it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bp_from_video_tpu_torch.render.colors import const

Tensor = torch.Tensor

GLYPH_H, GLYPH_W = 7, 5
PITCH = GLYPH_W + 1  # 1 blank column between glyphs

# 5x7 font, one string row per scanline; '#' = on.  The HUD and labels use
# digits, lowercase, and ". - : / _".
_FONT = {
    "0": ".###.|#..##|#.#.#|##..#|#...#|#...#|.###.",
    "1": "..#..|.##..|..#..|..#..|..#..|..#..|.###.",
    "2": ".###.|#...#|....#|...#.|..#..|.#...|#####",
    "3": ".###.|#...#|....#|..##.|....#|#...#|.###.",
    "4": "...#.|..##.|.#.#.|#..#.|#####|...#.|...#.",
    "5": "#####|#....|####.|....#|....#|#...#|.###.",
    "6": ".###.|#....|####.|#...#|#...#|#...#|.###.",
    "7": "#####|....#|...#.|..#..|..#..|..#..|..#..",
    "8": ".###.|#...#|#...#|.###.|#...#|#...#|.###.",
    "9": ".###.|#...#|#...#|.####|....#|....#|.###.",
    ".": ".....|.....|.....|.....|.....|.##..|.##..",
    "-": ".....|.....|.....|#####|.....|.....|.....",
    ":": ".....|.##..|.##..|.....|.##..|.##..|.....",
    "/": "....#|....#|...#.|..#..|.#...|#....|#....",
    "_": ".....|.....|.....|.....|.....|.....|#####",
    "a": ".....|.....|.###.|....#|.####|#...#|.####",
    "b": "#....|#....|####.|#...#|#...#|#...#|####.",
    "c": ".....|.....|.####|#....|#....|#....|.####",
    "d": "....#|....#|.####|#...#|#...#|#...#|.####",
    "e": ".....|.....|.###.|#...#|#####|#....|.###.",
    "f": "..##.|.#...|####.|.#...|.#...|.#...|.#...",
    "g": ".....|.####|#...#|#...#|.####|....#|.###.",
    "h": "#....|#....|####.|#...#|#...#|#...#|#...#",
    "i": "..#..|.....|.##..|..#..|..#..|..#..|.###.",
    "j": "...#.|.....|..##.|...#.|...#.|#..#.|.##..",
    "k": "#....|#....|#..#.|#.#..|##...|#.#..|#..#.",
    "l": ".##..|..#..|..#..|..#..|..#..|..#..|.###.",
    "m": ".....|.....|##.#.|#.#.#|#.#.#|#.#.#|#.#.#",
    "n": ".....|.....|####.|#...#|#...#|#...#|#...#",
    "o": ".....|.....|.###.|#...#|#...#|#...#|.###.",
    "p": ".....|####.|#...#|#...#|####.|#....|#....",
    "q": ".....|.####|#...#|#...#|.####|....#|....#",
    "r": ".....|.....|#.##.|##...|#....|#....|#....",
    "s": ".....|.....|.####|#....|.###.|....#|####.",
    "t": ".#...|.#...|####.|.#...|.#...|.#...|..##.",
    "u": ".....|.....|#...#|#...#|#...#|#...#|.####",
    "v": ".....|.....|#...#|#...#|#...#|.#.#.|..#..",
    "w": ".....|.....|#...#|#.#.#|#.#.#|#.#.#|.#.#.",
    "x": ".....|.....|#...#|.#.#.|..#..|.#.#.|#...#",
    "y": ".....|#...#|#...#|#...#|.####|....#|.###.",
    "z": ".....|.....|#####|...#.|..#..|.#...|#####",
    "N": "#...#|##..#|#.#.#|#..##|#...#|#...#|#...#",
    "H": "#...#|#...#|#...#|#####|#...#|#...#|#...#",
    " ": ".....|.....|.....|.....|.....|.....|.....",
}
CHARS = "".join(_FONT)
_IDX = {c: i for i, c in enumerate(CHARS)}
SPACE = _IDX[" "]


def _atlas_np() -> np.ndarray:
    """[n_chars, GLYPH_H, PITCH] float32: each glyph and its spacing
    column."""
    atlas = np.zeros((len(CHARS), GLYPH_H, PITCH), np.float32)
    for i, c in enumerate(CHARS):
        for y, line in enumerate(_FONT[c].split("|")):
            atlas[i, y, :GLYPH_W] = [ch == "#" for ch in line]
    return atlas


@functools.cache
def atlas(device: torch.device) -> Tensor:
    """The glyph atlas on ``device``, built once (read only)."""
    return torch.from_numpy(_atlas_np()).to(device)


def encode(text: str) -> np.ndarray:
    """Static text -> glyph index array (host side, for label constants)."""
    return np.asarray([_IDX.get(c, SPACE) for c in text], np.int32)


def render_line(idx: Tensor, show: Tensor | None = None, scale: int = 2
                ) -> Tensor:
    """Glyph indices [..., n] (and optional per-slot visibility) -> f32
    coverage [..., GLYPH_H*scale, n*PITCH*scale] in {0, 1}."""
    n = idx.shape[-1]
    glyphs = torch.index_select(atlas(idx.device), 0, idx.reshape(-1))
    glyphs = glyphs.reshape(idx.shape + (GLYPH_H, PITCH))  # [..., n, gh, pw]
    if show is not None:
        glyphs = glyphs * show[..., None, None].to(glyphs.dtype)
    row = glyphs.movedim(-3, -2).reshape(idx.shape[:-1]
                                         + (GLYPH_H, n * PITCH))
    if scale != 1:
        row = row.repeat_interleave(scale, -2).repeat_interleave(scale, -1)
    return row


def format_fixed(v: Tensor, int_digits: int = 3, frac_digits: int = 2
                 ) -> tuple[Tensor, Tensor]:
    """Values [...] -> (idx int32, show bool), each [..., slots], for the
    fixed field ``[-]III[.FF]``: the absolute value scaled to an integer,
    digits by floor-divide and modulo, leading integer zeros blanked, '-'
    in the sign slot; a non-finite value renders as 'NaN'.  Slots:
    1 + int_digits (+ 1 + frac_digits)."""
    slots = 1 + int_digits + ((1 + frac_digits) if frac_digits else 0)
    dev = v.device
    v = v.to(torch.float32)
    finite = torch.isfinite(v)
    vv = torch.where(finite, v, 0.0)
    neg = vv < 0
    # Capped before the integer cast (a cast past int32 is undefined; the
    # reference's saturating cast then cap gives the same field).
    cap = 10 ** (int_digits + frac_digits) - 1
    scaled = torch.clamp(torch.round(torch.abs(vv) * (10 ** frac_digits)),
                         max=float(cap)).to(torch.int32)

    idx_parts = [torch.where(neg, _IDX["-"], SPACE)]
    show_parts = [torch.ones_like(finite)]
    # Integer digits, most significant first; blank leading zeros (but
    # always show the ones digit).
    for j in range(int_digits):
        p = 10 ** (int_digits + frac_digits - 1 - j)
        d = torch.div(scaled, p, rounding_mode="floor") % 10
        idx_parts.append(_IDX["0"] + d)
        show_parts.append((scaled >= p * torch.where(d > 0, 1, 10))
                          | (j == int_digits - 1))
    if frac_digits:
        idx_parts.append(torch.full_like(scaled, _IDX["."]))
        show_parts.append(torch.ones_like(finite))
        for j in range(frac_digits):
            p = 10 ** (frac_digits - 1 - j)
            idx_parts.append(_IDX["0"]
                             + torch.div(scaled, p, rounding_mode="floor") % 10)
            show_parts.append(torch.ones_like(finite))
    idx = torch.stack([i.to(torch.int32) for i in idx_parts], -1)
    show = torch.stack(show_parts, -1)
    # NaN: the leading slots read 'NaN' (truncated if the field is
    # narrower than 3), the rest blank.
    nan_idx = const(tuple(encode("NaN"[:slots].ljust(slots)).tolist()), dev,
                    torch.int32)
    idx = torch.where(finite[..., None], idx, nan_idx)
    show = torch.where(finite[..., None], show,
                       torch.arange(slots, device=dev) < 3)
    return idx, show


def stamp(img: Tensor, line: Tensor, x0: int, y0: int,
          color: tuple[int, int, int]) -> Tensor:
    """Blend coverage ``line`` [..., h, w] into ``img`` [..., H, W, 3]
    uint8 at a static position, clipped to the canvas (oversize lines are
    cropped)."""
    h_img, w_img = img.shape[-3], img.shape[-2]
    line = line[..., :h_img, :w_img]
    h, w = line.shape[-2], line.shape[-1]
    x0, y0 = max(0, min(x0, w_img - w)), max(0, min(y0, h_img - h))
    region = img[..., y0:y0 + h, x0:x0 + w, :]
    col = const(tuple(color), img.device, img.dtype)
    img[..., y0:y0 + h, x0:x0 + w, :] = torch.where(line[..., None] > 0.5,
                                                    col, region)
    return img


def stamp_block(img: Tensor, idx: Tensor, show: Tensor, colors,
                x0: int, y0: int, row_pitch: int, scale: int = 2) -> Tensor:
    """Stamp a block of left-aligned text lines (the HUD) in one pass:
    ``idx``/``show`` [..., L, slots] (lines padded with SPACE), ``colors``
    L RGB tuples, ``row_pitch`` the line spacing in canvas pixels
    (>= GLYPH_H * scale).  The block keeps the caller's row grid: y0 is
    clamped into the canvas and the block's bottom cropped to what fits."""
    lines = idx.shape[-2]
    block = render_line(idx, show, scale)          # [..., L, gh, w]
    gh = GLYPH_H * scale
    pad = row_pitch - gh
    if pad < 0:
        raise ValueError(f"row_pitch {row_pitch} < glyph height {gh}")
    block = torch.nn.functional.pad(block, (0, 0, 0, pad))
    w = block.shape[-1]
    strip = block.reshape(block.shape[:-3] + (lines * row_pitch, w))
    cols = const(tuple(tuple(c) for c in colors), img.device, img.dtype
                 ).repeat_interleave(row_pitch, 0)     # [L * pitch, 3]
    h_img, w_img = img.shape[-3], img.shape[-2]
    y0 = max(0, min(y0, h_img - 1))
    h = min(strip.shape[-2], h_img - y0)
    w = min(w, w_img)
    strip, cols = strip[..., :h, :w], cols[:h]
    x0 = max(0, min(x0, w_img - w))
    region = img[..., y0:y0 + h, x0:x0 + w, :]
    img[..., y0:y0 + h, x0:x0 + w, :] = torch.where(
        strip[..., None] > 0.5, cols[:, None, :], region)
    return img


def _int_columns(xs: Tensor, lo: int, hi: int) -> Tensor:
    """Float columns -> int64 in [lo, hi]: truncated, NaN as 0 (the
    reference's integer cast, then clip)."""
    x = torch.clamp(torch.nan_to_num(xs.to(torch.float32), nan=0.0),
                    float(lo), float(hi))
    return x.to(torch.int64)


def scatter_row(lines: Tensor, xs: Tensor, show: Tensor, width: int,
                scale: int = 1) -> Tensor:
    """Composite ``n`` rendered label lines at data-dependent column
    offsets into one strip (the plot's gridline tick labels all share one
    text row, reference drawer.py:177-183): ``lines`` [..., n, gh, lw]
    coverage, ``xs`` [..., n] column offsets (clipped to the strip),
    ``show`` [..., n] bool.  Returns [..., gh*scale, width*scale]
    coverage; overlapping labels saturate at 1."""
    n, gh, lw = lines.shape[-3:]
    batch = lines.shape[:-3]
    flat = lines.movedim(-3, -2).reshape(batch + (gh, n * lw))
    x = _int_columns(xs, 0, width - lw)
    target = (torch.arange(lw, device=lines.device).repeat(n)
              + x.repeat_interleave(lw, -1))               # [..., n*lw]
    ink = flat * show.repeat_interleave(lw, -1)[..., None, :].to(flat.dtype)
    strip = torch.zeros(batch + (gh, width), dtype=flat.dtype,
                        device=lines.device)
    strip.scatter_add_(-1, target[..., None, :].expand(ink.shape), ink)
    strip = torch.clamp(strip, max=1.0)
    if scale != 1:
        strip = strip.repeat_interleave(scale, -2).repeat_interleave(scale,
                                                                     -1)
    return strip


def stamp_dyn(img: Tensor, line: Tensor, x0: Tensor, y0: int,
              color: tuple[int, int, int], show: Tensor | None = None
              ) -> Tensor:
    """Blend ``line`` [..., h, w] at a data-dependent column ``x0`` [...]
    (clipped so the line fits) and a static row; ``show`` [...] False
    leaves that image untouched."""
    h_img, w_img = img.shape[-3], img.shape[-2]
    line = line[..., :h_img, :w_img]
    h, w = line.shape[-2], line.shape[-1]
    x = _int_columns(x0, 0, w_img - w)
    line = line.expand(x.shape + (h, w))
    y0c = max(0, min(y0, h_img - h))
    col_in = torch.arange(w_img, device=img.device) - x[..., None]
    inside = (col_in >= 0) & (col_in < w)                  # [..., W]
    src = col_in.clamp(0, w - 1)[..., None, :].expand(line.shape[:-1]
                                                       + (w_img,))
    vis = (torch.gather(line, -1, src) > 0.5) & inside[..., None, :]
    if show is not None:
        vis = vis & show[..., None, None]
    region = img[..., y0c:y0c + h, :, :]
    col = const(tuple(color), img.device, img.dtype)
    img[..., y0c:y0c + h, :, :] = torch.where(vis[..., None], col, region)
    return img
