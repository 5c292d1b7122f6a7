"""Display stage — the counterpart of ``bp_from_video_tpu/render/drawer.py``
(reference drawer.py:57-260).

``Drawer.compose`` draws every stream of a batch on the card in one call,
with no loop over streams: detection boxes, landmark dots, ROI rects and
crosses, the segmenter mask blend, the alpha blend, the three signal plots
and (``DrawConfig.device_text``) the HUD numbers and plot labels.  It
returns the frame images, the plot images and one packed vector of every
number the host needs (HUD values and tick data), reads nothing back and
copies nothing to the card.  ``present`` is the host half for one stream:
one download of its two images and its packed vector, the BP head
(``bp_predictor``) on the downloaded vitals, host text where the card did
not stamp it (the BP line always), and the OpenCV windows.  OpenCV is
imported when a ``Drawer`` is built and may be absent: ``present`` then
runs headless and returns -1.
"""

from __future__ import annotations

import numpy as np
import torch

from bp_from_video_tpu_torch import resolve_device
from bp_from_video_tpu_torch.config import EngineConfig, ModelType
from bp_from_video_tpu_torch.models.runner import skin_confidence
from bp_from_video_tpu_torch.ops.roi import is_planar_frames
from bp_from_video_tpu_torch.render import colors as C
from bp_from_video_tpu_torch.render import glyphs, overlay, plotter

Tensor = torch.Tensor


def _import_cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


class Drawer:
    """Display shell around the on-card renderers; ``device=None`` means
    ``"cuda"`` (raises without CUDA unless ``device="cpu"``)."""

    def __init__(self, config: EngineConfig, *, show: bool = True,
                 window_pos: tuple[int, int] = (1080, 0), bp_predictor=None,
                 device=None):
        self.config = config
        self.bp_predictor = bp_predictor
        self.last_bp: np.ndarray | None = None
        self.draw_cfg = config.draw
        self.device = resolve_device(device)
        self.cv2 = _import_cv2()
        self.show = show and self.cv2 is not None
        self.window_pos = window_pos
        ns = config.signal.num_signals
        self.sig_colors = [C.signal_colormap(ns)[i] for i in range(ns)]
        self.last_frame: np.ndarray | None = None   # BGR, after host text
        self.last_plot: np.ndarray | None = None
        self._windows = False
        self._hud = self._hud_layout()

    # -- on-card composition ---------------------------------------------

    def compose(self, frames: Tensor, out) -> tuple[Tensor, Tensor, Tensor]:
        """Every stream of a batch: frames uint8 [S, H, W, 3] or planar
        [S, 3, H, W] and the step's ``StepOutputs`` -> (frame images
        [S, H, W, 3] uint8, plot images [S, Hp, Wp, 3] uint8, packed HUD
        and tick vector [S, P] f32).  One stream is the S = 1 case."""
        cfg = self.config
        nhwc = frames.permute(0, 2, 3, 1) if is_planar_frames(frames) \
            else frames
        layers = []
        for on, key, det in (
                (cfg.inference.face_detector, ModelType.FACE_DETECTOR,
                 out.models.face_detector),
                (cfg.inference.face_landmarker, ModelType.FACE_LANDMARKER,
                 out.models.face_landmarker),
                (cfg.inference.hand_landmarker, ModelType.HAND_LANDMARKER,
                 out.models.hand_landmarker)):
            if on:
                layers.append((det.bbox, det.points, C.MODEL_COLORMAP[key]))
        seg = (skin_confidence(out.models.seg_conf)
               if cfg.inference.person_segmenter else None)
        frame_img = overlay.compose_overlay(
            nhwc.contiguous(), layers, out.rois, self.sig_colors, seg,
            self.draw_cfg.alpha)
        groups = [(out.proc_x, out.proc_y, out.proc_range),
                  (out.spec_x, out.spec_y, out.spec_range),
                  (out.corr_x, out.corr_y, out.corr_range)]
        plot_img, ticks = plotter.rasterize_plots(self.draw_cfg, groups,
                                                  self.sig_colors)
        if self.draw_cfg.device_text:
            frame_img = self._stamp_hud(frame_img, out)
            plot_img = self._stamp_plot_labels(plot_img, ticks)
        # Every number the host needs in one vector: one download.
        parts = [out.curr_fs[:, None], out.mean_fs[:, None], out.bpm, out.ptt]
        for tk in ticks:
            parts += [tk.vline_n.to(torch.float32)[:, None], tk.range_x,
                      tk.range_y, tk.vline_px, tk.vline_val]
        packed = torch.cat([p.to(torch.float32) for p in parts], -1)
        return frame_img, plot_img, packed

    # -- on-card text (render/glyphs.py) -----------------------------------

    def _hud_layout(self) -> dict:
        """The HUD's static parts (reference write_info drawer.py:127-150),
        built once on the device: one row a line (labels, value slots,
        units, padded with SPACE), blank separator rows, the value slots'
        places, the bare 'NaN' rows and the line colours."""
        ns = self.config.signal.num_signals
        npairs = max(self.config.signal.num_pairs, 1)
        rows = []   # (label, value width, unit, color, nan_bare) or None

        def put(label, unit, color, wide, nan_bare):
            rows.append((label, wide, unit, color, nan_bare))

        put("curr_fs: ", " Hz", C.BLUE, 6, False)       # format (2, 2)
        put("mean_fs: ", " Hz", C.BLUE_AZURE, 6, False)
        rows.append(None)
        for s in range(ns):
            put(f"mean_bpm_{s}: ", " bpm", C.RED, 4, True)   # format (3, 0)
        rows.append(None)
        for p in range(npairs):
            put(f"mean_ptt_{p}: ", " ms", C.GREEN, 4, True)
        lens = [0 if r is None else len(r[0]) + r[1] + len(r[2]) for r in rows]
        slots = max(lens)
        idx = np.full((len(rows), slots), glyphs.SPACE, np.int32)
        show = np.zeros((len(rows), slots), bool)
        nan_idx = idx.copy()
        vrow, vcol, bare_rows, colors = [], [], [], []
        for r, row in enumerate(rows):
            if row is None:
                colors.append(C.BLACK)
                continue
            label, wide, unit, color, nan_bare = row
            text = np.concatenate([glyphs.encode(label),
                                   np.full(wide, glyphs.SPACE, np.int32),
                                   glyphs.encode(unit)])
            idx[r, :len(text)] = text
            show[r, :len(text)] = True
            vrow += [r] * wide
            vcol += range(len(label), len(label) + wide)
            if nan_bare:
                bare_rows.append(r)
                nan_idx[r, :len(text)] = glyphs.encode(
                    "NaN".ljust(len(text)))
            colors.append(color)
        dev = self.device

        def t(a, dtype=None):
            return torch.from_numpy(np.asarray(a)).to(dev, dtype)
        return dict(idx=t(idx), show=t(show), vrow=t(vrow, torch.int64),
                    vcol=t(vcol, torch.int64),
                    bare_rows=t(bare_rows, torch.int64), nan_idx=t(nan_idx),
                    nan_show=t(np.arange(slots) < 3), colors=tuple(colors))

    def _stamp_hud(self, img: Tensor, out) -> Tensor:
        """Stamp the HUD lines of every stream (reference write_info
        drawer.py:127-150): the static rows with the formatted values put
        in their slots, a bare 'NaN' line where a mean BPM or PTT is not
        finite, and every line blended in one pass (``stamp_block``)."""
        hud = self._hud
        s = img.shape[0]
        fs_i, fs_s = glyphs.format_fixed(
            torch.stack([out.curr_fs, out.mean_fs], -1), 2, 2)
        vitals = torch.cat([out.bpm, out.ptt], -1)
        v_i, v_s = glyphs.format_fixed(vitals, 3, 0)
        idx = hud["idx"].expand(s, -1, -1).clone()
        show = hud["show"].expand(s, -1, -1).clone()
        idx[:, hud["vrow"], hud["vcol"]] = torch.cat(
            [fs_i.flatten(1), v_i.flatten(1)], 1)
        show[:, hud["vrow"], hud["vcol"]] = torch.cat(
            [fs_s.flatten(1), v_s.flatten(1)], 1)
        bare = torch.zeros(idx.shape[:2], dtype=torch.bool, device=img.device)
        bare[:, hud["bare_rows"]] = ~torch.isfinite(vitals)
        idx = torch.where(bare[..., None], hud["nan_idx"], idx)
        show = torch.where(bare[..., None], hud["nan_show"], show)
        scale = 2 if img.shape[2] >= 480 else 1
        return glyphs.stamp_block(img, idx, show, hud["colors"], 15, 30, 30,
                                  scale)

    def _stamp_plot_labels(self, img: Tensor, ticks) -> Tensor:
        """Tick and corner range labels (reference draw_graph
        drawer.py:177-207) of every stream: each graph's gridline labels,
        at data-dependent x, scattered into one text row; its four range
        labels stamped at static places.  Every label of every graph is
        formatted, rendered and scattered in one pass."""
        w = img.shape[2]
        vals = torch.stack([torch.cat([tk.vline_val, tk.range_x, tk.range_y],
                                      -1) for tk in ticks], 1)   # [S, G, 36]
        vi, vs = glyphs.format_fixed(vals, 2, 2)
        lines = glyphs.render_line(vi, vs, 1)          # [S, G, 36, gh, lw]
        m = plotter.MAX_VLINES
        ok = (torch.arange(m, device=img.device)
              < torch.stack([tk.vline_n for tk in ticks], 1)[..., None])
        strips = glyphs.scatter_row(
            lines[:, :, :m], torch.stack([tk.vline_px for tk in ticks], 1)
            - 12, ok, w)                               # [S, G, gh, W]
        for g, gl in enumerate(plotter.graph_layouts(self.draw_cfg)):
            img = glyphs.stamp(img, strips[:, g], 0,
                               gl.origin_y + gl.height + 8, C.LIGHT_GRAY)
            # Corner range labels (black): static places, data values.
            for k, (xx, yy) in enumerate((
                    (gl.origin_x - 5, gl.origin_y + gl.height + 16),
                    (gl.origin_x + gl.width - 25, gl.origin_y + gl.height + 16),
                    (max(0, gl.origin_x - 40), gl.origin_y + gl.height - 12),
                    (max(0, gl.origin_x - 40), gl.origin_y + 8))):
                img = glyphs.stamp(img, lines[:, g, m + k], xx, yy, C.BLACK)
        return img

    # -- host text ------------------------------------------------------------

    def _put(self, img, text, pos, color_rgb, scale=0.5):
        cv2 = self.cv2
        cv2.putText(img, text, pos, cv2.FONT_HERSHEY_COMPLEX_SMALL, scale,
                    color_rgb[::-1], 1, cv2.LINE_AA)

    def _unpack(self, packed: np.ndarray):
        """One stream's downloaded vector [P] -> HUD values and per-graph
        tick data."""
        ns = self.config.signal.num_signals
        np_ = max(self.config.signal.num_pairs, 1)
        i = 0

        def take(k):
            nonlocal i
            v = packed[i:i + k]
            i += k
            return v

        hud = {"curr_fs": take(1)[0], "mean_fs": take(1)[0],
               "bpm": take(ns), "ptt": take(np_)}
        ticks = []
        for _ in range(self.draw_cfg.num_plots):
            ticks.append({"n": int(take(1)[0]), "range_x": take(2),
                          "range_y": take(2),
                          "px": take(plotter.MAX_VLINES),
                          "val": take(plotter.MAX_VLINES)})
        return hud, ticks

    def _host_line(self, img, line: int, text: str, color) -> None:
        cv2 = self.cv2
        cv2.putText(img, text, (15, (line + 1) * 30),
                    cv2.FONT_HERSHEY_COMPLEX, img.shape[1] / 1024,
                    color[::-1], 1, cv2.LINE_AA)

    def _write_info(self, img, hud, calibrating: bool):
        """HUD as host text (reference write_info drawer.py:127-150):
        current and mean fs, per-signal mean BPM, per-pair mean PTT, the
        calibration banner."""
        line = 0

        def put(text, color):
            nonlocal line
            self._host_line(img, line, text, color)
            line += 1

        put(f"curr_fs: {hud['curr_fs']:.2f} Hz", C.BLUE)
        put(f"mean_fs: {hud['mean_fs']:.2f} Hz", C.BLUE_AZURE)
        line += 1
        for s, bpm in enumerate(hud["bpm"]):
            put(f"mean_bpm_{s}: {int(bpm)} bpm" if np.isfinite(bpm)
                else "NaN", C.RED)
        line += 1
        for p, ptt in enumerate(hud["ptt"]):
            put(f"mean_ptt_{p}: {int(ptt)} ms" if np.isfinite(ptt)
                else "NaN", C.GREEN)
        line += 1
        if self.bp_predictor is not None:
            put(self._bp_text(), C.MAGENTA)
            line += 1
        if calibrating:
            put("calibrating camera", C.RED)

    def _bp_text(self) -> str:
        sbp, dbp = np.asarray(self.last_bp).reshape(-1)[:2]
        return (f"bp: {int(sbp)}/{int(dbp)} mmHg"
                if np.isfinite(sbp) and np.isfinite(dbp) else "bp: NaN")

    def _label_plot(self, img, ticks):
        """Tick and corner range labels as host text (reference draw_graph
        drawer.py:177-207)."""
        for gl, tk in zip(plotter.graph_layouts(self.draw_cfg), ticks):
            for i in range(max(0, min(tk["n"], plotter.MAX_VLINES))):
                self._put(img, f"{tk['val'][i]: .2f}",
                          (int(tk["px"][i]) - 12,
                           gl.origin_y + gl.height + 14), C.LIGHT_GRAY)
            rx, ry = tk["range_x"], tk["range_y"]
            self._put(img, f"{rx[0]: .2f}",
                      (gl.origin_x - 5, gl.origin_y + gl.height + 15), C.BLACK)
            self._put(img, f"{rx[1]: .2f}",
                      (gl.origin_x + gl.width - 25,
                       gl.origin_y + gl.height + 15), C.BLACK)
            self._put(img, f"{ry[0]: .2f}",
                      (gl.origin_x - 40, gl.origin_y + gl.height - 5), C.BLACK)
            self._put(img, f"{ry[1]: .2f}",
                      (gl.origin_x - 40, gl.origin_y + 15), C.BLACK)

    # -- public stage interface --------------------------------------------

    def present(self, frame_img: Tensor, plot_img: Tensor, packed: Tensor,
                calibrating: bool = False) -> int:
        """The host half of the display stage for one stream: download its
        composed images [H, W, 3], [Hp, Wp, 3] and packed vector [P], write
        the host text (only the BP line and the calibration banner when the
        card stamped the rest), blit.  With a ``bp_predictor`` it sets
        ``last_bp`` from the downloaded vitals.  Without OpenCV, or with
        ``show`` off, it keeps the images in ``last_frame`` /
        ``last_plot`` and returns -1."""
        frame_bgr = frame_img.cpu().numpy()[..., ::-1].copy()
        plot_bgr = plot_img.cpu().numpy()[..., ::-1].copy()
        hud, ticks = self._unpack(packed.cpu().numpy())
        if self.bp_predictor is not None:
            self.last_bp = self.bp_predictor(hud["bpm"], hud["ptt"])
        if self.cv2 is not None:
            if self.draw_cfg.device_text:
                # Numbers and labels are stamped already; the BP line and
                # the banner sit on the row grid below them (2 fs rows, a
                # blank, the BPM rows, a blank, the PTT rows, a blank).
                line = 5 + len(hud["bpm"]) + len(hud["ptt"])
                if self.bp_predictor is not None:
                    self._host_line(frame_bgr, line, self._bp_text(),
                                    C.MAGENTA)
                    line += 2
                if calibrating:
                    self._host_line(frame_bgr, line, "calibrating camera",
                                    C.RED)
            else:
                self._write_info(frame_bgr, hud, calibrating)
                self._label_plot(plot_bgr, ticks)
        self.last_frame, self.last_plot = frame_bgr, plot_bgr
        if not self.show:
            return -1
        cv2 = self.cv2
        if not self._windows:
            cv2.namedWindow("frame")
            cv2.namedWindow("plot")
            px, py = self.window_pos
            cv2.moveWindow("plot", px, py)
            cv2.moveWindow("frame",
                           px + 1920 // 2 - frame_bgr.shape[1] // 2, py)
            self._windows = True
        cv2.imshow("frame", frame_bgr)
        cv2.imshow("plot", plot_bgr)
        return self.wait_key()

    def wait_key(self, delay: int = 1) -> int:
        key = self.cv2.waitKey(delay)
        if key == ord("q"):
            raise KeyboardInterrupt
        return key

    def cleanup(self) -> None:
        if self.show:
            self.cv2.destroyAllWindows()
