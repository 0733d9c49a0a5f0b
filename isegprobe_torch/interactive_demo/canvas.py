"""Zoomable and pannable image canvas for the interactive demo.

Counterpart of ``isegprobe_tpu/interactive_demo/canvas.py``: mouse-wheel
zoom anchored at the cursor, drag panning, and the exact canvas <-> image
mapping, so that a click lands on the right pixel at any zoom. The geometry
lives in the pure ``Viewport`` value object (tested without a display); the
Tk widget is a thin shell that owns the event plumbing and the resampled
photo. Rendering crops the visible image region first and resizes only
that crop, with ``data/raster.py``'s OpenCV-exact resizes (nearest at a
scale of 4 or more, bilinear below), and the photo is a PPM handed to
``tk.PhotoImage``, so no OpenCV or PIL is needed.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np

from isegprobe_torch.data.raster import resize_linear, resize_nearest

__all__ = ["MIN_SCALE", "MAX_SCALE", "Viewport", "CanvasImage", "ppm_bytes"]

MIN_SCALE = 0.05
MAX_SCALE = 32.0


@dataclass(frozen=True)
class Viewport:
    """Mapping between image pixels and canvas pixels.

    canvas = (image - origin) * scale; origin is the image-space point at
    the canvas' top-left corner.
    """

    img_w: int
    img_h: int
    canvas_w: int
    canvas_h: int
    scale: float = 1.0
    ox: float = 0.0
    oy: float = 0.0

    @classmethod
    def fit(cls, img_w: int, img_h: int, canvas_w: int,
            canvas_h: int) -> "Viewport":
        """Initial view: the whole image visible, centered."""
        scale = min(canvas_w / img_w, canvas_h / img_h, 1.0)
        ox = (img_w - canvas_w / scale) / 2.0
        oy = (img_h - canvas_h / scale) / 2.0
        return cls(img_w, img_h, canvas_w, canvas_h, scale, ox, oy)

    # -- coordinate mapping ---------------------------------------------------

    def to_image(self, cx: float, cy: float) -> Tuple[float, float]:
        return self.ox + cx / self.scale, self.oy + cy / self.scale

    def to_canvas(self, ix: float, iy: float) -> Tuple[float, float]:
        return (ix - self.ox) * self.scale, (iy - self.oy) * self.scale

    def image_click(self, cx: float, cy: float) -> Optional[Tuple[int, int]]:
        """Integer image pixel under a canvas point, or None if outside."""
        ix, iy = self.to_image(cx, cy)
        ix, iy = int(ix), int(iy)
        if 0 <= ix < self.img_w and 0 <= iy < self.img_h:
            return ix, iy
        return None

    # -- navigation ------------------------------------------------------------

    def zoom_at(self, cx: float, cy: float, factor: float) -> "Viewport":
        """Scale by ``factor`` keeping the image point under (cx, cy)
        fixed."""
        new_scale = float(np.clip(self.scale * factor, MIN_SCALE, MAX_SCALE))
        ix, iy = self.to_image(cx, cy)
        return replace(self, scale=new_scale, ox=ix - cx / new_scale,
                       oy=iy - cy / new_scale)

    def pan(self, dcx: float, dcy: float) -> "Viewport":
        """Shift the view by a canvas-space delta (drag direction)."""
        return replace(self, ox=self.ox - dcx / self.scale,
                       oy=self.oy - dcy / self.scale)

    def resized(self, canvas_w: int, canvas_h: int) -> "Viewport":
        return replace(self, canvas_w=canvas_w, canvas_h=canvas_h)

    # -- rendering ---------------------------------------------------------------

    def render(self, image: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """Resample the visible image region for display.

        Returns (rgb array, canvas_x, canvas_y): the resized crop and where
        its top-left corner sits on the canvas.
        """
        x0 = max(0.0, self.ox)
        y0 = max(0.0, self.oy)
        x1 = min(float(self.img_w), self.ox + self.canvas_w / self.scale)
        y1 = min(float(self.img_h), self.oy + self.canvas_h / self.scale)
        if x1 <= x0 or y1 <= y0:
            return np.zeros((1, 1, 3), np.uint8), 0, 0

        crop = image[int(y0):max(int(y0) + 1, int(np.ceil(y1))),
                     int(x0):max(int(x0) + 1, int(np.ceil(x1)))]
        out_w = max(1, int(round((x1 - x0) * self.scale)))
        out_h = max(1, int(round((y1 - y0) * self.scale)))
        resize = resize_nearest if self.scale >= 4 else resize_linear
        view = resize(np.ascontiguousarray(crop), out_h, out_w)
        cx, cy = self.to_canvas(x0, y0)
        return view, int(round(cx)), int(round(cy))


def ppm_bytes(rgb: np.ndarray) -> bytes:
    """A binary PPM (P6) of uint8 RGB ``[H, W, 3]`` (gray is repeated)."""
    rgb = np.asarray(rgb, np.uint8)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[:, :, None], 3, axis=2)
    h, w = rgb.shape[:2]
    return b"P6 %d %d 255\n" % (w, h) + np.ascontiguousarray(rgb).tobytes()


class CanvasImage:
    """Tk widget shell around a Viewport: wheel = zoom at the cursor,
    middle- (or Ctrl+left-) drag = pan, left/right click = positive/negative
    click."""

    def __init__(self, canvas, click_callback=None) -> None:
        import tkinter as tk

        self.canvas = canvas
        self.click_callback = click_callback
        self.image: Optional[np.ndarray] = None
        self.viewport: Optional[Viewport] = None
        self._photo = None
        self._drag_anchor = None
        self._tk = tk

        canvas.bind("<ButtonPress-1>", self._on_left)
        canvas.bind("<ButtonPress-3>", self._on_right)
        canvas.bind("<ButtonPress-2>", self._pan_start)
        canvas.bind("<B2-Motion>", self._pan_move)
        canvas.bind("<Control-ButtonPress-1>", self._pan_start)
        canvas.bind("<Control-B1-Motion>", self._pan_move)
        canvas.bind("<MouseWheel>", self._on_wheel)  # win/mac
        canvas.bind("<Button-4>", lambda e: self._wheel_zoom(e, 1.2))  # X11
        canvas.bind("<Button-5>", lambda e: self._wheel_zoom(e, 1 / 1.2))
        canvas.bind("<Configure>", self._on_resize)

    # -- public -----------------------------------------------------------------

    def reload_image(self, image: np.ndarray, reset_view: bool = False) -> None:
        self.image = image
        h, w = image.shape[:2]
        cw = max(self.canvas.winfo_width(), 2)
        ch = max(self.canvas.winfo_height(), 2)
        if reset_view or self.viewport is None or (
                self.viewport.img_w, self.viewport.img_h) != (w, h):
            self.viewport = Viewport.fit(w, h, cw, ch)
        self.redraw()

    def redraw(self) -> None:
        if self.image is None or self.viewport is None:
            return
        view, cx, cy = self.viewport.render(self.image)
        self._photo = self._tk.PhotoImage(
            data=ppm_bytes(view.astype(np.uint8)), format="PPM")
        self.canvas.delete("all")
        self.canvas.create_image(cx, cy, image=self._photo, anchor="nw")

    # -- events -------------------------------------------------------------------

    def _on_left(self, event):
        self._emit_click(event, True)

    def _on_right(self, event):
        self._emit_click(event, False)

    def _emit_click(self, event, is_positive: bool):
        if self.viewport is None or self.click_callback is None:
            return
        hit = self.viewport.image_click(event.x, event.y)
        if hit is not None:
            self.click_callback(x=hit[0], y=hit[1], is_positive=is_positive)

    def _pan_start(self, event):
        self._drag_anchor = (event.x, event.y)

    def _pan_move(self, event):
        if self._drag_anchor is None or self.viewport is None:
            return
        dx = event.x - self._drag_anchor[0]
        dy = event.y - self._drag_anchor[1]
        self._drag_anchor = (event.x, event.y)
        self.viewport = self.viewport.pan(dx, dy)
        self.redraw()

    def _on_wheel(self, event):
        self._wheel_zoom(event, 1.2 if event.delta > 0 else 1 / 1.2)

    def _wheel_zoom(self, event, factor: float):
        if self.viewport is None:
            return
        self.viewport = self.viewport.zoom_at(event.x, event.y, factor)
        self.redraw()

    def _on_resize(self, event):
        if self.viewport is not None:
            self.viewport = self.viewport.resized(event.width, event.height)
            self.redraw()
