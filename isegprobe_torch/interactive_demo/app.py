"""Tkinter interactive demo, the port's counterpart of
``isegprobe_tpu/interactive_demo/app.py`` (the reference's
core/interactive_demo/app.py, canvas.py and wrappers.py).

Layout: menu bar (load image / save mask / load mask / about / exit), a
zoom/pan canvas (interactive_demo/canvas.py) on the left, and a controls
column: clicks management (finish / undo / reset), ZoomIn options, BRS mode +
L-BFGS settings, and prediction-threshold / alpha-blend / click-radius
sliders.  Keyboard: <space> finishes the object, <a> partially finishes.

All model work runs through the port's predictor (on the GPU unless the
builder was made for the CPU); changing ZoomIn/BRS options rebuilds the
predictor from the current widget state. Images are read by
``data/image_io.py`` (JPEG, PNG, BMP, as ``cv2.imread`` reads them), masks
saved with its PNG writer, so the app needs neither OpenCV nor PIL.
"""

from __future__ import annotations

import tkinter as tk
from tkinter import filedialog, messagebox, ttk

from pathlib import Path

import numpy as np

from isegprobe_torch.data.image_io import decode_bgr, read_rgb, write_png
from isegprobe_torch.interactive_demo.canvas import CanvasImage
from isegprobe_torch.interactive_demo.controller import InteractiveController

BRS_MODES = ["NoBRS", "RGB-BRS", "DistMap-BRS", "f-BRS-A", "f-BRS-B", "f-BRS-C"]


class InteractiveDemoApp(ttk.Frame):
    def __init__(self, master, predictor_builder, prob_thresh: float = 0.5,
                 limit_longest_size: int = 800):
        """``predictor_builder(brs_mode, prob_thresh, zoomin_params,
        predictor_params, lbfgs_max_iters)`` -> predictor; called on every
        option change."""
        super().__init__(master)
        self.master = master
        master.title("iSegProbe interactive demo")
        self.pack(fill="both", expand=True)
        self.predictor_builder = predictor_builder
        self.limit_longest_size = limit_longest_size

        self._init_state(prob_thresh)
        self.controller = InteractiveController(
            self._build_predictor,
            update_image_callback=self._update_image,
            prob_thresh=prob_thresh,
        )

        self._add_menu()
        self._add_canvas()
        self._add_controls()

        master.bind("<space>", lambda _e: self.controller.finish_object())
        master.bind("a", lambda _e: self.controller.partially_finish_object())

    # -- state -------------------------------------------------------------

    def _init_state(self, prob_thresh: float) -> None:
        self.state = {
            "use_zoom_in": tk.BooleanVar(value=True),
            "fixed_crop": tk.BooleanVar(value=True),
            "skip_clicks": tk.IntVar(value=-1),
            "target_size": tk.IntVar(value=448),
            "expansion_ratio": tk.DoubleVar(value=1.4),
            "net_clicks_limit": tk.IntVar(value=20),
            "brs_mode": tk.StringVar(value="NoBRS"),
            "lbfgs_max_iters": tk.IntVar(value=20),
            "prob_thresh": tk.DoubleVar(value=prob_thresh),
            "alpha_blend": tk.DoubleVar(value=0.5),
            "click_radius": tk.IntVar(value=3),
        }

    def _build_predictor(self):
        s = self.state
        size = int(s["target_size"].get())
        zoomin = None
        if s["use_zoom_in"].get():
            zoomin = {
                "target_size": (size, size),
                "skip_clicks": -1 if s["fixed_crop"].get()
                else max(0, int(s["skip_clicks"].get())),
                "expansion_ratio": float(s["expansion_ratio"].get()),
            }
        return self.predictor_builder(
            brs_mode=s["brs_mode"].get(),
            prob_thresh=float(s["prob_thresh"].get()),
            zoomin_params=zoomin,
            predictor_params={"net_clicks_limit": int(s["net_clicks_limit"].get())},
            lbfgs_max_iters=int(s["lbfgs_max_iters"].get()),
        )

    # -- menu -----------------------------------------------------------------

    def _add_menu(self):
        bar = tk.Frame(self, bd=1)
        bar.pack(side="top", fill="x")
        tk.Button(bar, text="Load image", command=self._load_image).pack(side="left")
        self.save_mask_btn = tk.Button(bar, text="Save mask", state=tk.DISABLED,
                                       command=self._save_mask)
        self.save_mask_btn.pack(side="left")
        self.load_mask_btn = tk.Button(bar, text="Load mask", state=tk.DISABLED,
                                       command=self._load_mask)
        self.load_mask_btn.pack(side="left")
        tk.Button(bar, text="About", command=self._about).pack(side="left")
        tk.Button(bar, text="Exit", command=self.master.quit).pack(side="left")

    def _add_canvas(self):
        frame = tk.LabelFrame(self, text="Image")
        frame.pack(side="left", fill="both", expand=True, padx=5, pady=5)
        canvas = tk.Canvas(frame, highlightthickness=0, cursor="hand1",
                           width=640, height=480, bg="#404040")
        canvas.pack(fill="both", expand=True, padx=5, pady=5)
        self.canvas_image = CanvasImage(canvas, click_callback=self._click)

    # -- controls column ------------------------------------------------------

    def _add_controls(self):
        col = tk.Frame(self)
        col.pack(side="top", fill="x", padx=5, pady=5)

        clicks = tk.LabelFrame(col, text="Clicks management")
        clicks.pack(side="top", fill="x", padx=10, pady=3)
        self.finish_btn = tk.Button(clicks, text="Finish\nobject", bg="#b6d7a8",
                                    width=10, height=2, state=tk.DISABLED,
                                    command=self.controller.finish_object)
        self.finish_btn.pack(side="left", padx=10, pady=3)
        self.undo_btn = tk.Button(clicks, text="Undo click", bg="#ffe599",
                                  width=10, height=2, state=tk.DISABLED,
                                  command=self.controller.undo_click)
        self.undo_btn.pack(side="left", padx=10, pady=3)
        self.reset_btn = tk.Button(clicks, text="Reset clicks", bg="#ea9999",
                                   width=10, height=2, state=tk.DISABLED,
                                   command=self._reset_last_object)
        self.reset_btn.pack(side="left", padx=10, pady=3)

        zoom = tk.LabelFrame(col, text="ZoomIn options")
        zoom.pack(side="top", fill="x", padx=10, pady=3)
        tk.Checkbutton(zoom, text="Use ZoomIn", variable=self.state["use_zoom_in"],
                       command=self._reset_predictor).grid(row=0, column=0, padx=10)
        tk.Checkbutton(zoom, text="Fixed crop", variable=self.state["fixed_crop"],
                       command=self._reset_predictor).grid(row=1, column=0, padx=10)
        for row, (label, key, lo, hi) in enumerate([
            ("Skip clicks", "skip_clicks", -1, 99),
            ("Target size", "target_size", 100, self.limit_longest_size),
            ("Expand ratio", "expansion_ratio", 1.0, 2.0),
        ]):
            tk.Label(zoom, text=label).grid(row=row, column=1, sticky="e")
            self._bounded_entry(zoom, key, lo, hi).grid(
                row=row, column=2, padx=10, pady=1, sticky="w"
            )

        brs = tk.LabelFrame(col, text="BRS options")
        brs.pack(side="top", fill="x", padx=10, pady=3)
        menu = tk.OptionMenu(brs, self.state["brs_mode"], *BRS_MODES,
                             command=self._change_brs_mode)
        menu.config(width=11)
        menu.grid(rowspan=2, column=0, padx=10)
        tk.Label(brs, text="Network clicks").grid(row=0, column=1, sticky="e")
        self.net_clicks_entry = self._bounded_entry(brs, "net_clicks_limit", 1, 99)
        self.net_clicks_entry.grid(row=0, column=2, padx=10, pady=2, sticky="w")
        tk.Label(brs, text="L-BFGS\nmax iterations").grid(row=1, column=1,
                                                          sticky="e")
        self.lbfgs_entry = self._bounded_entry(brs, "lbfgs_max_iters", 1, 1000)
        self.lbfgs_entry.grid(row=1, column=2, padx=10, pady=2, sticky="w")
        self._change_brs_mode()

        for title, key, lo, hi, res, cmd in [
            ("Predictions threshold", "prob_thresh", 0.0, 1.0, 0.01,
             self._update_prob_thresh),
            ("Alpha blending coefficient", "alpha_blend", 0.0, 1.0, 0.01,
             lambda _v: self._update_image()),
            ("Visualisation click radius", "click_radius", 0, 7, 1,
             lambda _v: self._update_image()),
        ]:
            frame = tk.LabelFrame(col, text=title)
            frame.pack(side="top", fill="x", padx=10, pady=3)
            tk.Scale(frame, from_=lo, to=hi, resolution=res,
                     orient=tk.HORIZONTAL, variable=self.state[key],
                     command=cmd).pack(fill="x", padx=10)

    def _bounded_entry(self, parent, key, lo, hi):
        var = self.state[key]

        def _clamp(_e=None):
            try:
                v = type(lo)(float(var.get()))
            except (tk.TclError, ValueError):
                v = lo
            var.set(min(hi, max(lo, v)))
            self._reset_predictor()

        entry = tk.Entry(parent, textvariable=var, width=7)
        entry.bind("<Return>", _clamp)
        entry.bind("<FocusOut>", _clamp)
        return entry

    # -- actions -------------------------------------------------------------------

    def _load_image(self):
        path = filedialog.askopenfilename(
            parent=self.master,
            filetypes=[("Images", "*.jpg *.jpeg *.png *.bmp *.tiff *.tif"),
                       ("All files", "*.*")],
            title="Choose an image",
        )
        if not path:
            return
        image = read_rgb(path)
        self.controller.set_image(image)
        self.save_mask_btn.configure(state=tk.NORMAL)
        self.load_mask_btn.configure(state=tk.NORMAL)

    def _save_mask(self):
        mask = self.controller.result_mask
        if mask is None:
            return
        path = filedialog.asksaveasfilename(
            parent=self.master, initialfile="mask.png",
            filetypes=[("PNG image", "*.png"), ("All files", "*.*")],
            title="Save the current mask as...",
        )
        if not path:
            return
        if mask.max() < 256:
            mask = mask.astype(np.uint8)
            mask *= 255 // max(1, mask.max())
        write_png(path, mask)

    def _load_mask(self):
        if not getattr(self.controller.predictor, "with_prev_mask", False):
            messagebox.showwarning(
                "Warning", "The current model doesn't support loading "
                "external masks.",
            )
            return
        path = filedialog.askopenfilename(
            parent=self.master,
            filetypes=[("Binary mask (png, bmp)", "*.png *.bmp"),
                       ("All files", "*.*")],
            title="Choose a mask",
        )
        if not path:
            return
        mask = decode_bgr(Path(path).read_bytes(), path)[:, :, 0] > 127
        if not self.controller.set_mask(mask):
            messagebox.showwarning(
                "Warning", "A segmentation mask must have the same size as "
                "the current image!",
            )
            return
        self._update_image()

    def _about(self):
        messagebox.showinfo(
            "About", "iSegProbe interactive demo\n"
            "PyTorch/CUDA port of the iSegProbe annotation tool",
        )

    def _click(self, x: int, y: int, is_positive: bool):
        if self.controller.image is None:
            return
        self.controller.add_click(x, y, is_positive)

    def _reset_last_object(self):
        self.state["alpha_blend"].set(0.5)
        self.state["prob_thresh"].set(0.5)
        self.controller.reset_last_object()

    def _reset_predictor(self, *_a):
        self.controller.reset_predictor()

    def _change_brs_mode(self, *_a):
        no_brs = self.state["brs_mode"].get() == "NoBRS"
        state = tk.DISABLED if no_brs else tk.NORMAL
        self.lbfgs_entry.configure(state=state)
        self._reset_predictor()

    def _update_prob_thresh(self, _value):
        if self.controller.is_incomplete_mask:
            self.controller.prob_thresh = float(self.state["prob_thresh"].get())
            self._update_image()

    def _update_image(self, reset_canvas: bool = False):
        vis = self.controller.get_visualization(
            alpha_blend=float(self.state["alpha_blend"].get()),
            click_radius=int(self.state["click_radius"].get()),
        )
        active = tk.NORMAL if self.controller.is_incomplete_mask else tk.DISABLED
        for btn in (self.finish_btn, self.undo_btn, self.reset_btn):
            btn.configure(state=active)
        if vis is not None:
            self.canvas_image.reload_image(vis, reset_view=reset_canvas)


def run_app(predictor_builder, prob_thresh: float = 0.5,
            limit_longest_size: int = 800):
    root = tk.Tk()
    root.minsize(960, 720)
    app = InteractiveDemoApp(root, predictor_builder, prob_thresh,
                             limit_longest_size)
    root.deiconify()
    app.mainloop()
