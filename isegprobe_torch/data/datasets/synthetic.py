"""Procedural synthetic-shapes scenes, without OpenCV.

Counterpart of ``isegprobe_tpu/data/datasets/synthetic.py``: each index
seeds its own ``np.random.default_rng(seed * 1_000_003 + index)`` and draws
1-3 filled shapes (ellipse, rotated box, convex polygon) over a shaded,
lightly textured background, with the same draws in the same order. The
OpenCV calls go through ``data/raster.py``: the shape masks are OpenCV's
(the ellipse and every polygon inside the image exactly; a polygon edge
that leaves the image may differ on a pixel of the image's border), and the
background noise's bilinear resize differs from OpenCV's by float64
rounding only (``tests/test_torch_data.py`` states both).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from isegprobe_torch.data import raster
from isegprobe_torch.data.base_dataset import iSegBaseDataset
from isegprobe_torch.data.sample import DSample

__all__ = ["SyntheticShapesDataset", "render_scene"]


def _shaded_background(rng: np.random.Generator,
                       hw: Tuple[int, int]) -> np.ndarray:
    """Smooth two-direction colour ramp with mild blurred noise."""
    h, w = hw
    base = rng.uniform(50, 200, size=3)
    slope = rng.uniform(-50, 50, size=(2, 3))
    yy = np.linspace(-0.5, 0.5, h)[:, None, None]
    xx = np.linspace(-0.5, 0.5, w)[None, :, None]
    img = base + slope[0] * yy + slope[1] * xx
    noise = rng.normal(0, 1, size=(h // 4, w // 4, 3))
    noise = raster.resize_linear(noise, h, w)
    return img + 6.0 * noise


def _pick_color(rng: np.random.Generator, taken, min_dist: float = 70.0):
    """A colour at least ``min_dist`` (L2) from every colour already in the
    scene."""
    for _ in range(64):
        c = rng.uniform(20, 235, size=3)
        if all(np.linalg.norm(c - t) >= min_dist for t in taken):
            return c
    return c  # pathological draw; accept the collision


def _stamp_shape(rng: np.random.Generator, canvas: np.ndarray) -> np.ndarray:
    """One filled shape in a fresh byte mask (1 = inside)."""
    h, w = canvas.shape[:2]
    stamp = np.zeros((h, w), np.uint8)
    cy = int(rng.uniform(0.25, 0.75) * h)
    cx = int(rng.uniform(0.25, 0.75) * w)
    r0 = int(rng.uniform(0.14, 0.30) * min(h, w))
    r1 = int(r0 * rng.uniform(0.6, 1.0))
    angle = rng.uniform(0, 180)

    kind = rng.integers(3)
    if kind == 0:
        raster.fill_ellipse(stamp, (cx, cy), (r0, r1), angle, 1)
    elif kind == 1:
        box = raster.box_points((cx, cy), (2 * r0, 2 * r1), angle)
        raster.fill_poly(stamp, box.astype(np.int32), 1)
    else:
        # convex blob: hull of points scattered on a wobbly ring
        n = int(rng.integers(5, 9))
        theta = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(0.6, 1.0, n)
        pts = np.stack([cx + r0 * rad * np.cos(theta),
                        cy + r1 * rad * np.sin(theta)],
                       axis=1).astype(np.int32)
        raster.fill_poly(stamp, raster.convex_hull(pts), 1)
    return stamp


def render_scene(rng: np.random.Generator, hw: Tuple[int, int],
                 n_shapes: int) -> Tuple[np.ndarray, np.ndarray]:
    """One (image uint8 [H, W, 3], instance mask int32 [H, W]) scene."""
    img = _shaded_background(rng, hw)
    labels = np.zeros(hw, np.int32)
    colors = [img.reshape(-1, 3).mean(axis=0)]
    for i in range(n_shapes):
        color = _pick_color(rng, colors)
        colors.append(color)
        inside = _stamp_shape(rng, img).astype(bool)
        shade = 1.0 + 0.1 * rng.normal(0, 1, size=hw)[..., None]
        img = np.where(inside[..., None], color * shade, img)
        labels[inside] = i + 1  # later shapes occlude earlier ones
    img += rng.normal(0, 2.0, size=img.shape)
    return np.clip(img, 0, 255).astype(np.uint8), labels


class SyntheticShapesDataset(iSegBaseDataset):
    """Deterministic on-the-fly shape scenes (no files)."""

    def __init__(self, n_samples: int = 200,
                 image_size: Tuple[int, int] = (224, 224),
                 min_shapes: int = 1, max_shapes: int = 3, seed: int = 17,
                 min_instance_area: int = 0, **kwargs) -> None:
        super().__init__(**kwargs)
        self.image_size = tuple(image_size)
        self.min_shapes = min_shapes
        self.max_shapes = max_shapes
        self.seed = seed
        self.min_instance_area = min_instance_area
        self.dataset_samples = list(range(n_samples))

    def get_sample(self, index: int, rng=None) -> DSample:
        rng = np.random.default_rng(self.seed * 1_000_003 + index)
        n_shapes = int(rng.integers(self.min_shapes, self.max_shapes + 1))
        image, labels = render_scene(rng, self.image_size, n_shapes)
        present = [i for i in range(1, n_shapes + 1)
                   if (labels == i).sum() >= max(1, self.min_instance_area)]
        return DSample(image, labels, objects_ids=present, sample_id=index)
