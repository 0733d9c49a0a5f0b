"""The traffic's scenes, drawn from a traffic file's parameters.

A traffic file's ``scenes`` entry names a seed, a smallest object area and
groups of frame sizes with the number of objects each group holds, and the
sha256 of what they draw. :func:`objects` renders the scenes and returns
every object as ``(uint8 image [H, W, 3], int32 gt [H, W])`` with its
group; a digest other than the pinned one fails the run.

A scene takes the draws of the program's Synthetic scenes
(``isegprobe_torch/data/datasets/synthetic.py``, on which the checkpoints
were trained) in their order: a shaded background with blurred noise, then
1-3 shapes (ellipse, rotated box, convex blob), each in a colour far from
the others and lightly shaded, later shapes occluding earlier ones, and
pixel noise. The shapes are filled by exact integer half-plane tests of
their integer vertices rather than by OpenCV's fixed-point outlines, and
every step is a plain IEEE add, multiply or divide, so the same seed gives
the same bytes on any machine with the same ``numpy.random`` streams.
Scenes are drawn one after another in each group until it holds its
objects (labels of at least ``min_area`` pixels, in scene order).
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import numpy as np


def _resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize with half-pixel centres and clamped taps."""
    def taps(dst, src):
        f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
        f = np.clip(f, 0.0, src - 1.0)
        s0 = np.floor(f).astype(np.int64)
        s1 = np.minimum(s0 + 1, src - 1)
        return s0, s1, (f - s0).astype(np.float32)

    r0, r1, fy = taps(h, img.shape[0])
    c0, c1, fx = taps(w, img.shape[1])
    rows = (img[r0] * (1.0 - fy)[:, None, None]
            + img[r1] * fy[:, None, None])
    return (rows[:, c0] * (1.0 - fx)[None, :, None]
            + rows[:, c1] * fx[None, :, None])


def _background(rng: np.random.Generator, hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    base = rng.uniform(50, 200, size=3)
    slope = rng.uniform(-50, 50, size=(2, 3))
    yy = np.linspace(-0.5, 0.5, h, dtype=np.float32)[:, None, None]
    xx = np.linspace(-0.5, 0.5, w, dtype=np.float32)[None, :, None]
    img = (base.astype(np.float32) + slope[0].astype(np.float32) * yy
           + slope[1].astype(np.float32) * xx)
    noise = rng.standard_normal(size=(h // 4, w // 4, 3), dtype=np.float32)
    img += np.float32(6.0) * _resize_linear(noise, h, w)
    return img, base


def _pick_color(rng: np.random.Generator, taken,
                min_dist: float = 70.0) -> np.ndarray:
    for _ in range(64):
        c = rng.uniform(20, 235, size=3).tolist()
        if all(math.sqrt(sum((a - b) ** 2 for a, b in zip(c, t)))
               >= min_dist for t in taken):
            return c
    return c


def _hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull of integer points, counter-clockwise (monotone chain,
    collinear points dropped)."""
    pts = sorted(set(map(tuple, pts.tolist())))
    if len(pts) < 3:
        return np.asarray(pts, np.int64)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return np.asarray(lower[:-1] + upper[:-1], np.int64)


def _fill_convex(hw: Tuple[int, int], poly: np.ndarray) -> np.ndarray:
    """Pixels (x, y) on or inside the convex polygon ``poly`` ``[n, 2]``
    (integer x, y), by exact integer edge tests over its bounding box."""
    h, w = hw
    mask = np.zeros(hw, bool)
    hull = _hull(poly)
    if len(hull) < 3:
        return mask
    x0, y0 = max(int(hull[:, 0].min()), 0), max(int(hull[:, 1].min()), 0)
    x1 = min(int(hull[:, 0].max()), w - 1)
    y1 = min(int(hull[:, 1].max()), h - 1)
    if x1 < x0 or y1 < y0:
        return mask
    ys = np.arange(y0, y1 + 1, dtype=np.int64)[:, None]
    xs = np.arange(x0, x1 + 1, dtype=np.int64)[None, :]
    inside = np.ones((len(ys), xs.shape[1]), bool)
    for (ax, ay), (bx, by) in zip(hull, np.roll(hull, -1, axis=0)):
        inside &= (bx - ax) * (ys - ay) - (by - ay) * (xs - ax) >= 0
    mask[y0:y1 + 1, x0:x1 + 1] = inside
    return mask


def _stamp(rng: np.random.Generator, hw: Tuple[int, int]) -> np.ndarray:
    """One filled shape as a boolean mask, with the program's draws."""
    h, w = hw
    cy = int(rng.uniform(0.25, 0.75) * h)
    cx = int(rng.uniform(0.25, 0.75) * w)
    r0 = int(rng.uniform(0.14, 0.30) * min(h, w))
    r1 = int(r0 * rng.uniform(0.6, 1.0))
    angle = math.radians(rng.uniform(0, 180))
    ca, sa = math.cos(angle), math.sin(angle)
    kind = rng.integers(3)
    if kind == 0:  # ellipse: 360 vertices, one a degree
        pts = []
        for deg in range(360):
            t = math.radians(deg)
            u, v = r0 * math.cos(t), r1 * math.sin(t)
            pts.append((round(cx + u * ca - v * sa),
                        round(cy + u * sa + v * ca)))
        poly = np.asarray(pts, np.int64)
    elif kind == 1:  # rotated box 2 r0 x 2 r1
        poly = np.asarray([(int(cx + u * ca - v * sa), int(cy + u * sa
                                                          + v * ca))
                           for u, v in ((-r0, -r1), (r0, -r1), (r0, r1),
                                        (-r0, r1))], np.int64)
    else:  # convex blob: hull of points scattered on a wobbly ring
        n = int(rng.integers(5, 9))
        theta = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(0.6, 1.0, n)
        poly = np.asarray([(int(cx + r0 * r * math.cos(t)),
                            int(cy + r1 * r * math.sin(t)))
                           for t, r in zip(theta.tolist(), rad.tolist())],
                          np.int64)
    return _fill_convex(hw, poly)


def render_scene(rng: np.random.Generator, hw: Tuple[int, int],
                 n_shapes: int) -> Tuple[np.ndarray, np.ndarray]:
    """One (uint8 image [H, W, 3], int32 label map [H, W]) scene."""
    img, base = _background(rng, hw)
    labels = np.zeros(hw, np.int32)
    colors = [base]
    for i in range(n_shapes):
        color = _pick_color(rng, colors)
        colors.append(color)
        inside = _stamp(rng, hw)
        shade = np.float32(1.0) + np.float32(0.1) * rng.standard_normal(
            size=int(inside.sum()), dtype=np.float32)
        img[inside] = np.asarray(color, np.float32) * shade[:, None]
        labels[inside] = i + 1
    img += np.float32(2.0) * rng.standard_normal(size=img.shape,
                                                 dtype=np.float32)
    return np.clip(img, 0, 255).astype(np.uint8), labels


def draw(params: Dict) -> List[Dict]:
    """Every object of the scenes ``params`` describes: dicts of ``image``,
    ``gt`` (int32, 1 inside), ``group`` (index into ``params["groups"]``)
    and ``hw``, group after group."""
    out: List[Dict] = []
    for g, group in enumerate(params["groups"]):
        hw = tuple(group["hw"])
        taken, scene = 0, 0
        while taken < group["objects"]:
            rng = np.random.default_rng([params["seed"], g, scene])
            n_shapes = int(rng.integers(1, 4))
            image, labels = render_scene(rng, hw, n_shapes)
            scene += 1
            for lab in range(1, n_shapes + 1):
                gt = (labels == lab).astype(np.int32)
                if gt.sum() < params["min_area"] or taken == group["objects"]:
                    continue
                out.append(dict(image=image, gt=gt, group=g, hw=hw))
                taken += 1
    return out


def digest(objs: List[Dict]) -> str:
    h = hashlib.sha256()
    for o in objs:
        h.update(np.ascontiguousarray(o["image"]).tobytes())
        h.update(o["gt"].astype(np.uint8).tobytes())
    return h.hexdigest()


def objects(params: Dict) -> List[Dict]:
    """:func:`draw`, after checking the pinned digest."""
    objs = draw(params)
    got = digest(objs)
    if got != params["sha256"]:
        raise RuntimeError(f"scenes: sha256 {got}, the traffic pins "
                           f"{params['sha256']}")
    return objs
