"""The OpenCV raster operations of the training data layer, in numpy.

The JAX package's data layer calls OpenCV (``data/transforms.py``,
``data/datasets/synthetic.py``); the GPU machine has no OpenCV. These are
the same operations, computed as OpenCV 5's ``imgproc`` computes them:

* :func:`resize_linear`: ``cv2.resize(..., INTER_LINEAR)``. On uint8 it
  follows OpenCV's fixed-point path (11-bit weights rounded from float32
  offsets, the horizontal pass in int32, the vertical pass as
  ``((b0·(S0>>4))>>16) + ((b1·(S1>>4))>>16) + 2 >> 2``), exact; on
  float64 it computes offsets and weights in double, within a few ulp.
* :func:`resize_nearest`: ``INTER_NEAREST`` (source index
  ``floor(x · (1 / (dst/src)))``), exact.
* :func:`flip`: ``cv2.flip``.
* :func:`fill_poly`: ``cv2.fillPoly`` of one integer polygon at
  ``LINE_8``: the 8-connected outline (Bresenham, clipped to the image)
  joined to the scan-line fill of OpenCV's edge table in 16.16 fixed
  point.
* :func:`fill_ellipse`: ``cv2.ellipse(..., thickness=-1)`` with integer
  centre and axes: the vertices of ``ellipse2Poly`` (OpenCV's table of
  sines to 7 decimals) in 16.16 fixed point, filled as
  ``FillConvexPoly`` fills them (its fixed-point outline and scan lines).
* :func:`convex_hull` and :func:`box_points`: ``cv2.convexHull`` of
  integer points (collinear points dropped) and ``cv2.boxPoints``.
* :func:`rotation_matrix_2d`: ``cv2.getRotationMatrix2D`` (the centre
  rounded to float32, the angle's cosine and sine in double).
* :func:`warp_affine`: ``cv2.warpAffine(..., borderMode=BORDER_CONSTANT,
  borderValue=0)`` with the matrix inverted in double as OpenCV inverts it.
  ``INTER_NEAREST`` on int32 masks is OpenCV's classic fixed-point path
  (10-bit offsets), in numpy; ``INTER_LINEAR`` on uint8 images is its
  float32 path (source coordinates ``fma(M0, x, f32(f32(M1·y) + M2))``
  over the columns its 16-wide vector loop covers and ``f32(fma(x, M0,
  f32(M1·y)) + M2)`` over the scalar tail after it, then float32 lerps
  ``fma(a, p1 − p0, p0)`` and round-half-even), in
  ``csrc/host/jpeg.cpp``; both exact.

``tests/test_torch_data.py`` holds each against OpenCV.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["resize_linear", "resize_nearest", "flip", "fill_poly",
           "fill_ellipse", "convex_hull", "box_points", "rotation_matrix_2d",
           "warp_affine"]

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS
XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


# -- resize -------------------------------------------------------------------

def _linear_taps(dst: int, src: int, dtype=np.float32):
    """Source indices and offsets ``f`` (the weights are ``(1 - f, f)``)
    of each destination index, as OpenCV's resize computes them: float32
    offsets on its fixed-point uint8 path, float64 on its float64 one."""
    scale = src / dst
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * scale - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    f = (f - s.astype(dtype)).astype(dtype)
    return s, f


def _h_coeffs(dst: int, src: int, dtype=np.float32):
    """Horizontal taps: OpenCV zeroes the weight and clamps the index
    outside the source."""
    s, f = _linear_taps(dst, src, dtype)
    left = s < 0
    f[left] = 0.0
    s[left] = 0
    right = s >= src - 1
    f[right] = 0.0
    s[right] = src - 1
    return s, np.minimum(s + 1, src - 1), right, f


def _v_coeffs(dst: int, src: int, dtype=np.float32):
    """Vertical taps: OpenCV clamps the two source rows and keeps the
    weight."""
    s, f = _linear_taps(dst, src, dtype)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), f


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)`` of a
    uint8 or float64 image ``[H, W]`` or ``[H, W, C]``."""
    src_h, src_w = img.shape[:2]
    squeeze = img.ndim == 2
    x = img[:, :, None] if squeeze else img
    if (src_h, src_w) == (h, w):
        return img.copy()
    if img.dtype == np.uint8:
        xs0, xs1, xright, fx = _h_coeffs(w, src_w)
        ys0, ys1, fy = _v_coeffs(h, src_h)
        a0 = np.rint((1.0 - fx) * _COEF_SCALE).astype(np.int32)
        a1 = np.rint(fx * _COEF_SCALE).astype(np.int32)
        xi = x.astype(np.int32)
        hbuf = (xi[:, xs0] * a0[None, :, None]
                + xi[:, xs1] * a1[None, :, None])
        hbuf[:, xright] = xi[:, xs0[xright]] * _COEF_SCALE
        b0 = np.rint((1.0 - fy) * _COEF_SCALE).astype(np.int32)
        b1 = np.rint(fy * _COEF_SCALE).astype(np.int32)
        r0 = (b0[:, None, None] * (hbuf[ys0] >> 4)) >> 16
        r1 = (b1[:, None, None] * (hbuf[ys1] >> 4)) >> 16
        out = ((r0 + r1 + 2) >> 2).astype(np.uint8)
    elif img.dtype == np.float64:
        xs0, xs1, xright, fx = _h_coeffs(w, src_w, np.float64)
        ys0, ys1, fy = _v_coeffs(h, src_h, np.float64)
        a0, a1 = 1.0 - fx, fx
        hbuf = x[:, xs0] * a0[None, :, None] + x[:, xs1] * a1[None, :, None]
        hbuf[:, xright] = x[:, xs0[xright]]
        b0, b1 = 1.0 - fy, fy
        out = hbuf[ys0] * b0[:, None, None] + hbuf[ys1] * b1[:, None, None]
    else:
        raise TypeError(f"resize_linear takes uint8 or float64, got "
                        f"{img.dtype}")
    return out[:, :, 0] if squeeze else out


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)``; a
    ``[H, W, 1]`` input comes back ``[h, w]``, as from OpenCV."""
    src_h, src_w = img.shape[:2]
    # OpenCV's step is the reciprocal of its scale dst/src, not src/dst
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / (h / src_h))).astype(
        np.int64), src_h - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / (w / src_w))).astype(
        np.int64), src_w - 1)
    out = img[ys][:, xs]
    if out.ndim == 3 and out.shape[2] == 1:
        out = out[:, :, 0]
    return np.ascontiguousarray(out)


def flip(img: np.ndarray, code: int) -> np.ndarray:
    """``cv2.flip``: 0 about the x axis, 1 about the y axis, -1 both; a
    ``[H, W, 1]`` input comes back ``[H, W]``."""
    if code == 0:
        out = img[::-1]
    elif code > 0:
        out = img[:, ::-1]
    else:
        out = img[::-1, ::-1]
    if out.ndim == 3 and out.shape[2] == 1:
        out = out[:, :, 0]
    return np.ascontiguousarray(out)


# -- lines --------------------------------------------------------------------

def _clip_line(w: int, h: int, p1: List[int], p2: List[int]) -> bool:
    """OpenCV's ``clipLine`` on an image of ``w`` x ``h``: moves the
    endpoints onto the image in place; False when the line misses it."""
    right, bottom = w - 1, h - 1
    x1, y1 = p1
    x2, y2 = p2
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    p1[:] = [x1, y1]
    p2[:] = [x2, y2]
    return (c1 | c2) == 0


def _line8(canvas: np.ndarray, p1: Sequence[int], p2: Sequence[int],
           value) -> None:
    """OpenCV's ``Line`` at 8-connectivity, left to right, through its
    ``LineIterator`` (clipped to the image first)."""
    h, w = canvas.shape[:2]
    p1, p2 = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if not (0 <= p1[0] < w and 0 <= p1[1] < h and 0 <= p2[0] < w
            and 0 <= p2[1] < h):
        if not _clip_line(w, h, p1, p2):
            return
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x1, y1
    for _ in range(dx + 1):
        canvas[y, x] = value
        if err < 0:  # step along both axes
            err += 2 * dx - 2 * dy
            x += 1
            y += sy
        else:
            err -= 2 * dy
            if steep:
                y += sy
            else:
                x += 1


def _line2(canvas: np.ndarray, p1: Sequence[int], p2: Sequence[int],
           value) -> None:
    """OpenCV's ``Line2``: the 8-connected line between 16.16 fixed-point
    endpoints."""
    h, w = canvas.shape[:2]
    p1, p2 = [int(p1[0]), int(p1[1])], [int(p2[0]), int(p2[1])]
    if not _clip_line(w << XY_SHIFT, h << XY_SHIFT, p1, p2):
        return
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = XY_ONE, _cdiv(dy << XY_SHIFT, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step, y_step = _cdiv(dx << XY_SHIFT, ay | 1), XY_ONE
        count = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            canvas[y, x] = value

    put((x2 + (XY_ONE >> 1)) >> XY_SHIFT, (y2 + (XY_ONE >> 1)) >> XY_SHIFT)
    if ax > ay:
        x1 >>= XY_SHIFT
        while count >= 0:
            put(x1, y1 >> XY_SHIFT)
            x1 += 1
            y1 += y_step
            count -= 1
    else:
        y1 >>= XY_SHIFT
        while count >= 0:
            put(x1 >> XY_SHIFT, y1)
            x1 += x_step
            y1 += 1
            count -= 1


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


# -- polygon fills ------------------------------------------------------------

def _fill_edges(canvas: np.ndarray, edges, value) -> None:
    """OpenCV's ``FillEdgeCollection`` at ``LINE_8``: for each row, the
    active edges sorted by x, spans between pairs from the ceiling of the
    left x to the floor of the right one, x in 16.16 fixed point advanced
    by each edge's dx."""
    if len(edges) < 2:
        return
    h, w = canvas.shape[:2]
    y_min = min(e[0] for e in edges)
    y_max = min(max(e[1] for e in edges), h)
    for y in range(max(y_min, 0), y_max):
        xs = sorted(x0 + (y - y0) * dx for y0, y1, x0, dx in edges
                    if y0 <= y < y1)
        for i in range(0, len(xs) - 1, 2):
            x1 = (xs[i] + XY_ONE - 1) >> XY_SHIFT
            x2 = xs[i + 1] >> XY_SHIFT
            if x1 < w and x2 >= 0:
                canvas[y, max(x1, 0):min(x2, w - 1) + 1] = value


def fill_poly(canvas: np.ndarray, pts: np.ndarray, value=1) -> np.ndarray:
    """``cv2.fillPoly(canvas, [pts], value)`` of one polygon with integer
    vertices ``[N, 2]`` (x, y), ``LINE_8``, in place."""
    h, w = canvas.shape[:2]
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    edges = []
    x0, y0 = pts[-1]
    x0 <<= XY_SHIFT
    for x1, y1 in pts:
        x1 <<= XY_SHIFT
        t0 = [(x0 + (XY_ONE >> 1)) >> XY_SHIFT, y0]
        t1 = [(x1 + (XY_ONE >> 1)) >> XY_SHIFT, y1]
        _line8(canvas, t0, t1, value)
        c0, c1 = [x0, y0], [x1, y1]
        if not all(0 <= t[0] < w and 0 <= t[1] < h for t in (t0, t1)):
            # an edge that leaves the image runs along its clipped part;
            # clipped to a point or a row, it stands upright at the clipped
            # x over its own rows (this OpenCV build's fills, held against
            # cv2.fillPoly on rings that leave the image)
            _clip_line(w, h, t0, t1)
            c0 = [t0[0] << XY_SHIFT, t0[1] if t0[1] != t1[1] else y0]
            c1 = [t1[0] << XY_SHIFT, t1[1] if t0[1] != t1[1] else y1]
        if y0 != y1:
            dx = (c1[0] - c0[0]) // (c1[1] - c0[1])
            top = c0 if y0 < y1 else c1
            edges.append((min(y0, y1), max(y0, y1),
                          top[0] + (min(y0, y1) - top[1]) * dx, dx))
        x0, y0 = x1, y1
    _fill_edges(canvas, edges, value)
    return canvas


def _fill_convex_fixed(canvas: np.ndarray, v: List[Tuple[int, int]],
                       value) -> None:
    """OpenCV's ``FillConvexPoly`` of 16.16 fixed-point vertices at
    ``LINE_8``: the fixed-point outline (``Line2``), then two edges walked
    down from the top vertex, each span rounded by half a pixel."""
    h, w = canvas.shape[:2]
    n = len(v)
    delta = XY_ONE >> 1
    p0 = v[-1]
    for p in v:
        _line2(canvas, p0, p, value)
        p0 = p
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge = [dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-XY_ONE, dx=0, ye=ymin)]
    y = ymin
    edges = n
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0 = e["idx"]
                idx = (idx0 + e["di"]) % n
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs0, xe = v[idx0][0], v[idx][0]
                        e["ye"] = ty
                        e["dx"] = _cdiv((xe - xs0) * 2 + (ty - y),
                                        2 * (ty - y))
                        e["x"] = xs0
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + e["di"]) % n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            if edge[0]["x"] > edge[1]["x"]:
                left, right = edge[1], edge[0]
            else:
                left, right = edge[0], edge[1]
            x1 = (left["x"] + delta) >> XY_SHIFT
            x2 = (right["x"] + delta) >> XY_SHIFT
            if x2 >= 0 and x1 < w:
                canvas[y, max(x1, 0):min(x2, w - 1) + 1] = value
        for e in edge:
            e["x"] += e["dx"]
        y += 1
        if y > ymax:
            break


# OpenCV's table of sines at whole degrees, 0..450, to 7 decimals
_SIN_TABLE = np.array([round(math.sin(math.radians(d)), 7)
                       for d in range(451)], dtype=np.float32)


def _ellipse_poly(center, axes, angle: int, arc_start: int, arc_end: int,
                  delta: int) -> List[Tuple[float, float]]:
    """OpenCV's ``ellipse2Poly`` (double version)."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    a = angle + (360 if angle < 0 else 0)
    beta = float(_SIN_TABLE[a])
    alpha = float(_SIN_TABLE[450 - a])
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        ang = min(i, arc_end)
        if ang < 0:
            ang += 360
        x = axes[0] * float(_SIN_TABLE[450 - ang])
        y = axes[1] * float(_SIN_TABLE[ang])
        pts.append((center[0] + x * alpha - y * beta,
                    center[1] + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [tuple(center)] * 2
    return pts


def fill_ellipse(canvas: np.ndarray, center: Tuple[int, int],
                 axes: Tuple[int, int], angle: float, value=1) -> np.ndarray:
    """``cv2.ellipse(canvas, center, axes, angle, 0, 360, value, -1)`` with
    integer ``center`` (x, y) and ``axes``, in place."""
    cx, cy = int(center[0]) << XY_SHIFT, int(center[1]) << XY_SHIFT
    ax, ay = abs(int(axes[0])) << XY_SHIFT, abs(int(axes[1])) << XY_SHIFT
    d = (max(ax, ay) + (XY_ONE >> 1)) >> XY_SHIFT
    d = 90 if d < 3 else 30 if d < 10 else 18 if d < 15 else 5
    raw = _ellipse_poly((float(cx), float(cy)), (float(ax), float(ay)),
                        int(np.rint(angle)), 0, 360, d)
    v: List[Tuple[int, int]] = []
    for x, y in raw:
        px = int(np.rint(x / XY_ONE)) << XY_SHIFT
        py = int(np.rint(y / XY_ONE)) << XY_SHIFT
        px += int(np.rint(x - px))
        py += int(np.rint(y - py))
        if not v or v[-1] != (px, py):
            v.append((px, py))
    if len(v) == 1:
        v = [(cx, cy)] * 2
    _fill_convex_fixed(canvas, v, value)
    return canvas


# -- geometry -----------------------------------------------------------------

def convex_hull(pts: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(pts)[:, 0, :]`` for integer points ``[N, 2]``: the
    hull's vertices without collinear points (their order does not change
    a fill)."""
    p = sorted({(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)})
    if len(p) <= 2:
        return np.asarray(p, np.int32).reshape(-1, 2)

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower: list = []
    for q in p:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], q) <= 0:
            lower.pop()
        lower.append(q)
    upper: list = []
    for q in reversed(p):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], q) <= 0:
            upper.pop()
        upper.append(q)
    return np.asarray(lower[:-1] + upper[:-1], np.int32)


def box_points(center, size, angle: float) -> np.ndarray:
    """``cv2.boxPoints(((cx, cy), (w, h), angle))``: the rotated
    rectangle's corners, float32 ``[4, 2]``, in OpenCV's float32
    arithmetic (``RotatedRect::points``)."""
    f = np.float32
    rad = float(f(angle)) * math.pi / 180.0
    b = f(math.cos(rad)) * f(0.5)
    a = f(math.sin(rad)) * f(0.5)
    cx, cy = f(center[0]), f(center[1])
    w, h = f(size[0]), f(size[1])
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    p2 = (f(2) * cx - p0[0], f(2) * cy - p0[1])
    p3 = (f(2) * cx - p1[0], f(2) * cy - p1[1])
    return np.asarray([p0, p1, p2, p3], np.float32)


# -- affine warp --------------------------------------------------------------

def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: float64 [2, 3]."""
    cx, cy = (float(np.float32(v)) for v in center)
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> List[float]:
    """The destination-to-source matrix, as ``warpAffine`` inverts it."""
    m = [float(v) for v in np.asarray(m, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0] = a11
    m[1] *= -d
    m[3] *= -d
    m[4] = a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def warp_affine(img: np.ndarray, m: np.ndarray, size: Tuple[int, int],
                nearest: bool = False) -> np.ndarray:
    """``cv2.warpAffine(img, m, size, flags=INTER_NEAREST if nearest else
    INTER_LINEAR, borderMode=BORDER_CONSTANT, borderValue=0)``; ``size`` is
    (width, height). Linear takes uint8 images ``[H, W]`` or ``[H, W, C]``,
    nearest int32 or uint8 masks (packed layers); a trailing axis of one
    is dropped, as OpenCV drops it."""
    w, h = int(size[0]), int(size[1])
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    inv = _invert_affine(m)
    if nearest:
        if img.dtype not in (np.int32, np.uint8):
            raise TypeError(f"warp_affine(nearest=True) takes int32 or "
                            f"uint8 masks, got {img.dtype}")
        return _warp_nearest(img, inv, w, h)
    if img.dtype != np.uint8:
        raise TypeError(f"warp_affine takes uint8 images, got {img.dtype}")
    return _warp_linear(img, inv, w, h)


def _warp_nearest(img: np.ndarray, inv: List[float], w: int,
                  h: int) -> np.ndarray:
    bits = 10
    xs = np.arange(w, dtype=np.float64)
    ys = np.arange(h, dtype=np.float64)
    adelta = np.rint(inv[0] * xs * (1 << bits)).astype(np.int64)
    bdelta = np.rint(inv[3] * xs * (1 << bits)).astype(np.int64)
    x0 = np.rint((inv[1] * ys + inv[2]) * (1 << bits)).astype(np.int64)
    y0 = np.rint((inv[4] * ys + inv[5]) * (1 << bits)).astype(np.int64)
    half = 1 << (bits - 1)
    sx = np.clip((x0[:, None] + half + adelta[None]) >> bits, -32768, 32767)
    sy = np.clip((y0[:, None] + half + bdelta[None]) >> bits, -32768, 32767)
    src_h, src_w = img.shape[:2]
    inside = (sx >= 0) & (sx < src_w) & (sy >= 0) & (sy < src_h)
    out = np.zeros((h, w) + img.shape[2:], img.dtype)
    out[inside] = img[sy[inside], sx[inside]]
    return out


def _warp_linear(img: np.ndarray, inv: List[float], w: int,
                 h: int) -> np.ndarray:
    """The float32 bilinear warp, in ``csrc/host/jpeg.cpp`` (numpy has no
    float32 fused multiply-add)."""
    import ctypes

    from isegprobe_torch.utils import host_lib

    src = np.ascontiguousarray(img)
    channels = src.shape[2] if src.ndim == 3 else 1
    out = np.empty((h, w) + src.shape[2:], np.uint8)
    m = np.asarray(inv, np.float32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    host_lib.check(host_lib.load().iseg_warp_affine_linear(
        src.ctypes.data_as(u8p), src.shape[0], src.shape[1], channels,
        out.ctypes.data_as(u8p), h, w,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_float))), "warp_affine")
    return out
