"""Drawing of the evaluation and training dumps, on the host, without OpenCV.

Counterpart of ``isegprobe_tpu/utils/viz.py`` (``get_palette``,
``draw_probmap``, ``draw_points``, ``draw_with_blend_and_clicks``,
``plot_feats``). The JAX functions call OpenCV; these compute the same
arrays in numpy, as OpenCV 5 computes them:

* :data:`COLORMAP_HOT`: ``cv2.applyColorMap(..., COLORMAP_HOT)``'s
  lookup table (BGR rows, as OpenCV returns them), stored.
* :func:`fill_circle`: ``cv2.circle(..., thickness=-1)`` at ``LINE_8``
  (OpenCV's midpoint ``Circle`` with filled spans, clipped to the image).
* :func:`scale_image`: ``cv2.addWeighted(img, alpha, zeros, 0, 0)`` on
  uint8 (float32 product, rounded half to even).
* :func:`find_contours`: ``cv2.findContours(mask, RETR_CCOMP,
  CHAIN_APPROX_SIMPLE)[0]``: Suzuki-Abe border following on the
  zero-bordered mask, a vertex where the chain code changes, the
  contours in OpenCV's order (outer borders last found first, each
  followed by its holes, last found first).
* :func:`draw_contours`: ``cv2.drawContours(img, contours, -1, color,
  thickness)`` for ``thickness >= 2``: each edge a quad of half-width
  ``thickness / 2`` in 16.16 fixed point filled as ``FillConvexPoly``
  fills it (``data/raster.py``), and a filled disc at its end.

``tests/test_torch_viz.py`` holds each against OpenCV and the JAX
functions.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np

from isegprobe_torch.data.raster import XY_ONE, XY_SHIFT, _fill_convex_fixed

__all__ = ["COLORMAP_HOT", "get_palette", "draw_probmap", "fill_circle",
           "scale_image", "find_contours", "draw_contours", "draw_points",
           "draw_with_blend_and_clicks", "plot_feats"]

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_HOT): row
# i is the BGR colour of i
COLORMAP_HOT = np.frombuffer(bytes.fromhex(
    "00000000000200000500000800000a00000c00000f00001200001400001600001900001b"
    "00001e00002000002300002600002800002a00002d000030000032000034000037000039"
    "00003c00003e00004100004400004600004800004b00004e000050000052000055000058"
    "00005a00005c00005f00006200006400006600006900006c00006e000070000073000075"
    "00007800007a00007d00008000008200008400008700008a00008c00008e000091000094"
    "00009600009800009b00009e0000a00000a20000a50000a80000aa0000ac0000af0000b2"
    "0000b40000b60000b90000bc0000be0000c00000c30000c60000c80000ca0000cd0000d0"
    "0000d20000d40000d70000da0000dc0000df0000e10000e40000e60000e80000eb0000ee"
    "0000f00000f30000f50000f80000fa0000fc0002fd0004fe0006fe0008ff000aff000dff"
    "000fff0012ff0014ff0016ff0019ff001cff001eff0020ff0023ff0026ff0028ff002aff"
    "002dff0030ff0032ff0034ff0037ff003aff003cff003eff0041ff0044ff0046ff0048ff"
    "004bff004eff0050ff0052ff0055ff0058ff005aff005cff005fff0062ff0064ff0066ff"
    "0069ff006cff006eff0070ff0073ff0076ff0078ff007aff007dff0080ff0082ff0084ff"
    "0087ff008aff008cff008eff0091ff0094ff0096ff0098ff009bff009eff00a0ff00a2ff"
    "00a5ff00a8ff00aaff00acff00afff00b2ff00b4ff00b6ff00b9ff00bcff00beff00c0ff"
    "00c3ff00c6ff00c8ff00caff00cdff00d0ff00d2ff00d4ff00d7ff00daff00dcff00deff"
    "00e1ff00e4ff00e6ff00e8ff00ebff00eeff00f0ff00f2ff00f5ff00f8ff00faff02fcff"
    "05fdff08feff0bffff0fffff14ffff19ffff1effff23ffff28ffff2dffff32ffff37ffff"
    "3cffff41ffff46ffff4bffff50ffff55ffff5affff5fffff64ffff69ffff6effff73ffff"
    "78ffff7dffff82ffff87ffff8cffff91ffff96ffff9bffffa0ffffa5ffffaaffffafffff"
    "b4ffffb9ffffbeffffc3ffffc8ffffcdffffd2ffffd7ffffdcffffe1ffffe6ffffebffff"
    "f0fffff5fffffaffffffffff"), np.uint8).reshape(256, 3)
COLORMAP_HOT.flags.writeable = False

# OpenCV's chain codes: direction s steps (dx, dy)
_CODE_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_CODE_DY = (0, -1, -1, -1, 0, 1, 1, 1)


def get_palette(num_cls: int) -> np.ndarray:
    """The VOC bit-interleaved palette: channel c of label j collects j's
    bits (3i + c) into descending output bit positions."""
    ids = np.arange(num_cls, dtype=np.int64)
    palette = np.zeros((num_cls, 3), dtype=np.int32)
    for i in range(8):
        for ch in range(3):
            palette[:, ch] |= (((ids >> (3 * i + ch)) & 1) << (7 - i)).astype(
                np.int32)
    return palette


def draw_probmap(x: np.ndarray) -> np.ndarray:
    """``cv2.applyColorMap((x * 255).astype(np.uint8), COLORMAP_HOT)``:
    ``[H, W, 3]`` BGR."""
    return COLORMAP_HOT[(x * 255).astype(np.uint8)]


@lru_cache(maxsize=64)
def _circle_half_widths(radius: int) -> Tuple[int, ...]:
    """Half-width of the filled midpoint circle's span on each row offset
    0..radius: OpenCV's ``Circle`` fills rows ``±dy`` over ``±dx`` and rows
    ``±dx`` over ``±dy`` at each step, spans centred on the centre."""
    half = [-1] * (radius + 1)
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        half[dy] = max(half[dy], dx)
        half[dx] = max(half[dx], dy)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    return tuple(half)


def fill_circle(img: np.ndarray, center: Tuple[int, int], radius: int,
                color) -> np.ndarray:
    """``cv2.circle(img, center, radius, color, -1)`` (``LINE_8``, no
    shift): ``center`` is (x, y); in place, and returned."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    for off, hw in enumerate(_circle_half_widths(int(radius))):
        if hw < 0:
            continue
        x0, x1 = max(cx - hw, 0), min(cx + hw, w - 1)
        if x0 > x1:
            continue
        for y in {cy - off, cy + off}:
            if 0 <= y < h:
                img[y, x0:x1 + 1] = color
    return img


def scale_image(img: np.ndarray, alpha: float) -> np.ndarray:
    """``cv2.addWeighted(img, alpha, np.zeros_like(img), 0, 0)`` on uint8:
    ``round(float32(img) * float32(alpha))``, half to even, saturated."""
    out = np.rint(img.astype(np.float32) * np.float32(alpha))
    return np.clip(out, 0, 255).astype(np.uint8)


def _component_labels(img: np.ndarray) -> np.ndarray:
    """8-connected labels of the nonzero pixels."""
    from scipy import ndimage

    return ndimage.label(img, structure=np.ones((3, 3), np.int32))[0]


def find_contours(mask: np.ndarray) -> List[np.ndarray]:
    """``cv2.findContours(mask.astype(np.uint8), cv2.RETR_CCOMP,
    cv2.CHAIN_APPROX_SIMPLE)[0]`` as a list of ``[N, 1, 2]`` int32 (x, y)
    arrays.

    The mask (nonzero is foreground) gets a one-pixel zero border, as
    OpenCV's ``findContours`` gives it. A raster scan meets each border at
    its first pixel: an outer border where a 0 is followed by an unvisited
    1, a hole border where a 1 or a visited pixel not marked as a right
    edge is followed by a 0. Each is followed from there (``icvFetchContour``:
    counter-clockwise search of the 8 neighbours from the last direction,
    visited pixels marked 2, right-edge pixels -2), writing a vertex where
    the chain code changes. A hole's parent is the outer border of its
    8-connected component; the result lists the outer borders last found
    first, each followed by its holes, last found first (OpenCV's tree,
    which inserts a child before its siblings, read in pre-order)."""
    h, w = mask.shape[:2]
    step = w + 2
    img = np.zeros((h + 2, step), np.int8)
    img[1:-1, 1:-1] = np.asarray(mask) != 0
    flat = img.ravel()
    left = np.empty_like(flat)
    left[0] = 0
    left[1:] = flat[:-1]
    starts = np.flatnonzero(flat != left).tolist()
    if not starts:
        return []
    labels = _component_labels(img).ravel()
    a = flat.astype(np.int32).tolist()
    deltas = [1, -step + 1, -step, -step - 1, -1, step - 1, step, step + 1]
    deltas = deltas + deltas
    outers: List[Tuple[int, list]] = []  # (component, points)
    holes: dict = {}
    for i in starts:
        if a[i] == 1 and a[i - 1] == 0:
            is_hole, i0 = False, i
        elif a[i] == 0 and a[i - 1] >= 1:
            is_hole, i0 = True, i - 1
        else:
            continue
        pts = _follow_border(a, i0, is_hole, deltas, step)
        comp = int(labels[i0])
        if is_hole:
            holes.setdefault(comp, []).append(pts)
        else:
            outers.append((comp, pts))
    out = []
    for comp, pts in reversed(outers):
        out.append(pts)
        out.extend(reversed(holes.get(comp, [])))
    return [np.asarray(p, np.int32).reshape(-1, 1, 2) for p in out]


def _follow_border(a: list, i0: int, is_hole: bool, deltas: list,
                   step: int) -> list:
    """OpenCV's ``icvFetchContour`` with ``CHAIN_APPROX_SIMPLE`` from pixel
    ``i0`` of the bordered, flattened image ``a`` (marked in place);
    returns the vertices as (x, y) of the unbordered image."""
    x, y = i0 % step - 1, i0 // step - 1
    s = s_end = 0 if is_hole else 4
    while True:
        s = (s - 1) & 7
        i1 = i0 + deltas[s]
        if a[i1] != 0 or s == s_end:
            break
    if s == s_end and a[i1] == 0:  # a single pixel
        a[i0] = -2
        return [(x, y)]
    pts = []
    i3, prev_s = i0, s ^ 4
    while True:
        s_end = s
        while s < 15:
            s += 1
            i4 = i3 + deltas[s]
            if a[i4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # (unsigned)(s - 1) < s_end: a right edge
            a[i3] = -2
        elif a[i3] == 1:
            a[i3] = 2
        if s != prev_s:
            pts.append((x, y))
            prev_s = s
        x += _CODE_DX[s]
        y += _CODE_DY[s]
        if i4 == i0 and i3 == i1:
            return pts
        i3 = i4
        s = (s + 4) & 7


def _thick_segment(img: np.ndarray, p0: Tuple[int, int],
                   p1: Tuple[int, int], color, thickness: int) -> None:
    """OpenCV's ``ThickLine`` at ``LINE_8`` with only the end cap
    (``flags=2``, as ``drawContours`` draws each edge): the quad of
    half-width ``thickness / 2`` in 16.16 fixed point, then the filled disc
    at ``p1``."""
    x0, y0 = p0[0] << XY_SHIFT, p0[1] << XY_SHIFT
    x1, y1 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    t = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (t + odd * XY_ONE * 0.5) / np.sqrt(r)
        ddx = int(np.rint(dy * r))
        ddy = int(np.rint(dx * r))
        _fill_convex_fixed(img, [(x0 + ddx, y0 + ddy), (x0 - ddx, y0 - ddy),
                                 (x1 - ddx, y1 - ddy), (x1 + ddx, y1 + ddy)],
                           color)
    fill_circle(img, ((x1 + (XY_ONE >> 1)) >> XY_SHIFT,
                      (y1 + (XY_ONE >> 1)) >> XY_SHIFT),
                (t + (XY_ONE >> 1)) >> XY_SHIFT, color)


def draw_contours(img: np.ndarray, contours: Sequence[np.ndarray], color,
                  thickness: int = 2) -> np.ndarray:
    """``cv2.drawContours(img, contours, -1, color, thickness)`` for
    ``thickness >= 2`` at ``LINE_8``: every closed contour edge drawn as a
    thick segment ending in a disc; in place, and returned."""
    if thickness < 2:
        raise ValueError("draw_contours draws thickness >= 2 only")
    color = np.asarray(color, dtype=img.dtype)[:img.shape[2]] \
        if img.ndim == 3 else color
    for cnt in contours:
        pts = [(int(x), int(y)) for x, y in np.asarray(cnt).reshape(-1, 2)]
        prev = pts[-1]
        for p in pts:
            _thick_segment(img, prev, p, color, thickness)
            prev = p
    return img


def draw_points(image: np.ndarray, points, color: Tuple[int, int, int],
                radius: int = 3) -> np.ndarray:
    """Filled discs at the points (y, x[, index]) of ``points`` on a copy
    of ``image``; a point with ``y < 0`` is skipped, and a point with an
    index takes radius 8, 6, 4 for indices 0, 1, 2 and 2 after."""
    image = image.copy()
    for p in points:
        if p[0] < 0:
            continue
        if len(p) == 3:
            pradius = {0: 8, 1: 6, 2: 4}[p[2]] if p[2] < 3 else 2
        else:
            pradius = radius
        fill_circle(image, (int(p[1]), int(p[0])), pradius,
                    np.asarray(color, image.dtype))
    return image


def draw_with_blend_and_clicks(img: np.ndarray,
                               mask: Optional[np.ndarray] = None,
                               alpha: float = 0.6, clicks_list=None,
                               pos_color: Tuple[int, int, int] = (0, 255, 0),
                               neg_color: Tuple[int, int, int] = (255, 0, 0),
                               radius: int = 4,
                               use_color_mask: bool = False) -> np.ndarray:
    """The darkened background, the mask's contour in (255, 255, 100) at
    thickness 2 inside the mask, and the click discs."""
    result = img.copy()
    darkened = scale_image(result, alpha)
    if mask is not None:
        draw_contours(result, find_contours(mask.astype(np.uint8)),
                      (255, 255, 100), thickness=2)
        mask_region = (mask > 0).astype(np.uint8)
        result = (darkened * (1 - mask_region[:, :, np.newaxis])
                  + result * mask_region[:, :, np.newaxis])
        if use_color_mask:
            palette = get_palette(int(np.max(mask)) + 1)
            rgb_mask = palette[mask.astype(np.uint8)]
            result = (result * (1 - alpha * mask_region[:, :, None])
                      + rgb_mask * (alpha * mask_region[:, :, None]))
        result = result.astype(np.uint8)
    if clicks_list:
        pos_points = [c.coords for c in clicks_list if c.is_positive]
        neg_points = [c.coords for c in clicks_list if not c.is_positive]
        result = draw_points(result, pos_points, pos_color, radius=radius)
        result = draw_points(result, neg_points, neg_color, radius=radius)
    return result


def plot_feats(images, lr_feats_list, hr_feats_list, save_path=None,
               names=None):
    """A grid of image / LowRes PCA / HighRes PCA panels (features
    ``[H, W, C]`` numpy); saved to ``save_path`` at 150 dpi, else the
    figure is returned."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from isegprobe_torch.utils.pca import fit_joint_pca

    n = len(images)
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i, (img, lr, hr) in enumerate(zip(images, lr_feats_list,
                                          hr_feats_list)):
        lr_rgb, hr_rgb = fit_joint_pca(lr, hr)
        axes[i][0].imshow(img)
        axes[i][0].set_title("image" if not names else names[i])
        axes[i][1].imshow(lr_rgb)
        axes[i][1].set_title("LowRes")
        axes[i][2].imshow(hr_rgb)
        axes[i][2].set_title("HighRes")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=150)
        plt.close(fig)
        return None
    return fig
