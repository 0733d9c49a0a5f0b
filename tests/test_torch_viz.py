"""The port's host drawing (``utils/viz.py``) and JPEG encoder
(``data/image_io.encode_jpeg``, ``csrc/host/jpeg.cpp``) against OpenCV and
the JAX package's ``utils/viz.py``, bitwise, on seeded inputs: masks with
holes and islands, clicks on and past the image's edge, radii 2-8, odd
image sizes, JPEG qualities 85 (the trainer's dumps) and 95 (OpenCV's
default, the evaluation's dumps)."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from scipy import ndimage  # noqa: E402

SEEDS = range(6)


def _mask(seed: int, hw=None) -> np.ndarray:
    """A blob mask with holes and islands: smoothed noise thresholded."""
    rng = np.random.default_rng(seed)
    h, w = hw or tuple(int(v) for v in rng.integers(20, 90, 2))
    field = ndimage.gaussian_filter(rng.random((h, w)), rng.uniform(1.5, 4))
    return (field > np.quantile(field, rng.uniform(0.3, 0.7))).astype(
        np.uint8)


def _image(seed: int, hw) -> np.ndarray:
    return np.random.default_rng(seed + 100).integers(
        0, 256, (*hw, 3), dtype=np.uint8)


# -- the pieces against OpenCV -------------------------------------------------

def test_colormap_hot_is_opencvs():
    from isegprobe_torch.utils.viz import COLORMAP_HOT

    ramp = np.arange(256, dtype=np.uint8)[:, None]
    assert np.array_equal(COLORMAP_HOT,
                          cv2.applyColorMap(ramp, cv2.COLORMAP_HOT)[:, 0])


@pytest.mark.parametrize("radius", range(2, 9))
def test_fill_circle_is_cv2_circle(radius):
    """Centres inside, on and past every edge of odd-sized images."""
    from isegprobe_torch.utils.viz import fill_circle

    rng = np.random.default_rng(radius)
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(5, 31, 2))
        img = _image(radius, (h, w))
        c = (int(rng.integers(-radius - 2, w + radius + 2)),
             int(rng.integers(-radius - 2, h + radius + 2)))
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        want = cv2.circle(img.copy(), c, radius, color, -1)
        got = fill_circle(img.copy(), c, radius, np.asarray(color, np.uint8))
        assert np.array_equal(got, want), (h, w, c)


@pytest.mark.parametrize("alpha", [0.5, 0.6, 0.25, 0.9])
def test_scale_image_is_add_weighted(alpha):
    from isegprobe_torch.utils.viz import scale_image

    img = np.tile(np.arange(256, dtype=np.uint8), (3, 2, 1)).transpose(
        1, 2, 0).copy()
    want = cv2.addWeighted(img, alpha, np.zeros_like(img), 0, 0)
    assert np.array_equal(scale_image(img, alpha), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_find_contours_is_opencvs(seed):
    """Point lists and their order equal ``cv2.findContours(RETR_CCOMP,
    CHAIN_APPROX_SIMPLE)``'s, on a blob mask, on noise (single pixels,
    diagonal joints) and on the mask touching the image's edge."""
    from isegprobe_torch.utils.viz import find_contours

    rng = np.random.default_rng(seed)
    masks = [_mask(seed), (rng.random((23, 37)) < 0.45).astype(np.uint8),
             np.pad(_mask(seed + 50, (30, 30)), ((0, 3), (5, 0)),
                    constant_values=1)]
    for m in masks:
        want, _ = cv2.findContours(m, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_SIMPLE)
        got = find_contours(m)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert find_contours(np.zeros((5, 6), np.uint8)) == []


@pytest.mark.parametrize("seed", SEEDS)
def test_draw_contours_is_opencvs(seed):
    """``cv2.drawContours(..., -1, color, thickness=2)`` bitwise: every
    pixel of the stroke (no pixel allowed to differ)."""
    from isegprobe_torch.utils.viz import draw_contours

    m = _mask(seed)
    contours, _ = cv2.findContours(m, cv2.RETR_CCOMP,
                                   cv2.CHAIN_APPROX_SIMPLE)
    img = _image(seed, m.shape)
    for thickness in (2, 3):
        want = cv2.drawContours(img.copy(), contours, -1, (255, 255, 100),
                                thickness=thickness)
        got = draw_contours(img.copy(), contours, (255, 255, 100), thickness)
        assert np.array_equal(got, want)


# -- the JAX package's drawings ---------------------------------------------------

def test_palette_and_probmap_match_jax():
    from isegprobe_torch.utils import viz
    from isegprobe_tpu.utils import viz as jviz

    assert np.array_equal(viz.get_palette(37), jviz.get_palette(37))
    probs = np.random.default_rng(0).random((19, 27)).astype(np.float32)
    probs[0, :3] = (0.0, 1.0, 0.25)
    assert np.array_equal(viz.draw_probmap(probs), jviz.draw_probmap(probs))


@pytest.mark.parametrize("seed", SEEDS)
def test_draw_points_matches_jax(seed):
    """Indexed points (radius 8, 6, 4, then 2; -1 rows skipped) on the
    trainer's float32 image, and plain coordinates on uint8."""
    from isegprobe_torch.utils.viz import draw_points
    from isegprobe_tpu.utils.viz import draw_points as jdraw_points

    rng = np.random.default_rng(seed)
    h, w = 41, 53
    pts = np.full((12, 3), -1.0, np.float32)
    pts[:8, 0] = rng.integers(-3, h + 3, 8)
    pts[:8, 1] = rng.integers(-3, w + 3, 8)
    pts[:8, 2] = rng.integers(0, 6, 8)
    img = rng.random((h, w, 3)).astype(np.float32) * 255
    for color in ((0, 255, 0), (255, 0, 0)):
        assert np.array_equal(draw_points(img, pts, color),
                              jdraw_points(img, pts, color))
    coords = [tuple(int(v) for v in p[:2]) for p in pts[:8]]
    u8 = _image(seed, (h, w))
    assert np.array_equal(draw_points(u8, coords, (0, 255, 0), radius=6),
                          jdraw_points(u8, coords, (0, 255, 0), radius=6))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("color_mask", [False, True])
def test_draw_with_blend_and_clicks_matches_jax(seed, color_mask):
    """The evaluation's prediction panel: darkened background, contour,
    click discs, clicks at the edge."""
    from isegprobe_torch.inference.clicker import Click
    from isegprobe_torch.utils.viz import draw_with_blend_and_clicks
    from isegprobe_tpu.inference.clicker import Click as JClick
    from isegprobe_tpu.utils.viz import draw_with_blend_and_clicks as jdraw

    mask = _mask(seed).astype(bool)
    img = _image(seed, mask.shape)
    h, w = mask.shape
    spots = [(True, (0, 0)), (False, (h - 1, w // 2)), (True, (h // 2, w - 1)),
             (False, (h // 3, w // 3))]
    clicks = [Click(p, c, i) for i, (p, c) in enumerate(spots)]
    jclicks = [JClick(p, c, i) for i, (p, c) in enumerate(spots)]
    for alpha in (0.5, 0.6):
        got = draw_with_blend_and_clicks(img, mask, alpha, clicks,
                                         use_color_mask=color_mask)
        want = jdraw(img, mask, alpha, jclicks, use_color_mask=color_mask)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(draw_with_blend_and_clicks(img), jdraw(img))


# -- the JPEG encoder -------------------------------------------------------------

JPEG_SIZES = [(1, 1), (7, 9), (17, 23), (33, 47), (64, 48), (97, 131)]


@pytest.mark.parametrize("hw", JPEG_SIZES)
@pytest.mark.parametrize("quality", [85, 95])
def test_encode_jpeg_is_cv2_imencode(hw, quality):
    """The file is ``cv2.imencode``'s, byte for byte, for RGB (4:2:0, the
    dummy blocks of odd MCU counts) and gray images, noise and smooth; so
    cv2 decodes both to the same pixels."""
    from isegprobe_torch.data.image_io import encode_jpeg

    rng = np.random.default_rng(hw[0] * 1000 + hw[1] + quality)
    smooth = (ndimage.gaussian_filter(rng.random((*hw, 3)), 3) * 255).astype(
        np.uint8)
    noise = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    for rgb in (smooth, noise):
        for img, bgr in ((rgb, rgb[:, :, ::-1]), (rgb[:, :, 1], rgb[:, :, 1])):
            got = encode_jpeg(img, quality)
            ok, want = cv2.imencode(".jpg", np.ascontiguousarray(bgr),
                                    [cv2.IMWRITE_JPEG_QUALITY, quality])
            assert ok and got == want.tobytes()
            flag = cv2.IMREAD_UNCHANGED
            assert np.array_equal(
                cv2.imdecode(np.frombuffer(got, np.uint8), flag),
                cv2.imdecode(want, flag))


def test_encode_jpeg_all_qualities_and_the_decoder():
    """Every quality's tables (1-100), and the port's own decoder reads the
    file as cv2 reads it."""
    from isegprobe_torch.data.image_io import decode_bgr, encode_jpeg

    rng = np.random.default_rng(3)
    img = (ndimage.gaussian_filter(rng.random((21, 30, 3)), 2) * 255).astype(
        np.uint8)
    for quality in range(1, 101):
        got = encode_jpeg(img, quality)
        ok, want = cv2.imencode(".jpg", img[:, :, ::-1],
                                [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert got == want.tobytes(), quality
    assert np.array_equal(decode_bgr(got),
                          cv2.imdecode(want, cv2.IMREAD_COLOR))
    with pytest.raises(ValueError, match="1 or 3 channels"):
        encode_jpeg(np.zeros((4, 4, 2), np.uint8))
