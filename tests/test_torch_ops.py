"""The port's numeric ops and host protocol helpers against the JAX package's
functions on the same numpy inputs: resize, click encoding, ZoomIn
crop-resize and inverse paste, host EDT, bbox helpers and the clicker.

Tolerances: the resize and sampling ops are the same f32 arithmetic in
another summation order (matmul against the interpolation matrix vs. a
gather and a lerp), so 1e-5; click disks, EDT values, bboxes and click
decisions are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

TOL = 1e-5


@pytest.mark.parametrize("mode,align,size,scales", [
    ("bilinear", True, (56, 40), None),
    ("bilinear", False, (9, 23), None),
    ("bicubic", False, (16, 16), ((16 + 0.1) / 37, (16 + 0.1) / 37)),
    ("bicubic", False, (37, 37), None),
    ("nearest", False, (98, 50), None),
])
def test_resize_matches_jax(mode, align, size, scales):
    from isegprobe_tpu.ops.resize import resize as j_resize
    from isegprobe_torch.ops.resize import resize

    x = np.random.default_rng(0).standard_normal((2, 37, 37, 5)).astype(
        np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), size, mode, align, scales))
    got = resize(torch.from_numpy(x), size, mode, align, scales).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _points(b, n, h, w, seed):
    """Random clicks with -1 padding rows: [B, 2N, 3]."""
    rng = np.random.default_rng(seed)
    pts = np.full((b, 2 * n, 3), -1.0, np.float32)
    for bi in range(b):
        for slot in rng.choice(2 * n, size=n, replace=False):
            pts[bi, slot] = (rng.uniform(0, h), rng.uniform(0, w), slot)
    return pts


@pytest.mark.parametrize("use_disks", [True, False])
def test_encode_clicks_matches_jax(use_disks):
    from isegprobe_tpu.ops.dist_maps import encode_clicks as j_encode
    from isegprobe_torch.ops.dist_maps import encode_clicks

    pts = _points(2, 4, 40, 50, seed=1)
    want = np.asarray(j_encode(jnp.asarray(pts), 40, 50, norm_radius=5.0,
                               use_disks=use_disks))
    got = encode_clicks(torch.from_numpy(pts), 40, 50, norm_radius=5.0,
                        use_disks=use_disks).numpy()
    assert got.shape == (2, 40, 50, 2)
    if use_disks:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


ROIS = [(0, 89, 0, 99), (13, 70, 21, 64), (40, 40, 5, 90), (3, 88, 50, 50)]


@pytest.mark.parametrize("roi", ROIS)
def test_crop_resize_matches_jax(roi):
    from isegprobe_tpu.ops.sample import crop_resize as j_crop
    from isegprobe_torch.ops.sample import crop_resize

    img = np.random.default_rng(2).random((1, 128, 128, 4)).astype(np.float32)
    want = np.asarray(j_crop(jnp.asarray(img),
                             jnp.asarray(np.asarray(roi, np.int32)), (56, 56)))
    got = crop_resize(torch.from_numpy(img), roi, (56, 56)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("roi", ROIS)
def test_inverse_paste_matches_jax(roi):
    from isegprobe_tpu.ops.sample import inverse_paste as j_paste
    from isegprobe_torch.ops.sample import inverse_paste

    probs = np.random.default_rng(3).random((1, 56, 56, 1)).astype(np.float32)
    frame = np.zeros((1, 128, 128, 1), np.float32)
    want = np.asarray(j_paste(jnp.asarray(probs),
                              jnp.asarray(np.asarray(roi, np.int32)),
                              jnp.asarray(frame)))
    got = inverse_paste(torch.from_numpy(probs), roi, (128, 128)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _blob_masks(seed, n=4, shape=(60, 70)):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        m = np.zeros(shape, np.uint8)
        for _ in range(3):
            y, x = rng.integers(0, shape[0]), rng.integers(0, shape[1])
            hh, ww = rng.integers(5, 30, size=2)
            m[y:y + hh, x:x + ww] = 1
        yield np.pad(m, 1)


def test_edt_matches_jax():
    from isegprobe_tpu.ops.edt import edt_l2sq as j_edt
    from isegprobe_tpu.ops.edt import edt_l2sq_device as j_edt_device
    from isegprobe_torch.ops.edt import edt_l2sq

    for m in _blob_masks(4):
        np.testing.assert_array_equal(edt_l2sq(m), j_edt(m))
    # no zero pixel: "infinitely far", the JAX device path's clamp
    ones = np.ones((4, 4), np.uint8)
    np.testing.assert_array_equal(edt_l2sq(ones),
                                  np.asarray(j_edt_device(jnp.asarray(ones))))


def test_bbox_helpers_match_jax():
    from isegprobe_tpu.utils import misc as j_misc
    from isegprobe_torch.utils import misc

    for m in _blob_masks(5):
        bbox = misc.get_bbox_from_mask(m)
        assert bbox == j_misc.get_bbox_from_mask(m)
        for ratio, min_size in ((1.4, 200), (1.4, 20), (2.0, None)):
            got = misc.expand_bbox(bbox, ratio, min_size)
            assert got == j_misc.expand_bbox(bbox, ratio, min_size)
            assert (misc.clamp_bbox(got, 0, 59, 0, 69)
                    == j_misc.clamp_bbox(got, 0, 59, 0, 69))
            assert misc.get_bbox_iou(bbox, got) == j_misc.get_bbox_iou(bbox,
                                                                       got)


def test_clicker_matches_jax():
    """Same ground truth, same sequence of predicted masks: identical click
    positions and signs, including already-clicked pixels and ties."""
    from isegprobe_tpu.inference.clicker import Clicker as JClicker
    from isegprobe_torch.inference.clicker import Clicker

    rng = np.random.default_rng(6)
    gt = np.zeros((60, 70), np.int32)
    gt[10:40, 15:55] = 1
    gt[45:50, 5:10] = -1  # ignore region
    ours, theirs = Clicker(gt_mask=gt), JClicker(gt_mask=gt)
    pred = np.zeros_like(gt, dtype=bool)
    for _ in range(8):
        ours.make_next_click(pred)
        theirs.make_next_click(pred)
        a, b = ours.clicks_list[-1], theirs.clicks_list[-1]
        assert (a.is_positive, a.coords, a.indx) == (b.is_positive, b.coords,
                                                     b.indx)
        pred = rng.random(gt.shape) < 0.3


def test_noc_metrics_match_jax():
    from isegprobe_tpu.inference import metrics as j_metrics
    from isegprobe_torch.inference import metrics

    rng = np.random.default_rng(7)
    all_ious = [np.sort(rng.random(int(n))).astype(np.float32)
                for n in rng.integers(1, 21, size=12)]
    thrs = [0.8, 0.85, 0.9]
    assert (metrics.compute_noc_metric(all_ious, thrs, 20)
            == j_metrics.compute_noc_metric(all_ious, thrs, 20))
    np.testing.assert_array_equal(metrics.miou_at_k(all_ious, 20),
                                  j_metrics.miou_at_k(all_ious, 20))
