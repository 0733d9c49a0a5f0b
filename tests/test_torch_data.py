"""The port's data layer without OpenCV against the JAX package's, which
draws with OpenCV (present here, not on the GPU machine).

What is exact and what is not:
- ``raster.fill_ellipse``, ``fill_poly`` (boxes and convex hulls, inside
  or leaving the image), ``convex_hull``, ``resize_nearest``, ``flip`` and
  the uint8 ``resize_linear``: equal to OpenCV on every case drawn here,
  and the rendered Synthetic scenes (the 320 train and 48 val scenes)
  are equal to the JAX package's, masks and images;
- the float64 ``resize_linear`` (the background noise): within 1e-12 of
  OpenCV (measured 6e-14: double rounding in another order);
- ``box_points``: within 1e-4 pixel of ``cv2.boxPoints`` (a few float32
  ulps: OpenCV's float expression is evaluated in another order), and its
  int32 vertices (what the renderer fills) equal on every case here.
Items: the port's item from a seed equals the JAX package's process-mode
item from that seed (images, points and masks bitwise).
"""

from __future__ import annotations

import random
import zlib

import cv2
import numpy as np
import pytest

from isegprobe_torch.data import raster

HW = [(224, 224), (181, 128), (44, 245)]


def _stamp_params(rng, h, w):
    cy = int(rng.uniform(0.25, 0.75) * h)
    cx = int(rng.uniform(0.25, 0.75) * w)
    r0 = int(rng.uniform(0.14, 0.30) * min(h, w))
    r1 = int(r0 * rng.uniform(0.6, 1.0))
    return cx, cy, r0, r1, rng.uniform(0, 180)


@pytest.mark.parametrize("h,w", HW)
def test_ellipse_fill_equals_opencv(h, w):
    rng = np.random.default_rng(h * w)
    for _ in range(60):
        cx, cy, r0, r1, angle = _stamp_params(rng, h, w)
        want = np.zeros((h, w), np.uint8)
        cv2.ellipse(want, (cx, cy), (r0, r1), angle, 0, 360, 1, -1)
        got = raster.fill_ellipse(np.zeros((h, w), np.uint8), (cx, cy),
                                  (r0, r1), angle, 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", HW)
def test_box_fill_equals_opencv(h, w):
    rng = np.random.default_rng(h + w)
    for _ in range(60):
        cx, cy, r0, r1, angle = _stamp_params(rng, h, w)
        want_pts = cv2.boxPoints(((cx, cy), (2 * r0, 2 * r1), angle))
        pts = raster.box_points((cx, cy), (2 * r0, 2 * r1), angle)
        np.testing.assert_allclose(pts, want_pts, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(pts.astype(np.int32),
                                      want_pts.astype(np.int32))
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [want_pts.astype(np.int32)], 1)
        got = raster.fill_poly(np.zeros((h, w), np.uint8),
                               pts.astype(np.int32), 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w", HW)
def test_convex_hull_fill_equals_opencv(h, w):
    rng = np.random.default_rng(3 * h + w)
    for _ in range(60):
        cx, cy, r0, r1, _ = _stamp_params(rng, h, w)
        n = int(rng.integers(5, 9))
        theta = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(0.6, 1.0, n)
        pts = np.stack([cx + r0 * rad * np.cos(theta),
                        cy + r1 * rad * np.sin(theta)], 1).astype(np.int32)
        want_hull = cv2.convexHull(pts)[:, 0, :]
        hull = raster.convex_hull(pts)
        assert {tuple(p) for p in hull.tolist()} == {
            tuple(p) for p in want_hull.tolist()}
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, [want_hull], 1)
        got = raster.fill_poly(np.zeros((h, w), np.uint8), hull, 1)
        np.testing.assert_array_equal(got, want)


def test_resizes_and_flips_equal_opencv():
    rng = np.random.default_rng(0)
    for _ in range(40):
        sh, sw = (int(v) for v in rng.integers(5, 260, 2))
        h, w = (int(v) for v in rng.integers(5, 300, 2))
        img = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            raster.resize_linear(img, h, w),
            cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR))
        mask = rng.integers(0, 4, (sh, sw, 1)).astype(np.int32)
        np.testing.assert_array_equal(
            raster.resize_nearest(mask, h, w),
            cv2.resize(mask, (w, h), interpolation=cv2.INTER_NEAREST))
        noise = rng.normal(0, 1, (sh, sw, 3))
        np.testing.assert_allclose(
            raster.resize_linear(noise, h, w),
            cv2.resize(noise, (w, h), interpolation=cv2.INTER_LINEAR),
            rtol=0, atol=1e-12)
        for code in (-1, 0, 1):
            np.testing.assert_array_equal(raster.flip(img, code),
                                          cv2.flip(img, code))
            np.testing.assert_array_equal(raster.flip(mask, code),
                                          cv2.flip(mask, code))


@pytest.mark.parametrize("seed,n", [(17, 320), (999, 48)])
def test_rendered_scenes_equal_the_jax_dataset(seed, n):
    from isegprobe_torch.data.datasets import SyntheticShapesDataset as T
    from isegprobe_tpu.data.datasets import SyntheticShapesDataset as J

    jset, tset = J(n_samples=n, seed=seed), T(n_samples=n, seed=seed)
    step = 1 if n <= 48 else 4
    for index in range(0, n, step):
        want, got = jset.get_sample(index), tset.get_sample(index)
        np.testing.assert_array_equal(got.image, want.image)
        np.testing.assert_array_equal(got._encoded_masks,
                                      want._encoded_masks)
        assert got.objects_ids == want.objects_ids


def _scene_sample(seed=0):
    from isegprobe_torch.data.datasets import SyntheticShapesDataset as T
    from isegprobe_tpu.data.datasets import SyntheticShapesDataset as J

    return J(n_samples=8, seed=5).get_sample(seed), T(
        n_samples=8, seed=5).get_sample(seed)


@pytest.mark.parametrize("name,kwargs", [
    ("UniformRandomResize", dict(scale_range=(0.75, 1.25))),
    ("Flip", dict(p=1.0)),
    ("HorizontalFlip", dict(p=1.0)),
    ("RandomRotate90", dict(p=1.0)),
    ("PadIfNeeded", dict(min_height=260, min_width=250)),
    ("RandomCrop", dict(height=150, width=170)),
    ("RandomBrightnessContrast", dict(brightness_limit=(-0.2, 0.2),
                                      contrast_limit=(-0.1, 0.3), p=1.0)),
    ("ShiftScaleRotate", dict(shift_limit=0.03, scale_limit=0,
                              rotate_limit=(-3, 3), p=1.0)),
    ("ShiftScaleRotate", dict(p=1.0)),
    ("ShiftScaleRotate", dict(shift_limit=0.3, scale_limit=0.5,
                              rotate_limit=180, p=0.75)),
    ("RGBShift", dict(r_shift_limit=10, g_shift_limit=10, b_shift_limit=10,
                      p=1.0)),
    ("RGBShift", dict(p=0.75)),
])
def test_transforms_equal_the_jax_transforms(name, kwargs):
    from isegprobe_torch.data import transforms as tt
    from isegprobe_tpu.data import transforms as jt

    jsample, _ = _scene_sample(1)
    image, mask = jsample.image, jsample._encoded_masks
    for seed in range(6):
        random.seed(seed)
        want = jt.Compose([getattr(jt, name)(**kwargs)])(image=image,
                                                         mask=mask)
        got = tt.Compose([getattr(tt, name)(**kwargs)])(
            image=image, mask=mask, rng=random.Random(seed))
        for key in ("image", "mask"):
            assert got[key].shape == want[key].shape
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("kwargs", [
    dict(prob_gamma=0.80, merge_objects_prob=0.15, max_num_merged_objects=2),
    dict(prob_gamma=0.7, merge_objects_prob=0.9, first_click_center=True),
    dict(prob_gamma=0.8, first_click_center=True, sfc_inner_k=-1,
         only_one_first_click=True, merge_objects_prob=0.5),
])
def test_points_sampler_bitwise(kwargs):
    """The same seeds give the same clicks and target as the JAX sampler
    on the global generators."""
    from isegprobe_torch.data.points_sampler import MultiPointSampler as T
    from isegprobe_tpu.data.points_sampler import MultiPointSampler as J

    for scene in range(4):
        jsample, tsample = _scene_sample(scene)
        for seed in range(5):
            random.seed(seed)
            np.random.seed(seed)
            js = J(12, **kwargs)
            js.sample_object(jsample)
            want = js.sample_points()
            ts = T(12, **kwargs)
            rng, np_rng = random.Random(seed), np.random.RandomState(seed)
            ts.sample_object(tsample, rng, np_rng)
            assert ts.sample_points(rng, np_rng) == want
            np.testing.assert_array_equal(ts.selected_mask, js.selected_mask)


def _train_sets():
    from isegprobe_torch.train import synthetic_datasets
    from tests.test_torch_training import jax_cfg, jax_synthetic_datasets

    return jax_synthetic_datasets(jax_cfg()), synthetic_datasets()


@pytest.mark.parametrize("which,salt", [(0, "train"), (1, "val")])
def test_items_equal_jax_process_mode_items(which, salt):
    """Items 0-11 of epoch 1 of the Synthetic train and val sets."""
    from isegprobe_torch.data.loader import item_seed
    from tests.test_torch_training import jax_items

    (jsets, tsets) = _train_sets()
    positions = list(range(12))
    want = jax_items(jsets[which], positions, salt=salt, epoch=1)
    for p, w in zip(positions, want):
        got = tsets[which].get_item(
            p, item_seed(0, zlib.crc32(salt.encode()), 1, p))
        assert sorted(got) == sorted(w)
        for key in w:
            assert got[key].dtype == w[key].dtype
            np.testing.assert_array_equal(got[key], w[key])


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_batches_do_not_depend_on_workers(workers):
    """Batch ``k`` holds items ``8k..8k+7`` of the epoch, each from its own
    seed, whatever the worker count."""
    from isegprobe_torch.data.loader import DataLoader, item_seed
    from isegprobe_torch.train import synthetic_datasets

    trainset, _ = synthetic_datasets(epoch_len=16)
    loader = DataLoader(trainset, 8, num_workers=workers, seed=0,
                        salt="train")
    loader.set_epoch(2)
    batches = list(loader)
    loader.shutdown()
    assert len(batches) == 2 and batches[0]["images"].shape == (8, 224, 224,
                                                                3)
    salt = zlib.crc32(b"train")
    for k, batch in enumerate(batches):
        for i in (0, 7):
            want = trainset.get_item(0, item_seed(0, salt, 2, 8 * k + i))
            for key in want:
                np.testing.assert_array_equal(batch[key][i], want[key])
