"""Training-time augmentations without OpenCV.

Counterpart of ``isegprobe_tpu/data/transforms.py``: each transform edits
(image, layered mask) jointly, masks with nearest-neighbour resampling and
constant-zero borders, drawing its random numbers from the item's explicit
``random.Random`` (the JAX package draws the same numbers, in the same
order, from the global ``random``). The OpenCV calls are replaced by
``data/raster.py``: the flips, the nearest-neighbour mask resize, the
uint8 bilinear image resize and the affine warps of ``ShiftScaleRotate``
are exact.
"""

from __future__ import annotations

import random
from typing import Sequence, Tuple

import numpy as np

from isegprobe_torch.data import raster

__all__ = ["Transform", "Compose", "UniformRandomResize", "Flip",
           "HorizontalFlip", "RandomRotate90", "ShiftScaleRotate",
           "PadIfNeeded", "RandomCrop", "RandomBrightnessContrast",
           "RGBShift"]

Pair = Tuple[np.ndarray, np.ndarray]


class Transform:
    def __init__(self, p: float = 1.0) -> None:
        self.p = p

    def __call__(self, image: np.ndarray, mask: np.ndarray,
                 rng: random.Random) -> Pair:
        if rng.random() < self.p:
            return self.apply(image, mask, rng)
        return image, mask

    def apply(self, image, mask, rng) -> Pair:
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: Sequence[Transform], p: float = 1.0) -> None:
        self.transforms = list(transforms)
        self.p = p

    def __call__(self, image=None, mask=None, rng=None, **_) -> dict:
        if rng.random() < self.p:
            for t in self.transforms:
                image, mask = t(image, mask, rng)
        return {"image": image, "mask": mask}


def _resize_pair(image, mask, h, w) -> Pair:
    image = raster.resize_linear(image, h, w)
    mask = raster.resize_nearest(mask, h, w)
    if mask.ndim == 2:
        mask = mask[:, :, None]
    return image, mask


class UniformRandomResize(Transform):
    def __init__(self, scale_range=(0.9, 1.1), p: float = 1.0) -> None:
        super().__init__(p)
        self.scale_range = scale_range

    def apply(self, image, mask, rng) -> Pair:
        scale = rng.uniform(*self.scale_range)
        h = int(round(image.shape[0] * scale))
        w = int(round(image.shape[1] * scale))
        return _resize_pair(image, mask, h, w)


class Flip(Transform):
    """Horizontal, vertical or both, equiprobable."""

    def __init__(self, p: float = 0.5) -> None:
        super().__init__(p)

    def apply(self, image, mask, rng) -> Pair:
        d = rng.choice([-1, 0, 1])
        image = raster.flip(image, d)
        mask = raster.flip(mask, d)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        return image, mask


class HorizontalFlip(Transform):
    def __init__(self, p: float = 0.5) -> None:
        super().__init__(p)

    def apply(self, image, mask, rng) -> Pair:
        return (np.ascontiguousarray(image[:, ::-1]),
                np.ascontiguousarray(mask[:, ::-1]))


class RandomRotate90(Transform):
    def __init__(self, p: float = 0.5) -> None:
        super().__init__(p)

    def apply(self, image, mask, rng) -> Pair:
        k = rng.randint(0, 3)
        return (np.ascontiguousarray(np.rot90(image, k)),
                np.ascontiguousarray(np.rot90(mask, k)))


class ShiftScaleRotate(Transform):
    """Constant-zero border affine jitter: the image warped bilinearly, the
    mask by nearest neighbour, about the image centre."""

    def __init__(self, shift_limit=0.0625, scale_limit=0.1, rotate_limit=45,
                 p: float = 0.5) -> None:
        super().__init__(p)
        self.shift_limit = _pair(shift_limit)
        self.scale_limit = _pair(scale_limit)
        self.rotate_limit = _pair(rotate_limit)

    def apply(self, image, mask, rng) -> Pair:
        h, w = image.shape[:2]
        angle = rng.uniform(*self.rotate_limit)
        scale = 1.0 + rng.uniform(*self.scale_limit)
        dx = rng.uniform(*self.shift_limit) * w
        dy = rng.uniform(*self.shift_limit) * h
        m = raster.rotation_matrix_2d((w / 2, h / 2), angle, scale)
        m[0, 2] += dx
        m[1, 2] += dy
        image = raster.warp_affine(image, m, (w, h))
        mask = raster.warp_affine(mask, m, (w, h), nearest=True)
        if mask.ndim == 2:
            mask = mask[:, :, None]
        return image, mask


class PadIfNeeded(Transform):
    """Centre-pad to a minimum size with zeros."""

    def __init__(self, min_height: int, min_width: int, p: float = 1.0) -> None:
        super().__init__(p)
        self.min_height = min_height
        self.min_width = min_width

    def apply(self, image, mask, rng) -> Pair:
        h, w = image.shape[:2]
        pt = max(0, (self.min_height - h) // 2)
        pb = max(0, self.min_height - h - pt)
        pl = max(0, (self.min_width - w) // 2)
        pr = max(0, self.min_width - w - pl)
        if pt or pb or pl or pr:
            image = np.pad(image, ((pt, pb), (pl, pr), (0, 0)))
            mask = np.pad(mask, ((pt, pb), (pl, pr), (0, 0)))
        return image, mask


class RandomCrop(Transform):
    def __init__(self, height: int, width: int, p: float = 1.0) -> None:
        super().__init__(p)
        self.height = height
        self.width = width

    def apply(self, image, mask, rng) -> Pair:
        h, w = image.shape[:2]
        top = rng.randint(0, max(0, h - self.height))
        left = rng.randint(0, max(0, w - self.width))
        return (image[top:top + self.height, left:left + self.width],
                mask[top:top + self.height, left:left + self.width])


class RandomBrightnessContrast(Transform):
    """img' = clip(img·alpha + beta·255), in float32 for uint8 inputs."""

    def __init__(self, brightness_limit=(-0.2, 0.2),
                 contrast_limit=(-0.2, 0.2), p: float = 0.5) -> None:
        super().__init__(p)
        self.brightness_limit = _pair(brightness_limit)
        self.contrast_limit = _pair(contrast_limit)

    def apply(self, image, mask, rng) -> Pair:
        alpha = 1.0 + rng.uniform(*self.contrast_limit)
        beta = rng.uniform(*self.brightness_limit)
        out = image.astype(np.float32) * alpha + beta * 255.0
        return np.clip(out, 0, 255).astype(image.dtype), mask


class RGBShift(Transform):
    """A per-channel shift, added in float32 and clipped to the dtype."""

    def __init__(self, r_shift_limit=20, g_shift_limit=20, b_shift_limit=20,
                 p: float = 0.5) -> None:
        super().__init__(p)
        self.limits = [_pair(v) for v in
                       (r_shift_limit, g_shift_limit, b_shift_limit)]

    def apply(self, image, mask, rng) -> Pair:
        shift = np.array([rng.uniform(*lim) for lim in self.limits],
                         dtype=np.float32)
        out = image.astype(np.float32) + shift
        return np.clip(out, 0, 255).astype(image.dtype), mask


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (-v, v)
