"""Dataset base class: item assembly and index resolution.

Counterpart of ``isegprobe_tpu/data/base_dataset.py``. Items are NHWC
numpy::

    {'images': [H, W, 3] uint8 (or f32 in [0, 1]),
     'points': [2N, 3] f32 (y, x, label), padded with -1,
     'instances': [H, W, 1] int8 (soft masks: f32)}

An item is built from a seed (``get_item(index, seed)``): the seed starts a
``random.Random`` and a ``np.random.RandomState``, and every draw of the
item (index resolution, the loader's own draws in ``get_sample``,
augmentation, click synthesis) comes from those two, in the order in
which the JAX package draws from the global
``random`` and ``np.random`` after its process workers seed them with the
same number (``isegprobe_tpu/data/loader.py:_process_worker_get``). Seeded
alike, an item is the JAX package's item. Subclasses implement
``get_sample`` and fill ``dataset_samples``.
"""

from __future__ import annotations

import pickle
import random
import threading
from typing import Dict, Optional

import numpy as np

from isegprobe_torch.data.sample import DSample

__all__ = ["iSegBaseDataset"]

# the sampler keeps its click plan in instance state, and one sampler may
# serve several loader threads: its plan-then-draw section is serialized
_SAMPLER_LOCK = threading.Lock()


class _WeightedIndex:
    """Difficulty-weighted index resampling from a score pickle of
    (index, _, score) rows: draw probability ``(1 - score) ** gamma``."""

    def __init__(self, path: str, gamma: float) -> None:
        with open(path, "rb") as f:
            rows = pickle.load(f)
        self.indices = [r[0] for r in rows]
        w = np.array([(1.0 - r[2]) ** gamma for r in rows], dtype=np.float64)
        self.probs = w / w.sum()

    def draw(self, np_rng) -> int:
        return np_rng.choice(self.indices, p=self.probs)


class iSegBaseDataset:
    def __init__(self, augmentator=None, points_sampler=None,
                 min_object_area: float = 0,
                 keep_background_prob: float = 0.0,
                 with_image_info: bool = False,
                 samples_scores_path: Optional[str] = None,
                 samples_scores_gamma: float = 1.0,
                 sample_points: bool = True, epoch_len: int = -1) -> None:
        self.epoch_len = epoch_len
        self.augmentator = augmentator
        self.min_object_area = min_object_area
        self.keep_background_prob = keep_background_prob
        self.points_sampler = points_sampler
        self.with_image_info = with_image_info
        self.sample_points = sample_points
        self.dataset_samples = None
        self._weighted_index = (
            _WeightedIndex(samples_scores_path, samples_scores_gamma)
            if samples_scores_path is not None else None)

    def _resolve_index(self, index: int, rng, np_rng) -> int:
        """Difficulty weighting and virtual epochs (``epoch_len > 0``) both
        replace the loader's index with a random draw."""
        if self._weighted_index is not None:
            return self._weighted_index.draw(np_rng)
        if self.epoch_len > 0:
            return rng.randrange(len(self.dataset_samples))
        return index

    def __len__(self) -> int:
        return self.epoch_len if self.epoch_len > 0 \
            else self.get_samples_number()

    def get_samples_number(self) -> int:
        return len(self.dataset_samples)

    def get_item(self, index: int, seed: int) -> Dict:
        """Item ``index`` built from ``seed`` (see the module's note)."""
        rng = random.Random(int(seed))
        np_rng = np.random.RandomState(int(seed))
        sample = self.draw_sample(self._resolve_index(index, rng, np_rng),
                                  rng, np_rng)
        sample = self.augment_sample(sample, rng)
        sample.remove_small_objects(self.min_object_area)

        with _SAMPLER_LOCK:
            self.points_sampler.sample_object(sample, rng, np_rng)
            n_max = self.points_sampler.max_num_points * 2
            points = (
                np.array(self.points_sampler.sample_points(rng, np_rng),
                         dtype=np.float32)
                if self.sample_points
                else np.full([n_max, 3], -1.0, dtype=np.float32))
            mask = np.moveaxis(self.points_sampler.selected_mask, 0, -1)

        # uint8 images stay uint8: the train step normalizes on the device
        if sample.image.dtype == np.uint8:
            image = np.ascontiguousarray(sample.image)
        else:
            image = np.ascontiguousarray(sample.image, dtype=np.float32)
        mask_i8 = mask.astype(np.int8)
        # binary and ignore masks ride as int8; soft masks stay f32
        instances = (mask_i8 if np.array_equal(mask, mask_i8)
                     else mask.astype(np.float32))
        item = {"images": image, "points": points, "instances": instances}
        if self.with_image_info:
            item["image_info"] = sample.sample_id
        return item

    def augment_sample(self, sample: DSample, rng) -> DSample:
        """Re-roll the augmentation until an object survives (or a
        background-only crop is kept with ``keep_background_prob``)."""
        if self.augmentator is None:
            return sample
        while True:
            sample.augment(self.augmentator, rng)
            if len(sample) > 0:
                return sample
            if self.keep_background_prob < 0.0:
                return sample
            if rng.random() < self.keep_background_prob:
                return sample

    def draw_sample(self, index: int, rng, np_rng) -> DSample:
        """The sample an item starts from; a dataset whose choice is random
        (a mixture) draws it from ``np_rng``."""
        return self.get_sample(index, rng)

    def get_sample(self, index: int, rng=None) -> DSample:
        """Sample ``index``. A loader that draws while reading (a stuff
        layer kept or not, a mask picked) draws from ``rng``, a
        ``random.Random``, where the JAX package draws from the global
        ``random``; without one it draws from the global ``random`` too."""
        raise NotImplementedError
