"""The standard evaluation and training datasets, read without OpenCV.

Counterpart of ``isegprobe_tpu/data/datasets/standard.py``, on the same
on-disk layouts and with the same samples: images are read by
``data/image_io.py`` (``cv2.imread``'s pixels), SBD's ``.mat`` instance
files by ``scipy.io.loadmat``.

* :class:`GrabCutDataset` (``data_GT`` + ``boundary_GT``: the mask's blue
  channel, 128 the ignore band, above 128 the object), and
  :class:`BerkeleyDataset` (``images`` + ``masks``, the same encoding);
* :class:`DavisDataset` (``img`` + ``gt``: any coloured pixel is the
  object), which also serves COCO_MVal;
* :class:`SBDDataset` (training: thin, buggy instances scrubbed, their ids
  cached per index) and :class:`SBDEvaluationDataset` (one entry per
  (image, instance), the index cached as
  ``<split>_images_and_ids_list.pkl`` beside the split list, in the JAX
  package's pickle format);
* :class:`PascalVocDataset` (``SegmentationObject`` palette PNGs read as
  gray, 220 the ignore boundary; the ``test`` split from
  ``ImageSets/Segmentation/test.pickle``).
"""

from __future__ import annotations

import pickle as pkl
from pathlib import Path
from typing import List, Tuple

import numpy as np

from isegprobe_torch.data import image_io
from isegprobe_torch.data.base_dataset import iSegBaseDataset
from isegprobe_torch.data.sample import DSample
from isegprobe_torch.utils.misc import get_bbox_from_mask, get_labels_with_sizes

__all__ = ["GrabCutDataset", "BerkeleyDataset", "DavisDataset",
           "SBDDataset", "SBDEvaluationDataset", "PascalVocDataset"]


class _PairedFolderDataset(iSegBaseDataset):
    """``<root>/<images_dir>/x.jpg`` paired with ``<root>/<masks_dir>/x.*``
    by stem."""

    IMAGES_DIR = "img"
    MASKS_DIR = "gt"

    def __init__(self, dataset_path, images_dir_name=None,
                 masks_dir_name=None, **kwargs) -> None:
        super().__init__(**kwargs)
        root = Path(dataset_path)
        self.dataset_path = root
        self._images_path = root / (images_dir_name or self.IMAGES_DIR)
        self._insts_path = root / (masks_dir_name or self.MASKS_DIR)
        self.dataset_samples = sorted(
            p.name for p in self._images_path.glob("*.*"))
        self._masks_by_stem = {p.stem: p for p in self._insts_path.glob("*.*")}

    def get_sample(self, index: int, rng=None) -> DSample:
        name = self.dataset_samples[index]
        image = image_io.read_rgb(self._images_path / name)
        raw = image_io.read_bgr(self._masks_by_stem[name.split(".")[0]])
        mask, object_ids, ignore_ids = self._decode_mask(raw)
        return DSample(image, mask, objects_ids=object_ids,
                       ignore_ids=ignore_ids, sample_id=index)

    @classmethod
    def _decode_mask(cls, raw: np.ndarray):
        raise NotImplementedError


class GrabCutDataset(_PairedFolderDataset):
    """One object an image; gray-128 pixels are the ignore band."""

    IMAGES_DIR = "data_GT"
    MASKS_DIR = "boundary_GT"

    @classmethod
    def _decode_mask(cls, raw):
        mask = raw[:, :, 0].astype(np.int32)
        mask[mask == 128] = -1
        mask[mask > 128] = 1
        return mask, [1], [-1]


class BerkeleyDataset(GrabCutDataset):
    """GrabCut's encoding in ``images`` + ``masks``."""

    IMAGES_DIR = "images"
    MASKS_DIR = "masks"


class DavisDataset(_PairedFolderDataset):
    """DAVIS layout; any coloured pixel is the object (COCO_MVal too)."""

    @classmethod
    def _decode_mask(cls, raw):
        mask = (raw.astype(np.int32).max(axis=2) > 0).astype(np.int32)
        return mask, [1], None


# -- SBD ----------------------------------------------------------------------


def _load_sbd_mask(inst_info_path) -> np.ndarray:
    from scipy.io import loadmat

    return loadmat(str(inst_info_path))["GTinst"][0][0][0].astype(np.int32)


def _thin_object_ids(mask: np.ndarray, fill_thresh: float) -> List[int]:
    """Instance labels whose bounding box is filled below ``fill_thresh``:
    SBD's known buggy sliver annotations."""
    thin = []
    for obj_id in get_labels_with_sizes(mask)[0]:
        obj = mask == obj_id
        r0, r1, c0, c1 = get_bbox_from_mask(obj)
        if obj.sum() < fill_thresh * (r1 - r0 + 1) * (c1 - c0 + 1):
            thin.append(obj_id)
    return thin


class _SBDBase(iSegBaseDataset):
    def __init__(self, dataset_path, split="train", **kwargs) -> None:
        super().__init__(**kwargs)
        assert split in {"train", "val"}
        self.dataset_path = Path(dataset_path)
        self.dataset_split = split
        self._images_path = self.dataset_path / "img"
        self._insts_path = self.dataset_path / "inst"
        self.dataset_samples = (
            (self.dataset_path / f"{split}.txt").read_text().split())

    def _load_pair(self, name: str) -> Tuple[np.ndarray, np.ndarray]:
        return (image_io.read_rgb(self._images_path / f"{name}.jpg"),
                _load_sbd_mask(self._insts_path / f"{name}.mat"))


class SBDDataset(_SBDBase):
    """SBD's training split; thin buggy instances are scrubbed (their ids
    cached per index) before sampling."""

    def __init__(self, dataset_path, split="train", buggy_mask_thresh=0.08,
                 **kwargs) -> None:
        super().__init__(dataset_path, split, **kwargs)
        self._buggy_mask_thresh = buggy_mask_thresh
        self._thin_cache = {}

    def get_sample(self, index: int, rng=None) -> DSample:
        image, mask = self._load_pair(self.dataset_samples[index])
        if self._buggy_mask_thresh > 0:
            if index not in self._thin_cache:
                self._thin_cache[index] = _thin_object_ids(
                    mask, self._buggy_mask_thresh)
            for obj_id in self._thin_cache[index]:
                mask[mask == obj_id] = 0
        return DSample(image, mask,
                       objects_ids=get_labels_with_sizes(mask)[0],
                       sample_id=index)


class SBDEvaluationDataset(_SBDBase):
    """SBD's evaluation protocol: one entry per (image, instance), the
    index flattened once and cached as a pickle beside the split list."""

    def __init__(self, dataset_path, split="val", **kwargs) -> None:
        super().__init__(dataset_path, split, **kwargs)
        self.dataset_samples = self._instance_index()

    def get_sample(self, index: int, rng=None) -> DSample:
        name, instance_id = self.dataset_samples[index]
        image, mask = self._load_pair(name)
        binary = (mask == instance_id).astype(np.int32)
        return DSample(image, binary, objects_ids=[1], sample_id=index)

    def _instance_index(self) -> List[Tuple[str, int]]:
        cache = (self.dataset_path /
                 f"{self.dataset_split}_images_and_ids_list.pkl")
        if cache.exists():
            return pkl.loads(cache.read_bytes())
        index = [
            (name, obj_id)
            for name in self.dataset_samples
            for obj_id in get_labels_with_sizes(
                _load_sbd_mask(self._insts_path / f"{name}.mat"))[0]
        ]
        cache.write_bytes(pkl.dumps(index))
        return index


class PascalVocDataset(iSegBaseDataset):
    """Pascal VOC SegmentationObject; label 220 marks the ignore boundary.
    The ``test`` split enumerates (image, instance) pairs from a pickle."""

    def __init__(self, dataset_path, split="train", **kwargs) -> None:
        super().__init__(**kwargs)
        assert split in {"train", "val", "trainval", "test"}
        root = Path(dataset_path)
        self.dataset_path = root
        self.dataset_split = split
        self._images_path = root / "JPEGImages"
        self._insts_path = root / "SegmentationObject"
        sets = root / "ImageSets/Segmentation"
        if split == "test":
            self.dataset_samples, self.instance_ids = pkl.loads(
                (sets / "test.pickle").read_bytes())
        else:
            self.dataset_samples = (sets / f"{split}.txt").read_text().split()

    def get_sample(self, index: int, rng=None) -> DSample:
        name = self.dataset_samples[index]
        image = image_io.read_rgb(self._images_path / f"{name}.jpg")
        labels = image_io.read_gray(
            self._insts_path / f"{name}.png").astype(np.int32)
        if self.dataset_split == "test":
            wanted = self.instance_ids[index]
            mask = np.where(labels == 220, 220, 0)
            mask[labels == wanted] = 1
            object_ids = [1]
        else:
            mask = labels
            object_ids = [int(v) for v in np.unique(labels)
                          if v not in (0, 220)]
        return DSample(image, mask, objects_ids=object_ids, ignore_ids=[220],
                       sample_id=index)
