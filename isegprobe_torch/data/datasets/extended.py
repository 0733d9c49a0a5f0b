"""The extended training datasets, read without OpenCV.

Counterpart of ``isegprobe_tpu/data/datasets/extended.py``, on the same
on-disk layouts and with the same samples: images are read by
``data/image_io.py`` as ``cv2.imread`` reads them, packed mask layers and
label PNGs as ``IMREAD_UNCHANGED`` reads them (``read_unchanged``,
``decode_unchanged``), LVIS's polygons are filled by ``data/raster.py``
as ``cv2.fillPoly`` fills them, and OpenImages' shrink to the common
extent uses ``raster``'s resizes. Each loader's own draws (a stuff layer
kept or not, LVIS's annotation order, ADE20k's layer, OpenImages' mask)
come from the item's ``random.Random`` (``get_sample(index, rng)``), in
the order in which the JAX package draws them from the global ``random``.

* :class:`CocoLvisDataset`: packed COCO+LVIS layers with an instance
  hierarchy; stuff promoted to objects with ``stuff_prob`` or scrubbed;
* :class:`LvisDataset`: polygons stamped in a shuffled order under the
  ``max_overlap_ratio`` placement rule; ``train_categories.json`` written
  into the root when it is missing, as the JAX package writes it;
* :class:`CocoDataset`: COCO panoptic, the segment id of a pixel being
  its first (blue) channel × 65536 + green × 256 + red, as the JAX package
  computes it from cv2's BGR order; crowds dropped, stuff kept with
  ``stuff_prob``;
* :class:`ADE20kDataset`: one instance layer a draw (its blue channel),
  stuff scrubbed unless kept with ``stuff_prob``;
* :class:`OpenImagesDataset`: one binary mask a draw, image and mask
  shrunk to their common extent.
"""

from __future__ import annotations

import json
import pickle
import random
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np

from isegprobe_torch.data import image_io, raster
from isegprobe_torch.data.base_dataset import iSegBaseDataset
from isegprobe_torch.data.sample import DSample
from isegprobe_torch.utils.misc import get_labels_with_sizes

__all__ = ["CocoLvisDataset", "LvisDataset", "CocoDataset",
           "ADE20kDataset", "OpenImagesDataset"]


class CocoLvisDataset(iSegBaseDataset):
    """Packed COCO+LVIS hierarchy dataset: each sample ships PNG-encoded
    mask layers plus an instance hierarchy; "stuff" occupies the mapping
    slots past ``num_instance_masks`` and is promoted to clickable objects
    (with prob ``stuff_prob``) or scrubbed from its layers."""

    def __init__(self, dataset_path, split="train", stuff_prob=0.0,
                 allow_list_name=None, anno_file="hannotation.pickle",
                 **kwargs) -> None:
        super().__init__(**kwargs)
        root = Path(dataset_path) / split
        self.split = split
        self._split_path = root
        self._images_path = root / "images"
        self._masks_path = root / "masks"
        self.stuff_prob = stuff_prob

        samples: Dict = pickle.loads((root / anno_file).read_bytes())
        if allow_list_name:
            allowed = set(json.loads((root / allow_list_name).read_text()))
            samples = {k: v for k, v in samples.items() if k in allowed}
        self.dataset_samples = sorted(samples.items())

    def get_sample(self, index: int, rng=None) -> DSample:
        rng = rng or random
        image_id, meta = self.dataset_samples[index]
        image = image_io.read_rgb(self._images_path / f"{image_id}.jpg")
        packed, mapping = pickle.loads(
            (self._masks_path / f"{image_id}.pickle").read_bytes())
        layers = np.stack([image_io.decode_unchanged(bytes(buf))
                           for buf in packed], axis=2)

        # instance nodes: the stored hierarchy (None = isolated object) plus
        # this sample's (layer, label) mapping
        nodes = {}
        instance_ids = set(meta["hierarchy"]) | set(
            range(meta["num_instance_masks"]))
        for inst_id in instance_ids:
            info = meta["hierarchy"].get(inst_id) or {}
            nodes[inst_id] = {"mapping": mapping[inst_id],
                              "parent": info.get("parent"),
                              "children": list(info.get("children", []))}

        stuff_ids = range(meta["num_instance_masks"], len(mapping))
        if self.stuff_prob > 0 and rng.random() < self.stuff_prob:
            for sid in stuff_ids:
                nodes[sid] = {"mapping": mapping[sid], "parent": None,
                              "children": []}
        else:
            for sid in stuff_ids:
                layer_idx, label = mapping[sid]
                plane = layers[:, :, layer_idx]
                plane[plane == label] = 0

        return DSample(image, layers, objects=nodes)


class LvisDataset(iSegBaseDataset):
    """LVIS with polygon rasterization: annotations are stamped in shuffled
    order; one is kept only when neither it nor anything already placed
    would be mostly covered (the ``max_overlap_ratio`` placement rule)."""

    def __init__(self, dataset_path, split="train", max_overlap_ratio=0.5,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        root = Path(dataset_path)
        self.split = split
        self.max_overlap_ratio = max_overlap_ratio
        self._train_path = root / "train"
        self._val_path = root / "val"

        payload = json.loads((root / split / f"lvis_{split}.json").read_text())
        self.annotations = defaultdict(list)
        for anno in payload["annotations"]:
            self.annotations[anno["image_id"]].append(anno)

        categories_cache = root / "train_categories.json"
        if not categories_cache.exists():
            train_meta = json.loads(
                (root / "train/lvis_train.json").read_text())
            categories_cache.write_text(
                json.dumps(train_meta["categories"], indent=1))
        self.dataset_samples = [
            img for img in payload["images"] if self.annotations[img["id"]]]

    def _can_place(self, canvas, areas, obj_mask) -> bool:
        """Overlap rule: reject when the candidate is covered beyond the
        threshold OR it would cover any placed instance beyond it."""
        covered = (canvas[obj_mask] > 0).sum() / max(1, obj_mask.sum())
        worst = covered
        hit = np.bincount(canvas[obj_mask].ravel())
        for inst_id, overlap in enumerate(hit):
            if inst_id > 0 and overlap > 0:
                worst = max(worst, overlap / areas[inst_id])
        return worst <= self.max_overlap_ratio

    def get_sample(self, index: int, rng=None) -> DSample:
        rng = rng or random
        info = self.dataset_samples[index]
        annos = self.annotations[info["id"]]
        # in place, as the JAX package shuffles: an image's order carries
        # over to its next draw
        rng.shuffle(annos)
        url = info["coco_url"]
        base = self._train_path if "train2017" in url else self._val_path
        image = image_io.read_rgb(base / "images" / url.split("/")[-1])

        canvas = np.zeros(image.shape[:2], dtype=np.int32)
        areas: Dict[int, int] = defaultdict(int)
        object_ids: List[int] = []
        for rank, anno in enumerate(annos):
            obj_mask = self._rasterize(anno, image.shape[:2]) > 0
            if not self._can_place(canvas, areas, obj_mask):
                continue
            inst_id = rank + 1
            canvas[obj_mask] = inst_id
            areas[inst_id] = obj_mask.sum()
            object_ids.append(inst_id)

        return DSample(image, canvas, objects_ids=object_ids)

    @staticmethod
    def _rasterize(annotation, hw) -> np.ndarray:
        mask = np.zeros(hw, dtype=np.int32)
        for ring in annotation["segmentation"]:
            pts = np.round(np.asarray(ring).reshape(-1, 2)).astype(np.int32)
            raster.fill_poly(mask, pts, 1)
        return mask


class CocoDataset(iSegBaseDataset):
    """COCO panoptic: colour-encoded segment ids; crowds dropped, stuff
    kept with prob ``stuff_prob``."""

    def __init__(self, dataset_path, split="train", stuff_prob=0.0,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        root = Path(dataset_path)
        self.split = split
        self.dataset_path = root
        self.stuff_prob = stuff_prob
        self.images_path = root / split
        self.labels_path = root / "annotations" / f"panoptic_{split}"
        payload = json.loads(
            (root / "annotations" / f"panoptic_{split}.json").read_text())
        self.dataset_samples = payload["annotations"]
        self._thing_categories = {
            cat["id"] for cat in payload["categories"] if cat["isthing"] == 1}

    def get_sample(self, index: int, rng=None) -> DSample:
        rng = rng or random
        entry = self.dataset_samples[index]
        image = image_io.read_rgb(
            self.images_path / entry["file_name"].replace(".png", ".jpg"))
        # cv2's channel order (BGR): the first channel weighs 65536
        bgr = image_io.read_unchanged(
            self.labels_path / entry["file_name"]).astype(np.int32)
        segment_ids = bgr @ np.asarray([256 * 256, 256, 1], dtype=np.int32)

        things = [seg["id"] for seg in entry["segments_info"]
                  if seg["category_id"] in self._thing_categories
                  and seg["iscrowd"] != 1]
        stuff = [seg["id"] for seg in entry["segments_info"]
                 if seg["category_id"] not in self._thing_categories]
        keep_stuff = self.stuff_prob > 0 and rng.random() < self.stuff_prob
        wanted = things + stuff if keep_stuff else things

        labels = np.where(np.isin(segment_ids, wanted), segment_ids, 0)
        return DSample(image, labels, objects_ids=wanted)


class ADE20kDataset(iSegBaseDataset):
    """Layered instance PNGs, one random layer a draw; stuff instances
    scrubbed unless kept by ``stuff_prob``."""

    def __init__(self, dataset_path, split="train", stuff_prob=0.0,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        assert split in {"train", "val"}
        self.dataset_path = Path(dataset_path)
        self.dataset_split = split
        self.stuff_prob = stuff_prob
        anno_path = (self.dataset_path /
                     f"{split}-annotations-object-segmentation.pkl")
        if not anno_path.exists():
            raise RuntimeError(f"Can't find annotations at {anno_path}")
        self.annotations = pickle.loads(anno_path.read_bytes())
        self.dataset_samples = list(self.annotations)

    def get_sample(self, index: int, rng=None) -> DSample:
        rng = rng or random
        image_id = self.dataset_samples[index]
        meta = self.annotations[image_id]
        folder = self.dataset_path / meta["folder"]
        image = image_io.read_rgb(folder / f"{image_id}.jpg")
        layer = rng.choice(meta["layers"])
        # the blue channel carries the instance labels
        labels = image_io.read_unchanged(
            folder / layer["mask_name"])[:, :, 0].astype(np.int32)

        object_ids = get_labels_with_sizes(labels)[0]
        if self.stuff_prob <= 0 or rng.random() > self.stuff_prob:
            for rank, obj_id in enumerate(object_ids):
                if rank in layer["stuff_instances"]:
                    labels[labels == obj_id] = 0
            object_ids = get_labels_with_sizes(labels)[0]

        return DSample(image, labels, objects_ids=object_ids, sample_id=index)


class OpenImagesDataset(iSegBaseDataset):
    """One random binary mask an image; image and mask resolutions can
    disagree, so both shrink to the common extent."""

    def __init__(self, dataset_path, split="train", **kwargs) -> None:
        super().__init__(**kwargs)
        assert split in {"train", "val", "test"}
        root = Path(dataset_path) / split
        self.dataset_split = split
        self.dataset_path = Path(dataset_path)
        self._images_path = root / "images"
        self._masks_path = root / "masks"
        anno_path = root / f"{split}-annotations-object-segmentation_clean.pkl"
        if not anno_path.exists():
            raise RuntimeError(f"Can't find annotations at {anno_path}")
        payload = pickle.loads(anno_path.read_bytes())
        self.image_id_to_masks = payload["image_id_to_masks"]
        self.dataset_samples = payload["dataset_samples"]

    def get_sample(self, index: int, rng=None) -> DSample:
        rng = rng or random
        image_id = self.dataset_samples[index]
        image = image_io.read_rgb(self._images_path / f"{image_id}.jpg")
        mask_name = rng.choice(self.image_id_to_masks[image_id])
        gray = image_io.read_gray(self._masks_path / mask_name)
        binary = (gray > 0).astype(np.int32)

        h = min(image.shape[0], binary.shape[0])
        w = min(image.shape[1], binary.shape[1])
        if image.shape[:2] != (h, w):
            image = raster.resize_linear(image, h, w)
        if binary.shape != (h, w):
            binary = raster.resize_nearest(binary, h, w)

        return DSample(image, binary,
                       objects_ids=[1] if binary.any() else [],
                       sample_id=index)
