"""DSample: one image plus layered instance masks and an object hierarchy.

Counterpart of ``isegprobe_tpu/data/sample.py``, with the same semantics;
augmentation takes the item's explicit ``random.Random``. Restructured around
an ``ObjNode`` dataclass per object (the reference keeps nested dicts): each
node records which (layer, label) pair in the encoded mask stack it owns, its
place in the parent/child hierarchy, and its current pixel area.  Areas are
refreshed lazily from the mask layers; labels present in a layer but claimed
by no node (an augmentation can occlude an object entirely) are scrubbed to
background during the refresh.

Construction accepts either flat ``objects_ids`` (one mask layer) or a nested
``objects`` dict with parent/children/mapping keys — the loader-facing
protocol shared with the reference datasets — normalizing both into nodes.
"""

from __future__ import annotations

from copy import deepcopy
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from isegprobe_torch.utils.misc import get_labels_with_sizes

Mapping = Tuple[int, int]  # (mask-stack layer index, integer label in layer)


@dataclass
class ObjNode:
    mapping: Mapping
    parent: Optional[int] = None
    children: List[int] = field(default_factory=list)
    area: Optional[int] = None

    @classmethod
    def from_dict(cls, info: Dict) -> "ObjNode":
        return cls(
            mapping=tuple(info["mapping"]),
            parent=info.get("parent"),
            children=list(info.get("children", [])),
            area=info.get("area"),
        )


class DSample:
    def __init__(
        self,
        image: np.ndarray,
        encoded_masks: np.ndarray,
        objects: Optional[Dict] = None,
        objects_ids: Optional[List] = None,
        ignore_ids: Optional[List] = None,
        sample_id: Optional[int] = None,
    ) -> None:
        self.image = image
        self.sample_id = sample_id
        self.points = None

        if encoded_masks.ndim == 2:
            encoded_masks = encoded_masks[:, :, np.newaxis]
        self._encoded_masks = encoded_masks

        self.nodes: Dict[int, ObjNode] = {}
        self._ignored: List[Mapping] = []
        if objects_ids is not None:
            if objects_ids and not isinstance(objects_ids[0], tuple):
                assert encoded_masks.shape[2] == 1
                objects_ids = [(0, label) for label in objects_ids]
            self.nodes = {
                i: ObjNode(mapping=m) for i, m in enumerate(objects_ids)
            }
            for region in ignore_ids or []:
                self._ignored.append(
                    region if isinstance(region, tuple) else (0, region)
                )
        elif objects is not None:
            self.nodes = {k: ObjNode.from_dict(v) for k, v in objects.items()}

        self._augmented = False
        self._pristine = (image, encoded_masks, deepcopy(self.nodes))
        self.remove_small_objects(min_area=1)

    # -- augmentation ---------------------------------------------------------

    def augment(self, augmentator, rng) -> None:
        """Apply a joint image+mask pipeline drawing from ``rng`` (a
        ``random.Random``).  Always restarts from the pristine data first,
        so repeated augmentation never compounds."""
        self.reset_augmentation()
        out = augmentator(image=self.image, mask=self._encoded_masks, rng=rng)
        self.image = out["image"]
        self._encoded_masks = out["mask"]
        self._refresh_areas()
        self.remove_small_objects(min_area=1)
        self._augmented = True

    def reset_augmentation(self) -> None:
        if self._augmented:
            self.image, self._encoded_masks, nodes = self._pristine
            self.nodes = deepcopy(nodes)
            self._augmented = False

    # -- mask views -------------------------------------------------------------

    def get_object_mask(self, obj_id: int) -> np.ndarray:
        layer, label = self.nodes[obj_id].mapping
        mask = (self._encoded_masks[:, :, layer] == label).astype(np.int32)
        for ig_layer, ig_label in self._ignored:
            mask[self._encoded_masks[:, :, ig_layer] == ig_label] = -1
        return mask

    def get_soft_object_mask(self, obj_id: int) -> np.ndarray:
        # soft masks only exist under augmentation replay; hard otherwise
        return self.get_object_mask(obj_id).astype(np.float32)

    def get_background_mask(self) -> np.ndarray:
        return self._encoded_masks.max(axis=2) == 0

    def gt_mask(self, obj_id: int) -> np.ndarray:
        return self.get_object_mask(obj_id)

    @property
    def gt_masks(self) -> List[np.ndarray]:
        return [self.get_object_mask(i) for i in self.nodes]

    # -- hierarchy ----------------------------------------------------------------

    @property
    def objects_ids(self) -> List[int]:
        return list(self.nodes)

    @property
    def root_objects(self) -> List[int]:
        return [i for i, node in self.nodes.items() if node.parent is None]

    def __len__(self) -> int:
        return len(self.nodes)

    def remove_small_objects(self, min_area: float) -> None:
        if any(node.area is None for node in self.nodes.values()):
            self._refresh_areas()
        for obj_id in [i for i, n in self.nodes.items() if n.area < min_area]:
            self._unlink(obj_id)

    def _unlink(self, obj_id: int) -> None:
        """Drop a node, splicing its children onto its parent."""
        node = self.nodes.pop(obj_id)
        for child in node.children:
            self.nodes[child].parent = node.parent
        if node.parent is not None:
            siblings = self.nodes[node.parent].children
            self.nodes[node.parent].children = [
                c for c in siblings if c != obj_id
            ] + node.children

    def _refresh_areas(self) -> None:
        """Recount every node's pixels from the mask layers.

        A label owned by no node and not ignored is an orphan (e.g. an object
        fully occluded after augmentation re-layering) and is scrubbed from
        its layer; a node whose label vanished gets area 0.
        """
        by_mapping = {node.mapping: node for node in self.nodes.values()}
        ignored = set(self._ignored)
        seen = set()
        for layer_idx in range(self._encoded_masks.shape[2]):
            layer = self._encoded_masks[:, :, layer_idx]
            labels, areas = get_labels_with_sizes(layer)
            for label, area in zip(labels, areas):
                key = (layer_idx, label)
                if key in ignored:
                    continue
                node = by_mapping.get(key)
                if node is None:
                    layer[layer == label] = 0
                else:
                    node.area = area
                    seen.add(key)
        for key, node in by_mapping.items():
            if key not in seen:
                node.area = 0
