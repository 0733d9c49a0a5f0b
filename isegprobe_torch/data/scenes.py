"""A NoC evaluation dataset over scenes stored in one ``.npz`` file.

Counterpart of the evaluation side of ``isegprobe_tpu/data/sample.py:DSample``
(``image``, ``objects_ids``, ``gt_mask``): what
``inference/evaluation.py:evaluate_dataset`` and
``inference/device_eval.py:evaluate_dataset_device`` read. The JAX package
renders its ``Synthetic`` scenes with OpenCV, which the GPU machine lacks, so
the scenes are rendered once by the JAX package and stored
(``tests/test_torch_fixtures.py --export`` writes
``isegprobe_torch/fixtures/synthetic2026_50.npz``).

The file holds ``images`` uint8 ``[S, H, W, 3]``, instance label maps
``labels`` ``[S, H, W]`` and ``objects`` int ``[N, 2]``: the (scene, label)
of every evaluated object, in the JAX dataset's order.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np

__all__ = ["SceneDataset", "SYNTHETIC_FIXTURE"]

SYNTHETIC_FIXTURE = (Path(__file__).resolve().parents[1] / "fixtures"
                     / "synthetic2026_50.npz")


class SceneDataset:
    """Scenes and their evaluated objects; ``get_sample(i)`` returns a
    sample with ``.image``, ``.objects_ids`` (0..k-1) and ``.gt_mask(obj)``
    (int32, 1 inside the object).

    ``source`` is the ``.npz`` file or a mapping of the same three arrays.
    By default a sample is a scene with its objects, as in the JAX dataset;
    with ``objects`` (a slice or indices into the stored object list) the
    dataset holds just those objects, one a sample."""

    def __init__(self, source: Union[str, Path, Mapping] = SYNTHETIC_FIXTURE,
                 objects: Optional[Union[slice, Sequence[int]]] = None
                 ) -> None:
        if isinstance(source, Mapping):
            self.images, self.labels, stored = (
                np.asarray(source[k]) for k in ("images", "labels", "objects"))
        else:
            with np.load(source) as data:
                self.images, self.labels, stored = (
                    data[k] for k in ("images", "labels", "objects"))
        if self.images.dtype != np.uint8 or self.images.ndim != 4:
            raise ValueError(f"{source}: images must be uint8 [S, H, W, 3], "
                             f"got {self.images.dtype} {self.images.shape}")
        if objects is None:
            self._scene_of = list(range(len(self.images)))
            self._labels_of: List[List[int]] = [[] for _ in self.images]
            for scene, label in stored:
                self._labels_of[int(scene)].append(int(label))
        else:
            picked = np.asarray(stored)[objects].reshape(-1, 2)
            self._scene_of = [int(scene) for scene, _ in picked]
            self._labels_of = [[int(label)] for _, label in picked]

    def __len__(self) -> int:
        return len(self._scene_of)

    @property
    def n_objects(self) -> int:
        return sum(map(len, self._labels_of))

    def get_sample(self, index: int) -> SimpleNamespace:
        scene = self._scene_of[index]
        labels = self.labels[scene]
        ids = self._labels_of[index]

        def gt_mask(obj: int) -> np.ndarray:
            return (labels == ids[obj]).astype(np.int32)

        return SimpleNamespace(image=self.images[scene],
                               objects_ids=list(range(len(ids))),
                               gt_mask=gt_mask)
