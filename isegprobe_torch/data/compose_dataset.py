"""Combined datasets: a concatenation, and a ratio-weighted mixture.

Counterpart of ``isegprobe_tpu/data/compose_dataset.py``. The mixture's
draws come from the item's ``np.random.RandomState`` (``get_item``), in the
order in which the JAX package draws them from the global ``np.random``
(``draw_sample``), and a member's own draws from the item's
``random.Random``, so
a mixture's items are the JAX package's process-mode items seed for seed.
"""

from __future__ import annotations

from math import isclose
from typing import List, Tuple

from isegprobe_torch.data.base_dataset import iSegBaseDataset
from isegprobe_torch.data.sample import DSample

__all__ = ["ComposeDataset", "ProportionalComposeDataset"]


def _flat_index(datasets) -> List[Tuple[int, int]]:
    """(member, local index) pairs covering every sample of every member."""
    return [(member, local) for member, ds in enumerate(datasets)
            for local in range(len(ds))]


class ComposeDataset(iSegBaseDataset):
    """Concatenation: index i is one member's sample."""

    def __init__(self, datasets: List[iSegBaseDataset], **kwargs) -> None:
        super().__init__(**kwargs)
        self._datasets = list(datasets)
        self.dataset_samples = _flat_index(self._datasets)

    def get_sample(self, index: int, rng=None) -> DSample:
        member, local = self.dataset_samples[index]
        return self._datasets[member].get_sample(local, rng)


class ProportionalComposeDataset(ComposeDataset):
    """Mixture: every draw ignores the index, picks a member by ratio, then
    a uniform sample within it."""

    def __init__(self, datasets: List[iSegBaseDataset], ratios: List[float],
                 **kwargs) -> None:
        if len(ratios) != len(datasets):
            raise ValueError("one mixing ratio per dataset required")
        if not isclose(sum(ratios), 1.0):
            raise ValueError(f"ratios must sum to 1, got {sum(ratios)}")
        super().__init__(datasets, **kwargs)
        self._ratios = list(ratios)

    def draw_sample(self, index: int, rng, np_rng) -> DSample:
        del index  # the draw does not depend on the requested index
        member = np_rng.choice(len(self._datasets), p=self._ratios)
        local = np_rng.choice(len(self._datasets[member]))
        return self._datasets[member].get_sample(local, rng)
