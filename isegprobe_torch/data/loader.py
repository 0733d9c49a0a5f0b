"""Host data loader: items built in a worker pool, stacked as numpy.

Counterpart of ``isegprobe_tpu/data/loader.py``. Item ``k`` of epoch ``e``
is built from the seed ``SeedSequence([seed, crc32(salt), e, k])
.generate_state(1)[0]`` (``iSegBaseDataset.get_item``), the seed the JAX
loader's process workers give the global ``random`` and ``np.random``
before they build that item. So the items do not depend on the worker
count or on which worker builds them, and they are the JAX package's
process-mode items. Workers are threads by default (decoding, warping and
the numpy kernels release the GIL; the rest of item assembly holds it) or,
with ``use_processes=True`` (``dataloader.mp``), a ``spawn`` process pool
whose initializer snapshots the dataset once, as the JAX loader's process
workers do (spawn, not fork: the parent holds a CUDA context; as with any
spawned pool, the main script must guard its entry with ``if __name__ ==
"__main__"``). Either way the items are the same. ``num_workers=0`` builds in the caller's thread.
Batches are stacked numpy arrays (uint8 images, int8 masks) that the
trainer uploads. With ``rank``/``world`` (a data-parallel run's data index
and size) each rank loads its own shard of the epoch's order, the JAX
loader's rank striding: every rank shuffles with the same ``(seed,
epoch)`` key and takes positions ``rank, rank + world, ...``, and an epoch
has ``len(dataset) // world // batch_size`` batches on every rank.
"""

from __future__ import annotations

import random
import zlib
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

__all__ = ["DataLoader", "item_seed"]


def item_seed(seed: int, salt: int, epoch: int, position: int) -> int:
    """The seed of item ``position`` of ``epoch`` (the JAX loader's
    ``_process_worker_get``)."""
    return int(np.random.SeedSequence(
        [seed, salt, epoch, position]).generate_state(1)[0])


# the dataset and seeds of a process worker, set by its initializer
_WORKER: Dict = {}


def _process_worker_init(dataset, seed: int, salt: int) -> None:
    _WORKER.update(dataset=dataset, seed=int(seed), salt=int(salt))


def _process_worker_get(epoch: int, position: int, index: int) -> Dict:
    return _WORKER["dataset"].get_item(
        index, item_seed(_WORKER["seed"], _WORKER["salt"], epoch, position))


def _stack(items: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for key in items[0]:
        arrays = [np.asarray(it[key]) for it in items]
        if any(a.dtype != arrays[0].dtype for a in arrays):
            # a silent promotion would skip the step's uint8 normalization
            # for part of the batch
            raise TypeError(f"batch key {key!r} mixes dtypes "
                            f"{sorted({str(a.dtype) for a in arrays})}")
        out[key] = np.stack(arrays)
    return out


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0,
                 prefetch: int = 2, salt: str = "",
                 use_processes: bool = False, rank: int = 0,
                 world: int = 1) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.prefetch = prefetch
        self.salt = zlib.crc32(salt.encode())
        self.use_processes = use_processes
        self._epoch = 0
        self._pool = None
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        self.rank = rank
        self.world = world

    def __len__(self) -> int:
        # the tail is dropped
        return len(self.dataset) // self.world // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _indices(self) -> List[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        return idx[self.rank::self.world]

    def item(self, epoch: int, position: int, index: int) -> Dict:
        """Item ``position`` of ``epoch`` (dataset index ``index``)."""
        return self.dataset.get_item(
            index, item_seed(self.seed, self.salt, epoch, position))

    def _submit(self, epoch: int, position: int, index: int):
        if self._pool is None:
            if self.use_processes:
                import multiprocessing as mp

                # the dataset is pickled into each worker once, here: a
                # later change to it in this process is not seen there
                self._pool = ProcessPoolExecutor(
                    self.num_workers, mp_context=mp.get_context("spawn"),
                    initializer=_process_worker_init,
                    initargs=(self.dataset, self.seed, self.salt))
            else:
                self._pool = ThreadPoolExecutor(self.num_workers)
        if self.use_processes:
            return self._pool.submit(_process_worker_get, epoch, position,
                                     index)
        return self._pool.submit(self.item, epoch, position, index)

    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        total = min(len(self) * self.batch_size, len(indices))
        epoch = self._epoch
        if self.num_workers <= 0:
            for start in range(0, total, self.batch_size):
                yield _stack([self.item(epoch, p, indices[p]) for p in
                              range(start, min(start + self.batch_size,
                                               total))])
            self._epoch += 1
            return
        window = self.batch_size * (self.prefetch + 1) + self.num_workers
        futures: deque = deque()
        pos = 0
        while pos < total and len(futures) < window:
            futures.append(self._submit(epoch, pos, indices[pos]))
            pos += 1
        batch: List[Dict] = []
        while futures:
            batch.append(futures.popleft().result())
            if pos < total:
                futures.append(self._submit(epoch, pos, indices[pos]))
                pos += 1
            if len(batch) == self.batch_size:
                yield _stack(batch)
                batch = []
        self._epoch += 1
