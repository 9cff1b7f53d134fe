"""Threaded, prefetching host data loader producing NHWC numpy batches.

The port's copy of count_pipnet_tpu/data/loader.py (framework-free host
code); the batch stacking runs through the port's own C++ assembler
(native/) where it builds, else numpy.

Replaces torch DataLoader (reference util/data.py:141-214). Design:

* per-epoch deterministic shuffling keyed by (seed, epoch) — call
  ``set_epoch`` like torch's DistributedSampler convention;
* per-item RNG derived from (seed, epoch, index): augmentations are
  reproducible regardless of worker count (fixes the reference's broken
  ``worker_init_fn``, util/data.py:147);
* a ThreadPoolExecutor decodes/augments ahead of consumption (PIL releases
  the GIL during decode), with ``prefetch_batches`` in flight so host IO
  overlaps device compute;
* optional WeightedRandomSampler semantics for ``--weighted_loss``
  (util/data.py:126-136): inverse-class-frequency sampling with
  replacement;
* in a data-parallel world (``process_index`` / ``process_count``) every
  rank draws the same epoch permutation and loads only its slice of each
  global batch (``host_local``).
"""

import random
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Queue
from typing import Iterator, Optional, Sequence

import numpy as np

from ..native import stack_batch as _native_stack

__all__ = ["DataLoader", "make_weighted_sample_weights"]


def make_weighted_sample_weights(targets: Sequence[int]) -> np.ndarray:
    """Inverse class-frequency weights (reference util/data.py:126-136)."""
    targets = np.asarray(targets)
    classes, counts = np.unique(targets, return_counts=True)
    class_weight = {c: 1.0 / n for c, n in zip(classes, counts)}
    return np.asarray([class_weight[t] for t in targets], dtype=np.float64)


def _stack(items):
    """Stack a list of per-item tuples into a tuple of batched arrays
    (float32 images through the C++ parallel memcpy of native/)."""
    out = []
    for f in range(len(items[0])):
        field = [it[f] for it in items]
        if not isinstance(field[0], np.ndarray):
            out.append(np.asarray(field))
        elif field[0].dtype == np.float32 and field[0].ndim >= 2:
            out.append(_native_stack(field))
        else:
            out.append(np.stack(field))
    return tuple(out)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8,
                 seed: int = 0, sample_weights: Optional[np.ndarray] = None,
                 prefetch_batches: int = 2, process_index: int = 0,
                 process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.sample_weights = sample_weights
        self.prefetch_batches = prefetch_batches
        self.epoch = 0
        # a data-parallel world: the epoch permutation is keyed only by
        # (seed, epoch), so every rank decodes only its indices[lo:hi]
        # slice of each global batch
        self.process_index = process_index
        self.process_count = process_count
        self.host_local = process_count > 1
        if self.host_local and batch_size % process_count:
            raise ValueError(
                f"batch_size {batch_size} not divisible by "
                f"{process_count} processes")

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        if self.sample_weights is not None:
            p = self.sample_weights / self.sample_weights.sum()
            return rng.choice(n, size=n, replace=True, p=p)
        idx = np.arange(n)
        if self.shuffle:
            rng.shuffle(idx)
        return idx

    def _load_item(self, index: int):
        # deterministic per-(seed, epoch, index) stream
        mix = (self.seed * 1_000_003 + self.epoch) * 1_000_003 + int(index)
        item_rng = random.Random(mix)
        return self.dataset[(int(index), item_rng)]

    def __iter__(self) -> Iterator:
        indices = self._epoch_indices()
        n = len(indices)
        batches = []
        for start in range(0, n, self.batch_size):
            chunk = indices[start:start + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                continue
            if self.host_local:
                if len(chunk) % self.process_count:
                    raise ValueError(
                        f"ragged batch of {len(chunk)} not divisible by "
                        f"{self.process_count} processes (use "
                        f"drop_last=True for host-local loaders)")
                per = len(chunk) // self.process_count
                chunk = chunk[self.process_index * per:
                              (self.process_index + 1) * per]
            batches.append(chunk)

        if not batches:
            return iter(())

        q: Queue = Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()

        def producer():
            # The sentinel (None on success, the exception on failure) MUST
            # reach the queue no matter what, or the consumer deadlocks.
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self._load_item, chunk))
                        q.put(_stack(items))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                q.put(e)
            else:
                q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def gen():
            try:
                while True:
                    batch = q.get()
                    if batch is None:
                        break
                    if isinstance(batch, BaseException):
                        raise batch
                    yield batch
            finally:
                stop.set()
                # Drain so a blocked producer can exit.
                while thread.is_alive():
                    try:
                        q.get_nowait()
                    except Exception:
                        thread.join(timeout=0.1)

        return gen()
