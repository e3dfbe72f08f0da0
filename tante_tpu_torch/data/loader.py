"""Host-side batching loader with threaded reads and device prefetch
(counterpart of ``tante_tpu/data/loader.py``).

- a worker thread pool reads dataset windows,
- batches are collated into pinned host tensors and pushed onto a bounded
  queue by a background producer (prefetch depth >= 2 keeps the card busy),
- each batch is copied to the device with ``non_blocking=True``.

Batch order is the JAX loader's: ``np.random.default_rng(seed + epoch)``
shuffles the index range, ``set_epoch`` reshuffles, ``drop_last`` drops the
ragged batch.

``sharding`` (a ``parallel.mesh.BatchSlice``, set by the Trainer under a
mesh): every rank draws the same global batch (same seed, same shuffle) and
reads only its part of it: its block of the batch over 'dp' and, for
H-sharded models, its block of H rows over 'sp'.  A global batch that does
not split over 'dp' raises, as ``jax.device_put`` refuses one.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
import torch

from tante_tpu_torch.ops.backend import resolve_device


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = True,
                 num_workers: int = 4, seed: int = 0, prefetch: int = 2, device=None,
                 epoch: int = 0, sharding=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.prefetch = max(1, prefetch)
        self.device = resolve_device(device)
        self._epoch = epoch
        self.sharding = sharding

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle per epoch (DistributedSampler.set_epoch parity)."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start : start + self.batch_size]
            if len(idx) < self.batch_size and self.drop_last:
                continue
            batches.append(idx)
        return batches

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        batches = self._batch_indices()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        on_card = self.device.type == "cuda"
        pool = ThreadPoolExecutor(max_workers=self.num_workers)

        sharding = self.sharding

        def collate(idx) -> Dict[str, torch.Tensor]:
            if sharding is not None:
                idx = sharding.local_batch(idx)
            items = list(pool.map(self.dataset.__getitem__, (int(i) for i in idx)))
            batch = {}
            for k in items[0]:
                a = np.stack([it[k] for it in items], axis=0)
                if sharding is not None:
                    a = np.ascontiguousarray(sharding.local_field(a))
                t = torch.from_numpy(a)
                # Pinned memory is what lets the copy below overlap the step.
                batch[k] = t.pin_memory() if on_card else t
            return batch

        def to_device(batch):
            return {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}

        def producer():
            # The consumer always gets either every batch and then None, or
            # the exception that stopped the producer.
            try:
                for idx in batches:
                    if stop.is_set():
                        break
                    out_q.put(to_device(collate(idx)))
                out_q.put(None)
            except Exception as e:  # handed to the consumer, which re-raises
                out_q.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    break
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
            # Drain so a producer blocked on a full queue can finish.
            while thread.is_alive():
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
            pool.shutdown(wait=False)
