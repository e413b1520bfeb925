"""Threaded host-side batch loader (counterpart of
octcubem_tpu/data/loader.py; replaces torch DataLoader +
DistributedSampler).

Shuffling is per-epoch deterministic from a seed (the JAX package's
permutation, so both packages serve the same batches in the same order);
in a ``torch.distributed`` group each process loads a disjoint stride of
it, replacing the reference's DistributedSampler
(main_pretrain…py:364-371).  Workers are threads (ingestion is
numpy/PIL which releases the GIL for the heavy parts).  Batches stay
numpy; the caller moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


def _collate(samples):
    first = samples[0]
    if isinstance(first, tuple):
        return tuple(_collate([s[i] for s in samples])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _collate([s[k] for s in samples]) for k in first}
    if isinstance(first, (str, bytes)):
        return list(samples)
    arr = np.stack([np.asarray(s) for s in samples])
    return arr


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 4, seed: int = 0,
                 shard_by_process: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.epoch = 0
        # multi-process: each rank loads a disjoint stride of the (shared
        # seed, hence identical) permutation — the DistributedSampler
        # equivalent (main_pretrain…py:364-371); batch_size is PER RANK.
        self._pidx, self._pcount = 0, 1
        if shard_by_process:
            from ..core.multihost import world

            self._pidx, self._pcount = world()

    def __len__(self):
        n = len(self.dataset) // self._pcount
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        # propagate to the dataset (and through subset views) so per-item
        # augmentation rngs vary across epochs — the reference's torch
        # transforms redraw every epoch; a dataset whose rng is seeded by
        # (seed, idx) alone would repeat the identical crop/flip forever
        ds = self.dataset
        seen = 0
        while ds is not None and seen < 8:
            if hasattr(ds, "epoch"):
                ds.epoch = epoch
            ds = getattr(ds, "dataset", None)
            seen += 1

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        if self._pcount > 1:
            # truncate to the floored per-rank count so EVERY rank holds
            # exactly the same number of indices — otherwise the remainder
            # lands on low-index ranks and (with drop_last=False) the last
            # batch's local shape differs across ranks
            idx = idx[self._pidx::self._pcount][:n // self._pcount]
        return idx

    def __iter__(self) -> Iterator:
        idx = self._indices()
        nb = len(self)
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        out_q: "queue.Queue" = queue.Queue(maxsize=2 * self.num_workers)
        job_q: "queue.Queue" = queue.Queue()
        for i, b in enumerate(batches):
            job_q.put((i, b))

        results: dict[int, object] = {}  # consumed by this thread only
        stop = threading.Event()

        def worker():
            # every exit path posts to out_q (or leaves job_q drained):
            # an exception escaping the loop would strand the consumer in
            # out_q.get() forever
            while not stop.is_set():
                try:
                    i, b = job_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = _collate([self.dataset[int(j)] for j in b])
                except BaseException as e:  # propagate instead of hanging
                    out_q.put((i, RuntimeError(
                        f"loader worker failed on batch {i}: "
                        f"{type(e).__name__}: {e}")))
                    return
                out_q.put((i, batch))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            next_i = 0
            received = 0
            while next_i < nb:
                while next_i not in results and received < nb:
                    i, batch = out_q.get()
                    if isinstance(batch, Exception):
                        raise RuntimeError(
                            f"loader worker failed on batch {i}") from batch
                    results[i] = batch
                    received += 1
                yield results.pop(next_i)
                next_i += 1
        finally:
            stop.set()


def cycle(loader: Loader) -> Iterator:
    """Wrap-around iterator for the secondary 2D loader
    (engine_pretrain.py:93-99)."""
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1
