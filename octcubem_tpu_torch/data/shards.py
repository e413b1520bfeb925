"""Tar-shard streaming dataset, webdataset-style (the port's copy of
octcubem_tpu/data/shards.py, pure numpy; PIL is imported only to decode
an image member).

Parity target: the COEM fork's OpenCLIP webdataset pipeline
(retinal-COEM/src/training/data.py:795-872: tar shards, grouped-by-key
samples, deterministic shuffle (detshuffle2), shard resampling).  This is
a dependency-free reimplementation of the core: iterate .tar shards,
group members by basename key, decode by extension, shuffle with a
bounded deterministic buffer, and shard the stream across data-parallel
workers.
"""

from __future__ import annotations

import io
import json
import tarfile
from typing import Callable, Iterable, Iterator

import numpy as np


def _default_decode(name: str, data: bytes):
    ext = name.rsplit(".", 1)[-1].lower()
    if ext in ("png", "jpg", "jpeg", "bmp"):
        from PIL import Image

        return np.asarray(Image.open(io.BytesIO(data)), np.float32) / 255.0
    if ext == "npy":
        return np.load(io.BytesIO(data), allow_pickle=False)
    if ext == "json":
        return json.loads(data)
    if ext in ("cls", "txt"):
        return data.decode("utf-8").strip()
    return data


def iterate_shard(path: str, decode: Callable = _default_decode
                  ) -> Iterator[dict]:
    """Yield {ext: decoded} sample dicts grouped by basename key."""
    with tarfile.open(path) as tar:
        current_key = None
        sample: dict = {}
        for member in tar:
            if not member.isfile():
                continue
            # webdataset key convention: split the extension at the first
            # dot of the BASENAME — a dot in a directory component must
            # not truncate the key (e.g. 'v1.2/sample0.png')
            dirpart, _, fname = member.name.rpartition("/")
            stem, _, ext = fname.partition(".")
            base = f"{dirpart}/{stem}" if dirpart else stem
            if base != current_key:
                if sample:
                    yield sample
                current_key = base
                sample = {"__key__": base}
            data = tar.extractfile(member).read()
            sample[ext] = decode(member.name, data)
        if sample:
            yield sample


def det_shuffle(stream: Iterable, bufsize: int, seed: int, epoch: int
                ) -> Iterator:
    """Deterministic bounded-buffer shuffle (detshuffle2 semantics: the
    permutation depends only on (seed, epoch))."""
    rng = np.random.default_rng((seed, epoch))
    buf: list = []
    for item in stream:
        if len(buf) < bufsize:
            buf.append(item)
            continue
        j = int(rng.integers(bufsize))
        yield buf[j]
        buf[j] = item
    rng.shuffle(buf)
    yield from buf


class ShardDataset:
    """Streaming dataset over a list of tar shards.

    epoch-deterministic shard order + sample shuffle; `worker_index` /
    `num_workers` shard the stream for data-parallel hosts (the
    ResampledShards2 / split_by_node roles).
    """

    def __init__(self, shard_paths: list[str], decode: Callable = _default_decode,
                 shuffle_buffer: int = 256, seed: int = 0,
                 worker_index: int = 0, num_workers: int = 1):
        self.shards = list(shard_paths)
        self.decode = decode
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.worker_index = worker_index
        self.num_workers = num_workers
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng((self.seed, self.epoch, 17))
        order = rng.permutation(len(self.shards))
        my_shards = [self.shards[i] for i in order[self.worker_index::self.num_workers]]

        def stream():
            for p in my_shards:
                yield from iterate_shard(p, self.decode)

        if self.shuffle_buffer > 1:
            yield from det_shuffle(stream(), self.shuffle_buffer, self.seed,
                                   self.epoch)
        else:
            yield from stream()
