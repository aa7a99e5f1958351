"""Batch iteration: epoch-seeded shuffling, host sharding, thread prefetch.

Indices are permuted with an epoch-seeded generator, padded to a multiple
of (num_shards x batch_size), and each host takes a strided slice. A small
thread pool prepares samples (file reads, numpy, and the C++ library,
which releases the interpreter lock) while the device computes.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from .kitti import collate


def epoch_indices(n: int, epoch: int, seed: int, shuffle: bool,
                  num_shards: int = 1, shard_id: int = 0,
                  batch_size: int = 1) -> np.ndarray:
    """Deterministic per-epoch index slice for this host.

    Pads (by wrapping) to a multiple of num_shards*batch_size so every host
    sees the same number of batches.
    """
    rng = np.random.default_rng(seed + epoch)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    total = num_shards * batch_size
    pad = (-len(idx)) % total
    if pad:
        idx = np.concatenate([idx, idx[:pad]])
    return idx[shard_id::num_shards]


def iterate_batches(dataset, batch_size: int, *, epoch: int = 0,
                    shuffle: bool = True, seed: int = 0,
                    num_shards: int = 1, shard_id: int = 0,
                    num_workers: int = 4, prefetch: int = 2,
                    start_batch: int = 0) -> Iterator:
    """Yield (batch_dict, metas) with background sample preparation. An
    exception raised while preparing a sample is raised here, in the
    consumer, and ends the iteration. start_batch: skip the first N
    batches of the epoch's order (a resumed mid-epoch checkpoint)."""
    idx = epoch_indices(len(dataset), epoch, seed, shuffle,
                        num_shards, shard_id, batch_size)
    idx = idx[start_batch * batch_size:]
    n_batches = len(idx) // batch_size
    if num_workers <= 0:
        for b in range(n_batches):
            samples = [dataset[int(i)]
                       for i in idx[b * batch_size:(b + 1) * batch_size]]
            yield collate(samples)
        return

    pool = ThreadPoolExecutor(max_workers=num_workers)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def produce():
        try:
            for b in range(n_batches):
                if stop.is_set():
                    return
                futs = [pool.submit(dataset.__getitem__, int(i))
                        for i in idx[b * batch_size:(b + 1) * batch_size]]
                q.put(collate([f.result() for f in futs]))
        except Exception as e:              # re-raised in the consumer
            q.put(e)
        finally:
            q.put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        pool.shutdown(wait=False)
