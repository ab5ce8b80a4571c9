"""Threaded, prefetching data loader (port of xtagclip_tpu/data/loader.py).

The host pipeline keeps N worker threads decoding and cropping (PIL
releases the GIL in decode and resize) and collates numpy batches; the
per-epoch order is the JAX loader's (numpy ``default_rng(seed + epoch)``
permutation, the reference's DistributedSampler + SharedEpoch contract,
data.py:50-58), and a train loader of rank r of W takes
``idx[r::W]`` of it, padded to a multiple of W with the permutation's
head, as the reference's DistributedSampler does (JAX loader.py:50-95).
``device_prefetch`` then copies each batch to the card from pinned host
memory, asynchronously on the current stream, while the previous step
runs.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch


def default_collate(samples: Sequence):
    """Collate a list of samples (tuples/dicts/arrays/scalars) into batches."""
    first = samples[0]
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    if isinstance(first, np.ndarray):
        return np.stack(samples)
    if isinstance(first, (int, np.integer)):
        return np.asarray(samples, dtype=np.int32)
    if isinstance(first, (float, np.floating)):
        return np.asarray(samples, dtype=np.float32)
    return list(samples)  # strings and other objects stay as lists


class DataLoader:
    """Map-style dataset loader with epoch-seeded shuffle and prefetch."""

    PREFETCH = 4  # collated batches queued ahead of the consumer

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self._epoch = 0
        # a rank's share is ceil(n / W): the split pads (module doc)
        n = -(-len(dataset) // world_size)
        if drop_last:
            self.num_batches = n // batch_size
        else:
            self.num_batches = (n + batch_size - 1) // batch_size
        self.num_samples = self.num_batches * batch_size if drop_last else n

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng(self.seed + self._epoch).permutation(n)
        else:
            idx = np.arange(n)
        if self.world_size > 1:
            total = -(-n // self.world_size) * self.world_size
            idx = np.concatenate([idx, idx[:total - n]])
            idx = idx[self.rank::self.world_size]
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        return idx

    def __len__(self):
        return self.num_batches

    def __iter__(self) -> Iterator:
        idx = self._indices()
        batches = [idx[i: i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]

        def collated():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for b in batches:
                    yield default_collate(
                        list(pool.map(self.dataset.__getitem__, b)))

        return background(collated, self.PREFETCH)


def background(make_items, size: int) -> Iterator:
    """The items of the iterator ``make_items()``, produced by a daemon
    thread up to ``size`` ahead of the consumer; an exception there is
    raised here, and a consumer that stops early stops the thread at its
    next item."""
    out_q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def put_checked(item) -> bool:
        # never block forever on a full queue: an early-exiting consumer
        # sets stop, and a blocked put() would leak this thread
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in make_items():
                if not put_checked(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised below
            put_checked(_Failure(e))
        finally:
            put_checked(None)

    threading.Thread(target=produce, daemon=True).start()

    def gen():
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, _Failure):
                    raise item.error
                yield item
        finally:
            stop.set()
            while not out_q.empty():
                out_q.get_nowait()

    return gen()


class _Failure:
    """A worker's exception, carried to the consumer and raised there."""

    def __init__(self, error: BaseException):
        self.error = error


@dataclass
class DataInfo:
    """Reference data.py:61-71 contract: dataloader + sampler epoch hook."""

    dataloader: DataLoader

    def set_epoch(self, epoch: int):
        self.dataloader.set_epoch(epoch)


def to_device(batch, device):
    """A collated host batch with every numpy array as a tensor on
    ``device`` (integer arrays as int64, for indexing and embedding);
    other items (class words) stay as they are. To a CUDA device the
    copy goes from pinned memory, asynchronously on the current stream."""
    device = torch.device(device)

    def put(x):
        if not isinstance(x, np.ndarray):
            return x
        if np.issubdtype(x.dtype, np.integer) and x.dtype != np.uint8:
            x = x.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(x))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    if isinstance(batch, (tuple, list)):
        return type(batch)(put(x) for x in batch)
    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)


def device_prefetch(iterator, device, size: int = 2):
    """Overlap the host->device copy with compute: keep ``size`` batches
    in flight (their copies enqueued on the current stream ahead of the
    step that reads them)."""
    buf = collections.deque()
    it = iter(iterator)
    for batch in it:
        buf.append(to_device(batch, device))
        if len(buf) >= size:
            break
    while buf:
        batch = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(to_device(nxt, device))
        yield batch
