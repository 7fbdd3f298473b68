"""Host data pipeline (port of mtt_tpu/data/loader.py): sharded sampling,
threaded loading, fixed-shape batches, and the copy to the card.

- ``ShardedSampler``: DistributedSampler(drop_last=True) for training (a
  per-epoch seeded shuffle, contiguous equal shards); for eval every index in
  exactly one shard, short shards and the last batch padded with -1.
- ``MultiTaskLoader``: ``dataset.__getitem__(idx, rng)`` and its transforms
  in a thread pool, each sample drawing from its own generator seeded by
  (loader seed, epoch, index); ``collate`` stacks the arrays into float32
  NHWC batches and keeps ``meta`` a list. A -1 index is a pad sample no
  meter, loss or saver counts. A sample that raises re-raises in the
  consumer: the producer thread puts the exception on the queue (the JAX
  loader's producer dies before its end marker, and its consumer waits
  forever).
- ``device_put_batch``: the arrays from pinned host memory to one device
  with ``non_blocking`` copies; ``prefetch_to_device`` keeps the next
  batches' copies queued while the current step runs. Over several ranks
  each rank's loader reads its own shard (``num_shards``, ``shard_index``
  from ``parallel.mesh.data_shard_info``) and copies to its own device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np
import torch


class ShardedSampler:
    """Per-epoch shuffled, per-process contiguous shard, drop_last."""

    def __init__(self, n: int, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0,
                 drop_last: bool = True):
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0
        self.drop_last = drop_last
        per_shard = n // num_shards
        self.per_shard = (per_shard // batch_size) * batch_size if drop_last \
            else per_shard

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed * 1000003 + self.epoch)
            rng.shuffle(idx)
        if self.drop_last:
            shard = idx[self.shard_index::self.num_shards][:self.per_shard]
            for i in range(0, len(shard), self.batch_size):
                batch = shard[i:i + self.batch_size]
                if len(batch) == self.batch_size:
                    yield batch.tolist()
            return
        # eval: every index in exactly one shard and every shard the same
        # number of batches, the short ones padded with -1
        shard = idx[self.shard_index::self.num_shards]
        max_len = -(-self.n // self.num_shards)
        nb = -(-max_len // self.batch_size)
        padded = np.full(nb * self.batch_size, -1, np.int64)
        padded[:len(shard)] = shard
        for i in range(0, len(padded), self.batch_size):
            yield padded[i:i + self.batch_size].tolist()

    def __len__(self):
        if self.drop_last:
            return self.per_shard // self.batch_size
        return -(-(-(-self.n // self.num_shards)) // self.batch_size)


def collate(samples: List[Dict]) -> Dict:
    """Stack per key into float32; 'meta' (and any *idx key) stays a
    python list."""
    out = {}
    for k in samples[0]:
        if k == "meta" or k.endswith("idx"):
            out[k] = [s[k] for s in samples]
        elif isinstance(samples[0][k], np.ndarray):
            out[k] = np.stack([s[k] for s in samples]).astype(np.float32)
        else:
            out[k] = [s[k] for s in samples]
    return out


class _Raised:
    """An exception of the producer, carried to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class MultiTaskLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 num_shards: int = 1, shard_index: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.sampler = ShardedSampler(len(dataset), batch_size, shuffle, seed,
                                      num_shards, shard_index, drop_last)
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self._pad_sample = None

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler)

    def _load_one(self, idx: int, epoch: int) -> Dict:
        if idx < 0:
            return self._ignore_sample()
        rng = np.random.default_rng(
            (self.seed * 7919 + epoch) * 1000003 + idx)
        return self.dataset.__getitem__(idx, rng=rng)

    def _ignore_sample(self) -> Dict:
        """A batch-padding sample no meter, loss or saver counts: labels
        filled with the ignore index, det boxes invalid, meta flagged
        'pad'."""
        if self._pad_sample is None:
            s = dict(self._load_one(0, 0))
            for k, v in s.items():
                if k == "meta":
                    s[k] = dict(v, pad=True) if isinstance(v, dict) else v
                elif not isinstance(v, np.ndarray) or k == "image":
                    continue
                elif k.startswith("det_"):
                    s[k] = np.zeros_like(v)
                else:
                    s[k] = np.full_like(v, 255.0)
            self._pad_sample = s
        return self._pad_sample

    def __iter__(self):
        epoch = self.sampler.epoch
        batches = list(self.sampler)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        samples = list(pool.map(
                            lambda i: self._load_one(i, epoch), b))
                        if not put(collate(samples)):
                            return
            except BaseException as exc:       # re-raised by the consumer
                put(_Raised(exc))
                return
            put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _Raised):
                    raise item.exc
                yield item
        finally:
            stop.set()


def pad_batch_to_multiple(batch: Dict, m: int, ignore: float = 255.0) -> Dict:
    """Pad the batch axis up to a multiple of ``m``: label entries filled
    with the ignore index and det entries with 0, so that no meter or loss
    counts them; padded images repeat the last sample."""
    sizes = [v.shape[0] for v in batch.values() if isinstance(v, np.ndarray)]
    if not sizes:
        return batch
    B = sizes[0]
    pad = (-B) % m
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        tail_shape = (pad,) + v.shape[1:]
        if k == "image":
            tail = np.repeat(v[-1:], pad, axis=0)
        elif k.startswith("det_"):
            tail = np.zeros(tail_shape, v.dtype)
        else:
            tail = np.full(tail_shape, ignore, v.dtype)
        out[k] = np.concatenate([v, tail], axis=0)
    return out


def device_put_batch(batch: Dict, device) -> Dict:
    """The batch's arrays as tensors on ``device``, copied from pinned host
    memory without blocking the host when it is a CUDA device; every other
    entry (``meta``) as it is. No normalisation: the transforms did it."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            else:
                t = t.to(device)
            out[k] = t
        else:
            out[k] = v
    return out


def prefetch_to_device(iterator, device, size: int = 2):
    """The batches of ``iterator`` on ``device``, ``size`` copies queued
    ahead of the one handed out."""
    buf = []
    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(device_put_batch(next(it), device))
    except StopIteration:
        pass
    while buf:
        nxt = buf.pop(0)
        try:
            buf.append(device_put_batch(next(it), device))
        except StopIteration:
            pass
        yield nxt
