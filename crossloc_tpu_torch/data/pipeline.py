"""Host input pipeline: epoch-keyed shuffling and sharding, batching with
background decoding, the uint8 wire format and a pinned-memory prefetch to
the card (counterpart of `crossloc_tpu/data/pipeline.py`).
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

_DECODE_THREADS = 4
_PREFETCH_BATCHES = 2


def images_to_wire(images: np.ndarray) -> np.ndarray:
    """[0, 1] float32 images -> uint8 on the k/255 grid, saturating: values
    outside [0, 1] clip instead of wrapping. On-grid pixels round-trip
    exactly through `images_from_wire`."""
    return np.rint(np.clip(images, 0.0, 1.0) * 255.0).astype(np.uint8)


def images_from_wire(images: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 / 255.0, the host's `array / 255.0` rounding."""
    if images.dtype != torch.uint8:
        raise TypeError(f"wire images are uint8, got {images.dtype}")
    return images.float() / 255.0


def to_grayscale(images: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] -> [B, H, W, 1], ITU-R 601 luma."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=images.dtype, device=images.device)
    return (images * w).sum(-1, keepdim=True)


def device_prefetch(iterator: Iterable[dict], device, size: int = 2,
                    keys: Tuple[str, ...] = ("image", "pose")) -> Iterator[dict]:
    """Keep `size` batches' `keys` arrays in flight to `device`: on a card,
    copied through pinned host memory with `non_blocking` (PyTorch's host
    allocator keeps each pinned buffer until its copy has run); on the CPU,
    wrapped as tensors."""
    device = torch.device(device)
    buf = collections.deque()

    def put(batch):
        out = dict(batch)
        for k in keys:
            if k in out and isinstance(out[k], np.ndarray):
                t = torch.from_numpy(out[k])
                if device.type == "cuda":
                    t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
        return out

    for batch in iterator:
        buf.append(put(batch))
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class Loader:
    """Iterates over host batches; a thread pool decodes batches ahead of the
    consumer.

    By default in dataset order with the last batch short (evaluation). With
    `shuffle`, the order of epoch E is `np.random.default_rng([seed, E])`'s
    permutation, so a resumed run sees the data of an uninterrupted one;
    `set_epoch(E)` before iterating, else each pass advances the epoch. A
    `shard` (rank, world) reads idx[rank::world] cut to len // world, the
    same count on every rank. `drop_last` drops a short last batch."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 2021,
                 drop_last: bool = False, shard: Tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        rank, world = shard
        if not 0 <= rank < world:
            raise ValueError(f"shard rank {rank} not in [0, {world})")
        self.shard = (rank, world)
        self._epoch = 0

    def _local_size(self) -> int:
        return len(self.dataset) // self.shard[1]

    def __len__(self) -> int:
        n = self._local_size()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def index_batches(self):
        """The index arrays of this epoch's batches."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng([self.seed, self._epoch]).shuffle(idx)
        rank, world = self.shard
        idx = idx[rank::world][: self._local_size()]
        bs = self.batch_size
        return [idx[b * bs: (b + 1) * bs] for b in range(len(self))]

    def __iter__(self) -> Iterator[dict]:
        batches = self.index_batches()
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=_PREFETCH_BATCHES)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(_DECODE_THREADS) as pool:
                futures = [pool.submit(self.dataset.collate, b) for b in batches]
                for f in futures:
                    if stop.is_set():
                        f.cancel()
                        continue
                    try:
                        item = f.result()
                    except Exception as e:  # handed to the consumer, which raises it
                        q.put(e)
                        break
                    q.put(item)
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
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
            # unblock a producer waiting on a full queue, then let it finish
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
