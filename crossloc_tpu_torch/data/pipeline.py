"""Host input pipeline: epoch-keyed shuffling and sharding, batching with
background decoding, the uint8 wire format and a pinned-memory prefetch to
the card (counterpart of `crossloc_tpu/data/pipeline.py`).

The `Loader`'s workers collate batches whose images are already uint8 wire
images (`CamLocDataset.collate`); `images_to_wire` hands such a batch on as
it is, so the main thread converts nothing.
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from ..utils.profiling import span


def quantize_images(images: np.ndarray) -> np.ndarray:
    """[0, 1] float32 images -> uint8 on the k/255 grid, saturating: values
    outside [0, 1] clip instead of wrapping. On-grid pixels round-trip
    exactly through `images_from_wire`. Opens no span: the Loader's workers
    run it on the frames `CamLocDataset.collate` resamples."""
    return np.rint(np.clip(images, 0.0, 1.0) * 255.0).astype(np.uint8)


def images_to_wire(images: np.ndarray) -> np.ndarray:
    """Host images -> the uint8 wire, on the caller's thread, under a
    `data.wire` span that counts the bytes it converted. A uint8 array (a
    `CamLocDataset.collate` or `Loader` batch) is on the wire already: it is
    returned as it is, with no copy, and `bytes=0`. Any other dtype goes
    through `quantize_images`."""
    if images.dtype == np.uint8:
        with span("data.wire", bytes=0):
            return images
    with span("data.wire", bytes=images.size):
        return quantize_images(images)


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
        arrays = [k for k in keys if k in out and isinstance(out[k], np.ndarray)]
        with span("data.copy", bytes=sum(out[k].nbytes for k in arrays)):
            for k in arrays:
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
    """Iterates over host batches; a pool of `num_workers` threads decodes
    batches ahead of the consumer, at most `prefetch` of them waiting.

    By default in dataset order with the last batch short (evaluation). With
    `shuffle`, the order of epoch E is `np.random.default_rng([seed, E])`'s
    permutation, so a resumed run sees the data of an uninterrupted one;
    `set_epoch(E)` before iterating, else each pass advances the epoch. A
    `shard` (rank, world) reads idx[rank::world] cut to len // world, the
    same count on every rank. `drop_last` drops a short last batch. Each
    batch is the dataset's `collate`, run in a worker under a `data.collate`
    span (of a `CamLocDataset`: uint8 wire images, and the span's `direct`
    count says how many frames took the decoder's bytes as they are).

    `num_workers` and `prefetch` keep the JAX package's `Loader` signature;
    every caller takes their defaults (4, 2), and no CLI or tool flag sets
    them."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 2021,
                 num_workers: int = 4, prefetch: int = 2, drop_last: bool = False,
                 shard: Tuple[int, int] = (0, 1)):
        if num_workers < 1 or prefetch < 1:
            raise ValueError(f"num_workers={num_workers} and prefetch={prefetch} must be >= 1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
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
        epoch = self._epoch
        self._epoch += 1
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def collate(i, b):
            with span("data.collate", epoch=epoch, batch=i, frames=len(b)):
                return self.dataset.collate(b)

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futures = [pool.submit(collate, i, b) for i, b in enumerate(batches)]
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
            for i in itertools.count():
                with span("data.loader_wait", epoch=epoch, batch=i):
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
