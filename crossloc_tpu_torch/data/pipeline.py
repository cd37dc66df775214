"""Host input pipeline: batching with background decoding, and the uint8
wire format of eval images (counterpart of `crossloc_tpu/data/pipeline.py`).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

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


class Loader:
    """Iterates over host batches in dataset order, the last one possibly
    short; a thread pool decodes batches ahead of the consumer."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n, bs = len(self.dataset), self.batch_size
        batches = [range(i, min(i + bs, n)) for i in range(0, n, bs)]
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
