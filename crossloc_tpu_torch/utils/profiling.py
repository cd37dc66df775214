"""Section timers and traces (counterpart of `crossloc_tpu/utils/profiling.py`).

`StopWatch` accumulates host time per named section, waiting for the card
where asked; `timeit` times a callable after a warm-up; `trace` records a
`torch.profiler` Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


def _first_tensor(x):
    """The first tensor in x (a tensor, or lists, tuples and dicts of them)."""
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (list, tuple)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def device_sync(x) -> None:
    """Wait until the card has computed x: `torch.cuda.synchronize` on the
    device of its first tensor; nothing for CPU tensors (they are done)."""
    t = _first_tensor(x)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


class StopWatch:
    """Accumulating section timer: `with sw.section("solve"): ...`."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_result is not None:
                device_sync(sync_result)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in self.totals:
            n = self.counts[name]
            lines.append(
                f"{name}: total {self.totals[name]*1000:.1f}ms over {n} calls "
                f"({self.totals[name]/n*1000:.2f}ms avg)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` over the block (the card's kernels too, where there
    is one); writes `<log_dir>/trace.json`, a Chrome trace (chrome://tracing,
    Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timeit(fn, *args, iters: int = 5, warmup: int = 2) -> float:
    """Seconds per call after `warmup` calls, waiting for the card's result."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    device_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    device_sync(out)
    return (time.perf_counter() - t0) / iters
