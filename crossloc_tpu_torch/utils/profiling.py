"""Spans, section timers and traces (counterpart of
`crossloc_tpu/utils/profiling.py`).

`span(name, **counts)` marks a section of the program. It is on exactly
while a `torch.profiler` records: then it opens a
`record_function("crossloc.<name>")`, so that the kernels it launches nest
under it in the device trace, and keeps a record (`Span`) of its name,
thread, entry and exit on the `time.time_ns` clock (the profiler's own), the
enclosing span on its thread and its counts, in a ring of the last
`RING_SIZE` spans (`records()`, `clear()`); `add_counts` adds to the counts
of the innermost open span of its thread. The profiler traces only the
thread that started it; the records also hold the spans of other threads,
such as the `Loader`'s workers. With no profiler recording, a span costs
one read of the profiler's flag.

`StopWatch` accumulates host time per named section (each a span), waiting
for the card where asked; `trace` records a `torch.profiler` Chrome trace
and the spans of the same stretch.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RING_SIZE = 65536  # spans kept; the oldest go first


class Span(NamedTuple):
    name: str
    thread: int  # threading.get_ident() of the thread that ran it
    start_ns: int  # time.time_ns() at entry and exit
    end_ns: int
    parent: Optional[str]  # the enclosing span's name on the same thread
    counts: dict


_ring: "collections.deque[Span]" = collections.deque(maxlen=RING_SIZE)
_ring_lock = threading.Lock()
_local = threading.local()
_OFF = contextlib.nullcontext()


def profiler_enabled() -> bool:
    """Whether a `torch.profiler` records, in any thread: the flag the
    profiler sets for the whole process (torch's own
    `_profiler_enabled()` is per thread, and False in other threads)."""
    return _autograd_profiler._is_profiler_enabled


class _Recording:
    __slots__ = ("name", "counts", "parent", "annotation", "start_ns")

    def __init__(self, name: str, counts: dict):
        self.name = name
        self.counts = counts

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.annotation = torch.profiler.record_function("crossloc." + self.name)
        self.annotation.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self.annotation.__exit__(*exc)
        _local.stack.pop()
        if profiler_enabled():  # a span the profiler saw end to end
            record = Span(self.name, threading.get_ident(), self.start_ns, end_ns,
                          self.parent, self.counts)
            with _ring_lock:
                _ring.append(record)
        return False


def span(name: str, **counts):
    """Context manager marking the section `name`, with `counts` (numbers
    of the work done) kept in its record. A no-op unless a profiler
    records; a span still open when the profiler stops keeps no record."""
    if not profiler_enabled():
        return _OFF
    return _Recording(name, counts)


def add_counts(**counts) -> None:
    """Add `counts` to the innermost span open on this thread, for work
    counted below the code that opened it (`CamLocDataset.collate`'s
    `direct` frames, in the Loader's `data.collate`). A no-op where no span
    records on this thread."""
    stack = getattr(_local, "stack", None)
    if stack:
        stack[-1].counts.update(counts)


def records() -> List[Span]:
    """The kept spans, in the order they ended."""
    with _ring_lock:
        return list(_ring)


def clear() -> None:
    with _ring_lock:
        _ring.clear()


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
        with span(name):
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
    Perfetto), and `<log_dir>/spans.jsonl`, the block's spans one a line
    (`Span`'s fields) on the trace's clock, those of every thread."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
        for r in records():
            if r.start_ns >= t0:
                f.write(json.dumps(r._asdict()) + "\n")
