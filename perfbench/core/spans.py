"""The program's own spans (`crossloc_tpu_torch/utils/profiling.py`), read
by the per-layer metrics of the loops that train.

The program keeps a record of a span only while a `torch.profiler` records
at both of its ends. In a run of the benchmark the one profiler is the
traced stretch's (`core/tracer.py`), so the records are the spans of that
stretch: the main thread's and those of the Loader's worker threads, which
the profiler's own trace does not hold. A program that keeps no span
records gives None, and so does a run without a trace.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from .trace import PROGRAM_PREFIX as PREFIX


def records(ctx) -> Optional[list]:
    """The traced stretch's span records, or None."""
    if ctx.trace is None or not ctx.traced_units:
        return None
    try:
        from crossloc_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    return (read() or None) if read is not None else None


def named(ctx, name: str, main_thread: bool) -> Optional[list]:
    """The records of the spans `name` on the main thread, or on the others."""
    recs = records(ctx)
    if recs is None:
        return None
    main = threading.main_thread().ident
    return [r for r in recs if r.name == name and (r.thread == main) == main_thread] or None


def main_ms_per_step(ctx, name: str) -> Optional[float]:
    """The main thread's ms in the spans `name` per traced step."""
    recs = named(ctx, name, main_thread=True)
    if recs is None:
        return None
    return 1e-6 * sum(r.end_ns - r.start_ns for r in recs) / ctx.traced_units


def device_ms_per_step(ctx, name: str) -> Optional[float]:
    """Device ms per traced step of the kernels launched inside the span
    `name` on the main thread (the span among their ancestors)."""
    if ctx.trace is None or not ctx.traced_units:
        return None
    seconds = ctx.trace.seconds(under={PREFIX + name})
    return 1e3 * seconds / ctx.traced_units if seconds > 0 else None


def overlap_ns(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total

