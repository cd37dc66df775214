"""The profiler's record of a traced stretch of the window, reduced to what
the per-layer readers need: every device kernel with its time and the names
of the host operations and benchmark spans that launched it, the device's
busy intervals (the union of its operations' intervals) and their sum, the
main thread's spans of the program, and the idle gaps by what the main
thread was doing.

The traced stretch is the benchmark's own span `perfbench.traced` on the
main thread; device work is clipped to it. A kernel is linked to the host
operation that launched it by the profiler's correlation id, and that
operation's ancestors are the host spans that contain it on its thread.
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, FrozenSet, List, Optional, Tuple

TRACED = "perfbench.traced"
SPAN_PREFIX = "perfbench."
PROGRAM_PREFIX = "crossloc."  # the program's spans (`utils/profiling.py::span`)


class Kernel:
    __slots__ = ("name", "seconds", "ancestors")

    def __init__(self, name: str, seconds: float, ancestors: FrozenSet[str]):
        self.name = name
        self.seconds = seconds
        self.ancestors = ancestors


class Trace:
    """`busy`: the device's busy intervals, sorted and disjoint; `bounds`:
    the traced stretch; `spans`: the main thread's spans of the program
    (`crossloc.<name>`) as (start, end, name), clipped to the stretch. All
    in ns on the profiler's clock."""

    def __init__(self, window_s: float, busy_s: float, kernels: List[Kernel],
                 device_ops: List[Tuple[str, float]], idle_gaps: List[Tuple[str, float]],
                 busy: List[Tuple[int, int]], bounds: Tuple[int, int],
                 spans: List[Tuple[int, int, str]]):
        self.window_s = window_s
        self.busy_s = busy_s
        self.kernels = kernels
        self.device_ops = device_ops
        self.idle_gaps = idle_gaps
        self.busy = busy
        self.bounds = bounds
        self.spans = spans

    def intervals(self, prefix: str) -> List[Tuple[int, int]]:
        """The union of the main thread's spans whose names start with
        `prefix`, sorted and disjoint."""
        return _union([(s, e) for s, e, name in self.spans if name.startswith(prefix)])

    def seconds(self, name_re: Optional[str] = None, under: Optional[set] = None) -> float:
        """Device seconds of the kernels whose name matches `name_re` and
        (or) that were launched under one of the host names `under`."""
        return sum(k.seconds for k in self.select(name_re, under))

    def select(self, name_re: Optional[str] = None, under: Optional[set] = None) -> List[Kernel]:
        rx = re.compile(name_re) if name_re else None
        return [k for k in self.kernels
                if (rx is None or rx.search(k.name)) and (under is None or k.ancestors & under)]


def _kind(ev) -> str:
    act = ev.activity_type() if hasattr(ev, "activity_type") else ""
    if act:
        return act
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def short_name(name: str, width: int = 96) -> str:
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)::", "")
    cut = name.find("(")
    return (name if cut < 0 else name[:cut])[:width]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(prof) -> Trace:
    """Reduce a stopped `torch.profiler.profile` (CPU and CUDA activities)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host: Dict[int, list] = defaultdict(list)  # thread -> [(start, end, name, corr)]
    device = []  # (start, end, name, kind, linked, corr)
    runtime: Dict[int, int] = {}  # correlation id -> linked host op's correlation id
    window = None
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            device.append((s, e, ev.name(), _kind(ev), ev.linked_correlation_id(),
                           ev.correlation_id()))
            continue
        kind = _kind(ev)
        if kind == "cuda_runtime" or kind == "cuda_driver":
            runtime[ev.correlation_id()] = ev.linked_correlation_id()
            continue
        name = ev.name()
        host[ev.start_thread_id()].append((s, e, name, ev.correlation_id()))
        if name == TRACED:
            window = (s, e, ev.start_thread_id())
    if window is None:
        raise RuntimeError(f"the trace holds no {TRACED} span")
    w0, w1, main = window

    # each host event's ancestors (names of the events that contain it on its thread)
    ancestors_of: Dict[int, Tuple[str, ...]] = {}
    interned: Dict[Tuple[str, ...], FrozenSet[str]] = {}
    for thread, evs in host.items():
        evs.sort(key=lambda x: (x[0], -x[1]))
        stack: List[tuple] = []
        for s, e, name, corr in evs:
            while stack and stack[-1][1] <= s:
                stack.pop()
            chain = tuple(x[2] for x in stack) + (name,)
            ancestors_of[corr] = chain
            stack.append((s, e, name))

    # a host span's mirror on the device timeline (a user annotation's range
    # over the kernels it launched) is no device work
    host_names = {x[2] for evs in host.values() for x in evs}
    kernels: List[Kernel] = []
    busy_iv: List[Tuple[int, int]] = []
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name, kind, linked, corr in device:
        if kind == "gpu_user_annotation" or (kind == "kernel" and name in host_names):
            continue
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        busy_iv.append((s, e))
        if kind != "kernel":
            by_name[kind] += (e - s) * 1e-9
            continue
        if linked == 0:
            linked = runtime.get(corr, 0)
        chain = ancestors_of.get(linked, ())
        anc = interned.get(chain)
        if anc is None:
            anc = interned[chain] = frozenset(chain)
        kernels.append(Kernel(name, (e - s) * 1e-9, anc))
        by_name[short_name(name)] += (e - s) * 1e-9

    busy = _union(busy_iv)
    busy_s = sum(e - s for s, e in busy) * 1e-9

    # idle gaps, each named by the innermost benchmark span on the main
    # thread at the gap's midpoint
    spans = sorted((x for x in host[main] if x[2].startswith(SPAN_PREFIX) and x[2] != TRACED),
                   key=lambda x: (x[0], -x[1]))
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [p for iv in busy for p in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label = "outside benchmark spans"
        for s, e, name, _ in spans:
            if s > mid:
                break
            if e >= mid:
                label = name
        gaps[label] += (b - a) * 1e-9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    program = [(max(s, w0), min(e, w1), name) for s, e, name, _ in host[main]
               if name.startswith(PROGRAM_PREFIX) and min(e, w1) > max(s, w0)]
    return Trace((w1 - w0) * 1e-9, busy_s, kernels, top(by_name), top(gaps), busy, (w0, w1),
                 program)
