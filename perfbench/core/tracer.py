"""The benchmark's spans around its calls into the program, and the
profiler over a stretch of the window.

Every span's host seconds are summed by name in every run (a clock read on
each side). With tracing on, each span is also a `torch.profiler`
annotation `perfbench.<name>`, and `start()` / `stop()` bound the traced
stretch: a synchronised device at both ends, so that exactly the work
enqueued in between is recorded.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from . import trace as trace_mod


class Tracer:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.host: Dict[str, float] = defaultdict(float)
        self.units = 0  # steps or batches enqueued inside the traced stretch
        self.trace: Optional[trace_mod.Trace] = None
        self._prof = None
        self._stopped = None
        self._window = None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.enabled:
            with torch.profiler.record_function("perfbench." + name):
                yield
        else:
            yield
        self.host[name] += time.perf_counter() - t0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        if not self.enabled or self._prof is not None or self._stopped is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(trace_mod.TRACED)
        self._window.__enter__()

    def stop(self):
        if self._prof is None:
            return
        self._sync()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._stopped, self._prof = self._prof, None

    def finish(self):
        """Stop a stretch still open, and reduce the record (after the
        window, so that the reduction takes none of its time)."""
        self.stop()
        if self._stopped is not None:
            self.trace = trace_mod.reduce(self._stopped)
            self._stopped = None

    def unit(self):
        """Count one step or batch enqueued while the stretch is traced."""
        if self._prof is not None:
            self.units += 1
