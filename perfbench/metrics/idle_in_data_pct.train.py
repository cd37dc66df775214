"""Share of the traced stretch in which the device is idle while the main
thread is inside one of the program's `data.*` spans (waiting on the
Loader, the wire's pass-through, the pinned copy's enqueue).

Reads the spans, the device's busy intervals and the stretch's bounds all
from the profiler's trace, on its one clock (`core/trace.py::Trace`)."""
from perfbench.core import spans

UNIT = "%"
MOVES = "train_img_s"


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.traced_units or tr.bounds[1] <= tr.bounds[0]:
        return None
    data = tr.intervals(spans.PREFIX + "data.")
    if not data:
        return None
    in_data = sum(e - s for s, e in data)
    return 100.0 * (in_data - spans.overlap_ns(data, tr.busy)) / (tr.bounds[1] - tr.bounds[0])
