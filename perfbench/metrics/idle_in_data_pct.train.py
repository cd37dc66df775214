"""Share of the traced stretch in which the device is idle while the main
thread is inside one of the program's `data.*` spans (waiting on the
Loader, the uint8 wire, the pinned copy's enqueue).

Reads the device's busy intervals and the stretch's bounds on the
profiler's clock, `ctx.trace.busy` (sorted, disjoint (start, end) ns) and
`ctx.trace.bounds` ((start, end) ns); `core/trace.py::reduce` sums them
away, and this reader gives None until it keeps them."""
from perfbench.core import spans

UNIT = "%"
MOVES = "train_img_s"


def read(ctx):
    busy = getattr(ctx.trace, "busy", None)
    bounds = getattr(ctx.trace, "bounds", None)
    if busy is None or bounds is None or bounds[1] <= bounds[0]:
        return None
    data = spans.main_intervals(ctx, "data.", bounds)
    if data is None:
        return None
    in_data = sum(e - s for s, e in data)
    return 100.0 * (in_data - spans.overlap_ns(data, busy)) / (bounds[1] - bounds[0])
