"""Kernels per batch launched inside the benchmark's span around
`ransac.solve_batch` (`perfbench.solve`), in the traced batches."""

UNIT = "kernels"
MOVES = "validate_img_s"
SPANS = {"perfbench.solve"}


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    return len(ctx.trace.select(under=SPANS)) / ctx.traced_units
