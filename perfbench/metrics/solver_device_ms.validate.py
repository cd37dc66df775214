"""Device time per batch of every kernel launched inside the benchmark's span
around `ransac.solve_batch` (`perfbench.solve`), in the traced batches."""

UNIT = "ms"
MOVES = "validate_img_s"
SPANS = {"perfbench.solve"}


def read(ctx):
    if ctx.trace is None or not ctx.traced_units:
        return None
    return 1e3 * ctx.trace.seconds(under=SPANS) / ctx.traced_units
