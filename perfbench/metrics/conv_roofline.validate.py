"""Share of the convolutions' roofline: the least time the card needs for the
convs of the traced batches (every conv's forward; operations and bytes from
the configuration's layer table, `perfbench/core/work.py`) over the device
time of the kernels launched under the operators below."""

UNIT = "%"
MOVES = "validate_img_s"
OPERATORS = {"aten::convolution", "aten::convolution_backward"}


def read(ctx):
    if ctx.trace is None or not ctx.peaks or not ctx.traced_units:
        return None
    seconds = ctx.trace.seconds(under=OPERATORS)
    if seconds <= 0:
        return None
    return 100.0 * ctx.work["conv"].bound_s * ctx.traced_units / seconds
