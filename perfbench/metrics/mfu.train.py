"""Model FLOP utilisation of the traced stretch: the convolutions' operations
of the traced steps (forward and the gradients the step needs), from the
layer table, over the stretch's wall time and the card's peak at the
configuration's precision. The rest of the step (norms, loss, optimizer) is
left out."""

UNIT = "%"
MOVES = "train_img_s"


def read(ctx):
    if ctx.trace is None or not ctx.peaks or ctx.trace.window_s <= 0:
        return None
    flop = ctx.work["conv"].flop * ctx.traced_units
    return 100.0 * flop / ctx.trace.window_s / ctx.peaks["flops"]
