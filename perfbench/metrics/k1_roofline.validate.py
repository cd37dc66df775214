"""Share of K1's roofline: the bytes of every GroupNorm+ReLU forward (x read
once, y written once) in the traced batches, from the layer table's shapes,
at the card's memory bandwidth, over the device time of the kernels that
implement it (`crossloc_tpu_torch/csrc/groupnorm.cu`, named below)."""

UNIT = "%"
MOVES = "validate_img_s"
KERNELS = r"(?<![A-Za-z0-9_])gn_"


def read(ctx):
    if ctx.trace is None or not ctx.peaks or not ctx.traced_units:
        return None
    seconds = ctx.trace.seconds(name_re=KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * ctx.work["k1"].bound_s * ctx.traced_units / seconds
