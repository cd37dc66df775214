"""Host time per batch that the loop spends fetching its next batch: waiting on
the Loader, the uint8 wire conversion and the copy to the card (the
benchmark's `data` spans, on the host clock, over the whole window)."""

UNIT = "ms"
MOVES = "validate_img_s"


def read(ctx):
    if not ctx.units:
        return None
    return 1e3 * ctx.host.get("data", 0.0) / ctx.units
