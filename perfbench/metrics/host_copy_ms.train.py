"""Host ms per traced step that the main thread spends pinning a batch and
enqueueing its copies to the card: the program's `data.copy` spans
(`crossloc_tpu_torch/data/pipeline.py::device_prefetch`)."""
from perfbench.core import spans

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    return spans.main_ms_per_step(ctx, "data.copy")
