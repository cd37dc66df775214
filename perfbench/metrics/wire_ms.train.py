"""Host ms per traced step that the main thread spends turning the float32
frames into the uint8 wire: the program's `data.wire` spans
(`crossloc_tpu_torch/data/pipeline.py::images_to_wire`)."""
from perfbench.core import spans

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    return spans.main_ms_per_step(ctx, "data.wire")
