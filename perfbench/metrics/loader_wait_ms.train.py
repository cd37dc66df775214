"""Host ms per traced step that the main thread waits on the Loader's queue
for its next batch: the program's `data.loader_wait` spans
(`crossloc_tpu_torch/data/pipeline.py::Loader`), one a batch, each with its
epoch and batch index. An epoch's refill, where the workers start over,
shows here."""
from perfbench.core import spans

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    return spans.main_ms_per_step(ctx, "data.loader_wait")
