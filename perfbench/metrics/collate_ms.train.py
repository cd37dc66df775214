"""Host ms a worker thread of the Loader spends decoding and stacking one
batch: the mean of the program's `data.collate` spans
(`crossloc_tpu_torch/data/pipeline.py::Loader`, around `dataset.collate`)
that ran in the traced stretch. Whether the main thread waits on the Loader
(`loader_wait_ms.train`) turns on this time against a step's."""
from perfbench.core import spans

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    recs = spans.named(ctx, "data.collate", main_thread=False)
    if recs is None:
        return None
    return 1e-6 * sum(r.end_ns - r.start_ns for r in recs) / len(recs)
