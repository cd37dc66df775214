"""Host ms per traced step that the main thread spends in the program's
`data.wire` spans (`crossloc_tpu_torch/data/pipeline.py::images_to_wire`).
The Loader's workers collate the uint8 wire images, so the call passes a
batch on as it is (`bytes=0`) and this reads near 0 ms; a batch that comes
as float32 is converted there, on the main thread, and shows here."""
from perfbench.core import spans

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    return spans.main_ms_per_step(ctx, "data.wire")
