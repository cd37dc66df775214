"""Device ms per traced step of the kernels launched inside the program's
span `augment` (`crossloc_tpu_torch/data/augment.py::augment_batch`: the
colour jitter, the normalisation, the affine resampling of images and
labels)."""
from perfbench.core import spans

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    return spans.device_ms_per_step(ctx, "augment")
