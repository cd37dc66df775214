"""Device ms per traced step of the kernels launched inside the program's
span `step.loss` (`crossloc_tpu_torch/train/step.py::train_step`, around
`task_loss_fn`): the task loss's forward. Its backward runs on autograd's
device thread, outside the span."""
from perfbench.core import spans

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    return spans.device_ms_per_step(ctx, "step.loss")
