"""Device ms per traced step of the kernels launched inside the program's
span `step.optimizer` (`crossloc_tpu_torch/train/step.py::apply_gradients`:
the gradients' global norm, the clip, Adam)."""
from perfbench.core import spans

UNIT = "ms"
MOVES = "train_img_s"


def read(ctx):
    return spans.device_ms_per_step(ctx, "step.optimizer")
