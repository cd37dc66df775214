"""Hand-written CUDA kernels of the port, each beside its plain twin."""
from .groupnorm import (
    GN_EPS,
    group_norm_relu,
    group_norm_relu_backward,
    group_norm_relu_backward_plain,
    group_norm_relu_plain,
)

__all__ = ["GN_EPS", "group_norm_relu", "group_norm_relu_backward",
           "group_norm_relu_backward_plain", "group_norm_relu_plain"]
