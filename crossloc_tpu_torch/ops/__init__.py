"""Hand-written CUDA kernels of the port, each beside its plain twin."""
from .groupnorm import (
    GN_EPS,
    group_norm_relu,
    group_norm_relu_backward,
    group_norm_relu_backward_plain,
    group_norm_relu_plain,
    group_norm_shard_apply,
    group_norm_shard_apply_plain,
    group_norm_shard_backward_apply,
    group_norm_shard_backward_apply_plain,
    group_norm_shard_backward_sums,
    group_norm_shard_backward_sums_plain,
    group_norm_shard_stats,
    group_norm_shard_stats_plain,
)

__all__ = ["GN_EPS", "group_norm_relu", "group_norm_relu_backward",
           "group_norm_relu_backward_plain", "group_norm_relu_plain",
           "group_norm_shard_apply", "group_norm_shard_apply_plain",
           "group_norm_shard_backward_apply", "group_norm_shard_backward_apply_plain",
           "group_norm_shard_backward_sums", "group_norm_shard_backward_sums_plain",
           "group_norm_shard_stats", "group_norm_shard_stats_plain"]
