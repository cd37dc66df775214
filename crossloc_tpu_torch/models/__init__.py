"""TransPose nets on NHWC tensors."""
from .layers import Conv, GroupNorm, MLRConcatenator, MLRSkip, ResBlock, conv_gn
from .transpose_net import (
    TransPoseDecoder,
    TransPoseEncoder,
    TransPoseNet,
    build_network,
    init_weights,
    task_channels,
)

__all__ = [
    "Conv",
    "GroupNorm",
    "MLRConcatenator",
    "MLRSkip",
    "ResBlock",
    "TransPoseDecoder",
    "TransPoseEncoder",
    "TransPoseNet",
    "build_network",
    "conv_gn",
    "init_weights",
    "task_channels",
]
