"""TransPose nets on NHWC tensors."""
from .layers import (
    Conv,
    DenseUpsamplingConv,
    GroupNorm,
    MLRConcatenator,
    MLRSkip,
    ResBlock,
    bilinear_resize,
    conv_gn,
    pixel_shuffle,
)
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
    "DenseUpsamplingConv",
    "GroupNorm",
    "MLRConcatenator",
    "MLRSkip",
    "ResBlock",
    "TransPoseDecoder",
    "TransPoseEncoder",
    "TransPoseNet",
    "bilinear_resize",
    "build_network",
    "conv_gn",
    "init_weights",
    "pixel_shuffle",
    "task_channels",
]
