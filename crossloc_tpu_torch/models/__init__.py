"""TransPose nets, the projection head and the vanilla net on NHWC tensors."""
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
    ProjHead,
    TransPoseDecoder,
    TransPoseEncoder,
    TransPoseNet,
    build_network,
    init_weights,
    task_channels,
)
from .vanilla import VanillaNetwork

__all__ = [
    "Conv",
    "DenseUpsamplingConv",
    "GroupNorm",
    "MLRConcatenator",
    "MLRSkip",
    "ProjHead",
    "ResBlock",
    "TransPoseDecoder",
    "TransPoseEncoder",
    "TransPoseNet",
    "VanillaNetwork",
    "bilinear_resize",
    "build_network",
    "conv_gn",
    "init_weights",
    "pixel_shuffle",
    "task_channels",
]
