"""Building blocks of the TransPose nets on NHWC tensors (counterpart of
`crossloc_tpu/models/layers.py`).

Activations stay NHWC [B, H, W, C] between layers. A conv views its input
as NCHW through a permute, which for a contiguous NHWC tensor is exactly
PyTorch's channels_last layout, so cuDNN runs channels-last and returns an
NHWC-contiguous result without a copy. Module attribute names are the
reference state-dict keys, so a `.net` file loads with `strict=True`.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import GN_EPS, group_norm_relu


class Conv(nn.Conv2d):
    """Conv2d with torch's symmetric `k // 2` padding over NHWC input.

    Computes in the input's dtype: under bf16 the weights are cast per call,
    as flax casts its f32 params to the compute dtype."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2)

    def forward(self, x):
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    """GroupNorm over NHWC with fp32 statistics and fp32 affine params
    (`weight`/`bias`, torch naming); kernel K1 on CUDA tensors."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = GN_EPS):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, relu: bool = False):
        return group_norm_relu(x.contiguous(), self.weight, self.bias, self.num_groups, self.eps,
                               relu)


def conv_gn(x, conv: Conv, norm: GroupNorm, relu: bool):
    """Conv -> GroupNorm (fp32 statistics) [-> ReLU], output in x's dtype:
    the port's `ConvGN` (`crossloc_tpu/models/layers.py:68-103`), with the
    conv and norm held by the parent under their reference key names."""
    return norm(conv(x), relu=relu)


def conv_norm_pair(in_ch: int, out_ch: int, kernel: int, stride: int, num_groups: int):
    """(Conv, GroupNorm) with groups = min(num_groups, out_ch)."""
    return Conv(in_ch, out_ch, kernel, stride), GroupNorm(min(num_groups, out_ch), out_ch)


class ResBlock(nn.Sequential):
    """3x3 -> 1x1 -> 3x3 Conv-GN-ReLU; the caller adds the skip.

    A Sequential of (conv, GN, ReLU) x 3 so its keys are the reference's
    `.0/.1/.3/.4/.6/.7`; the ReLU is fused into the norm. `in_features`
    (default `features`) is the first conv's input width."""

    def __init__(self, features: int, num_groups: int = 32, in_features: Optional[int] = None):
        mods = []
        for i, k in enumerate((3, 1, 3)):
            cin = features if i or in_features is None else in_features
            mods += [*conv_norm_pair(cin, features, k, 1, num_groups), nn.ReLU()]
        super().__init__(*mods)

    def forward(self, x):
        for i in (0, 3, 6):
            x = conv_gn(x, self[i], self[i + 1], relu=True)
        return x


class MLRConcatenator(ResBlock):
    """Merge block over the concatenated MLR activations (the JAX package's
    `MLRConcatenator`): a ResBlock whose first conv takes `in_features`
    channels; keys `mlr_forward.{0,1,3,4,6,7}` under its parent."""

    def __init__(self, in_features: int, features: int, num_groups: int = 32):
        super().__init__(features, num_groups, in_features)


class MLRSkip(nn.Sequential):
    """1x1 Conv + GN skip of the MLR merge, no ReLU (applied after the add);
    keys `mlr_skip.0` / `mlr_skip.1` under its parent."""

    def __init__(self, in_features: int, features: int, num_groups: int = 32):
        super().__init__(*conv_norm_pair(in_features, features, 1, 1, num_groups))

    def forward(self, x):
        return conv_gn(x, self[0], self[1], relu=False)


def pixel_shuffle(x, r: int):
    """NHWC pixel shuffle in `nn.PixelShuffle`'s channel order (c major,
    then r1, r2): [B, H, W, C*r*r] -> [B, H*r, W*r, C]."""
    B, H, W, CRR = x.shape
    C = CRR // (r * r)
    x = x.reshape(B, H, W, C, r, r).permute(0, 1, 4, 2, 5, 3)  # B, H, r1, W, r2, C
    return x.reshape(B, H * r, W * r, C)


class DenseUpsamplingConv(nn.Module):
    """The DUC head: 3x3 Conv -> GroupNorm -> ReLU (K1) -> pixel shuffle by
    `rate`; keys `conv` / `norm` under its parent (`duc_upsample`)."""

    def __init__(self, in_ch: int, rate: int, num_classes: int, num_groups: int = 32):
        super().__init__()
        self.rate = rate
        self.conv, self.norm = conv_norm_pair(in_ch, rate * rate * num_classes, 3, 1, num_groups)

    def forward(self, x):
        return pixel_shuffle(conv_gn(x, self.conv, self.norm, relu=True), self.rate)


def bilinear_resize(x, out_h: int, out_w: int):
    """NHWC bilinear resize with half-pixel centres (`align_corners=False`,
    no antialiasing). The JAX package's `jax.image.resize` antialiases when
    it shrinks, so the two differ where the DUC output overshoots an image
    whose sides are not multiples of 8 (ROADMAP R8); equal sizes are the
    identity in both."""
    if (x.shape[1], x.shape[2]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1)
