"""The DSAC*-style scene-coordinate FCN with no norm, NHWC in and out
(counterpart of `crossloc_tpu/models/vanilla.py`): the net the CLIs build
for scenes outside urbanscape and naturescape.

A strided conv stack, three residual stages with no GroupNorm and no ReLU
after the skip-adds, a 1x1 fc head to 3 channels and a per-channel `mean`
buffer: [B, H, W, in_ch] -> [B, H/8, W/8, 3] in float32 (float64 for a
float64 net). Module names are the reference `Network`'s state-dict keys
(`conv1..4`, `res{1,2,3}_conv{1,2,3}`, `res2_skip` unless tiny, `fc1..3`,
`mean`), so a `.net` file loads with `strict=True`. Its convs are cuDNN's:
the net launches no kernel of the port.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import Conv
from .transpose_net import _widths

OUTPUT_SUBSAMPLE = 8


class VanillaNetwork(nn.Module):
    """`in_ch` is 1 for the reference's grayscale input, 3 for RGB; `dtype`
    is the compute dtype of the convs (float32 or bfloat16)."""

    def __init__(self, tiny: bool = False, mean_init: Optional[Sequence[float]] = None,
                 in_ch: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid, wide = _widths(tiny)
        self.tiny = tiny
        self.dtype = dtype
        self.num_task_channel = 3
        self.conv1 = Conv(in_ch, 32, 3, 1)
        self.conv2 = Conv(32, 64, 3, 2)
        self.conv3 = Conv(64, 128, 3, 2)
        self.conv4 = Conv(128, mid, 3, 2)
        for b, (cin, cout, kernels) in enumerate(
                [(mid, mid, (3, 1, 3)), (mid, wide, (3, 1, 3)), (wide, wide, (1, 1, 1))],
                start=1):
            for i, k in enumerate(kernels, start=1):
                self.add_module(f"res{b}_conv{i}", Conv(cin if i == 1 else cout, cout, k))
        if not tiny:
            self.res2_skip = Conv(mid, wide, 1)
        self.fc1 = Conv(wide, wide, 1)
        self.fc2 = Conv(wide, wide, 1)
        self.fc3 = Conv(wide, 3, 1)
        mean = [0.0] * 3 if mean_init is None else list(mean_init)
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32))

    def _stage(self, res, b: int):
        x = res
        for i in range(1, 4):
            x = torch.relu(getattr(self, f"res{b}_conv{i}")(x))
        if b == 2 and not self.tiny:
            res = self.res2_skip(res)
        return res + x

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(1, 5):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        for b in range(1, 4):
            x = self._stage(x, b)
        sc = torch.relu(self.fc1(x))
        sc = torch.relu(self.fc2(sc))
        sc = self.fc3(sc)
        return sc.to(torch.promote_types(sc.dtype, torch.float32)) + self.mean
