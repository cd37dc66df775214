"""TransPose encoder/decoder FCN, NHWC in and out (counterpart of
`crossloc_tpu/models/transpose_net.py`): one encoder (`num_mlr=0`) or
`num_mlr` encoder towers merged by the MLR blocks (CrossLoc's finetuned
decoder over mid-level representations).

Output: [B, H/8, W/8, task + pos] in float32 (float64 for a float64 net), or [B, H, W, task + pos] with
`full_size_output` (the DUC head: 8x pixel shuffle, then a bilinear resize
to the input's size); the last `num_pos_channel` channels pass through
exp(clip(x, -16.10, 13.82)) into [1e-7, 1e6]. The
per-scene output `mean` is a buffer, stored twice in the state dict like the
reference (`decoder.mean` and the top-level `mean`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import (
    Conv,
    DenseUpsamplingConv,
    GroupNorm,
    MLRConcatenator,
    MLRSkip,
    ResBlock,
    bilinear_resize,
    conv_gn,
    conv_norm_pair,
)

OUTPUT_SUBSAMPLE = 8


def _widths(tiny: bool):
    """(mid, wide) channel counts: 256/512 normally, 128/128 for tiny."""
    return (128, 128) if tiny else (256, 512)


def _add_pair(module: nn.Module, conv_name: str, norm_name: str, *args) -> None:
    conv, norm = conv_norm_pair(*args)
    module.add_module(conv_name, conv)
    module.add_module(norm_name, norm)


class TransPoseEncoder(nn.Module):
    """Strided conv stem + two residual stages + `enc_add_res_block` blocks:
    [B, H, W, in_ch] -> [B, H/8, W/8, wide]."""

    def __init__(self, in_ch: int = 3, tiny: bool = False, enc_add_res_block: int = 2,
                 num_groups: int = 32):
        super().__init__()
        mid, wide = _widths(tiny)
        g = num_groups
        self.tiny = tiny
        self.enc_add_res_block = enc_add_res_block
        stems = [(in_ch, g, 1), (g, 64, 2), (64, 128, 2), (128, mid, 2)]
        for i, (cin, cout, s) in enumerate(stems, start=1):
            _add_pair(self, f"conv{i}", f"norm{i}", cin, cout, 3, s, g)
        for i, k in enumerate((3, 1, 3), start=1):
            _add_pair(self, f"res1_conv{i}", f"res1_norm{i}", mid, mid, k, 1, g)
        for i, k in enumerate((3, 1, 3), start=1):
            _add_pair(self, f"res2_conv{i}", f"res2_norm{i}", mid if i == 1 else wide, wide, k,
                      1, g)
        if not tiny:
            _add_pair(self, "res2_skip", "res2_skip_norm", mid, wide, 1, 1, g)
        for k in range(1, enc_add_res_block + 1):
            self.add_module(f"enc_add_res_block{k}", ResBlock(wide, g))

    def _cgn(self, x, conv: str, norm: str, relu: bool = True):
        return conv_gn(x, getattr(self, conv), getattr(self, norm), relu)

    def forward(self, x):
        for i in range(1, 5):
            x = self._cgn(x, f"conv{i}", f"norm{i}")
        res = x
        for i in range(1, 4):
            x = self._cgn(x, f"res1_conv{i}", f"res1_norm{i}")
        res = torch.relu(res + x)
        x = res
        for i in range(1, 4):
            x = self._cgn(x, f"res2_conv{i}", f"res2_norm{i}")
        if not self.tiny:
            res = self._cgn(res, "res2_skip", "res2_skip_norm", relu=False)
        res = torch.relu(res + x)
        for k in range(1, self.enc_add_res_block + 1):
            res = torch.relu(res + getattr(self, f"enc_add_res_block{k}")(res))
        return res


class TransPoseDecoder(nn.Module):
    """Residual blocks + 1x1 residual stage + fc head (+ the DUC head with
    `full_size_output`, before `fc3`); `mean` is a buffer of length
    num_task_channel added to the task channels. `spatial` (set by
    `parallel.spatialize`) refuses a DUC resize that is not the identity."""

    spatial = None  # this rank's SpatialShard, or None (unsharded)

    def __init__(self, num_task_channel: int = 3, num_pos_channel: int = 1, tiny: bool = False,
                 dec_add_res_block: int = 2, num_groups: int = 32,
                 mean_init: Optional[Sequence[float]] = None, full_size_output: bool = False):
        super().__init__()
        _, wide = _widths(tiny)
        g = num_groups
        self.num_task_channel = num_task_channel
        self.num_pos_channel = num_pos_channel
        self.dec_add_res_block = dec_add_res_block
        mean = [0.0] * num_task_channel if mean_init is None else list(mean_init)
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32))
        for k in range(1, dec_add_res_block + 1):
            self.add_module(f"dec_add_res_block{k}", ResBlock(wide, g))
        for i in range(1, 4):
            _add_pair(self, f"res3_conv{i}", f"res3_norm{i}", wide, wide, 1, 1, g)
        _add_pair(self, "fc1", "fc1_norm", wide, wide, 1, 1, g)
        _add_pair(self, "fc2", "fc2_norm", wide, wide, 1, 1, g)
        out_ch = num_task_channel + num_pos_channel
        self.full_size_output = full_size_output
        if full_size_output:
            self.duc_upsample = DenseUpsamplingConv(wide, OUTPUT_SUBSAMPLE, out_ch, g)
        self.fc3 = Conv(out_ch if full_size_output else wide, out_ch, 1)

    def forward(self, x, up_hw=None):
        """`up_hw` (H, W): the size the DUC output is resized to."""
        res = x
        for k in range(1, self.dec_add_res_block + 1):
            res = torch.relu(res + getattr(self, f"dec_add_res_block{k}")(res))
        x = res
        for i in range(1, 4):
            x = conv_gn(x, getattr(self, f"res3_conv{i}"), getattr(self, f"res3_norm{i}"), True)
        res = torch.relu(res + x)
        sc = conv_gn(res, self.fc1, self.fc1_norm, True)
        sc = conv_gn(sc, self.fc2, self.fc2_norm, True)
        if self.full_size_output:
            sc = self.duc_upsample(sc)
            if up_hw is not None:
                sc = bilinear_resize(sc, *up_hw, spatial=self.spatial)
        sc = self.fc3(sc)
        sc = sc.to(torch.promote_types(sc.dtype, torch.float32))  # bf16 -> f32, f64 stays
        task = sc[..., : self.num_task_channel] + self.mean
        if self.num_pos_channel:
            pos = torch.exp(torch.clamp(sc[..., self.num_task_channel:], -16.10, 13.82))
            return torch.cat([task, pos], dim=-1)
        return task


class TransPoseNet(nn.Module):
    """Encoder -> decoder, or with `num_mlr > 0` that many encoder towers
    (`mlr_encoder_{i}`) whose outputs are concatenated on the channel axis
    and merged, `relu(mlr_skip(m) + mlr_forward(mlr_norm(m)))`, before the
    decoder. Towers from index `num_unfrozen_encoder` on are frozen: their
    parameters do not require grad and they run under `torch.no_grad()`, so
    they build no graph and keep no statistics for the backward (the JAX
    package's `stop_gradient` on their activations).

    `dtype` is the compute dtype of the convs and norms (float32 or
    bfloat16); norm statistics, params and the output stay float32. A
    float64 net (`net.double()`, `dtype` float64) computes and outputs
    float64: the reference of the gradient checks.
    `full_size_output` adds the DUC head and a full-size output.
    `stem_s2d` is accepted for flag compatibility: it is an exact re-layout
    of stems 1+2 in the JAX package, and the port computes the standard
    stems."""

    def __init__(self, num_task_channel: int = 3, num_pos_channel: int = 1, tiny: bool = False,
                 grayscale: bool = False, enc_add_res_block: int = 2, dec_add_res_block: int = 2,
                 num_groups: int = 32, num_mlr: int = 0, num_unfrozen_encoder: int = 0,
                 full_size_output: bool = False, mean_init: Optional[Sequence[float]] = None,
                 dtype: torch.dtype = torch.float32, stem_s2d: bool = False):
        super().__init__()
        _, wide = _widths(tiny)
        self.num_task_channel = num_task_channel
        self.tiny = tiny
        self.enc_add_res_block = enc_add_res_block
        self.dec_add_res_block = dec_add_res_block
        self.num_mlr = num_mlr
        self.num_unfrozen_encoder = num_unfrozen_encoder
        self.full_size_output = full_size_output
        self.dtype = dtype
        in_ch = 1 if grayscale else 3
        if num_mlr == 0:
            self.encoder = TransPoseEncoder(in_ch, tiny, enc_add_res_block, num_groups)
        else:
            for i in range(1, num_mlr + 1):
                tower = TransPoseEncoder(in_ch, tiny, enc_add_res_block, num_groups)
                self.add_module(f"mlr_encoder_{i}", tower.requires_grad_(i <= num_unfrozen_encoder))
            cat = wide * num_mlr
            self.mlr_skip = MLRSkip(cat, wide, num_groups)
            self.mlr_norm = GroupNorm(min(num_groups, cat), cat)
            self.mlr_forward = MLRConcatenator(cat, wide, num_groups)
        self.decoder = TransPoseDecoder(num_task_channel, num_pos_channel, tiny,
                                        dec_add_res_block, num_groups, mean_init,
                                        full_size_output)
        # top-level duplicate of decoder.mean, as in the reference state dict
        self.register_buffer("mean", self.decoder.mean.clone())

    def towers(self):
        """The MLR encoder towers, in order."""
        return [getattr(self, f"mlr_encoder_{i}") for i in range(1, self.num_mlr + 1)]

    def forward(self, x):
        """[B, H, W, C] images -> [B, H/8, W/8, task + pos] float32 (full
        size: [B, H, W, task + pos])."""
        up_hw = (x.shape[1], x.shape[2]) if self.full_size_output else None
        x = x.to(self.dtype)
        if self.num_mlr == 0:
            return self.decoder(self.encoder(x), up_hw)
        acts = []
        for i, tower in enumerate(self.towers()):
            with torch.set_grad_enabled(torch.is_grad_enabled() and i < self.num_unfrozen_encoder):
                acts.append(tower(x))
        mlr = torch.cat(acts, dim=-1)  # [B, h, w, wide * num_mlr], contiguous NHWC
        res = self.mlr_skip(mlr)
        mlr = self.mlr_forward(self.mlr_norm(mlr, relu=False))
        return self.decoder(torch.relu(res + mlr), up_hw)


class _ConvGN(nn.Module):
    """Conv -> GroupNorm -> ReLU under the keys `conv` / `norm` (the JAX
    package's `ConvGN` with relu=True)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, num_groups: int):
        super().__init__()
        self.conv, self.norm = conv_norm_pair(in_ch, out_ch, kernel, stride, num_groups)

    def forward(self, x):
        return conv_gn(x, self.conv, self.norm, relu=True)


class ProjHead(nn.Module):
    """Strided projection head to a global-average-pooled feature vector
    (`crossloc_tpu/models/transpose_net.py:233-253`; the reference defines it
    and uses it nowhere): three stride-2 3x3 Conv->GN->ReLU to `wide`, one
    1x1 Conv->GN->ReLU to `out_length`, the mean over H and W.
    [B, h, w, in_ch] -> [B, out_length] float32 (float64 for a float64 head).
    `in_ch` defaults to `wide`, the encoder's output; `dtype` is the compute
    dtype of the convs and norms. Keys `proj{1..4}.conv` / `.norm`."""

    def __init__(self, out_length: int = 2048, tiny: bool = False, num_groups: int = 32,
                 in_ch: Optional[int] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        _, wide = _widths(tiny)
        self.dtype = dtype
        cin = wide if in_ch is None else in_ch
        for i in range(1, 4):
            self.add_module(f"proj{i}", _ConvGN(cin if i == 1 else wide, wide, 3, 2, num_groups))
        self.proj4 = _ConvGN(wide, out_length, 1, 1, num_groups)

    def forward(self, x):
        x = x.to(self.dtype)
        for i in range(1, 5):
            x = getattr(self, f"proj{i}")(x)
        out = x.mean(dim=(1, 2))
        return out.to(torch.promote_types(out.dtype, torch.float32))


def task_channels(task: str) -> int:
    """coord 3, normal 2, depth 1, semantics 6."""
    table = {"coord": 3, "normal": 2, "depth": 1, "semantics": 6}
    if task not in table:
        raise NotImplementedError(f"task={task}")
    return table[task]


def build_network(task: str, uncertainty: Optional[str] = None, tiny: bool = False,
                  grayscale: bool = False, fullsize: bool = False, num_mlr: int = 0,
                  num_unfrozen_encoder: int = 0, mean: Optional[Sequence[float]] = None,
                  dtype: torch.dtype = torch.float32, stem_s2d: bool = False) -> TransPoseNet:
    """`config_network` factory: enc/dec_add_res_block=2, +1 positive
    channel iff MLE uncertainty; `num_mlr` towers of which the first
    `num_unfrozen_encoder` train."""
    if uncertainty not in (None, "MLE"):
        raise NotImplementedError(f"uncertainty={uncertainty}")
    if task == "semantics" and uncertainty is not None:
        raise NotImplementedError("semantics has no uncertainty head")
    if task == "semantics" and not fullsize:
        raise NotImplementedError("semantics requires fullsize output")
    return TransPoseNet(
        num_task_channel=task_channels(task),
        num_pos_channel=0 if uncertainty is None else 1,
        tiny=tiny,
        grayscale=grayscale,
        num_mlr=num_mlr,
        num_unfrozen_encoder=num_unfrozen_encoder,
        full_size_output=fullsize,
        mean_init=mean,
        dtype=dtype,
        stem_s2d=stem_s2d,
    )


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: conv kernels normal with variance 1/fan_in,
    zero biases; norms keep their unit/zero affine."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator) * fan_in**-0.5
                m.weight.copy_(w)
                m.bias.zero_()
    return model
