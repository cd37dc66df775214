"""The "spatial" axis: an image's rows split over the ranks of one group,
the halo exchange its 3x3 convs need and the GroupNorm whose statistics
span the group (the counterpart of what XLA SPMD inserts for
`crossloc_tpu/parallel/mesh.py`'s height sharding).

Each rank of a spatial group holds an equal, even block of every image's
rows, in rank order from the top (`mesh.shard_batch` checks the height).
A conv that reads across the block's edge needs its neighbours' rows:

  * a 3x3 stride-1 conv (padding 1) reads one row above and one below;
  * a 3x3 stride-2 conv reads one row above only: an even block starting
    at an even row never reaches the row below its last;
  * a 1x1 conv reads nothing beyond its own rows.

The first and last shards take zeros for the rows beyond the image, as the
unsharded conv's padding does. The backward sends each halo row's gradient
back to the rank that owns the row, which adds it to its own.

A GroupNorm's per-(image, group) statistics span the group's blocks:
`group_norm_relu_spatial` runs the cross-shard entries of `ops` (the
kernels on CUDA tensors, their twins on CPU tensors) and all-gathers
between them, the shards' (count, mean, M2) in the forward and their
per-channel sums in the backward.

Transport: two ranks sharing one card run gloo (NCCL refuses them), and
gloo's point-to-point does not take CUDA tensors: an `isend` of one
aborted the sending process on an H100 machine (SIGABRT; its peer saw the
connection close). So the halos go through `all_gather_into_tensor`, a
collective gloo takes on CUDA tensors as NCCL does: every rank contributes
its first and last rows, and each takes its neighbours' from the gathered
stack. That moves S x 2 rows where point-to-point would move 2, which at
one row of an image is small.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch import nn

from ..ops import (
    group_norm_shard_apply,
    group_norm_shard_backward_apply,
    group_norm_shard_backward_sums,
    group_norm_shard_stats,
)


class SpatialShard(NamedTuple):
    """Where this rank's rows sit in the image."""

    group: Any  # process group of the ranks that hold one image's rows
    index: int  # this rank's block, counted from the top
    count: int  # blocks per image


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """[S, *t.shape]: every rank's `t` of `group`, in rank order."""
    size = dist.get_world_size(group)
    out = t.new_empty(size * t.numel())
    dist.all_gather_into_tensor(out, t.reshape(-1).contiguous(), group=group)
    return out.view((size,) + tuple(t.shape))


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard: SpatialShard, below: bool):
        ctx.shard, ctx.below = shard, below
        edges = all_gather_stack(torch.stack([x[:, 0], x[:, -1]]), shard.group)  # [S, 2, B, W, C]
        s, S = shard.index, shard.count
        zero = torch.zeros_like(x[:, :1])
        parts = [edges[s - 1, 1].unsqueeze(1) if s > 0 else zero, x]
        if below:
            parts.append(edges[s + 1, 0].unsqueeze(1) if s < S - 1 else zero)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        s, S = ctx.shard.index, ctx.shard.count
        h = g.shape[1] - (2 if ctx.below else 1)
        above = g[:, 0]
        below = g[:, -1] if ctx.below else torch.zeros_like(above)
        back = all_gather_stack(torch.stack([above, below]), ctx.shard.group)  # [S, 2, B, W, C]
        dx = g[:, 1:1 + h].clone()
        if s > 0:  # the rank above read this block's first row as its halo below
            dx[:, 0] += back[s - 1, 1]
        if s < S - 1:  # the rank below read this block's last row as its halo above
            dx[:, -1] += back[s + 1, 0]
        return dx, None, None


def halo_rows(x: torch.Tensor, shard: SpatialShard, below: bool = True) -> torch.Tensor:
    """NHWC `x` [B, h, W, C] with the row above its block (and, with
    `below`, the row under it) from the neighbouring ranks, zeros at the
    image's edges: [B, h + 1 (+ 1), W, C]. Every rank of the group calls it."""
    return _Halo.apply(x, shard, below)


def _norm_forward(x, scale, bias, groups: int, eps: float, relu: bool, shard: SpatialShard):
    gathered = all_gather_stack(group_norm_shard_stats(x, groups), shard.group)
    return group_norm_shard_apply(x, scale, bias, gathered, groups, eps, relu)


class _GroupNormReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, relu, shard):
        y, stats = _norm_forward(x, scale, bias, groups, eps, relu, shard)
        ctx.cfg = (groups, relu, shard)
        ctx.save_for_backward(x, scale, bias, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, stats = ctx.saved_tensors
        groups, relu, shard = ctx.cfg
        dy = dy.contiguous()
        sums = group_norm_shard_backward_sums(x, scale, bias, stats, dy, groups, relu)
        gathered = all_gather_stack(sums, shard.group)
        count_hw = shard.count * x.shape[1] * x.shape[2]  # equal blocks (mesh.shard_batch)
        grads = group_norm_shard_backward_apply(x, scale, bias, stats, dy, gathered, shard.index,
                                                groups, count_hw, relu)
        return (*grads, None, None, None, None)


def group_norm_relu_spatial(x, scale, bias, groups: int, eps: float, relu: bool,
                            shard: SpatialShard):
    """`ops.group_norm_relu` of an image whose rows are split over the ranks
    of `shard.group` in equal blocks, `x` [B, h, W, C] being this rank's:
    the statistics are those of the whole image. Every rank of the group
    calls it; the forward and the backward each all-gather once, between
    the two cross-shard `ops` entries of their direction. CUDA tensors
    launch the cross-shard kernels, CPU tensors take their twins; nothing
    falls back."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or bias.requires_grad):
        return _GroupNormReLU.apply(x, scale, bias, groups, eps, relu, shard)
    return _norm_forward(x, scale, bias, groups, eps, relu, shard)[0]


def spatialize(module: nn.Module, shard: SpatialShard) -> nn.Module:
    """Put `shard` on every submodule that declares a `spatial` attribute
    (the port's `Conv`, `GroupNorm` and decoder): from then on they compute
    on this rank's block of rows. Parameters and state-dict keys stay as
    they are. `None` undoes it. Returns `module`."""
    for m in module.modules():
        if hasattr(type(m), "spatial"):
            m.spatial = shard
    return module
