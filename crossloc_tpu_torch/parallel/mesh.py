"""Data parallelism and ZeRO over the default process group (counterpart of
`crossloc_tpu/parallel/mesh.py`: `replicate`, `param_spec`, `shard_params`
and `gather_tree` on its "data" axis).

  * DP: rank 0's weights are broadcast, every rank runs the forward and the
    backward on its own slice of the global batch (`data.Loader(shard=)`),
    and one all-reduce averages the gradients after the backward. Every
    loss of the port is a mean over images of equal count per rank, so the
    average is the global batch's gradient. Frozen parameters (the MLR
    net's towers) take no part.
  * ZeRO (`zero=True`): JAX's rule decides what is sharded (`param_spec`):
    a trainable tensor whose out-channel count, dim 0 of torch's OIHW and
    [C] tensors, is a multiple of 32 is split on that dim; the rest is
    replicated. Each rank keeps its rows of every sharded tensor in one flat
    tensor, which is what Adam updates, so parameters and Adam moments are
    sharded at rest. `gather` all-gathers the whole net before the forward,
    `reduce_gradients` reduce-scatters and averages the gradients into the
    shard after the backward, and `release` frees the full tensors after
    the update. The JAX package gathers per layer through GSPMD.

Only the "data" axis is here; the "spatial" (image height) and "model" axes
are ROADMAP item 16.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .distributed import topology


def param_spec(params: Sequence[torch.Tensor], world: int, axis: str = "data") -> List[bool]:
    """Whether each tensor is sharded over `world` ranks: its dim 0 (the
    out-channels) is a multiple of 32, so GroupNorm's 32 groups stay whole
    on a rank whenever `world` divides 32, which is checked."""
    if 32 % world != 0:
        raise ValueError(f"{axis}={world} must divide 32 (GroupNorm groups)")
    return [p.dim() > 0 and p.shape[0] % 32 == 0 for p in params]


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[torch.dtype, List[torch.Tensor]]:
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


@torch.no_grad()
def replicate(module: nn.Module, src: int = 0) -> None:
    """Broadcast rank `src`'s parameters and buffers to every rank, in place
    (one broadcast per dtype)."""
    for ts in _by_dtype(list(module.parameters()) + list(module.buffers())).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src)
        off = 0
        for t in ts:
            t.copy_(flat[off: off + t.numel()].view(t.shape))
            off += t.numel()


def all_gather_cat(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's `t` concatenated along `dim` in rank order (JAX's
    `all_gather(..., tiled=True)`)."""
    world = topology()[1]
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim)


class DataParallel:
    """The gradient exchange of one model over the default process group
    (module docstring). Build it after the model is on its device; pass
    `update_params()` to the optimizer."""

    def __init__(self, model: nn.Module, zero: bool = False):
        self.rank, self.world = topology()
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        spec = (param_spec([p for _, p in named], self.world) if zero
                else [False] * len(named))
        replicate(model)
        self.zero = zero
        self.sharded = [np for np, s in zip(named, spec) if s]
        self.replicated = [np for np, s in zip(named, spec) if not s]
        self._layout = [(p.shape, p.stride()) for _, p in self.sharded]
        self.shard = None
        self._mesh = None
        if self.sharded:
            with torch.no_grad():
                self.shard = torch.cat([p.reshape(self.world, -1)[self.rank]
                                        for _, p in self.sharded])
            self.shard.requires_grad_(True)
            self.release()

    def device_mesh(self):
        """The 1-D DeviceMesh of the ranks (DTensor's view of the shards)."""
        if self._mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            self._mesh = init_device_mesh(self.shard.device.type, (self.world,))
        return self._mesh

    def update_params(self) -> List[torch.Tensor]:
        """What the optimizer updates: the flat shard (first) and the
        replicated trainable parameters."""
        return ([self.shard] if self.shard is not None else []) + [p for _, p in self.replicated]

    def shard_views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Name -> this rank's rows [C / world, ...] of each sharded tensor,
        as views of `flat` (the shard or one of its Adam moments)."""
        out, off = {}, 0
        for (name, _), (shape, _) in zip(self.sharded, self._layout):
            rows = (shape[0] // self.world,) + tuple(shape[1:])
            n = int(torch.Size(rows).numel())
            out[name] = flat[off: off + n].view(rows)
            off += n
        return out

    def full_tensors(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Name -> the whole of each sharded tensor, all-gathered from every
        rank's `flat` (a collective every rank joins)."""
        buf = flat.new_empty(self.world * flat.numel())
        dist.all_gather_into_tensor(buf, flat.detach().contiguous())
        buf = buf.view(self.world, -1)
        out, off = {}, 0
        for (name, _), (shape, _) in zip(self.sharded, self._layout):
            n = shape.numel() // self.world
            out[name] = buf[:, off: off + n].reshape(shape)
            off += n
        return out

    @torch.no_grad()
    def gather(self) -> None:
        """ZeRO: all-gather the shards into the model's full parameters."""
        if self.shard is None:
            return
        full = self.full_tensors(self.shard)
        for (name, p), (shape, stride) in zip(self.sharded, self._layout):
            p.data = torch.empty_strided(shape, stride, dtype=p.dtype, device=p.device)
            p.data.copy_(full[name])

    def release(self) -> None:
        """ZeRO: free the full sharded parameters (the shard holds them)."""
        for _, p in self.sharded:
            p.data = p.data.new_empty(0)
            p.grad = None

    @contextlib.contextmanager
    def materialized(self):
        """The full parameters inside the block (every rank enters it)."""
        self.gather()
        try:
            yield
        finally:
            self.release()

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Average the gradients over ranks after the backward: one
        all-reduce of the replicated parameters' gradients and, under ZeRO,
        one reduce-scatter of the sharded ones into the shard's gradient (a
        sharded tensor without a gradient contributes zeros)."""
        reps = [p for _, p in self.replicated if p.grad is not None]
        if reps:
            flat = torch.cat([p.grad.reshape(-1) for p in reps])
            dist.all_reduce(flat)
            flat /= self.world
            off = 0
            for p in reps:
                p.grad.copy_(flat[off: off + p.numel()].view(p.shape))
                off += p.numel()
        if self.shard is not None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for _, p in self.sharded]
            stacked = torch.cat([g.reshape(self.world, -1) for g in grads], dim=1)
            out = torch.empty_like(self.shard)
            dist.reduce_scatter_tensor(out, stacked.reshape(-1))
            self.shard.grad = out.div_(self.world)
            for _, p in self.sharded:
                p.grad = None

    def param_sum(self, per_param: List[torch.Tensor]) -> torch.Tensor:
        """The global sum of per-parameter values given in `update_params()`
        order: the shard's summed over ranks, each replicated parameter's
        counted once."""
        values = [v.float() for v in per_param]
        if self.shard is not None:
            values[0] = self.all_sum(values[0])
        return sum(values)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks (a new tensor)."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over ranks, in float32 or wider (a new tensor)."""
        return self.all_sum(t if t.is_floating_point() else t.float()) / self.world
