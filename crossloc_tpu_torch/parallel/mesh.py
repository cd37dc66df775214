"""The device mesh over the default process group: data parallelism, ZeRO,
and the "spatial" and "model" axes (counterpart of
`crossloc_tpu/parallel/mesh.py`: `make_mesh`, `shard_batch` with
`batch_spec`'s rule, `replicate`, `param_spec`, `shard_params` and
`gather_tree`).

The ranks are laid out as data x spatial x model, rank
((d * spatial) + s) * model + m, as JAX reshapes its device list:

  * "data": each data index takes its slice of the global batch. One
    all-reduce after the backward averages the gradients over every rank.
    Every loss of the port is a mean over pixels of equal count per rank,
    so the average is the global batch's gradient. Frozen parameters (the
    MLR net's towers) take no part.
  * "spatial": the ranks of one spatial column split every image's rows
    (`shard_batch(shard_spatial=True)`). The net's convs exchange halo rows
    and its norms merge their statistics over the column
    (`parallel/spatial.py`: `halo_rows`, `group_norm_relu_spatial`);
    parameters are replicated, and each rank's backward holds the gradient
    of its own rows, so the same all-reduce mean over every rank is again
    the global batch's gradient.
  * "model": parameters and Adam moments are sharded over the ranks of one
    model group by `param_spec`'s rule, replicated across the data groups;
    the batch spans ("data", "model"). Gradients are reduce-scattered in
    the model group and averaged over the data groups; the whole net is
    all-gathered for the forward and freed after the update, so at rest a
    rank holds only its rows.
  * ZeRO (`zero=True`) shards the same way over every rank: a trainable
    tensor whose out-channel count, dim 0 of torch's OIHW and [C] tensors,
    is a multiple of 32 is split on that dim; the rest is replicated. Each
    rank keeps its rows of every sharded tensor in one flat tensor, which is
    what Adam updates. `gather` all-gathers the whole net before the
    forward, `reduce_gradients` reduce-scatters and averages the gradients
    into the shard after the backward, and `release` frees the full tensors
    after the update. The JAX package gathers per layer through GSPMD.
    On a spatial mesh it shards over the data x spatial ranks, whose
    gradients the all-reduce averages alike.

`make_mesh` refuses spatial > 1 together with model > 1, as JAX's does.
JAX refuses that mesh because jax 0.9.0 miscompiles conv gradients on it;
torch has no such fault, but the JAX package then has no reference to hold
the port's mesh against, so the port refuses it too.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .distributed import topology
from .spatial import SpatialShard, all_gather_stack, spatialize

# fields of a batch that hold one value for the whole batch, not one per image
_WHOLE_FIELDS = ("pp_shift",)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the data x spatial x model layout of the default
    process group (`make_mesh`), with the process groups of its spatial
    column and of its model group, and the replica group of the ranks that
    hold the same model rows (None where the axis has size 1)."""

    data: int = 1
    spatial: int = 1
    model: int = 1
    rank: int = 0
    spatial_group: Any = None
    model_group: Any = None
    replica_group: Any = None

    @property
    def coords(self) -> Tuple[int, int, int]:
        """(data, spatial, model) index of this rank."""
        d, rest = divmod(self.rank, self.spatial * self.model)
        s, m = divmod(rest, self.model)
        return d, s, m

    @property
    def batch_shards(self) -> int:
        """The ranks the batch's N is split over: "data", or ("data", "model")."""
        return self.data * self.model

    @property
    def batch_index(self) -> int:
        d, _, m = self.coords
        return d * self.model + m

    @property
    def shard(self) -> Optional[SpatialShard]:
        """This rank's block of rows, or None without a spatial axis."""
        if self.spatial == 1:
            return None
        return SpatialShard(self.spatial_group, self.coords[1], self.spatial)


def mesh_shape(world: int, data: Optional[int] = None, spatial: int = 1,
               model: int = 1) -> Tuple[int, int, int]:
    """(data, spatial, model) of a mesh over `world` ranks, with
    `crossloc_tpu/parallel/mesh.py::make_mesh`'s checks: all ranks on "data"
    by default, spatial x model refused (module docstring), and `model`
    must divide GroupNorm's 32 groups."""
    if spatial > 1 and model > 1:
        raise ValueError(
            "spatial and model axes cannot be combined: the JAX package refuses this mesh "
            "(jax 0.9.0 miscompiles its conv gradients), so it has no reference to hold the "
            "port's against (see parallel/mesh.py docstring)")
    if min(spatial, model) < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh axes must be >= 1, got data={data} spatial={spatial} "
                         f"model={model}")
    if data is None:
        data = world // (spatial * model)
    if data * spatial * model != world:
        raise ValueError(f"mesh {data}x{spatial}x{model} != {world} devices")
    if 32 % model != 0:
        raise ValueError(f"model={model} must divide 32 (GroupNorm groups)")
    return data, spatial, model


def _own_group(rank_lists: Sequence[Sequence[int]], rank: int):
    """One process group per list of ranks, each created by every rank in
    the same order (`dist.new_group`'s rule); this rank's."""
    own = None
    for ranks in rank_lists:
        g = dist.new_group(list(ranks))
        if rank in ranks:
            own = g
    return own


def make_mesh(data: Optional[int] = None, spatial: int = 1, model: int = 1) -> Mesh:
    """The mesh over the default process group (one rank, outside one).
    Every rank calls it with the same arguments: it creates the spatial
    columns' and the model groups' process groups."""
    rank, world = topology()
    data, spatial, model = mesh_shape(world, data, spatial, model)
    groups = {}
    if spatial > 1:
        groups["spatial_group"] = _own_group(
            [range(d * spatial, (d + 1) * spatial) for d in range(data)], rank)
    if model > 1:
        groups["model_group"] = _own_group(
            [range(d * model, (d + 1) * model) for d in range(data)], rank)
        groups["replica_group"] = _own_group([range(m, world, model) for m in range(model)],
                                             rank)
    return Mesh(data, spatial, model, rank, **groups)


def shard_batch(mesh: Mesh, batch, shard_spatial: bool = False):
    """This rank's part of a global batch (a NamedTuple of tensors with an
    `images` field, such as `train.TrainBatch`): N over "data", or over
    ("data", "model") on a model mesh; with `shard_spatial`, the rows of
    every tensor of 4 or more dims (the images, and the labels' H/8 grid to
    match) over "spatial". Poses and focal stay whole per image; `pp_shift`
    and scalars stay whole. Refuses a spatial axis > 1 without
    `shard_spatial` (JAX's rule: an axis the batch does not span), a batch
    that does not split evenly, and an image height that is not a multiple
    of 8 x spatial: every shard must hold equal, even rows at every
    stride-2 layer."""
    if mesh.spatial > 1 and not shard_spatial:
        raise ValueError("shard_batch on a mesh with a spatial axis of size > 1 requires "
                         "shard_spatial=True: every mesh axis must be spanned by the batch")
    fields = batch._asdict()
    n, height = fields["images"].shape[0], fields["images"].shape[1]
    if n % mesh.batch_shards:
        raise ValueError(f"a global batch of {n} does not split over {mesh.batch_shards} ranks")
    if shard_spatial and height % (8 * mesh.spatial):
        raise ValueError(f"image height {height} is not a multiple of 8 x spatial = "
                         f"{8 * mesh.spatial}: every shard must hold equal, even rows at "
                         f"every stride-2 layer")
    per = n // mesh.batch_shards
    i, s = mesh.batch_index, mesh.coords[1]

    def take(name, t):
        if t is None or t.dim() == 0 or name in _WHOLE_FIELDS:
            return t
        t = t[i * per:(i + 1) * per]
        if shard_spatial and t.dim() >= 4:
            h = t.shape[1] // mesh.spatial
            t = t[:, s * h:(s + 1) * h]
        return t.contiguous()

    return type(batch)(**{k: take(k, v) for k, v in fields.items()})


def unshard_batch(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The global tensor from every rank's part of it, each laid out as
    `shard_batch` cut the images (N, then the rows over "spatial"): an
    all-gather over every rank, which every rank joins."""
    parts = all_gather_stack(t, None)
    S, M = mesh.spatial, mesh.model
    per_image = []
    for i in range(mesh.batch_shards):
        d, m = divmod(i, M)
        rows = [parts[(d * S + s) * M + m] for s in range(S)]
        per_image.append(torch.cat(rows, dim=1) if S > 1 else rows[0])
    return torch.cat(per_image, dim=0)


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
    laid out as `mesh` (module docstring; default: every rank on "data").
    Build it after the model is on its device; on a spatial mesh it puts
    the rank's block of rows on the model's layers (`spatialize`). Pass
    `update_params()` to the optimizer."""

    def __init__(self, model: nn.Module, zero: bool = False, mesh: Optional[Mesh] = None):
        self.rank, self.world = topology()
        self.mesh = mesh if mesh is not None else make_mesh()
        if zero and self.mesh.model > 1:
            raise ValueError("zero=True shards over 'data'; a mesh with a 'model' axis shards "
                             "over 'model' already")
        # the ranks a sharded tensor is split over, and the ranks that hold the same rows
        if self.mesh.model > 1:
            self.shards, self.shard_rank = self.mesh.model, self.mesh.coords[2]
            self.shard_group, self.replica_group = self.mesh.model_group, self.mesh.replica_group
        else:
            self.shards, self.shard_rank = self.world, self.rank
            self.shard_group = self.replica_group = None
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        axis = "model" if self.mesh.model > 1 else "data"
        spec = (param_spec([p for _, p in named], self.shards, axis)
                if zero or self.mesh.model > 1 else [False] * len(named))
        replicate(model)
        if self.mesh.shard is not None:
            spatialize(model, self.mesh.shard)
        self.zero = zero
        self.sharded = [np for np, s in zip(named, spec) if s]
        self.replicated = [np for np, s in zip(named, spec) if not s]
        self._layout = [(p.shape, p.stride()) for _, p in self.sharded]
        self.shard = None
        self._mesh = None
        if self.sharded:
            with torch.no_grad():
                self.shard = torch.cat([p.reshape(self.shards, -1)[self.shard_rank]
                                        for _, p in self.sharded])
            self.shard.requires_grad_(True)
            self.release()

    def device_mesh(self):
        """The 1-D DeviceMesh of the ranks (DTensor's view of the shards)."""
        if self.shard_group is not None:
            raise ValueError("a DeviceMesh of the shards spans every rank; on a 'model' mesh "
                             "the shards span one model group")
        if self._mesh is None:
            from torch.distributed.device_mesh import init_device_mesh

            self._mesh = init_device_mesh(self.shard.device.type, (self.world,))
        return self._mesh

    @property
    def spatial_block(self) -> Tuple[int, int]:
        """(index, count) of this rank's block of each image's rows."""
        return self.mesh.coords[1], self.mesh.spatial

    def update_params(self) -> List[torch.Tensor]:
        """What the optimizer updates: the flat shard (first) and the
        replicated trainable parameters."""
        return ([self.shard] if self.shard is not None else []) + [p for _, p in self.replicated]

    def shard_views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Name -> this rank's rows [C / world, ...] of each sharded tensor,
        as views of `flat` (the shard or one of its Adam moments)."""
        out, off = {}, 0
        for (name, _), (shape, _) in zip(self.sharded, self._layout):
            rows = (shape[0] // self.shards,) + tuple(shape[1:])
            n = int(torch.Size(rows).numel())
            out[name] = flat[off: off + n].view(rows)
            off += n
        return out

    def full_tensors(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Name -> the whole of each sharded tensor, all-gathered from the
        shard group's `flat`s (a collective every rank joins)."""
        buf = all_gather_stack(flat.detach(), self.shard_group)
        out, off = {}, 0
        for (name, _), (shape, _) in zip(self.sharded, self._layout):
            n = shape.numel() // self.shards
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
        all-reduce of the replicated parameters' gradients and, under ZeRO
        or on a model mesh, one reduce-scatter of the sharded ones into the
        shard's gradient over the shard group, then one all-reduce over the
        replica group (a sharded tensor without a gradient contributes
        zeros)."""
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
            stacked = torch.cat([g.reshape(self.shards, -1) for g in grads], dim=1)
            out = torch.empty_like(self.shard)
            dist.reduce_scatter_tensor(out, stacked.reshape(-1), group=self.shard_group)
            if self.replica_group is not None:
                dist.all_reduce(out, group=self.replica_group)
            self.shard.grad = out.div_(self.world)
            for _, p in self.sharded:
                p.grad = None

    def param_sum(self, per_param: List[torch.Tensor]) -> torch.Tensor:
        """The global sum of per-parameter values given in `update_params()`
        order: the shard's summed over the shard group, each replicated
        parameter's counted once."""
        values = [v.float() for v in per_param]
        if self.shard is not None:
            values[0] = values[0].detach().clone()
            dist.all_reduce(values[0], group=self.shard_group)
        return sum(values)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over ranks (a new tensor)."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def all_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean over ranks, in float32 or wider (a new tensor)."""
        return self.all_sum(t if t.is_floating_point() else t.float()) / self.world
