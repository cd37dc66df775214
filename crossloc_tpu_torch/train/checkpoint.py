"""Full-state checkpoints: weights, Adam moments and the update count
(counterpart of `crossloc_tpu/train/checkpoint.py`).

The `.net` weight file stays the interoperable artifact; the full state is
for an exact resume. It is kept by name (`train_state_dict`), so a file
written by one rank count loads at another, with or without ZeRO. Two
backends behind one manager:

  * "msgpack": one `torch.save` file `state_{step:09d}.state` written by
    rank 0 (the JAX package writes flax msgpack under this name; the two
    packages do not read each other's files). Under ZeRO every rank joins
    the all-gather that assembles it.
  * "orbax": `torch.distributed.checkpoint` (DCP) writes `<directory>/<step>/`,
    the layout orbax gives the JAX package; the files are DCP's own, not
    orbax's. Save and restore are collectives every rank enters: under ZeRO
    each rank writes its own shard of the sharded tensors, and a restore
    re-shards them to the ranks of the run that reads them. The ranks share
    the directory. It works in a single process too.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..parallel import barrier, topology
from .step import TrainState

STATE_SUFFIX = ".state"


def _named_moments(state: TrainState):
    """(name, optimizer tensor) of every unsharded tensor Adam updates: the
    model's trainable parameters by name, matched to Adam's in order (as
    `Optimizer.load_state_dict` matches them); under ZeRO the replicated
    ones."""
    dp = state.parallel
    if dp is not None and dp.shard is not None:
        return list(dp.replicated)
    names = [n for n, p in state.model.named_parameters() if p.requires_grad]
    params = [p for g in state.optimizer.adam.param_groups for p in g["params"]]
    if len(names) != len(params):
        raise ValueError(f"Adam holds {len(params)} tensors, the model trains {len(names)}")
    return list(zip(names, params))


def _ensure_moments(state: TrainState) -> None:
    """Adam's per-parameter state, zero before the first update."""
    adam = state.optimizer.adam
    for group in adam.param_groups:
        for p in group["params"]:
            if not adam.state[p]:
                adam.state[p] = {"step": torch.tensor(0.0),
                                 "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                                 "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}


def _sharded_dtensors(state: TrainState, flats: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """key -> {name: DTensor of this rank's rows} of each flat ZeRO tensor."""
    from torch.distributed.tensor import DTensor, Shard

    dp = state.parallel
    mesh = dp.device_mesh()
    out = {}
    for key, flat in flats.items():
        views = dp.shard_views(flat.detach())
        out[key] = {name: DTensor.from_local(views[name], mesh, [Shard(0)], run_check=False,
                                             shape=shape, stride=_contiguous_stride(shape))
                    for (name, _), (shape, _) in zip(dp.sharded, dp._layout)}
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return tuple(reversed(stride))


def train_state_dict(state: TrainState, full: bool = True) -> Dict[str, Any]:
    """The state by name: "model" (every parameter and buffer), "exp_avg" and
    "exp_avg_sq" (Adam's moments of each trainable parameter), "adam_step"
    and "step". The tensors are the live ones, so loading into this dict
    loads the state. Under ZeRO the sharded tensors are, with `full`, the
    all-gathered whole (a collective every rank joins; copies), else
    DTensors of this rank's rows (what DCP writes and re-shards)."""
    _ensure_moments(state)
    adam = state.optimizer.adam
    dp = state.parallel
    sharded = dp is not None and dp.shard is not None
    model = {k: v for k, v in state.model.state_dict(keep_vars=False).items()}
    moments = {"exp_avg": {}, "exp_avg_sq": {}}
    for name, p in _named_moments(state):
        for key in moments:
            moments[key][name] = adam.state[p][key]
    if sharded:
        flats = {"model": dp.shard, "exp_avg": adam.state[dp.shard]["exp_avg"],
                 "exp_avg_sq": adam.state[dp.shard]["exp_avg_sq"]}
        if full:
            parts = {k: dp.full_tensors(f) for k, f in flats.items()}
        else:
            parts = _sharded_dtensors(state, flats)
        model.update(parts["model"])
        moments["exp_avg"].update(parts["exp_avg"])
        moments["exp_avg_sq"].update(parts["exp_avg_sq"])
    first = next(iter(adam.state.values()))
    return {"model": model, **moments, "adam_step": first["step"],
            "step": torch.tensor(state.step, dtype=torch.int64)}


@torch.no_grad()
def load_train_state_dict(state: TrainState, sd: Dict[str, Any]) -> TrainState:
    """Copy a `train_state_dict` of any rank count (whole tensors, or this
    rank's DTensor rows) into `state` in place; returns it."""
    _ensure_moments(state)
    adam = state.optimizer.adam
    dp = state.parallel
    sharded = {n for n, _ in dp.sharded} if dp is not None and dp.shard is not None else set()

    def rows(t):
        return t.to_local() if hasattr(t, "to_local") else t

    live = state.model.state_dict(keep_vars=True)
    for name, t in sd["model"].items():
        if name not in sharded:
            live[name].data.copy_(rows(t))
    for name, p in _named_moments(state):
        for key in ("exp_avg", "exp_avg_sq"):
            adam.state[p][key].copy_(rows(sd[key][name]))
    if sharded:
        for key, flat in (("model", dp.shard), ("exp_avg", adam.state[dp.shard]["exp_avg"]),
                          ("exp_avg_sq", adam.state[dp.shard]["exp_avg_sq"])):
            views = dp.shard_views(flat)
            for name, view in views.items():
                t = rows(sd[key][name])
                if t.shape != view.shape:  # a whole tensor: take this rank's rows
                    t = t.reshape(dp.world, -1)[dp.rank].view(view.shape)
                view.copy_(t)
    step = float(sd["adam_step"])
    for s in adam.state.values():
        s["step"] = torch.tensor(step)
    state.step = int(sd["step"])
    return state


def save_train_state(path: str, state: TrainState) -> str:
    """Write the whole state to `<path>.state` from rank 0, atomically (a
    crash never leaves a torn file). Under ZeRO every rank must call it."""
    out = path if path.endswith(STATE_SUFFIX) else path + STATE_SUFFIX
    sd = train_state_dict(state, full=True)
    if topology()[0] == 0:
        tmp = out + ".tmp"
        torch.save(sd, tmp)
        os.replace(tmp, out)
    return out


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Load a file of `save_train_state` into `state` in place (tensors
    move to the model's device); returns it."""
    src = path if path.endswith(STATE_SUFFIX) else path + STATE_SUFFIX
    return load_train_state_dict(state, torch.load(src, map_location="cpu", weights_only=True))


class CheckpointManager:
    """Full-state checkpoints in one directory: save at every call (once per
    step), keep the newest `keep` (module docstring for the backends)."""

    def __init__(self, directory: str, keep: int = 5, prefix: str = "state",
                 backend: str = "msgpack"):
        if backend not in ("msgpack", "orbax"):
            raise ValueError(f"unknown checkpoint backend: {backend!r}")
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        self.backend = backend
        self._last_saved_step: Optional[int] = None

    def _path(self, step: int) -> str:
        if self.backend == "orbax":
            return os.path.join(self.directory, str(step))
        return os.path.join(self.directory, f"{self.prefix}_{step:09d}{STATE_SUFFIX}")

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        steps = []
        for f in os.listdir(self.directory):
            if self.backend == "orbax":
                if f.isdigit() and os.path.exists(os.path.join(self.directory, f, ".metadata")):
                    steps.append(int(f))
            elif f.startswith(self.prefix + "_") and f.endswith(STATE_SUFFIX):
                try:
                    steps.append(int(f[len(self.prefix) + 1: -len(STATE_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(steps)

    def save(self, state: TrainState) -> str:
        """Save at `state.step` (once per step), then drop all but the newest.
        Every rank calls it."""
        step = state.step
        path = self._path(step)
        if self._last_saved_step == step:
            return path
        self._last_saved_step = step
        if self.backend == "msgpack":
            if topology()[0] == 0:
                os.makedirs(self.directory, exist_ok=True)
            save_train_state(path, state)
            if topology()[0] == 0:
                for old in self.all_steps()[: -self.keep]:
                    os.remove(self._path(old))
            return path
        import torch.distributed.checkpoint as dcp

        tmp = path + ".tmp"
        if topology()[0] == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        barrier()
        dcp.save(train_state_dict(state, full=False), checkpoint_id=tmp)
        barrier()
        if topology()[0] == 0:
            shutil.rmtree(path, ignore_errors=True)
            os.replace(tmp, path)
            for old in self.all_steps()[: -self.keep]:
                shutil.rmtree(self._path(old))
        barrier()
        return path

    def flush(self) -> None:
        """Saves are synchronous: nothing is in flight when `save` returns."""

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        """Load the newest checkpoint into `state` in place; None when there
        is none. Every rank calls it; rank 0's listing decides the step."""
        steps = [self.all_steps()]
        if topology()[1] > 1:
            dist.broadcast_object_list(steps, src=0)
        if not steps[0]:
            return None
        path = self._path(steps[0][-1])
        if self.backend == "msgpack":
            return load_train_state(path, state)
        import torch.distributed.checkpoint as dcp

        sd = train_state_dict(state, full=False)
        dcp.load(sd, checkpoint_id=path)
        return load_train_state_dict(state, sd)
