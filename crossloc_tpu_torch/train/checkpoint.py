"""Full-state checkpoints: weights, Adam moments and the update count
(counterpart of `crossloc_tpu/train/checkpoint.py`).

The `.net` weight file stays the interoperable artifact; `.state` is for an
exact resume. The JAX package writes flax msgpack under the backend name
"msgpack"; the port keeps that flag value and writes a `torch.save` file
instead (the two packages do not read each other's `.state` files).
"""
from __future__ import annotations

import os
from typing import List, Optional

import torch

from .step import TrainState

STATE_SUFFIX = ".state"
_ORBAX_TODO = "--ckpt_backend orbax is ROADMAP queue 1, item 13 (parallel)"


def save_train_state(path: str, state: TrainState) -> str:
    """Write model weights, Adam state and the step to `<path>.state`,
    atomically (a crash never leaves a torn file)."""
    out = path if path.endswith(STATE_SUFFIX) else path + STATE_SUFFIX
    payload = {"model": state.model.state_dict(), "adam": state.optimizer.adam.state_dict(),
               "step": state.step}
    tmp = out + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)
    return out


def load_train_state(path: str, state: TrainState) -> TrainState:
    """Load a file of `save_train_state` into `state` in place (tensors
    move to the model's device); returns it."""
    src = path if path.endswith(STATE_SUFFIX) else path + STATE_SUFFIX
    payload = torch.load(src, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.adam.load_state_dict(payload["adam"])
    state.step = int(payload["step"])
    return state


class CheckpointManager:
    """Full-state checkpoints `state_{step:09d}.state` in one directory:
    save at every call, keep the newest `keep`."""

    def __init__(self, directory: str, keep: int = 5, prefix: str = "state",
                 backend: str = "msgpack"):
        if backend == "orbax":
            raise NotImplementedError(_ORBAX_TODO)
        if backend != "msgpack":
            raise ValueError(f"unknown checkpoint backend: {backend!r}")
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        self.backend = backend
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:09d}{STATE_SUFFIX}")

    def all_steps(self) -> List[int]:
        steps = []
        for f in os.listdir(self.directory):
            if f.startswith(self.prefix + "_") and f.endswith(STATE_SUFFIX):
                try:
                    steps.append(int(f[len(self.prefix) + 1: -len(STATE_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(steps)

    def save(self, state: TrainState) -> str:
        """Save at `state.step` (once per step), then drop all but the newest."""
        steps = self.all_steps()
        if steps and steps[-1] == state.step:
            return self._path(state.step)
        path = save_train_state(self._path(state.step), state)
        for old in self.all_steps()[: -self.keep]:
            os.remove(self._path(old))
        return path

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        steps = self.all_steps()
        if not steps:
            return None
        return load_train_state(self._path(steps[-1]), state)
