"""Sub-seeds of a run's `--seed`: one independent stream per purpose."""
from __future__ import annotations

import zlib

import numpy as np


def _words(seed: int, tags) -> list:
    out = [int(seed) % (1 << 64)]
    for t in tags:
        out.append(zlib.crc32(t.encode()) if isinstance(t, str) else int(t) % (1 << 64))
    return out


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for (seed, *tags), for `torch.Generator.manual_seed`."""
    state = np.random.SeedSequence(_words(seed, tags)).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def rng(seed: int, *tags) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(_words(seed, tags)))
