"""Multi-process scaffolding over `torch.distributed` (counterpart of
`crossloc_tpu/parallel/distributed.py`).

One process per card, the torch idiom. The JAX package runs one process per
host that drives all of that host's devices; here every rank owns one device,
`cuda:LOCAL_RANK` (or the CPU when the caller asks for it), and the batch is
split over ranks.

Launch contract
---------------
Every rank runs the same CLI. Set either our variables or torch's own (so
`torchrun` works too):

  CROSSLOC_COORDINATOR   = host:port of rank 0, or an init-method URL
                           (tcp://..., file://...)  (MASTER_ADDR + MASTER_PORT)
  CROSSLOC_NUM_PROCESSES = the number of ranks       (WORLD_SIZE)
  CROSSLOC_PROCESS_ID    = this process's rank       (RANK)

`LOCAL_RANK` and `LOCAL_WORLD_SIZE` (torchrun sets them) place a host's
ranks on its cards; without them every rank is taken to run on this host,
rank r on card r. With nothing set `initialize_distributed()` is a no-op,
so a single-process run is unchanged. The training CLIs' `--num_devices N`
starts N such ranks on this host itself (`cli/common.py::spawn_ranks`).

Backend, chosen from the topology before `init_process_group` and logged:
`nccl` for cuda ranks that each have a card of their own, `gloo` for CPU
ranks, and `gloo` over CUDA tensors when a host's ranks outnumber its cards
(NCCL refuses two ranks on one device). The choice is never made after a
failure, and a cuda rank never moves to the CPU.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..device import resolve_device


def _env(*names: str) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def _master_address() -> Optional[str]:
    addr, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
    return f"{addr}:{port}" if addr and port else None


def init_method_of(address: str) -> str:
    """`host:port` -> `tcp://host:port`; a URL (`tcp://`, `file://`) as it is."""
    return address if "://" in address else "tcp://" + address


def choose_backend(device_type: str, local_world: int, num_cards: int) -> str:
    """nccl when each of a host's cuda ranks has a card of its own; gloo for
    CPU ranks and for cuda ranks that share cards."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if local_world <= num_cards else "gloo"


def _local_topology(rank: int, world: int) -> Tuple[int, int]:
    """(local rank, ranks on this host): LOCAL_RANK / LOCAL_WORLD_SIZE, else
    every rank on this host."""
    local_rank = _env("LOCAL_RANK")
    local_world = _env("LOCAL_WORLD_SIZE")
    return (int(local_rank) if local_rank else rank,
            int(local_world) if local_world else world)


def topology() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_data_shard() -> Tuple[int, int]:
    """(shard_index, num_shards) this process reads from the dataset."""
    return topology()


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: the CPU when asked for, else `cuda:LOCAL_RANK`
    modulo the host's cards (ranks that outnumber the cards share them).
    Outside a process group, `resolve_device(device)`. Raises when CUDA is
    asked for and absent."""
    dev = resolve_device(device)
    if dev.type == "cpu" or not (dist.is_available() and dist.is_initialized()):
        return dev
    local_rank, _ = _local_topology(*topology())
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = "cuda",
) -> bool:
    """Join this process to the multi-process job, if one is configured.

    Explicit arguments win over the CROSSLOC_* and torch variables. Returns
    True when the default process group exists (now or before), False for
    the single-process no-op. Idempotent: safe to call from every CLI.
    `device` is the rank's device type ("cuda" or "cpu"), from which the
    backend follows (module docstring)."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _env("CROSSLOC_COORDINATOR") or _master_address()
    if num_processes is None:
        v = _env("CROSSLOC_NUM_PROCESSES", "WORLD_SIZE")
        num_processes = int(v) if v else None
    if process_id is None:
        v = _env("CROSSLOC_PROCESS_ID", "RANK")
        process_id = int(v) if v else None

    if coordinator_address is None and num_processes is None and process_id is None:
        return False
    missing = [name for name, val in (
        ("coordinator (CROSSLOC_COORDINATOR / MASTER_ADDR:MASTER_PORT)", coordinator_address),
        ("process count (CROSSLOC_NUM_PROCESSES / WORLD_SIZE)", num_processes),
        ("process id (CROSSLOC_PROCESS_ID / RANK)", process_id),
    ) if val is None]
    if missing:
        # a partial configuration would wait for ranks that never come
        raise ValueError(
            "incomplete multi-host configuration: set all of coordinator/"
            "num_processes/process_id together; missing: " + "; ".join(missing))

    dev = resolve_device(device)
    local_rank, local_world = _local_topology(process_id, num_processes)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, local_world, cards)
    kwargs = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    logging.info("torch.distributed backend %s: rank %d of %d on %s (%d ranks on this host, "
                 "%d cards)", backend, process_id, num_processes, dev, local_world, cards)
    dist.init_process_group(backend, init_method=init_method_of(coordinator_address),
                            world_size=num_processes, rank=process_id, **kwargs)
    return True


def barrier() -> None:
    """Wait for every rank; a no-op outside a process group."""
    if topology()[1] > 1:
        dist.barrier()
