"""Multi-process data parallelism: the process group, DP and ZeRO (counterpart
of `crossloc_tpu/parallel/`)."""
from .distributed import (
    barrier,
    choose_backend,
    init_method_of,
    initialize_distributed,
    local_data_shard,
    rank_device,
    topology,
)
from .mesh import DataParallel, all_gather_cat, param_spec, replicate

__all__ = [
    "DataParallel",
    "all_gather_cat",
    "barrier",
    "choose_backend",
    "init_method_of",
    "initialize_distributed",
    "local_data_shard",
    "param_spec",
    "rank_device",
    "replicate",
    "topology",
]
