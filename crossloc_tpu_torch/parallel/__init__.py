"""Multi-process parallelism: the process group, the data x spatial x model
mesh, DP and ZeRO, and the halo exchange (counterpart of
`crossloc_tpu/parallel/`)."""
from .distributed import (
    barrier,
    choose_backend,
    init_method_of,
    initialize_distributed,
    local_data_shard,
    rank_device,
    topology,
)
from .mesh import (
    DataParallel,
    Mesh,
    all_gather_cat,
    make_mesh,
    mesh_shape,
    param_spec,
    replicate,
    shard_batch,
    unshard_batch,
)
from .spatial import (
    SpatialShard,
    all_gather_stack,
    group_norm_relu_spatial,
    halo_rows,
    spatialize,
)

__all__ = [
    "DataParallel",
    "Mesh",
    "SpatialShard",
    "all_gather_cat",
    "all_gather_stack",
    "barrier",
    "choose_backend",
    "group_norm_relu_spatial",
    "halo_rows",
    "init_method_of",
    "initialize_distributed",
    "local_data_shard",
    "make_mesh",
    "mesh_shape",
    "param_spec",
    "rank_device",
    "replicate",
    "shard_batch",
    "spatialize",
    "topology",
    "unshard_batch",
]
