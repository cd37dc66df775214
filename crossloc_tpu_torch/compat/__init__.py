"""Checkpoint and naming compatibility with the reference and the JAX package;
the `dsacstar` plugin's API in `compat.dsacstar_shim`."""
from .naming import finetune_output_name, read_meta_info, train_output_name
from .weights import (
    load_net,
    proj_head_key_map,
    save_net,
    state_dict_from_flax,
    transpose_net_key_map,
    vanilla_net_key_map,
)

__all__ = ["finetune_output_name", "load_net", "proj_head_key_map",
           "read_meta_info", "save_net", "state_dict_from_flax", "train_output_name",
           "transpose_net_key_map", "vanilla_net_key_map"]
