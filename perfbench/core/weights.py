"""Seeded weights of a configuration, made on the device from the layer
table in four draws of one generator on the device, with the spreads of the
configuration's `init`: conv kernels normal times gain / sqrt(fan_in), conv
biases normal around 0, norm scales around 1 and norm shifts around 0, and
the configuration's output mean. No bias, scale or shift sits at the value
that would hide its term from the check. Both the port and the reference
load this same state dict by the reference's key names."""
from __future__ import annotations

from typing import Dict

import torch

from . import seeds


def state_dict(config: dict, seed: int, device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    init = config["init"]
    convs = [l for l in config["layers"] if l["op"] == "conv"]
    norms = [l for l in config["layers"] if l["op"] == "norm"]
    shapes = [(l["cout"], l["cin"], l["k"], l["k"]) for l in convs]
    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "weights"))

    def draw(n):
        return torch.randn(n, generator=gen, device=device, dtype=dtype)

    kernels = draw(sum(a * b * c * d for a, b, c, d in shapes))
    biases = draw(sum(s[0] for s in shapes)) * init["conv_bias_std"]
    scales = draw(sum(l["c"] for l in norms)) * init["norm_weight_std"] + init["norm_weight_mean"]
    shifts = draw(sum(l["c"] for l in norms)) * init["norm_bias_std"]
    out: Dict[str, torch.Tensor] = {}
    off = boff = 0
    for layer, shape in zip(convs, shapes):
        n = shape[0] * shape[1] * shape[2] * shape[3]
        fan_in = shape[1] * shape[2] * shape[3]
        out[layer["name"] + ".weight"] = kernels[off:off + n].view(shape) \
            * (init["conv_weight_gain"] * fan_in ** -0.5)
        out[layer["name"] + ".bias"] = biases[boff:boff + shape[0]]
        off, boff = off + n, boff + shape[0]
    off = 0
    for layer in norms:
        out[layer["name"] + ".weight"] = scales[off:off + layer["c"]]
        out[layer["name"] + ".bias"] = shifts[off:off + layer["c"]]
        off += layer["c"]
    mean = torch.tensor(config["mean"], device=device, dtype=torch.float32)
    out["decoder.mean"] = mean
    out["mean"] = mean.clone()
    return out


def trainable(config: dict) -> Dict[str, bool]:
    """Parameter name -> whether the optimizer updates it."""
    return {f"{l['name']}.{p}": bool(l["train"]) for l in config["layers"]
            for p in ("weight", "bias")}


def port_model(config: dict, seed: int, device: torch.device):
    """(the port's net for `config`, its seeded state dict): built without
    storage, then filled on `device` from `state_dict`, channels-last on a
    card as the CLIs lay it out. Refuses a net whose norms group or guard
    otherwise than the layer table and `gn_eps` state, which the reference
    computes with."""
    from crossloc_tpu_torch.cli import common
    from crossloc_tpu_torch.models.layers import GroupNorm

    net = config["net"]
    with torch.device("meta"):
        model = common.build_network(config["scene_family"], config["task"], False, False,
                                     config["uncertainty"], False, config["mean"],
                                     num_mlr=net["num_mlr"],
                                     num_unfrozen_encoder=net["num_unfrozen_encoder"])
    table = {l["name"]: l for l in config["layers"]}
    for name, mod in model.named_modules():
        if isinstance(mod, GroupNorm) and (mod.num_groups != table[name]["groups"]
                                           or mod.eps != config["gn_eps"]):
            raise ValueError(f"the port's {name} has {mod.num_groups} groups and eps "
                             f"{mod.eps}; the configuration states {table[name]['groups']} "
                             f"and {config['gn_eps']}")
    model.to_empty(device=device)
    state = state_dict(config, seed, device)
    model.load_state_dict(state)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model, state
