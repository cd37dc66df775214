"""Operations and bytes of a configuration's convolutions and GroupNorms,
reckoned from its layer table (never from the program's modules).

A layer's `scale` is its output's stride against the image, so its output
is ceil(H / scale) x ceil(W / scale) and its input ceil(H / (scale /
stride)) x ... A conv of the forward pass costs 2 C_in C_out k^2 H_out W_out
operations an image. A trainable conv's backward adds its weight gradient
(the same count) and, where some of its input needs a gradient, the input
gradient over the `grad_in` channels that need it (none into the image or a
frozen tower). Bytes are each input read once and each output written once:
a conv's input, weights and output; a norm's x and y forward, x and dy read
and dx (over `grad_in` channels) written backward.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

ELEM = {"float32": 4, "bfloat16": 2, "float16": 2}


class Work(NamedTuple):
    flop: float
    bytes: float
    bound_s: float  # the least time at the peaks: sum over layers of max(flop / F, bytes / BW)


def _hw(height: int, width: int, scale: float):
    return math.ceil(height / scale), math.ceil(width / scale)


def conv_terms(layer: dict, batch: int, height: int, width: int, elem: int,
               backward: bool) -> List[tuple]:
    """[(flop, bytes)] of one conv's forward, or of its backward's input and
    weight gradients."""
    ho, wo = _hw(height, width, layer["scale"])
    hi, wi = _hw(height, width, layer["scale"] / layer["stride"])
    cin, cout, k = layer["cin"], layer["cout"], layer["k"]
    x = batch * hi * wi * cin * elem
    y = batch * ho * wo * cout * elem
    w = cout * cin * k * k * elem
    macs = cin * cout * k * k * ho * wo * batch
    if not backward:
        return [(2.0 * macs, x + w + y)]
    if not layer["train"]:
        return []
    out = [(2.0 * macs, x + y + w)]  # weight gradient: x and dy read, dw written
    g = layer["grad_in"]
    if g:
        out.append((2.0 * macs * g / cin, y + w + batch * hi * wi * g * elem))
    return out


def norm_bytes(layer: dict, batch: int, height: int, width: int, elem: int,
               backward: bool) -> float:
    ho, wo = _hw(height, width, layer["scale"])
    px = batch * ho * wo * elem
    if not backward:
        return 2.0 * px * layer["c"]
    if not layer["train"]:
        return 0.0
    return px * (2 * layer["c"] + layer["grad_in"])


def counts(config: dict, batch: int, training: bool, peaks: Dict[str, float] = None) -> dict:
    """Work of one step (training) or one batch (forward only) at the
    configuration's image size: `conv`, `k1` and `k1bwd` as `Work`."""
    height, width = config["image"]
    elem = ELEM[config["dtype"]]
    flops = (peaks or {}).get("flops")
    bw = (peaks or {}).get("bytes_per_s")

    def work(terms):
        f = sum(t[0] for t in terms)
        b = sum(t[1] for t in terms)
        bound = (sum(max(tf / flops, tb / bw) for tf, tb in terms) if flops and bw else math.nan)
        return Work(f, b, bound)

    convs = [l for l in config["layers"] if l["op"] == "conv"]
    norms = [l for l in config["layers"] if l["op"] == "norm"]
    conv = []
    for l in convs:
        conv += conv_terms(l, batch, height, width, elem, False)
        if training:
            conv += conv_terms(l, batch, height, width, elem, True)
    k1 = [(0.0, norm_bytes(l, batch, height, width, elem, False)) for l in norms]
    k1bwd = ([(0.0, norm_bytes(l, batch, height, width, elem, True)) for l in norms]
             if training else [])
    return {"conv": work(conv), "k1": work(k1), "k1bwd": work(k1bwd)}
