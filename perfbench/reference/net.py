"""CrossLoc's TransPoseNet in plain PyTorch, NCHW, float32: the coord
encoder and decoder of `networks/networks.py`, and the MLR net whose towers
are concatenated on channels and merged before the decoder.

Weights come as a state dict under the reference's key names
(`encoder.conv1.weight`, `mlr_encoder_2.res2_norm3.bias`, ...). Every conv
pads k // 2; every GroupNorm is `F.group_norm` with the configuration's eps
and min(num_groups, C) groups, followed by a ReLU except where noted. The
sizes that shape the net come as `Arch`, read from a configuration. Frozen
towers run without autograd. Nothing here knows the program under test.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


class Arch(NamedTuple):
    num_mlr: int = 0
    num_unfrozen: int = 0
    num_task: int = 3
    enc_blocks: int = 2
    dec_blocks: int = 2
    groups: int = 32
    eps: float = 1e-5

    @classmethod
    def of(cls, config: dict) -> "Arch":
        net = config["net"]
        return cls(net["num_mlr"], net["num_unfrozen_encoder"], net["num_task_channel"],
                   net["enc_add_res_block"], net["dec_add_res_block"], net["num_groups"],
                   config["gn_eps"])


def conv(x, P: Params, name: str, stride: int = 1):
    w = P[name + ".weight"]
    return F.conv2d(x, w, P[name + ".bias"], stride, w.shape[-1] // 2)


def norm(x, P: Params, name: str, a: Arch, relu: bool = True):
    y = F.group_norm(x, min(a.groups, x.shape[1]), P[name + ".weight"], P[name + ".bias"],
                     a.eps)
    return F.relu(y) if relu else y


def conv_norm(x, P, cname, nname, a: Arch, stride=1, relu=True):
    return norm(conv(x, P, cname, stride), P, nname, a, relu)


def res_block(x, P, prefix, a: Arch):
    """3x3 -> 1x1 -> 3x3 conv-norm-ReLU (`prefix.0/.1`, `.3/.4`, `.6/.7`)."""
    for i in (0, 3, 6):
        x = conv_norm(x, P, f"{prefix}.{i}", f"{prefix}.{i + 1}", a)
    return x


def encoder(x, P, pre: str, a: Arch):
    """[B, 3, H, W] -> [B, 512, H/8, W/8]."""
    for i, s in zip(range(1, 5), (1, 2, 2, 2)):
        x = conv_norm(x, P, f"{pre}conv{i}", f"{pre}norm{i}", a, s)
    res = x
    for i in range(1, 4):
        x = conv_norm(x, P, f"{pre}res1_conv{i}", f"{pre}res1_norm{i}", a)
    res = F.relu(res + x)
    x = res
    for i in range(1, 4):
        x = conv_norm(x, P, f"{pre}res2_conv{i}", f"{pre}res2_norm{i}", a)
    res = conv_norm(res, P, f"{pre}res2_skip", f"{pre}res2_skip_norm", a, relu=False)
    res = F.relu(res + x)
    for k in range(1, a.enc_blocks + 1):
        res = F.relu(res + res_block(res, P, f"{pre}enc_add_res_block{k}", a))
    return res


def decoder(x, P, a: Arch):
    """[B, 512, h, w] -> [B, num_task + 1, h, w]: task channels plus the
    output mean, then exp(clip(., -16.10, 13.82)) of the uncertainty."""
    res = x
    for k in range(1, a.dec_blocks + 1):
        res = F.relu(res + res_block(res, P, f"decoder.dec_add_res_block{k}", a))
    x = res
    for i in range(1, 4):
        x = conv_norm(x, P, f"decoder.res3_conv{i}", f"decoder.res3_norm{i}", a)
    res = F.relu(res + x)
    sc = conv_norm(res, P, "decoder.fc1", "decoder.fc1_norm", a)
    sc = conv_norm(sc, P, "decoder.fc2", "decoder.fc2_norm", a)
    sc = conv(sc, P, "decoder.fc3")
    task = sc[:, :a.num_task] + P["decoder.mean"].view(1, -1, 1, 1)
    pos = torch.exp(torch.clamp(sc[:, a.num_task:], -16.10, 13.82))
    return torch.cat([task, pos], dim=1)


def forward(images_nhwc, P: Params, a: Arch):
    """Images [B, H, W, 3] -> predictions [B, H/8, W/8, num_task + 1]."""
    x = images_nhwc.permute(0, 3, 1, 2)
    if a.num_mlr == 0:
        out = decoder(encoder(x, P, "encoder.", a), P, a)
    else:
        acts = []
        for i in range(1, a.num_mlr + 1):
            with torch.set_grad_enabled(torch.is_grad_enabled() and i <= a.num_unfrozen):
                acts.append(encoder(x, P, f"mlr_encoder_{i}.", a))
        m = torch.cat(acts, dim=1)
        skip = norm(conv(m, P, "mlr_skip.0"), P, "mlr_skip.1", a, relu=False)
        merged = res_block(norm(m, P, "mlr_norm", a, relu=False), P, "mlr_forward", a)
        out = decoder(F.relu(skip + merged), P, a)
    return out.permute(0, 2, 3, 1)
