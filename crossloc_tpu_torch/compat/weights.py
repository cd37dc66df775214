"""Weights across from the JAX package and `.net` checkpoints.

The port's module names are the reference state-dict keys, so a `.net`
file (a torch state dict in the reference key grammar) loads straight into
the port with `load_state_dict(strict=True)`. `state_dict_from_flax` maps a
flax parameter tree (as numpy) onto those keys with the JAX package's
grammar (a copy of `crossloc_tpu/compat/torch_import.py:24-101`):

    conv  kernel [kh, kw, in, out]  ->  weight [out, in, kh, kw]
    GroupNorm scale/bias            ->  weight/bias
    ResBlock layer{1,2,3}/{conv,norm}{i}  ->  Sequential .0/.1, .3/.4, .6/.7
    decoder/mean                    ->  decoder.mean and the top-level mean
    mlr_encoder_{i}, mlr_norm, mlr_forward (a ResBlock), mlr_skip/ConvGN_0
                                    ->  the same names, mlr_skip.0 / .1
    decoder/duc/ConvGN_0 (full size) ->  decoder.duc_upsample.conv / .norm
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch


def _conv_entries(tkey: str, fpath: str) -> List[Tuple[str, str, str]]:
    return [(f"{tkey}.weight", f"{fpath}/kernel", "conv"), (f"{tkey}.bias", f"{fpath}/bias", "copy")]


def _norm_entries(tkey: str, fpath: str) -> List[Tuple[str, str, str]]:
    return [(f"{tkey}.weight", f"{fpath}/scale", "copy"), (f"{tkey}.bias", f"{fpath}/bias", "copy")]


def _convgn(tconv: str, tnorm: str, fprefix: str):
    return _conv_entries(tconv, f"{fprefix}/conv") + _norm_entries(tnorm, f"{fprefix}/norm")


def _seq_res_block(tprefix: str, fprefix: str):
    out = []
    for layer, (ci, ni) in enumerate([(0, 1), (3, 4), (6, 7)], start=1):
        out += _conv_entries(f"{tprefix}.{ci}", f"{fprefix}/layer{layer}/conv{layer}")
        out += _norm_entries(f"{tprefix}.{ni}", f"{fprefix}/layer{layer}/norm{layer}")
    return out


def _encoder_entries(tprefix: str, fprefix: str, tiny: bool, add_res: int):
    e = []
    for i in range(1, 5):
        e += _convgn(f"{tprefix}conv{i}", f"{tprefix}norm{i}", f"{fprefix}/stem{i}")
    for blk in (1, 2):
        for i in range(1, 4):
            e += _convgn(f"{tprefix}res{blk}_conv{i}", f"{tprefix}res{blk}_norm{i}",
                         f"{fprefix}/res{blk}_{i}")
    if not tiny:
        e += _convgn(f"{tprefix}res2_skip", f"{tprefix}res2_skip_norm", f"{fprefix}/res2_skip")
    for k in range(1, add_res + 1):
        e += _seq_res_block(f"{tprefix}enc_add_res_block{k}", f"{fprefix}/add_res{k}")
    return e


def _decoder_entries(tprefix: str, fprefix: str, add_res: int, full_size: bool):
    e = [(f"{tprefix}mean", f"{fprefix}/mean", "copy")]
    for k in range(1, add_res + 1):
        e += _seq_res_block(f"{tprefix}dec_add_res_block{k}", f"{fprefix}/add_res{k}")
    for i in range(1, 4):
        e += _convgn(f"{tprefix}res3_conv{i}", f"{tprefix}res3_norm{i}", f"{fprefix}/res3_{i}")
    e += _convgn(f"{tprefix}fc1", f"{tprefix}fc1_norm", f"{fprefix}/fc1")
    e += _convgn(f"{tprefix}fc2", f"{tprefix}fc2_norm", f"{fprefix}/fc2")
    if full_size:
        e += _convgn(f"{tprefix}duc_upsample.conv", f"{tprefix}duc_upsample.norm",
                     f"{fprefix}/duc/ConvGN_0")
    e += _conv_entries(f"{tprefix}fc3", f"{fprefix}/fc3")
    return e


def transpose_net_key_map(model) -> List[Tuple[str, str, str]]:
    """(torch_key, flax_path, transform) triplets of a TransPoseNet. The
    top-level `mean` duplicates `decoder.mean`."""
    entries = [("mean", "decoder/mean", "copy")]
    if model.num_mlr == 0:
        entries += _encoder_entries("encoder.", "encoder", model.tiny, model.enc_add_res_block)
    else:
        for i in range(1, model.num_mlr + 1):
            entries += _encoder_entries(f"mlr_encoder_{i}.", f"mlr_encoder_{i}", model.tiny,
                                        model.enc_add_res_block)
        entries += _norm_entries("mlr_norm", "mlr_norm")
        entries += _seq_res_block("mlr_forward", "mlr_forward")
        entries += _convgn("mlr_skip.0", "mlr_skip.1", "mlr_skip/ConvGN_0")
    return entries + _decoder_entries("decoder.", "decoder", model.dec_add_res_block,
                                      model.full_size_output)


def _get_path(tree: dict, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def state_dict_from_flax(params_np: dict, model) -> "OrderedDict[str, torch.Tensor]":
    """Flax params tree (numpy leaves) -> state dict for
    `model.load_state_dict(strict=True)`; conv kernels HWIO -> OIHW."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for tkey, fpath, tf in transpose_net_key_map(model):
        arr = np.asarray(_get_path(params_np, fpath), dtype=np.float32)
        if tf == "conv":
            arr = np.transpose(arr, (3, 2, 0, 1))
        out[tkey] = torch.from_numpy(np.array(arr, copy=True))
    return out


def load_net(path: str, model=None) -> Dict[str, torch.Tensor]:
    """Read a `.net` state dict (the reference key grammar). With `model`,
    load it strictly into the model as well."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if model is not None:
        model.load_state_dict(state, strict=True)
    return state


def save_net(path: str, model) -> None:
    """Write the model's weights as a reference-format `.net` file."""
    state = OrderedDict((k, v.detach().float().cpu().contiguous())
                        for k, v in model.state_dict().items())
    torch.save(state, path)
