"""Shared CLI pieces: the device, dataset roots, the training loader and the
network (counterpart of `crossloc_tpu/cli/common.py`, `num_mlr=0`)."""
from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np
import torch

from .. import models
from ..data import CamLocDataset, Loader, get_label_mean
from ..device import resolve_device

_VANILLA_TODO = ("scenes outside urbanscape / naturescape need the vanilla net, "
                 "ROADMAP queue 1, item 11 (other tasks and DUC)")


def select_device_from_env(device: Optional[str] = None) -> torch.device:
    """The device of `--device`; for CUDA, `CROSSLOC_DEVICE_ORDINAL` (the bash
    harness's DEVICE_ID slot, `script_clean_training/_lib.sh`) picks the
    card. Raises when CUDA is asked for and absent."""
    dev = resolve_device(device)
    ordinal = os.environ.get("CROSSLOC_DEVICE_ORDINAL")
    if dev.type == "cuda" and dev.index is None and ordinal is not None:
        dev = torch.device("cuda", int(ordinal))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"CROSSLOC_DEVICE_ORDINAL={ordinal} but the machine has "
                               f"{torch.cuda.device_count()} CUDA devices")
        logging.info("Selected device %s via CROSSLOC_DEVICE_ORDINAL", dev)
    return dev


def resolve_train_roots(scene: str, task: str, real_data_domain: str, real_data_chunk: float,
                        sim_data_chunk: float, fullsize: bool, real_only: bool = False,
                        datasets_dir: str = "./datasets") -> List[str]:
    """Dataset roots of a training run: LHS sim, in-place / out-of-place
    pairwise real + sim, fractional chunk directories, the '-fullsize' scene
    suffix (semantics exempt)."""
    if not ("urbanscape" in scene.lower() or "naturescape" in scene.lower()):
        raise NotImplementedError(f"scene={scene}")
    if real_data_domain not in ("in_place", "out_of_place"):
        raise ValueError(f"real_data_domain={real_data_domain} is not supported!")
    if not (0.0 <= real_data_chunk <= 1.0 and 0.0 <= sim_data_chunk <= 1.0):
        raise ValueError("chunks must be in [0, 1]")
    if real_data_chunk == 0.0 and sim_data_chunk == 0.0:
        raise ValueError("one of real_data_chunk or sim_data_chunk must be positive!")

    _scene = scene if task == "semantics" else (scene + "-fullsize" if fullsize else scene)
    roots = []
    if sim_data_chunk > 0:
        sub = "train_sim" if sim_data_chunk == 1 else f"train_sim_chunk_{sim_data_chunk:.2f}"
        roots.append(os.path.join(datasets_dir, _scene, sub))
    if real_data_chunk > 0:
        oop = "oop_" if real_data_domain == "out_of_place" else ""
        if real_data_chunk == 1:
            real, sim = f"train_{oop}drone_real", f"train_{oop}drone_sim"
        else:
            real = f"train_{oop}drone_real_chunk_{real_data_chunk:.2f}"
            sim = f"train_{oop}drone_sim_chunk_{real_data_chunk:.2f}"
        roots.append(os.path.join(datasets_dir, _scene, real))
        if not real_only:
            roots.append(os.path.join(datasets_dir, _scene, sim))
    return roots


def build_train_loader(scene: str, task: str, grayscale: bool, real_data_domain: str,
                       real_data_chunk: float, sim_data_chunk: float, fullsize: bool,
                       batch_size: int, real_only: bool = False, datasets_dir: str = "./datasets",
                       image_height: int = 480, shard=(0, 1)):
    """(dataset, loader, mean): shuffled, epoch-keyed, full batches only."""
    roots = resolve_train_roots(scene, task, real_data_domain, real_data_chunk, sim_data_chunk,
                                fullsize, real_only, datasets_dir)
    dataset = CamLocDataset(roots, coord=task == "coord", depth=task == "depth",
                            normal=task == "normal", semantics=task == "semantics",
                            grayscale=grayscale, image_height=image_height)
    family = "urbanscape" in scene.lower() or "naturescape" in scene.lower()
    mean = get_label_mean(scene, task, dataset=None if family else dataset)
    loader = Loader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, shard=shard)
    logging.info("This training uses {:d} data points. {:d} iterations per epoch.".format(
        len(dataset), len(dataset)))
    return dataset, loader, mean


def build_network(scene: str, task: str, tiny: bool, grayscale: bool,
                  uncertainty: Optional[str], fullsize: bool, mean,
                  dtype: torch.dtype = torch.float32) -> models.TransPoseNet:
    """TransPoseNet for the task with the scene's output mean."""
    if not ("urbanscape" in scene.lower() or "naturescape" in scene.lower()):
        raise NotImplementedError(_VANILLA_TODO)
    return models.build_network(task, uncertainty=uncertainty, tiny=tiny, grayscale=grayscale,
                                fullsize=fullsize, mean=list(np.asarray(mean, np.float32)),
                                dtype=dtype)
