"""Shared CLI pieces: the device, dataset roots, the training loader, the
network, the MLR weight wiring and the tower count of a finetuned net's
folder (counterpart of `crossloc_tpu/cli/common.py`)."""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import compat, models, parallel
from ..data import CamLocDataset, Loader, decoder_line, get_label_mean
from ..device import resolve_device


def select_device_from_env(device: Optional[str] = None) -> torch.device:
    """The device of `--device`; for CUDA, `CROSSLOC_DEVICE_ORDINAL` (the bash
    harness's DEVICE_ID slot, `script_clean_training/_lib.sh`) picks the
    card. Raises when CUDA is asked for and absent. Turns TF32 off for
    cuDNN's convolutions and for matmuls: float32 runs compute in float32,
    as the JAX package does (`--bf16` is the reduced-precision mode)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if parallel.topology()[1] > 1:
        return parallel.rank_device(device)  # a rank's card is its local rank's
    dev = resolve_device(device)
    ordinal = os.environ.get("CROSSLOC_DEVICE_ORDINAL")
    if dev.type == "cuda" and dev.index is None and ordinal is not None:
        dev = torch.device("cuda", int(ordinal))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"CROSSLOC_DEVICE_ORDINAL={ordinal} but the machine has "
                               f"{torch.cuda.device_count()} CUDA devices")
        logging.info("Selected device %s via CROSSLOC_DEVICE_ORDINAL", dev)
    return dev


def check_parallel(opt, in_job: bool) -> None:
    """Refuse, before anything is written, the parallel flags a run cannot
    honour, with the JAX CLI's words: --zero without a mesh, a rank count
    that does not divide 32 under --zero, a global batch that does not
    split over the ranks, and more --num_devices than the host has cards."""
    world = parallel.topology()[1] if in_job else max(1, opt.num_devices)
    if opt.zero and world == 1:
        raise ValueError("--zero requires a device mesh: set --num_devices > 1 "
                         "or run multi-host (CROSSLOC_COORDINATOR et al.)")
    if in_job:
        if opt.batch_size % world != 0:
            raise ValueError(f"--batch_size {opt.batch_size} must be divisible by the "
                             f"process count {world} (it is the global batch)")
    elif world > 1:
        if resolve_device(opt.device).type == "cuda" and torch.cuda.device_count() < world:
            raise ValueError(f"requested {world} devices, found {torch.cuda.device_count()}")
        if opt.batch_size % world != 0:
            raise ValueError("batch_size must be divisible by num_devices")
    if opt.zero:
        parallel.param_spec([], world)


def log_process_group(device: torch.device) -> None:
    """In a multi-process run, log the backend and this rank's place, then
    wait for every rank: each has resolved its output paths and resume
    weights before rank 0 writes into the output tree."""
    rank, world = parallel.topology()
    if world > 1:
        logging.info("Process group: backend %s, rank %d of %d on %s",
                     torch.distributed.get_backend(), rank, world, device)
        parallel.barrier()


def _rank_entry(rank: int, target, argv, init_method: str, world: int) -> None:
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    target(argv, (init_method, world, rank))


def spawn_ranks(opt, target, argv) -> None:
    """`--num_devices N`: run `target(argv, (init_method, N, rank))` in N
    spawned processes on this host, one card each (or the CPU with
    `--device cpu`), joined through a `file://` process group in a
    temporary directory; returns when all have ended and raises when one
    fails (the others are then stopped)."""
    import tempfile

    import torch.multiprocessing as mp

    world = opt.num_devices
    with tempfile.TemporaryDirectory(prefix="crossloc_pg_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        mp.start_processes(_rank_entry, args=(target, argv, init_method, world), nprocs=world,
                           join=True, start_method="spawn")


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
    print(decoder_line(dataset), flush=True)  # the console, not output.log
    family = "urbanscape" in scene.lower() or "naturescape" in scene.lower()
    mean = get_label_mean(scene, task, dataset=None if family else dataset)
    loader = Loader(dataset, batch_size=batch_size, shuffle=True, drop_last=True, shard=shard)
    logging.info("This training uses {:d} data points. {:d} iterations per epoch.".format(
        len(dataset), len(dataset)))
    return dataset, loader, mean


def build_network(scene: str, task: str, tiny: bool, grayscale: bool,
                  uncertainty: Optional[str], fullsize: bool, mean, num_mlr: int = 0,
                  num_unfrozen_encoder: int = 0, dtype: torch.dtype = torch.float32):
    """TransPoseNet for the task with the scene's output mean; `num_mlr`
    towers of which the first `num_unfrozen_encoder` train. Scenes outside
    urbanscape / naturescape get the VanillaNetwork, as in the JAX package
    (`crossloc_tpu/cli/common.py:166-168`)."""
    if not ("urbanscape" in scene.lower() or "naturescape" in scene.lower()):
        return models.VanillaNetwork(tiny=tiny, mean_init=list(np.asarray(mean, np.float32)),
                                     in_ch=1 if grayscale else 3, dtype=dtype)
    return models.build_network(task, uncertainty=uncertainty, tiny=tiny, grayscale=grayscale,
                                fullsize=fullsize, num_mlr=num_mlr,
                                num_unfrozen_encoder=num_unfrozen_encoder,
                                mean=list(np.asarray(mean, np.float32)), dtype=dtype)


def _renamed(state: Dict[str, torch.Tensor], src: str, dst: str,
             want: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The entries of `state` under `src`, renamed to `dst`; their names must
    be exactly `want` (the target module's keys)."""
    out = {dst + k[len(src):]: v for k, v in state.items() if k.startswith(src)}
    if set(out) != set(want):
        diff = sorted(set(out) ^ set(want))
        raise KeyError(f"{src}* of the donor does not match {dst}* of the model: {diff[:8]}")
    return out


def wire_mlr_weights(model: models.TransPoseNet, encoder_paths: Sequence[str],
                     reuse_coord_encoder: bool) -> models.TransPoseNet:
    """Load task-pretrain `.net` weights into an MLR model, in place: the
    coord weight (first path) gives the decoder and the output mean, and its
    encoder the first tower iff `reuse_coord_encoder`; each further weight's
    encoder fills the next tower. A `.net` is a state dict in the reference
    grammar, so wiring renames keys (`encoder.*` -> `mlr_encoder_{i}.*`); a
    donor's own head (another task's channels, a DUC) is not read. The MLR
    blocks keep the model's weights. Freezing is the model's
    (`num_unfrozen_encoder`)."""
    if "coord" not in os.path.abspath(encoder_paths[0]):
        raise ValueError("first weight must be the coord task")
    n_towers = len(encoder_paths) - (0 if reuse_coord_encoder else 1)
    if n_towers != model.num_mlr:
        raise ValueError(f"wired {n_towers} encoders but model has num_mlr={model.num_mlr}")
    keys = list(model.state_dict())
    donors = [compat.load_net(p) for p in encoder_paths]
    wired = _renamed(donors[0], "decoder.", "decoder.",
                     [k for k in keys if k.startswith("decoder.")])
    wired["mean"] = donors[0]["decoder.mean"]
    logging.info("Loaded coord weight for decoder init: %s", encoder_paths[0])
    if not reuse_coord_encoder:
        donors = donors[1:]
    for i, donor in enumerate(donors, start=1):
        dst = f"mlr_encoder_{i}."
        wired.update(_renamed(donor, "encoder.", dst, [k for k in keys if k.startswith(dst)]))
        logging.info("Wired MLR encoder %d (%s) from %s", i,
                     "trainable" if i <= model.num_unfrozen_encoder else "frozen",
                     encoder_paths[i - 1 if reuse_coord_encoder else i])
    state = model.state_dict()
    state.update(wired)
    model.load_state_dict(state, strict=True)
    return model


def infer_num_encoders(weight_path: str) -> int:
    """Encoder count from the output-folder name: the tasks named after
    'decoder_' (0 for a single-task net); 'free'/'frozen' markers follow
    'coord' and add none."""
    name = os.path.basename(os.path.dirname(os.path.abspath(weight_path)))
    if "decoder_" not in name:
        return 0
    spec = name.split("decoder_")[1].split("-")[0]
    return sum(p in ("coord", "depth", "normal", "semantics") for p in spec.split("_"))
