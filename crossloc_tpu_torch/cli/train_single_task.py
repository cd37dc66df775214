"""Train a single-task network (encoder pretraining) on the card unless
`--device cpu`.

    python -m crossloc_tpu_torch.cli.train_single_task urbanscape --task coord \
        --uncertainty MLE --batch_size 12 --learningrate 2e-4 --auto_resume
    python -m crossloc_tpu_torch.cli.train_single_task urbanscape --task semantics \
        --fullsize --uncertainty none --batch_size 12 --epochs 30 --auto_resume

Flags, output-directory names, `output.log` lines, the `model.net` and
`ckpt_iter_*.net` cadence, `FLAG_training_done.nodata` and the resume
bookkeeping are those of `crossloc_tpu/cli/train_single_task.py`; `--device`
is added (default cuda). A step moves uint8 images to the device, augments
them there with draws from a generator keyed by (epoch, batch), so that a
resumed run draws as an uninterrupted one, and runs forward, the task's
loss (coord, depth, normal or semantics), backward (K1's backward kernel on
the card) and Adam. Semantics trains full size through the DUC head, its
labels on the image canvas, sent to the card as uint8 class ids; with
`--fullsize` the other tasks train against full-resolution labels. `--bf16`
runs the convs and K1 in bfloat16; parameters, norm statistics, outputs and
the loss stay float32. With `--e2e_pose_loss` (coord only) the epochs from
`--e2e_warmup_epochs` on minimise the DSAC expected pose loss through the
differentiable solver instead (`train/dsac_step.py`), with the same
augmentation, its principal-point shift in the solver's camera, and solver
draws from a generator keyed by (epoch, batch); DSAC*'s `train_e2e.py`
flags `--hypotheses`, `--threshold`, `--inlieralpha`, `--maxpixelerror`,
`--weightrot` and `--weighttrans` set its solver and pose loss
(`e2e_configs`; unset, the step's defaults), and need `--e2e_pose_loss`.

Data parallelism: `--batch_size` is the global batch. `--num_devices N`
starts N ranks on this host, one card each (`cli/common.py::spawn_ranks`),
and a run launched through CROSSLOC_COORDINATOR / CROSSLOC_NUM_PROCESSES /
CROSSLOC_PROCESS_ID (or torch's MASTER_ADDR, WORLD_SIZE, RANK) joins that
job (`parallel/distributed.py`). Each rank reads its slice of the dataset,
draws the global batch's augmentation (and solver) draws and takes its own
rows, so a 2-rank run of identical frames equals a 1-rank run of the global
batch; the gradients are averaged after the backward, or with `--zero`
reduce-scattered into each rank's shard of the parameters and Adam moments
(`parallel/mesh.py`). Only rank 0 writes `output.log`, the `.net` files and
the done flag; the ZeRO gathers and the checkpoint saves are entered by
every rank on rank-symmetric conditions. `--ckpt_backend orbax` writes
`torch.distributed.checkpoint` directories `<output dir>/<step>/`.

Two departures from the JAX CLI, both fixes of its defects (ROADMAP queue
3): a log-parse resume sets the LR schedule's clock to the resumed step
(R5: the JAX CLI restarts optax's count at 0), and with
`--snapshot_every_epochs N` an `--auto_resume` epoch is floored to the last
written snapshot (R3).
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .. import compat, models, parallel
from ..data import (
    AugmentConfig,
    augment_batch,
    device_prefetch,
    draw_augmentation,
    images_from_wire,
    images_to_wire,
)
from ..losses import CoordLossConfig, DepthLossConfig, NormalLossConfig, get_nodata_value
from ..ransac import PoseLossConfig, RansacConfig
from ..train import (
    CheckpointManager,
    TrainBatch,
    TrainState,
    make_dsac_train_step,
    make_optimizer,
    train_ransac_config,
    train_step,
)
from ..utils import config_log, read_training_log
from ..utils.profiling import span
from . import common


def config_parser(description="Initialize a scene coordinate regression network."):
    """The JAX CLI's flags (those of the reference plus its extensions), and `--device`."""
    parser = argparse.ArgumentParser(
        description=description, formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("scene", help="name of a scene in the dataset folder")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--grayscale", "-grayscale", action="store_true")
    parser.add_argument("--real_data_domain", type=str, default="in_place")
    parser.add_argument("--real_data_chunk", type=float, default=1.0)
    parser.add_argument("--real_only", action="store_true")
    parser.add_argument("--sim_data_chunk", type=float, default=1.0)
    parser.add_argument("--task", type=str, required=True)
    parser.add_argument("--epoch_plus", "-epoch_plus", action="store_true")
    parser.add_argument("--network_in", type=str, default=None)
    parser.add_argument("--tiny", "-tiny", action="store_true")
    parser.add_argument("--fullsize", "-fullsize", action="store_true")
    parser.add_argument("--epochs", "-e", type=int, default=50)
    parser.add_argument("--learningrate", "-lr", type=float, default=0.0002)
    parser.add_argument("--no_lr_scheduling", action="store_true")
    parser.add_argument("--session", "-sid", default="")
    parser.add_argument("--ckpt_dir", type=str, default="")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--inittolerance", "-itol", type=float, default=50.0)
    parser.add_argument("--mindepth", "-mind", type=float, default=0.1)
    parser.add_argument("--softclamp", "-sc", type=float, default=100)
    parser.add_argument("--hardclamp", "-hc", type=float, default=1000)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--uncertainty", "-uncertainty", default=None, type=str)
    parser.add_argument("--datasets_dir", type=str, default="./datasets",
                        help="dataset root directory")
    parser.add_argument("--image_height", type=int, default=480,
                        help="standard input image height")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="data-parallel training over N ranks on this host, one card "
                             "each (--device cpu: N CPU ranks); --batch_size is the global "
                             "batch")
    parser.add_argument("--zero", action="store_true",
                        help="ZeRO: shard the parameters and Adam moments over the "
                             "data-parallel ranks (out-channel sharding, "
                             "parallel.param_spec); needs --num_devices > 1 or a "
                             "multi-process run, with the rank count dividing 32")
    parser.add_argument("--e2e_pose_loss", action="store_true",
                        help="DSAC end-to-end training: minimise the expected pose loss "
                             "through the differentiable RANSAC solver (coord task only)")
    parser.add_argument("--e2e_warmup_epochs", type=int, default=0,
                        help="epochs of the proxy reprojection loss before the expected "
                             "pose loss takes over")
    # the solver and pose-loss settings of the expected pose loss, under DSAC*'s
    # train_e2e.py flag names; unset, each keeps the training step's default
    parser.add_argument("--hypotheses", type=int, default=None,
                        help="RANSAC hypotheses per image in the expected pose loss "
                             "(unset: 16; DSAC* trains with 64); needs --e2e_pose_loss")
    parser.add_argument("--threshold", type=float, default=None,
                        help="inlier threshold in pixels (unset: 10); needs --e2e_pose_loss")
    parser.add_argument("--inlieralpha", type=float, default=None,
                        help="alpha of the soft inlier count (unset: 100); needs "
                             "--e2e_pose_loss")
    parser.add_argument("--maxpixelerror", type=float, default=None,
                        help="clamp of the reprojection errors in pixels (unset: 100); needs "
                             "--e2e_pose_loss")
    parser.add_argument("--weightrot", type=float, default=None,
                        help="pose loss weight per degree of rotation error (unset: 1); needs "
                             "--e2e_pose_loss")
    parser.add_argument("--weighttrans", type=float, default=None,
                        help="pose loss weight per metre of translation error (unset: 1; "
                             "DSAC*'s 100 weighs centimetres); needs --e2e_pose_loss")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 convs and GroupNorm; params, norm statistics, outputs "
                             "and the loss stay float32; adds a '-bf16' naming token")
    parser.add_argument("--stem_s2d", type=str, default="auto", choices=["auto", "on", "off"],
                        help="accepted for the JAX CLI's flag surface; the port computes the "
                             "standard stems (the same function)")
    parser.add_argument("--ckpt_backend", type=str, default="none",
                        choices=["none", "msgpack", "orbax"],
                        help="full-state checkpoints (weights, Adam, step) beside each epoch's "
                             "snapshot for an exact resume; 'msgpack' writes the port's "
                             "torch.save file, 'orbax' torch.distributed.checkpoint "
                             "directories <output dir>/<step>/")
    parser.add_argument("--snapshot_every_epochs", type=int, default=1,
                        help="write the per-epoch model.net every N epochs (the final epoch "
                             "always writes); a resume restarts from the last written one")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default; raises without CUDA) or cpu")
    return parser


# DSAC*'s train_e2e.py flags of the expected pose loss (`e2e_configs`)
E2E_FLAGS = ("hypotheses", "threshold", "inlieralpha", "maxpixelerror", "weightrot",
             "weighttrans")


def normalize_opt(opt):
    if isinstance(opt.uncertainty, str):
        if opt.uncertainty.lower() == "none":
            opt.uncertainty = None
        elif opt.uncertainty.lower() == "mle":
            opt.uncertainty = "MLE"
    if opt.uncertainty not in (None, "MLE"):
        raise ValueError(f"--uncertainty {opt.uncertainty} is not supported!")
    if opt.real_data_domain not in ("in_place", "out_of_place"):
        raise ValueError(f"--real_data_domain {opt.real_data_domain} is not supported!")
    if opt.real_only and opt.sim_data_chunk != 0:
        raise ValueError("--real_only needs --sim_data_chunk 0")
    if opt.e2e_pose_loss and opt.task != "coord":
        raise ValueError("--e2e_pose_loss requires --task coord (pose is only "
                         "defined for scene-coordinate regression)")
    given = [f"--{flag}" for flag in E2E_FLAGS if getattr(opt, flag) is not None]
    if given and not opt.e2e_pose_loss:
        raise ValueError(f"{' '.join(given)} set the expected pose loss: they require "
                         "--e2e_pose_loss")
    return opt


def e2e_configs(opt, subsample: int) -> Tuple[RansacConfig, PoseLossConfig]:
    """The expected pose loss's (RansacConfig, PoseLossConfig): the training
    step's defaults (`train_ransac_config`, `PoseLossConfig()`) with each of
    DSAC*'s flags that is set in its place."""
    def given(**fields):
        return {k: v for k, v in fields.items() if v is not None}

    rcfg = train_ransac_config(subsample)._replace(**given(
        hypotheses=opt.hypotheses, inlier_threshold=opt.threshold,
        inlier_alpha=opt.inlieralpha, max_pixel_error=opt.maxpixelerror))
    lcfg = PoseLossConfig()._replace(**given(w_rot=opt.weightrot, w_trans=opt.weighttrans))
    return rcfg, lcfg


def _reject_unported(opt) -> None:
    """Refuse, before anything is written, what the port cannot run: scenes
    of no known family (`get_nodata_value`, JAX's exception and words; the
    JAX CLI raises them after it made the output folder), and the net
    configurations the JAX package's `build_network` refuses."""
    get_nodata_value(opt.scene)
    if opt.task == "semantics" and opt.uncertainty is not None:
        raise NotImplementedError("semantics has no uncertainty head: pass --uncertainty none")
    if opt.task == "semantics" and not opt.fullsize:
        raise NotImplementedError("semantics requires --fullsize (the DUC output)")


def get_output_path(opt) -> str:
    """output/<name> under the working directory, the name from the flags."""
    name = compat.train_output_name(
        opt.scene, opt.task, session=opt.session, grayscale=opt.grayscale,
        uncertainty=opt.uncertainty, fullsize=opt.fullsize, epochs=opt.epochs,
        learning_rate=opt.learningrate, real_data_chunk=opt.real_data_chunk,
        sim_data_chunk=opt.sim_data_chunk, real_data_domain=opt.real_data_domain,
        real_only=opt.real_only, tiny=opt.tiny, network_in=opt.network_in,
        debug=opt.debug, e2e=opt.e2e_pose_loss, bf16=opt.bf16)
    return os.path.abspath(os.path.join("output", name))


def labels_to_wire(batch: dict, task: str) -> dict:
    """The semantics labels as uint8 class ids [B, H, W, 1] (the dataset's
    trimmed ids are 0..5): an eighth of the int64 bytes to the card; other
    tasks' labels go as they are."""
    if task != "semantics":
        return {}
    with span("data.wire", bytes=batch["semantics"].size):
        return {"semantics": batch["semantics"][..., None].astype(np.uint8)}


def augment_generator(epoch: int, batch_idx: int) -> torch.Generator:
    """CPU generator of one batch's augmentation draws, keyed by (epoch, batch)."""
    seed = int(np.random.SeedSequence([2021, epoch, batch_idx]).generate_state(1)[0])
    return torch.Generator().manual_seed(seed)


def solver_generator(epoch: int, batch_idx: int, device: torch.device) -> torch.Generator:
    """Generator on `device` of one e2e batch's solver draws (hypotheses),
    keyed by (epoch, batch) apart from the augmentation's."""
    seed = int(np.random.SeedSequence([2021, epoch, batch_idx, 1]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def draws_rows(draws, lo: int, hi: int):
    """The per-image augmentation draws of images [lo, hi); the batch-wide
    ones (scale, angle, translation) as they are."""
    return draws._replace(brightness=draws.brightness[lo:hi], contrast=draws.contrast[lo:hi])


def run_training(opt, output_dir: str, ckpt_output_dir: str, device: torch.device,
                 model: Optional[models.TransPoseNet] = None) -> TrainState:
    """The training loop shared by the train and finetune CLIs; returns the
    final state. Without `model` it builds the task's net with seeded
    weights; a given model (the finetune CLI's wired MLR net) is trained as
    it comes. `--network_in` weights load into either. In a multi-process
    run every rank calls it (module docstring)."""
    common.log_device_selection(device)
    nodata_value = get_nodata_value(opt.scene)
    rank, world = parallel.topology()
    is_main = rank == 0
    local_batch = opt.batch_size // world
    trainset, loader, mean = common.build_train_loader(
        opt.scene, opt.task, opt.grayscale, opt.real_data_domain, opt.real_data_chunk,
        opt.sim_data_chunk, opt.fullsize, local_batch, opt.real_only, opt.datasets_dir,
        opt.image_height, shard=(rank, world))
    if len(loader) == 0:
        raise ValueError(f"batch_size {opt.batch_size} exceeds dataset size {len(trainset)}: "
                         "no full batch can be formed (drop_last); reduce --batch_size")
    steps_per_epoch = len(loader)

    if model is None:
        model = common.build_network(opt.scene, opt.task, opt.tiny, opt.grayscale,
                                     opt.uncertainty, opt.fullsize, mean,
                                     dtype=torch.bfloat16 if opt.bf16 else torch.float32)
        models.init_weights(model, torch.Generator().manual_seed(2021))
    # a run from --network_in snapshots to model_{auto_,epoch_plus_}resume.net
    # and writes the weights it loaded at once; a fresh run to model.net
    if opt.network_in is not None:
        compat.load_net(opt.network_in, model)
        logging.info("Successfully loaded %s." % opt.network_in)
        if opt.auto_resume:
            model_path = os.path.join(output_dir, "model_auto_resume.net")
        elif opt.epoch_plus:
            model_path = os.path.join(output_dir, "model_epoch_plus_resume.net")
        else:
            model_path = os.path.join(output_dir, "model_resume.net")
        if is_main:
            compat.save_net(model_path, model)
    else:
        model_path = os.path.join(output_dir, "model.net")
    model.to(device)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    dp = None
    if world > 1:
        # rank 0's weights everywhere; frozen MLR towers stay replicated
        dp = parallel.DataParallel(model, zero=opt.zero)
        sharding = " with ZeRO parameter sharding" if opt.zero else ""
        if opt.num_devices > 1:
            logging.info("Data-parallel training over %d devices%s", world, sharding)
        else:
            logging.info("Multi-host data-parallel training: %d processes x %d local devices "
                         "(global batch %d, local %d)%s", world, 1, opt.batch_size,
                         local_batch, sharding)
    # Adam takes the parameters that train (frozen MLR towers stay out);
    # under ZeRO, this rank's shard and the replicated ones
    trainable = (dp.update_params() if dp is not None
                 else [p for p in model.parameters() if p.requires_grad])
    state = TrainState(model, make_optimizer(trainable, opt.learningrate, steps_per_epoch,
                                             opt.no_lr_scheduling), parallel=dp)
    zero = dp is not None and dp.shard is not None

    def full_params():
        """The whole net in the block: under ZeRO an all-gather every rank
        joins (on rank-symmetric conditions)."""
        return dp.materialized() if zero else contextlib.nullcontext()
    save_period = 1 if opt.task == "semantics" else 5  # epochs between ckpt_iter_*.net files

    # --fullsize trains against full-resolution labels (subsample 1);
    # semantics labels are full size whatever the flag, on the image canvas
    semantics = opt.task == "semantics"
    subsample = 1 if (opt.fullsize and not semantics) else 8
    aug_cfg = AugmentConfig(grayscale=opt.grayscale, nodata_value=nodata_value,
                            subsample=subsample)
    coord_cfg = CoordLossConfig(min_depth=opt.mindepth, soft_clamp=opt.softclamp,
                                hard_clamp=opt.hardclamp, init_tolerance=opt.inittolerance,
                                nodata_value=nodata_value, subsample=subsample)
    depth_cfg = DepthLossConfig(min_depth=opt.mindepth, hard_clamp=opt.hardclamp,
                                nodata_value=nodata_value)
    normal_cfg = NormalLossConfig(hard_clamp=opt.hardclamp, nodata_value=nodata_value)
    dsac_step = None
    if opt.e2e_pose_loss:
        if opt.uncertainty is not None:
            # the expected pose loss reads the coord channels alone
            logging.warning(
                "--e2e_pose_loss with --uncertainty %s: the uncertainty "
                "channel gets NO gradient from the pose loss (only the "
                "coord channels feed the solver)", opt.uncertainty)
        dsac_step = make_dsac_train_step(model, *e2e_configs(opt, subsample),
                                         subsample=subsample)
    manager = None
    if opt.ckpt_backend != "none":
        manager = CheckpointManager(output_dir, backend=opt.ckpt_backend)
    snap_every = max(1, opt.snapshot_every_epochs)

    if opt.auto_resume or opt.epoch_plus:
        iteration, start_epoch = read_training_log(
            os.path.join(os.path.dirname(opt.network_in), "output.log"), len(trainset))
        # R3: the weights loaded are those of the last written snapshot. An
        # --epoch_plus extension loads a finished run, whose last epoch wrote
        # one: it resumes at the log's epoch, as the JAX CLI does (F2)
        if not opt.epoch_plus:
            start_epoch = start_epoch // snap_every * snap_every
        save_counter = (start_epoch + 1) * len(trainset)
        epoch_de_facto = start_epoch
        last_ckpt_iteration = (start_epoch // 5 * 5) * len(trainset)
        state.step = start_epoch * steps_per_epoch  # R5: the LR follows the step
        if manager is not None:
            src_dir = os.path.dirname(os.path.abspath(opt.network_in))
            src = manager if src_dir == os.path.abspath(output_dir) else CheckpointManager(
                src_dir, backend=opt.ckpt_backend)
            if src.restore_latest(state) is not None:
                # a .state is written at an epoch's end: resume after that epoch
                start_epoch = state.step // steps_per_epoch
                save_counter = (start_epoch + 1) * len(trainset)
                epoch_de_facto = start_epoch
                logging.info("Restored full train state (step %d): exact optimizer resume from "
                             "epoch %d.", state.step, start_epoch)
            else:
                logging.info("No full-state checkpoint found; log-parse resume (optimizer "
                             "state reset).")
    else:
        iteration, start_epoch, save_counter, epoch_de_facto, last_ckpt_iteration = 0, 0, 0, 0, 0

    for epoch in range(start_epoch, opt.epochs):
        logging.info("=== Epoch: %d ======================================" % epoch)
        loader.set_epoch(epoch)
        e2e = dsac_step is not None and epoch >= opt.e2e_warmup_epochs
        wire = (dict(b, image=images_to_wire(b["image"]), **labels_to_wire(b, opt.task))
                for b in loader)
        for batch_idx, batch in enumerate(
                device_prefetch(wire, device, keys=("image", "pose", opt.task))):
            start_time = time.time()
            B = batch["image"].shape[0]
            # the global batch's draws, this rank's rows [rank B, (rank + 1) B)
            draws = draws_rows(draw_augmentation(augment_generator(epoch, batch_idx),
                                                 B * world, aug_cfg), rank * B, (rank + 1) * B)
            focal = torch.tensor(float(batch["focal"][0]), device=device)
            images, labels, poses, focal, pp_shift = augment_batch(
                images_from_wire(batch["image"]), batch[opt.task], batch["pose"], focal,
                draws.to(device), aug_cfg, semantics=semantics)
            tb = TrainBatch(images, poses, labels, focal, pp_shift)
            if e2e:
                metrics = dsac_step(state, tb,
                                    generator=solver_generator(epoch, batch_idx, device),
                                    global_batch=(rank * B, B * world) if world > 1 else None)
                valid_rate = 1.0  # no per-pixel validity here; the log line keeps its format
            else:
                metrics = train_step(state, tb, opt.task, opt.uncertainty, nodata_value,
                                     coord_cfg, depth_cfg, normal_cfg)
                valid_rate = float(metrics["valid_rate"])
            loss = float(metrics["loss"])
            time_avg = (time.time() - start_time) / (B * world)
            iteration += B * world  # global samples
            logging.info(
                "Iteration: %7d, Epoch: %3d, Total loss: %.2f, Valid: %.1f%%, Avg Time: %.3fs"
                % (iteration, epoch, loss, valid_rate * 100, time_avg))

            # the reference's de-facto-epoch snapshot (it can fire mid-epoch)
            # and the periodic ckpt_iter file; both weights only, written by
            # rank 0. The conditions are rank-symmetric (global samples)
            fire_snapshot = iteration > save_counter
            fire_ckpt = (iteration > last_ckpt_iteration + save_period * len(trainset)
                         or last_ckpt_iteration == 0)
            snap_write = fire_snapshot and (epoch_de_facto + 1) % snap_every == 0
            with full_params() if (snap_write or fire_ckpt) else contextlib.nullcontext():
                if fire_snapshot:
                    if snap_write and is_main:
                        logging.info("Saving snapshot of the network to %s." % model_path)
                        compat.save_net(model_path, model)
                    save_counter = iteration + len(trainset)
                    epoch_de_facto += 1
                if fire_ckpt:
                    if is_main:
                        compat.save_net(os.path.join(
                            ckpt_output_dir, "ckpt_iter_{:07d}.net".format(iteration)), model)
                    last_ckpt_iteration = iteration

        # the epoch's end: the full state is exact here, and only here
        if (epoch + 1) % snap_every == 0 or epoch == opt.epochs - 1:
            with full_params():
                if is_main:
                    logging.info("Saving snapshot of the network to %s." % model_path)
                    compat.save_net(model_path, model)
        if manager is not None:
            manager.save(state)  # every rank: a collective under ZeRO or DCP

    logging.info("Done without errors.")
    if manager is not None:
        manager.flush()
    if is_main:
        for d in (output_dir, ckpt_output_dir):
            with open(os.path.join(d, "FLAG_training_done.nodata"), "w") as f:
                f.write("")
    return state


def main(argv=None) -> str:
    """Parse, set up the output directory and log, train; returns the output
    directory."""
    return _main(argv)


def _main(argv=None, process_group=None) -> str:
    """`main`; a rank of `--num_devices` gets its `process_group`
    (init method, world size, rank)."""
    opt = normalize_opt(config_parser().parse_args(argv))
    _reject_unported(opt)
    in_job = parallel.initialize_distributed(*(process_group or ()), device=opt.device)
    common.check_parallel(opt, in_job)
    if not in_job and opt.num_devices > 1:
        common.spawn_ranks(opt, _main, argv)
        return get_output_path(opt)
    device = common.select_device_from_env(opt.device)
    output_dir, ckpt_output_dir = config_log(opt, get_output_path(opt),
                                             file_logging=parallel.topology()[0] == 0)
    common.log_process_group(device)
    run_training(opt, output_dir, ckpt_output_dir, device)
    return output_dir


if __name__ == "__main__":
    main()
