"""Fine-tune a task decoder over the concatenated encoders of several tasks
(CrossLoc's MLR stage) on the card unless `--device cpu`.

    python -m crossloc_tpu_torch.cli.finetune_decoder_single_task urbanscape \
        --task coord --uncertainty MLE --batch_size 8 --learningrate 1e-4 \
        --encoders coord depth normal --coord_weight <coord .net> \
        --depth_weight <depth .net> --normal_weight <normal .net> \
        --reuse_coord_encoder --unfreeze_coord_encoder --no_lr_scheduling \
        --sim_data_chunk 0.0 --real_data_chunk 1.0 --auto_resume

Flags, output-directory names and log lines are those of
`crossloc_tpu/cli/finetune_decoder_single_task.py`, plus the training CLI's
(`--device` among them). The coord weight initialises the decoder and, with
`--reuse_coord_encoder`, the first encoder tower, which keeps training with
`--unfreeze_coord_encoder`; each other task's weight fills one frozen tower.
A fresh run writes the wired weights to `model.net` before its first step;
the loop, snapshots, resume, `--e2e_pose_loss` and the parallel flags
(`--num_devices`, `--zero`, `--ckpt_backend orbax`, the CROSSLOC_* launch)
are the training CLI's. The frozen towers are identical on every rank and
stay replicated under `--zero`; Adam holds nothing for them.
"""
from __future__ import annotations

import argparse
import logging
import os

import torch

from .. import compat, models, parallel
from ..data import get_label_mean
from ..utils import check_encoders, config_log
from . import common
from .train_single_task import _reject_unported, config_parser, normalize_opt, run_training


def _extend_parser(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser.add_argument("--encoders", nargs="+", required=True,
                        help="pretrained encoders to concatenate, e.g. coord depth normal "
                             "[semantics]")
    parser.add_argument("--coord_weight", type=str, default=None)
    parser.add_argument("--depth_weight", type=str, default=None)
    parser.add_argument("--normal_weight", type=str, default=None)
    parser.add_argument("--semantics_weight", type=str, default=None)
    parser.add_argument("--reuse_coord_encoder", action="store_true",
                        help="reuse the coord pretrain encoder as an MLR encoder")
    parser.add_argument("--unfreeze_coord_encoder", action="store_true",
                        help="let the reused coord encoder keep training")
    return parser


def get_output_path(opt) -> str:
    """output/<name> under the working directory, the name from the flags."""
    name = compat.finetune_output_name(
        opt.scene, opt.task, opt.encoders, reuse_coord_encoder=opt.reuse_coord_encoder,
        unfreeze_coord_encoder=opt.unfreeze_coord_encoder, session=opt.session,
        grayscale=opt.grayscale, uncertainty=opt.uncertainty, fullsize=opt.fullsize,
        epochs=opt.epochs, learning_rate=opt.learningrate, real_data_chunk=opt.real_data_chunk,
        sim_data_chunk=opt.sim_data_chunk, real_data_domain=opt.real_data_domain,
        real_only=opt.real_only, tiny=opt.tiny, network_in=opt.network_in, debug=opt.debug,
        e2e=opt.e2e_pose_loss, bf16=opt.bf16)
    return os.path.abspath(os.path.join("output", name))


def main(argv=None) -> str:
    """Parse, check the encoder weights, set up the output directory and log,
    wire the MLR net and train it; returns the output directory."""
    return _main(argv)


def _main(argv=None, process_group=None) -> str:
    """`main`; a rank of `--num_devices` gets its `process_group`
    (init method, world size, rank)."""
    parser = _extend_parser(config_parser("Fine-tune a task decoder over frozen MLR encoders."))
    opt = normalize_opt(parser.parse_args(argv))
    _reject_unported(opt)
    in_job = parallel.initialize_distributed(*(process_group or ()), device=opt.device)
    common.check_parallel(opt, in_job)
    if opt.task != "coord":
        # the decoder starts from the coord weight's: its head fits no other task
        raise ValueError(f"--task {opt.task}: the MLR decoder finetune takes --task coord")
    encoder_paths = check_encoders(list(opt.encoders), opt.coord_weight, opt.depth_weight,
                                   opt.normal_weight, opt.semantics_weight)
    if opt.reuse_coord_encoder:
        num_mlr = len(encoder_paths)
    elif opt.unfreeze_coord_encoder:
        raise ValueError("--unfreeze_coord_encoder needs --reuse_coord_encoder")
    else:
        num_mlr = len(encoder_paths) - 1  # the coord weight only initialises the decoder
    output_path = get_output_path(opt)
    named = common.infer_num_encoders(os.path.join(output_path, "model.net"))
    if named != num_mlr:
        # the eval CLI builds the net from the folder name
        raise ValueError(f"the output folder {os.path.basename(output_path)} names {named} "
                         f"encoders but the net has {num_mlr}: list coord first in --encoders")
    if not in_job and opt.num_devices > 1:
        common.spawn_ranks(opt, _main, argv)
        return output_path
    device = common.select_device_from_env(opt.device)
    is_main = parallel.topology()[0] == 0
    output_dir, ckpt_output_dir = config_log(opt, output_path, file_logging=is_main)
    common.log_process_group(device)

    model = common.build_network(
        opt.scene, opt.task, opt.tiny, opt.grayscale, opt.uncertainty, opt.fullsize,
        get_label_mean(opt.scene, opt.task), num_mlr=num_mlr,
        num_unfrozen_encoder=1 if opt.unfreeze_coord_encoder else 0,
        dtype=torch.bfloat16 if opt.bf16 else torch.float32)
    logging.info("%d network weights to load, flag_unfreeze_coord_encoder: %s",
                 num_mlr, opt.unfreeze_coord_encoder)
    if opt.network_in is None:
        models.init_weights(model, torch.Generator().manual_seed(2021))
        common.wire_mlr_weights(model, encoder_paths, opt.reuse_coord_encoder)
        if is_main:
            model_path = os.path.join(output_dir, "model.net")
            compat.save_net(model_path, model)
            logging.info("Saving the initialized MLR model weight to {:s}".format(model_path))
    run_training(opt, output_dir, ckpt_output_dir, device, model=model)
    return output_dir


if __name__ == "__main__":
    main()
