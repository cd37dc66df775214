"""Evaluate trained weights on the card unless `--device cpu`: image -> pose
through the port's net and solver for the coord task; per-batch depth and
normal errors and per-image segmentation scores for the other tasks. A
finetuned MLR net's tower count comes from its folder's name
("decoder_coord_free_depth_normal" holds three).

    python -m crossloc_tpu_torch.cli.test_single_task urbanscape --task coord \
        --uncertainty MLE --network_in <dir or model.net> --section val_drone_real

Same flags, weight discovery, per-frame lines and `results_*.txt` format as
`crossloc_tpu/cli/test_single_task.py`; adds `--device`. `--bf16` runs the
convs and the GroupNorm kernel in bfloat16 (params, norm statistics, outputs
and the solver stay float32). Eval images pass through the uint8 wire
format, as the reference's uint8 image path does. `--plot` writes each
semantics batch's image | prediction | label grid beside the network
(`sm_section_<section>_batch_<i>.png`; needs matplotlib) and does nothing
for the other tasks, as the JAX CLI.

`--num_devices N` evaluates data-parallel in this one process: the weights
are copied to N cards (N times the CPU with `--device cpu`), each batch is
padded to a multiple of N by repeating its last frame, split, run through
the net and the solver on each device and sliced back to its real frames.
The solver's draws are made once for the whole batch and then split, so
the `results_*.txt` do not depend on N. `main(argv, devices=[...])` names
the devices instead (tests and the card run use `[cpu, cpu]` and
`[cuda:0, cuda:0]`).
"""
from __future__ import annotations

import argparse
import copy
import glob
import json
import os
from types import SimpleNamespace
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import compat, eval as evaluation, models, ransac
from ..data import (CamLocDataset, Loader, decoder_line, images_from_wire, images_to_wire,
                    to_grayscale)
from ..losses import get_nodata_value
from .common import build_network, infer_num_encoders, select_device_from_env


def config_parser():
    parser = argparse.ArgumentParser(
        description="Evaluate a scene coordinate regression network.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("scene", nargs="?", default=None)
    parser.add_argument("--grayscale", "-grayscale", action="store_true")
    parser.add_argument("--task", type=str, default=None)
    parser.add_argument("--section", type=str, nargs="+", default=["val_drone_sim", "val_drone_real"])
    parser.add_argument("--network_in", type=str, default=None)
    parser.add_argument("--tiny", "-tiny", action="store_true")
    parser.add_argument("--fullsize", "-fullsize", action="store_true")
    parser.add_argument("--session", "-sid", default="")
    parser.add_argument("--search_dir", action="store_true")
    parser.add_argument("--min_ckpt_iter", default=None, type=float)
    parser.add_argument("--max_ckpt_iter", default=None, type=float)
    parser.add_argument("--keywords", default=None, nargs="+")
    parser.add_argument("--plot", action="store_true")
    parser.add_argument("--save_pred", action="store_true")
    parser.add_argument("--hypotheses", "-hyps", type=int, default=64)
    parser.add_argument("--threshold", "-t", type=float, default=10)
    parser.add_argument("--inlieralpha", "-ia", type=float, default=100)
    parser.add_argument("--maxpixelerror", "-maxerrr", type=float, default=100)
    parser.add_argument("--uncertainty", "-uncertainty", default=None, type=str)
    parser.add_argument("--batch_size", type=int, default=8,
                        help="eval batch size (framework extension; reference is 1)")
    parser.add_argument("--datasets_dir", type=str, default="./datasets")
    parser.add_argument("--image_height", type=int, default=480,
                        help="standard input image height (framework extension)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 convs and GroupNorm for the network forward "
                             "(params, norm statistics, outputs and the solver stay f32)")
    parser.add_argument("--num_devices", type=int, default=1,
                        help="data-parallel evaluation over N cards in this process "
                             "(--device cpu: N times the CPU)")
    parser.add_argument("--ransac_cfg", type=str, default="{}",
                        help="RansacConfig field overrides as JSON, e.g. "
                             "'{\"refine_top_k\": 4, \"eval_selection\": \"hard\"}'")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (default; raises without CUDA) or cpu")
    return parser


def config_weight_path(
    network_in: Union[str, list],
    keywords=None,
    search_dir: bool = False,
    min_ckpt_iter: Optional[float] = None,
    max_ckpt_iter: Optional[float] = None,
) -> List[str]:
    """Weight discovery rules of the reference, including its quirk that
    setting min/max_ckpt_iter drops `model.net` (only `ckpt_iter_*` files
    carry an iteration number)."""
    if isinstance(network_in, list):
        paths_in = sorted(os.path.abspath(p) for p in network_in)
    else:
        paths_in = [os.path.abspath(network_in)]

    if search_dir:
        if len(paths_in) != 1 or not os.path.isdir(paths_in[0]):
            raise ValueError("--search_dir takes one directory as --network_in")
        src = paths_in[0]
        paths_in = [os.path.join(src, d) for d in os.listdir(src)]

    network_paths: List[str] = []
    for path in paths_in:
        if not os.path.exists(path):
            raise FileNotFoundError(f"Network input path {path} is not found.")
        if os.path.isdir(path):
            model_path = os.path.join(path, "model.net")
            if os.path.exists(model_path):
                network_paths.append(model_path)
            network_paths += glob.glob(os.path.join(path, "ckpt_iter*.net"))
        elif os.path.isfile(path):
            base = os.path.basename(path)
            if (base.startswith("model") or "ckpt_" in base) and base.endswith(".net"):
                network_paths.append(path)

    if keywords is not None:
        if isinstance(keywords, str):
            keywords = [keywords]
        network_paths = sorted(
            {p for p in network_paths if all(k in os.path.dirname(p) for k in keywords)})

    def _iter_of(p):
        return int(os.path.basename(p).split("_")[-1].replace(".net", ""))

    if min_ckpt_iter is not None:
        network_paths = [p for p in network_paths
                         if "ckpt_iter_" in os.path.basename(p) and _iter_of(p) > min_ckpt_iter]
    if max_ckpt_iter is not None:
        network_paths = [p for p in network_paths
                         if "ckpt_iter_" in os.path.basename(p) and _iter_of(p) < max_ckpt_iter]
    network_paths.sort()
    for idx, path in enumerate(network_paths):
        print("Network weight #{:d}: {:s}".format(idx, path))
    return network_paths


def resolve_eval_roots(scene: str, section_keyword: str, datasets_dir: str = "./datasets"):
    """Section directory, or the list behind an aggregate keyword."""
    direct = os.path.join(datasets_dir, scene, section_keyword)
    if os.path.exists(direct):
        return direct
    specials = {
        "test_real_all": ["val_drone_real", "test_drone_real"],
        "real_all": ["val_drone_real", "test_drone_real", "train_drone_real"],
        "test_sim_all": ["val_drone_sim", "val_sim", "test_drone_sim"],
        "sim_all": ["val_drone_sim", "val_sim", "test_drone_sim", "train_sim"],
    }
    if section_keyword not in specials:
        raise NotImplementedError(f"section {section_keyword} not found")
    return [os.path.join(datasets_dir, scene, s) for s in specials[section_keyword]]


def _ransac_config(opt, fullsize: bool) -> ransac.RansacConfig:
    cfg = ransac.RansacConfig(
        hypotheses=opt.hypotheses,
        inlier_threshold=opt.threshold,
        inlier_alpha=opt.inlieralpha,
        max_pixel_error=opt.maxpixelerror,
        subsample=1 if fullsize else 8,
    )
    overrides = json.loads(getattr(opt, "ransac_cfg", None) or "{}")
    if not overrides:
        return cfg
    unknown = set(overrides) - set(cfg._fields)
    if unknown:
        raise ValueError(f"unknown RansacConfig fields in --ransac_cfg: {sorted(unknown)}")
    for k, v in list(overrides.items()):
        want = type(getattr(cfg, k))
        if isinstance(v, want):
            continue
        if want is int and isinstance(v, float) and v != int(v):
            raise ValueError(f"--ransac_cfg {k}={v!r}: expected {want.__name__}")
        if want is bool or not isinstance(v, (int, float)):
            raise ValueError(f"--ransac_cfg {k}={v!r}: expected {want.__name__}")
        overrides[k] = want(v)
    print("RansacConfig overrides: %s" % overrides)
    return cfg._replace(**overrides)


def eval_devices(opt, devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices of an evaluation: `devices` when given, else
    `--num_devices` of `--device` (cards 0..N-1, or the CPU N times);
    too few cards raise the JAX CLI's error."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    device = select_device_from_env(getattr(opt, "device", None))
    ndev = max(1, int(getattr(opt, "num_devices", 1) or 1))
    if ndev == 1:
        return [device]
    if device.type == "cpu":
        return [device] * ndev
    found = torch.cuda.device_count()
    if found < ndev:
        raise ValueError(f"requested {ndev} devices, found {found}")
    return [torch.device("cuda", i) for i in range(ndev)]


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """`t` with its last row repeated to `n` rows."""
    return torch.cat([t, t[-1:].expand(n - t.shape[0], *t.shape[1:])]) if n > t.shape[0] else t


def evaluate_network(opt, network_path: str, scene, grayscale, task, sections, tiny,
                     fullsize, uncertainty, devices: Optional[Sequence] = None) -> str:
    """Evaluate one weight file over all sections; returns the results path.
    `devices` as in `eval_devices`."""
    devices = eval_devices(opt, devices)
    device = devices[0]
    nodata_value = get_nodata_value(scene)
    model = build_network(
        scene, task, tiny, grayscale, uncertainty, fullsize,
        np.zeros(models.task_channels(task), np.float32), num_mlr=infer_num_encoders(network_path),
        dtype=torch.bfloat16 if getattr(opt, "bf16", False) else torch.float32)
    compat.load_net(network_path, model)
    replicas = []
    for dev in devices:
        m = copy.deepcopy(model).to(dev).eval()
        if dev.type == "cuda":
            m.to(memory_format=torch.channels_last)
        replicas.append(m)
    print("Successfully loaded %s." % network_path)
    if len(devices) > 1:
        print("Data-parallel evaluation over %d devices" % len(devices))

    cfg = _ransac_config(opt, fullsize)
    ntc = model.num_task_channel
    testing_log = os.path.join(
        os.path.dirname(network_path),
        "results_{:s}_task_{:s}.txt".format(os.path.basename(network_path), task),
    )

    for this_section in sections:
        print("{:s} Evaluating over section {:s} {:s}".format("*" * 20, this_section, "*" * 20))
        eval_set = CamLocDataset(resolve_eval_roots(scene, this_section, opt.datasets_dir),
                                 coord=task == "coord", depth=task == "depth",
                                 normal=task == "normal", semantics=task == "semantics",
                                 image_height=opt.image_height)
        print(decoder_line(eval_set))
        loader = Loader(eval_set, batch_size=opt.batch_size)
        if opt.save_pred and task == "coord":
            pred_dir = os.path.abspath(os.path.join(
                network_path, "../{:s}_pred_{:s}_{:s}".format(
                    task, os.path.basename(network_path), this_section)))
            os.makedirs(pred_dir, exist_ok=True)

        t_err_ls, r_err_ls, est_xyz_ls, coords_error_ls, file_name_ls = [], [], [], [], []
        depth_ar_ls, depth_rms_ls, normal_err_ls = [], [], []
        miou_ls, fwiou_ls, acc_ls = [], [], []
        # the JAX package's PRNG stream cannot be reproduced in torch: the
        # port draws its hypotheses from its own generator, seeded alike
        gen = torch.Generator(device=device).manual_seed(2021)

        @torch.no_grad()
        def forward_split(wire):
            """(images, preds) of the batch, each device's share run on it and
            the results gathered on the first device, sliced to the real frames."""
            n_real, nd = wire.shape[0], len(devices)
            chunks = _pad_rows(wire, -(-n_real // nd) * nd).chunk(nd)
            images, preds = [], []
            for dev, m, chunk in zip(devices, replicas, chunks):
                x = images_from_wire(chunk.to(dev, non_blocking=True))
                if grayscale:
                    x = to_grayscale(x)
                images.append(x)
                preds.append(m(x))
            return images, preds

        @torch.no_grad()
        def dispatch(batch):
            """Enqueue the device work of one batch (CUDA runs it async)."""
            wire = torch.from_numpy(images_to_wire(batch["image"]))
            n_real = wire.shape[0]
            image_parts, pred_parts = forward_split(wire)
            images = torch.cat([x.to(device) for x in image_parts])[:n_real]
            preds = torch.cat([p.to(device) for p in pred_parts])[:n_real]
            d = dict(batch=batch, preds=preds)
            if task == "coord":
                hs, ws = preds.shape[1], preds.shape[2]
                # the whole batch's draws, as the solver makes them on one device
                idx = torch.randint(0, hs * ws, (n_real, cfg.hypotheses * cfg.sample_rounds, 4),
                                    generator=gen, device=device)
                focal = torch.from_numpy(batch["focal"])
                rows = pred_parts[0].shape[0]
                poses = []
                for i, (dev, part) in enumerate(zip(devices, pred_parts)):
                    sl = slice(i * rows, (i + 1) * rows)
                    res = ransac.solve_batch(part[..., :ntc],
                                             _pad_rows(focal, rows * len(devices))[sl].to(dev),
                                             (images.shape[1], images.shape[2]), cfg,
                                             idx=_pad_rows(idx, rows * len(devices))[sl].to(dev))
                    poses.append(res.cam_to_world.to(device))
                d["res"] = SimpleNamespace(cam_to_world=torch.cat(poses)[:n_real])
            elif task == "semantics":
                # the class map leaves the card, not the full-size logits
                d["classes"] = torch.argmax(preds, dim=-1)
                if opt.plot:
                    d["images"] = images
            return d

        def consume(d):
            batch = d["batch"]
            file_name_ls.extend(os.path.basename(f) for f in batch["file_name"])
            if task == "depth":
                ar, rms = evaluation.depth_eval(d["preds"][..., :ntc].cpu(), batch["depth"],
                                                nodata_value)
                depth_ar_ls.append(ar)
                depth_rms_ls.append(rms)
                return
            if task == "normal":
                normal_err_ls.append(evaluation.normal_eval(d["preds"][..., :ntc].cpu(),
                                                            batch["normal"], nodata_value))
                return
            if task == "semantics":
                miou, fwiou, acc = evaluation.semantic_scores(d["classes"].cpu().numpy(),
                                                              batch["semantics"], ntc)
                miou_ls.append(miou)
                fwiou_ls.append(fwiou)
                acc_ls.append(acc)
                if opt.plot:
                    from .visualize import semantic_plotter

                    semantic_plotter(d["images"].float().cpu().numpy(), d["classes"].cpu().numpy(),
                                     batch["semantics"], network_path, this_section,
                                     len(acc_ls) - 1)
                return
            preds = d["preds"].cpu()
            cam_to_world = d["res"].cam_to_world.cpu()
            labels = batch["coord"]
            for b in range(preds.shape[0]):
                t_err, r_err = evaluation.pose_err(batch["pose"][b], cam_to_world[b])
                t_err_ls.append(t_err)
                r_err_ls.append(r_err)
                est_xyz_ls.append(cam_to_world[b][0:3, 3].numpy())
                coords_error_ls.append(evaluation.coord_errors(
                    preds[b][None, ..., :ntc], labels[b][None], nodata_value))
                print("\nRotation Error: %.2f deg, Translation Error: %.1f m, "
                      "Mean coord prediction error: %.1f m"
                      % (r_err, t_err, float(np.mean(coords_error_ls[-1]))))
                if opt.save_pred:
                    fn = os.path.basename(batch["file_name"][b])
                    unc = preds[b][..., ntc:]
                    np.savez(
                        os.path.join(pred_dir, fn.replace(".png", ".npz")),
                        coord_pred=np.transpose(preds[b][..., :ntc].numpy(), (2, 0, 1)),
                        coord_gt=np.transpose(labels[b], (2, 0, 1)),
                        coord_unc=unc[..., 0].numpy() if unc.shape[-1] else None,
                        pose_pred=cam_to_world[b].numpy(),
                        pose_gt=batch["pose"][b],
                        pose_t_err=t_err_ls[-1], pose_r_err=r_err_ls[-1],
                    )

        # one-batch lookahead: batch i+1's device work is queued while the
        # host computes batch i's metrics
        pending = None
        for batch in loader:
            d = dispatch(batch)
            if pending is not None:
                consume(pending)
            pending = d
        if pending is not None:
            consume(pending)

        print("{:s} Evaluating over section {:s} is done!{:s}".format("*" * 20, this_section, "*" * 20))
        if task == "coord":
            eval_str = evaluation.scene_coords_report(
                t_err_ls, r_err_ls, est_xyz_ls, coords_error_ls, testing_log,
                network_path, this_section, file_name_ls,
            )
        elif task == "depth":
            eval_str = evaluation.depth_report(depth_ar_ls, depth_rms_ls, testing_log,
                                               this_section)
        elif task == "normal":
            eval_str = evaluation.normal_report(normal_err_ls, testing_log, this_section)
        else:
            eval_str = evaluation.semantic_report(acc_ls, miou_ls, fwiou_ls, testing_log,
                                                  this_section)
        print(eval_str)

    print("Network testing finished. Please find the log at {:s}".format(testing_log))
    return testing_log


def main(argv=None, devices: Optional[Sequence] = None):
    """The CLI; `devices` (a list of torch devices) in place of
    `--device` / `--num_devices`."""
    opt = config_parser().parse_args(argv)
    if opt.search_dir:
        opt.scene = opt.grayscale = opt.task = opt.section = None
        opt.tiny = opt.fullsize = opt.uncertainty = None
        print("search_dir is ON. Model parameters would be read from the folder name...")
    if isinstance(opt.uncertainty, str):
        if opt.uncertainty.lower() == "none":
            opt.uncertainty = None
        elif opt.uncertainty.lower() == "mle":
            opt.uncertainty = "MLE"

    network_paths = config_weight_path(
        opt.network_in, opt.keywords, opt.search_dir, opt.min_ckpt_iter, opt.max_ckpt_iter)
    devices = eval_devices(opt, devices)
    logs = []
    for network_path in network_paths:
        if opt.search_dir:
            folder = os.path.basename(os.path.dirname(network_path))
            scene, grayscale, task, sections, tiny, fullsize, uncertainty = (
                compat.read_meta_info(folder))
        else:
            scene, grayscale, task = opt.scene, opt.grayscale, opt.task
            sections, tiny, fullsize, uncertainty = (
                opt.section, opt.tiny, opt.fullsize, opt.uncertainty)
        logs.append(evaluate_network(
            opt, network_path, scene, grayscale, task, sections, tiny, fullsize, uncertainty,
            devices))
    return logs


if __name__ == "__main__":
    main()
