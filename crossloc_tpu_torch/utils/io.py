"""Logging, output directories and log-parse resume (counterpart of
`crossloc_tpu/utils/io.py`).

  * `read_training_log`: (iteration, epoch) from the last 100 lines of
    `output.log`, the reference's store of training progress.
  * `config_directory`: `--auto_resume` reuses the output directory and the
    newest of model{,_auto_resume,_epoch_plus_resume,_resume}.net;
    `--epoch_plus` finds the finished sibling run with the largest -eN.
  * `config_log`: file + stdout logging in the reference's line format.
  * `check_encoders`: the finetune CLI's encoder weights, coord first.
"""
from __future__ import annotations

import copy
import glob
import logging
import os
import re
import shutil
import subprocess
import sys
from typing import List, Optional, Tuple

import numpy as np

_RESUME_CANDIDATES = (
    "model_auto_resume.net",
    "model.net",
    "model_epoch_plus_resume.net",
    "model_resume.net",
)


def safe_printout(words: str) -> None:
    if logging.getLogger().hasHandlers():
        logging.info(words)
    else:
        print(words)


def read_training_log(log_path: str, iter_per_epoch: int) -> Tuple[int, int]:
    """(last_iteration, last_epoch) from the tail of output.log."""
    with open(log_path) as f:
        tail = "".join(f.readlines()[-100:])
    pattern = r"Iteration:\s+(?P<iter>\d+), Epoch:\s+(?P<epoch>\d+)"
    matches = re.findall(pattern, tail)
    if not matches:
        safe_printout("Maybe this is an empty training log. Setting last_iteration and last_epoch to 0...")
        return 0, 0
    last_iteration = max(int(m[0]) for m in matches)
    last_epoch = max(int(m[1]) for m in matches)
    if abs(last_iteration // iter_per_epoch - last_epoch) > 5:
        raise AssertionError(
            "Last iteration {:d} does not match last epoch {:d} with iteration per epoch being {:d}.".format(
                last_iteration, last_epoch, iter_per_epoch
            )
        )
    return last_iteration, last_epoch


def get_unique_file_name(file_path: str) -> str:
    """'<...>/<section>/rgb/name.png' -> 'name.png@<section>'."""
    section = os.path.basename(os.path.dirname(os.path.dirname(file_path)))
    return os.path.basename(file_path) + "@" + section


def get_epoch_from_dirname(model_dirname: str) -> Optional[int]:
    """The N of the "-eN-lr" token (anchored on "-lr", so "-e2e" and a
    session name never match)."""
    found = re.findall(r"-e(?P<epoch>\d+)(?=-lr)", model_dirname)
    return int(found[0]) if len(found) == 1 else None


def _has_model(d: str) -> bool:
    return any(os.path.exists(os.path.join(d, m)) for m in _RESUME_CANDIDATES)


def search_epoch_extension_model(output_dir: str) -> str:
    """The finished sibling run with the largest -eN, to extend."""
    dirname = os.path.basename(output_dir)
    key = f"-e{get_epoch_from_dirname(dirname)}"
    pos = dirname.find(key + "-lr")
    prefix = dirname[:pos]
    suffix = dirname[pos + len(key):]

    candidates, epochs = [], []
    for entry in glob.glob(os.path.abspath(os.path.join(output_dir, "../*"))):
        if not os.path.isdir(entry):
            continue
        if prefix in entry and suffix in entry:
            e = get_epoch_from_dirname(os.path.basename(entry))
            if e is None:
                continue
            done = os.path.exists(os.path.join(entry, "FLAG_training_done.nodata"))
            has_log = os.path.exists(os.path.join(entry, "output.log"))
            if _has_model(entry) and done and has_log:
                candidates.append(entry)
                epochs.append(e)
    if not candidates:
        raise RuntimeError("No plausible model to read for epoch extension experiments.")
    best = candidates[int(np.argmax(epochs))]
    print(f"Epoch extension: loading checkpoint from {best}")
    return best


def _stdin_is_foreground_tty() -> bool:
    """True only when stdin is a TTY of which this process holds the
    foreground (a backgrounded job would stop on input())."""
    try:
        fd = sys.stdin.fileno()
        return sys.stdin.isatty() and os.tcgetpgrp(fd) == os.getpgrp()
    except (AttributeError, OSError, ValueError):
        return False


def config_directory(output_dir: str, ckpt_dir: str, auto_resume: bool, epoch_plus: bool,
                     default_network_in: Optional[str] = None):
    """Resolve the output and checkpoint directories and the weight to resume
    from: (output_dir, ckpt_output_dir, network_to_load, auto_resume,
    epoch_plus). An existing output directory of a fresh run is wiped; when
    stdin is a foreground TTY the reference's prompt asks first."""
    output_dir = os.path.abspath(output_dir)
    ckpt_output_dir = (os.path.abspath(os.path.join(ckpt_dir, os.path.basename(output_dir)))
                       if ckpt_dir else output_dir)

    if auto_resume:
        auto_resume = (os.path.exists(output_dir)
                       and os.path.exists(os.path.join(output_dir, "output.log"))
                       and _has_model(output_dir))
    print(f"Effective auto resume: {auto_resume}")

    _epoch_plus = copy.copy(epoch_plus)
    resume_dir = None
    if epoch_plus:
        if auto_resume:
            epoch_plus = False
        else:
            resume_dir = search_epoch_extension_model(output_dir)
    print(f"Effective epoch extension: {epoch_plus}")

    if auto_resume or epoch_plus:
        if auto_resume:
            resume_dir = output_dir
        else:
            os.makedirs(output_dir, exist_ok=True)
        if os.path.exists(os.path.join(resume_dir, "model_auto_resume.net")):
            existing = os.path.join(resume_dir, "model_auto_resume.net")
        elif auto_resume and _epoch_plus:
            existing = os.path.join(resume_dir, "model_epoch_plus_resume.net")
        elif os.path.exists(os.path.join(resume_dir, "model_epoch_plus_resume.net")) and not auto_resume:
            existing = os.path.join(resume_dir, "model_epoch_plus_resume.net")
        elif default_network_in is None:
            existing = os.path.join(resume_dir, "model.net")
        else:
            existing = os.path.join(resume_dir, "model_resume.net")
        if not os.path.exists(existing):
            raise FileNotFoundError(f"Expected model weight at {existing} is not found!")
        network_to_load = os.path.abspath(existing)
        os.makedirs(ckpt_output_dir, exist_ok=True)
    else:
        if os.path.exists(output_dir):
            overwrite = True
            if _stdin_is_foreground_tty():
                key = input("Output directory already exists! Overwrite? (y/n)")
                overwrite = key.lower() == "y"
            if overwrite:
                shutil.rmtree(output_dir)
            os.makedirs(output_dir, exist_ok=True)
        else:
            os.makedirs(output_dir)
        if os.path.exists(ckpt_output_dir):
            shutil.rmtree(ckpt_output_dir)
        os.makedirs(ckpt_output_dir, exist_ok=True)
        network_to_load = None
    return output_dir, ckpt_output_dir, network_to_load, auto_resume, epoch_plus


def _git_sha() -> str:
    try:
        return subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL, text=True
        ).strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def config_log(opt, output_dirname: str) -> Tuple[str, str]:
    """File + stdout logging; returns (output_dir, ckpt_output_dir). Sets
    `opt.network_in`, `opt.auto_resume` and `opt.epoch_plus` as the
    reference does."""
    output_dir, ckpt_output_dir, network_to_load, flag_ar, flag_ep = config_directory(
        output_dirname, opt.ckpt_dir, opt.auto_resume, opt.epoch_plus, opt.network_in)
    if not (opt.network_in is not None and network_to_load is None):
        opt.network_in = network_to_load
    opt.auto_resume = flag_ar
    opt.epoch_plus = flag_ep

    log_file = os.path.join(output_dir, "output.log")
    if opt.epoch_plus:
        shutil.copy2(os.path.join(os.path.dirname(network_to_load), "output.log"), log_file)

    root = logging.getLogger()
    for h in list(root.handlers):  # repeated in-process calls log afresh
        root.removeHandler(h)
    mode = "a" if (opt.auto_resume or opt.epoch_plus) else "w"
    logging.basicConfig(
        level=logging.INFO,
        handlers=[logging.StreamHandler(sys.stdout), logging.FileHandler(log_file, mode=mode)],
        format="%(asctime)s, %(levelname)s: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
        force=True,
    )
    if opt.auto_resume:
        logging.info("***** Automatic resume training from {:s} *****".format(opt.network_in))
    elif opt.epoch_plus:
        logging.info("***** Epoch extension resume training from {:s} *****".format(opt.network_in))
    else:
        logging.info("***** A new training has been started *****")
    logging.info("Current git head hash code: %s" % _git_sha())
    logging.info("Path to save data: {:s}".format(output_dir))
    logging.getLogger("PIL").setLevel(logging.INFO)
    logging.info("Arg parser: ")
    logging.info(opt)
    logging.info("Saving model to {:s}".format(output_dir))
    logging.info("Saving checkpoint model to {:s}".format(ckpt_output_dir))
    return output_dir, ckpt_output_dir


def check_encoders(encoders: list, coord_weight: Optional[str], depth_weight: Optional[str],
                   normal_weight: Optional[str], semantics_weight: Optional[str]) -> List[str]:
    """The weight paths of the named encoders: each task once, coord first,
    then the others sorted. Raises on an unknown task, a missing coord
    encoder or a weight file that does not exist."""
    for entry in encoders:
        if entry not in ("coord", "depth", "normal", "semantics"):
            raise ValueError(f"encoder model {entry} is not supported!")
    if "coord" not in encoders:
        raise ValueError(
            "A coordinate regression network weight must be provided for decoder initialization!")
    by_task = {"coord": coord_weight, "depth": depth_weight, "normal": normal_weight,
               "semantics": semantics_weight}
    paths = []
    for entry in sorted(set(encoders)):
        w = by_task[entry]
        if w is None or not os.path.exists(w):
            raise FileNotFoundError(f"weight for encoder '{entry}' not found: {w}")
        if entry == "coord":
            paths.insert(0, w)
        else:
            paths.append(w)
    safe_printout("{:d} network weights are to be loaded for reuse".format(len(paths)))
    return paths
