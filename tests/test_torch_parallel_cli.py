"""The port's training CLI in two processes, on the protocol of the JAX
package's `tests/test_multihost_real.py`: 16 identical frames at 96x144,
global batch 16, 2 epochs, tiny net, CPU ranks over gloo.

With identical frames the multiset of (image, draw) pairs of a global batch
does not depend on how it is split (each rank takes its rows of the global
batch's draws), so a 2-rank run is comparable to one process at the global
batch: the per-step losses agree to every printed digit and `model.net`
within Adam's quantum (JAX's bounds: median parameter difference under
1e-5, the largest under 3 x steps x 2e-4). Rank 1 runs in its own working
directory and must write nothing; rank 0 writes JAX's log lines.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from crossloc_tpu_torch import compat, data
from crossloc_tpu_torch.cli import train_single_task as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG_H, IMG_W, FOCAL = 96, 144, 120.0
NAME = "urbanscape-coord-smh2p-no_unc-e2-lr0.0002-sim_only-sc1.00-tiny"


def write_identical_dataset(root: str, n: int = 16) -> None:
    """n copies of one synthetic frame."""
    data.write_fake_dataset(root, n=1, img_h=IMG_H, img_w=IMG_W, focal=FOCAL, seed=5)
    for sub in os.listdir(root):
        d = os.path.join(root, sub)
        files = sorted(os.listdir(d))
        if not files:
            continue
        ext = files[0].split("frame_00000")[1]
        for i in range(1, n):
            shutil.copyfile(os.path.join(d, files[0]), os.path.join(d, f"frame_{i:05d}{ext}"))


def train_args(datasets, ckpts, epochs=2, extra=()):
    return ["urbanscape", "--task", "coord", "--batch_size", "16", "--epochs", str(epochs),
            "--tiny", "--sim_data_chunk", "1.0", "--real_data_chunk", "0.0",
            "--datasets_dir", str(datasets), "--image_height", str(IMG_H),
            "--ckpt_dir", str(ckpts), "--session", "mh2p", "--device", "cpu", *extra]


def run_ranks_cli(cwds, args, store, timeout=240):
    """The train CLI as rank 0 and rank 1 of a job given by CROSSLOC_*; fails
    the test when a rank exits non-zero or outlives `timeout`."""
    procs = []
    for rank, cwd in enumerate(cwds):
        env = dict(os.environ, PYTHONPATH=REPO, CROSSLOC_COORDINATOR="file://" + str(store),
                   CROSSLOC_NUM_PROCESSES="2", CROSSLOC_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "crossloc_tpu_torch.cli.train_single_task", *args],
            cwd=str(cwd), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for rank, p in enumerate(procs):
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{out[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def run_single(cwd, args, monkeypatch):
    monkeypatch.chdir(cwd)
    torch.set_num_threads(2)
    cli.main(args)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh2p")
    write_identical_dataset(str(root / "datasets" / "urbanscape" / "train_sim"))
    return root


@pytest.fixture(scope="module")
def single(ws):
    """The single-process control at the global batch."""
    d = ws / "single"
    d.mkdir()
    cwd = os.getcwd()
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    os.chdir(d)
    try:
        cli.main(train_args(ws / "datasets", ws / "ckpt_single"))
    finally:
        os.chdir(cwd)
        torch.set_num_threads(n)
    return d / "output" / NAME


def assert_same_run(out, ref):
    losses = re.findall(r"Total loss: ([-\d.]+)", (out / "output.log").read_text())
    losses_ref = re.findall(r"Total loss: ([-\d.]+)", (ref / "output.log").read_text())
    assert losses == losses_ref and len(losses) == 2, (losses, losses_ref)
    a, b = compat.load_net(str(out / "model.net")), compat.load_net(str(ref / "model.net"))
    assert a.keys() == b.keys()
    diffs = sorted(float((a[k].double() - b[k].double()).abs().max()) for k in a)
    assert diffs[len(diffs) // 2] < 1e-5, diffs[len(diffs) // 2]
    assert diffs[-1] < 3.0 * 2 * 2e-4, diffs[-1]


def test_two_process_train_matches_single_process(ws, single):
    (ws / "rank0").mkdir()
    (ws / "rank1").mkdir()
    run_ranks_cli([ws / "rank0", ws / "rank1"], train_args(ws / "datasets", ws / "ckpts"),
                  ws / "store_dp")
    out0 = ws / "rank0" / "output" / NAME
    assert (out0 / "model.net").exists() and (out0 / "FLAG_training_done.nodata").exists()
    log0 = (out0 / "output.log").read_text()
    assert ("Multi-host data-parallel training: 2 processes x 1 local devices "
            "(global batch 16, local 8)") in log0
    assert "Process group: backend gloo, rank 0 of 2 on cpu" in log0
    assert "Iteration:      32, Epoch:   1" in log0  # global samples
    assert not (ws / "rank1" / "output").exists()  # rank 1 writes nothing
    assert (ws / "ckpts" / NAME / "FLAG_training_done.nodata").exists()
    assert_same_run(out0, single)


def test_num_devices_zero_matches_single_process(ws, single, monkeypatch):
    """--num_devices 2 --zero --device cpu: two spawned CPU ranks with the
    parameters and Adam moments sharded; the same run as one process."""
    d = ws / "zero"
    d.mkdir()
    run_single(d, train_args(ws / "datasets", ws / "ckpt_zero",
                             extra=["--num_devices", "2", "--zero"]), monkeypatch)
    out = d / "output" / NAME
    log = (out / "output.log").read_text()
    assert "Data-parallel training over 2 devices with ZeRO parameter sharding" in log
    assert log.count("Iteration:") == 2  # rank 0's lines only
    assert_same_run(out, single)
    ckpt = ws / "ckpt_zero" / NAME
    assert sorted(p.name for p in ckpt.glob("ckpt_iter_*.net")) == ["ckpt_iter_0000016.net"]
    assert np.isfinite([v.float().sum().item()
                        for v in compat.load_net(str(out / "model.net")).values()]).all()


def test_e2e_step_draws_the_global_pool(ws, monkeypatch):
    """--e2e_pose_loss under --num_devices 2: each rank solves with its rows
    of the global batch's hypothesis draws, so the first DSAC step's loss is
    the one-process loss to every printed digit (later steps part within the
    ill-conditioned solve's f32 rounding)."""
    losses = []
    for tag, extra in (("e2e_one", []), ("e2e_two", ["--num_devices", "2"])):
        d = ws / tag
        d.mkdir()
        run_single(d, train_args(ws / "datasets", ws / f"ckpt_{tag}", epochs=1,
                                 extra=["--e2e_pose_loss", *extra]), monkeypatch)
        log = (d / "output" / NAME.replace("-e2-", "-e2e-e1-") / "output.log").read_text()
        losses.append(re.findall(r"Total loss: ([-\d.]+)", log))
    assert len(losses[0]) == 1 and losses[0] == losses[1], losses
