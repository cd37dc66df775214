"""Full-state checkpoints under data parallelism: the "orbax" backend
(`torch.distributed.checkpoint` directories `<dir>/<step>/`) and the
rank-0 "msgpack" file, saved by two ZeRO ranks and restored re-sharded into
one process; and the training CLI's save and exact resume through them in
two ranks (the protocol of the JAX package's `tests/test_multihost_real.py`:
16 identical frames, global batch 16).
"""
import os
import re

import numpy as np
import pytest
import torch

from crossloc_tpu_torch import models
from crossloc_tpu_torch.cli import train_single_task as cli
from crossloc_tpu_torch.tools.parallel_check import checkpoint_check, run_ranks
from crossloc_tpu_torch.train import (
    CheckpointManager,
    TrainBatch,
    TrainState,
    make_optimizer,
    train_state_dict,
    train_step,
)

from test_torch_parallel_cli import NAME, train_args, write_identical_dataset

IMG_H, IMG_W = 48, 64
MEAN = [1.0, -2.0, 30.0]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(B=4):
    g = torch.Generator().manual_seed(0)
    labels = torch.randn(B, IMG_H // 8, IMG_W // 8, 3, generator=g) + torch.tensor(MEAN)
    poses = torch.eye(4).repeat(B, 1, 1)
    poses[:, 2, 3] = -10.0
    return dict(images=torch.randn(B, IMG_H, IMG_W, 3, generator=g), poses=poses, labels=labels,
                focal=torch.tensor(50.0), pp_shift=torch.zeros(2))


def _spec(zero=True, steps=2):
    net = models.init_weights(models.build_network("coord", "MLE", tiny=True, mean=MEAN),
                              torch.Generator().manual_seed(1))
    return dict(state_dict=net.state_dict(), batch=_batch(), kind="coord", uncertainty="MLE",
                mean=MEAN, tiny=True, zero=zero, steps=steps, lr=1e-3, device="cpu")


def _fresh_state():
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    return TrainState(net, make_optimizer([p for p in net.parameters()], 1e-3,
                                          steps_per_epoch=10))


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    assert int(a["step"]) == int(b["step"]) and float(a["adam_step"]) == float(b["adam_step"])
    for key in ("model", "exp_avg", "exp_avg_sq"):
        assert a[key].keys() == b[key].keys(), key
        for name in a[key]:
            assert torch.equal(a[key][name].cpu(), b[key][name].cpu()), (key, name)


def test_orbax_backend_single_process(tmp_path):
    """<dir>/<step>/ directories: once per step, the newest five kept, and a
    restore continues exactly like the run that saved."""
    spec = _spec(zero=False)
    b = TrainBatch(*(spec["batch"][k] for k in ("images", "poses", "labels", "focal",
                                                 "pp_shift")))
    state = _fresh_state()
    state.model.load_state_dict(spec["state_dict"])
    mgr = CheckpointManager(str(tmp_path), backend="orbax")
    assert mgr.restore_latest(_fresh_state()) is None
    for _ in range(7):
        train_step(state, b, "coord", "MLE")
        mgr.save(state)
        mgr.save(state)  # once per step
    assert mgr.all_steps() == [3, 4, 5, 6, 7]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4", "5", "6", "7"]
    assert (tmp_path / "7" / ".metadata").exists()
    other = _fresh_state()
    assert mgr.restore_latest(other).step == 7
    _assert_state_equal(train_state_dict(state), train_state_dict(other))
    for _ in range(2):
        train_step(state, b, "coord", "MLE")
        train_step(other, b, "coord", "MLE")
    for (k, x), (_, y) in zip(state.model.state_dict().items(), other.model.state_dict().items()):
        assert torch.equal(x, y), k


@pytest.mark.parametrize("backend", ["orbax", "msgpack"])
def test_zero_ranks_save_and_one_process_restores(tmp_path, backend):
    """Two ZeRO ranks each hold half of every sharded tensor; the saved state
    restores into one unsharded process equal to the ranks' gathered state."""
    out = str(tmp_path / "rank0.pt")
    run_ranks(checkpoint_check, 2, (_spec(), str(tmp_path / "ck"), backend, out), timeout=120)
    saved = torch.load(out, weights_only=False)
    mgr = CheckpointManager(str(tmp_path / "ck"), backend=backend)
    assert mgr.all_steps() == [2]
    if backend == "orbax":
        files = sorted(os.listdir(tmp_path / "ck" / "2"))
        assert files == [".metadata", "__0_0.distcp", "__1_0.distcp"]  # a shard per rank
    state = _fresh_state()
    mgr.restore_latest(state)
    _assert_state_equal(train_state_dict(state), saved)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("dcp_cli")
    write_identical_dataset(str(root / "datasets" / "urbanscape" / "train_sim"))
    return root


def test_cli_zero_orbax_save_and_exact_resume(ws, monkeypatch):
    """--num_devices 2 --zero --ckpt_backend orbax for one epoch, then an
    --epoch_plus run to two: the restore (collective, re-sharded onto the
    ranks) continues the single-process 2-epoch run to every printed digit."""
    monkeypatch.chdir(ws)
    extra = ["--num_devices", "2", "--zero", "--ckpt_backend", "orbax"]
    cli.main(train_args(ws / "datasets", ws / "ck", epochs=1, extra=extra))
    out1 = ws / "output" / NAME.replace("-e2-", "-e1-")
    assert (out1 / "FLAG_training_done.nodata").exists()
    assert [p for p in os.listdir(out1) if p.isdigit()] == ["1"]
    cli.main(train_args(ws / "datasets", ws / "ck", epochs=2, extra=extra + ["--epoch_plus"]))
    log = (ws / "output" / NAME / "output.log").read_text()
    assert "Restored full train state (step 1): exact optimizer resume from epoch 1." in log
    tail = log.split("Restored full train state", 1)[1]
    assert "=== Epoch: 0 ===" not in tail and "=== Epoch: 1 ===" in tail

    single = ws / "single"
    single.mkdir()
    monkeypatch.chdir(single)
    cli.main(train_args(ws / "datasets", ws / "ck_single"))
    control = re.findall(r"Total loss: ([-\d.]+)",
                         (single / "output" / NAME / "output.log").read_text())
    resumed = re.findall(r"Total loss: ([-\d.]+)", tail)
    assert len(control) == 2 and resumed == control[1:]
    assert np.isfinite(float(resumed[0]))
