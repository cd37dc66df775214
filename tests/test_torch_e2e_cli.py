"""`--e2e_pose_loss` through the port's training and decoder-finetune CLIs on
the CPU, against the JAX CLIs' output names and log contract.

Tiny nets at 32x48: the training CLI runs a proxy epoch, then an epoch of
DSAC steps; the folder is the JAX CLI's `-e2e` name, the `output.log`
lines keep their format (an e2e step logs `Valid: 100.0%`), the MLE
warning is the JAX CLI's, and the port's eval CLI serves the `model.net`.
The finetune CLI reaches the same loop over the MLR net.
"""
import os
import re

import pytest
import torch

from crossloc_tpu import compat as jcompat
from crossloc_tpu.cli import train_single_task as jcli
from crossloc_tpu_torch import compat, data, models
from crossloc_tpu_torch.cli import finetune_decoder_single_task as ft_cli
from crossloc_tpu_torch.cli import test_single_task as test_cli
from crossloc_tpu_torch.cli import train_single_task as cli

IMG_H, IMG_W = 32, 48
LINE = re.compile(r"Iteration:\s+(\d+), Epoch:\s+(\d+), Total loss: ([-\d.]+), Valid: ([\d.]+)%, "
                  r"Avg Time: [\d.]+s$")
WARNING = ("--e2e_pose_loss with --uncertainty MLE: the uncertainty channel gets NO gradient "
           "from the pose loss (only the coord channels feed the solver)")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A plane train_sim, a pairwise plane scene, a val section and three
    seeded tiny donors in folders named after their task."""
    root = tmp_path_factory.mktemp("e2e")
    sections = [("train_sim", 4), ("train_drone_real", 2), ("train_drone_sim", 2),
                ("val_drone_real", 2)]
    for seed, (sub, n) in enumerate(sections):
        data.write_fake_dataset(str(root / "datasets" / "urbanscape" / sub), n=n, img_h=IMG_H,
                                img_w=IMG_W, focal=40.0, seed=seed, scene="plane")
    for i, task in enumerate(("coord", "depth", "normal")):
        net = models.build_network(task, "MLE", tiny=True, mean=[0.5] * models.task_channels(task))
        models.init_weights(net, torch.Generator().manual_seed(i))
        (root / "weights" / task).mkdir(parents=True)
        compat.save_net(str(root / "weights" / task / "model.net"), net)
    return root


def _count_steps(monkeypatch, module):
    """Count the proxy and the e2e steps the CLI takes."""
    seen = {"proxy": 0, "e2e": 0}
    real_step, real_make = module.train_step, module.make_dsac_train_step

    def proxy(*a, **k):
        seen["proxy"] += 1
        return real_step(*a, **k)

    def make(*a, **k):
        step = real_make(*a, **k)

        def e2e(*sa, **sk):
            seen["e2e"] += 1
            assert isinstance(sk["generator"], torch.Generator)
            return step(*sa, **sk)

        return e2e

    monkeypatch.setattr(module, "train_step", proxy)
    monkeypatch.setattr(module, "make_dsac_train_step", make)
    return seen


def _iterations(out_dir):
    text = open(os.path.join(out_dir, "output.log")).read()
    lines = [line for line in text.splitlines() if "Iteration:" in line]
    found = [LINE.search(line) for line in lines]
    assert all(found), "an Iteration line of another format"
    return text, [(int(m[1]), int(m[2]), float(m[3]), m[4]) for m in found]


def _serves(ws, out_dir):
    logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny",
                          "--network_in", os.path.join(out_dir, "model.net"), "--section",
                          "val_drone_real", "--datasets_dir", str(ws / "datasets"),
                          "--image_height", str(IMG_H), "--batch_size", "2", "--device", "cpu"])
    assert "Median Error" in open(logs[0]).read()


def test_train_cli_e2e_after_a_warmup_epoch(ws, monkeypatch):
    args = ["urbanscape", "--task", "coord", "--batch_size", "2", "--epochs", "2", "--tiny",
            "--sim_data_chunk", "1.0", "--real_data_chunk", "0.0", "--uncertainty", "MLE",
            "--datasets_dir", str(ws / "datasets"), "--image_height", str(IMG_H),
            "--ckpt_dir", str(ws / "ckpts"), "--session", "e2e", "--e2e_pose_loss",
            "--e2e_warmup_epochs", "1"]
    seen = _count_steps(monkeypatch, cli)
    monkeypatch.chdir(ws)
    out_dir = cli.main(args + ["--device", "cpu"])
    j_out = jcli.get_output_path(jcli.normalize_opt(jcli.config_parser().parse_args(args)),
                                 str(ws))
    assert out_dir == j_out and "-e2e-" in os.path.basename(out_dir)
    assert seen == {"proxy": 2, "e2e": 2}
    text, iters = _iterations(out_dir)
    assert [(i, e) for i, e, _, _ in iters] == [(2, 0), (4, 0), (6, 1), (8, 1)]
    assert [v for _, e, _, v in iters if e == 1] == ["100.0", "100.0"]
    assert WARNING in text and "Done without errors." in text
    assert os.path.exists(os.path.join(out_dir, "FLAG_training_done.nodata"))
    _serves(ws, out_dir)


def test_finetune_cli_e2e(ws, monkeypatch):
    w = {t: str(ws / "weights" / t / "model.net") for t in ("coord", "depth", "normal")}
    args = ["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny", "--batch_size", "2",
            "--epochs", "1", "--learningrate", "1e-4", "--sim_data_chunk", "0.0",
            "--real_data_chunk", "1.0", "--encoders", "coord", "depth", "normal",
            "--coord_weight", w["coord"], "--depth_weight", w["depth"], "--normal_weight",
            w["normal"], "--reuse_coord_encoder", "--unfreeze_coord_encoder",
            "--no_lr_scheduling", "--session", "e2e", "--datasets_dir", str(ws / "datasets"),
            "--image_height", str(IMG_H), "--ckpt_dir", str(ws / "ckpts"), "--e2e_pose_loss",
            "--device", "cpu"]
    seen = _count_steps(monkeypatch, cli)  # the finetune CLI runs the training CLI's loop
    monkeypatch.chdir(ws)
    out_dir = ft_cli.main(args)
    assert os.path.basename(out_dir) == jcompat.finetune_output_name(
        "urbanscape", "coord", ["coord", "depth", "normal"], reuse_coord_encoder=True,
        unfreeze_coord_encoder=True, session="e2e", uncertainty="MLE", epochs=1,
        learning_rate=1e-4, real_data_chunk=1.0, sim_data_chunk=0.0, tiny=True, e2e=True)
    assert seen == {"proxy": 0, "e2e": 2}
    text, iters = _iterations(out_dir)
    assert [(i, e, v) for i, e, _, v in iters] == [(2, 0, "100.0"), (4, 0, "100.0")]
    assert WARNING in text
    _serves(ws, out_dir)


def test_solver_draws_are_keyed_by_epoch_and_batch():
    """A resumed run draws as an uninterrupted one: the generator is a pure
    function of (epoch, batch), apart from the augmentation's."""
    def draw(*key):
        return torch.randint(0, 10**6, (4,), generator=cli.solver_generator(*key, "cpu"))

    assert torch.equal(draw(3, 1), draw(3, 1))
    assert not torch.equal(draw(3, 1), draw(3, 2)) and not torch.equal(draw(3, 1), draw(4, 1))
    aug = torch.randint(0, 10**6, (4,), generator=cli.augment_generator(3, 1))
    assert not torch.equal(draw(3, 1), aug)
