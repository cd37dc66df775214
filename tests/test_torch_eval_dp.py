"""Data-parallel evaluation in the port's eval CLI: one process, the weights
copied to each device, each batch padded to a multiple of the device count
by repeating its last frame, split, run and sliced back. Over `[cpu, cpu]`
a batch of 5 (padded to 6) gives the very `results_*.txt` of one device: the
solver's draws are made once for the whole batch and then split.
"""
import os

import pytest
import torch

from crossloc_tpu_torch import compat, data, models
from crossloc_tpu_torch.cli import test_single_task as cli

IMG_H, IMG_W, FOCAL = 96, 144, 120.0


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_dp")
    data.write_fake_dataset(str(root / "datasets" / "urbanscape" / "val_drone_real"), n=7,
                            img_h=IMG_H, img_w=IMG_W, focal=FOCAL, seed=1, scene="plane")
    return root


def _net(ws, task, folder):
    d = ws / folder
    d.mkdir()
    net = models.init_weights(models.build_network(task, "MLE", tiny=True),
                              torch.Generator().manual_seed(0))
    compat.save_net(str(d / "model.net"), net)
    return d / "model.net"


def _args(ws, task, path):
    return ["urbanscape", "--task", task, "--uncertainty", "MLE", "--tiny", "--network_in",
            str(path), "--section", "val_drone_real", "--datasets_dir", str(ws / "datasets"),
            "--image_height", str(IMG_H), "--batch_size", "5", "--device", "cpu"]


@pytest.mark.parametrize("task", ["coord", "depth"])
def test_two_devices_give_the_one_device_results(ws, task, capsys):
    one, two = _net(ws, task, f"{task}_one"), _net(ws, task, f"{task}_two")
    log_one = cli.main(_args(ws, task, one))[0]
    assert "Data-parallel evaluation" not in capsys.readouterr().out
    log_two = cli.main(_args(ws, task, two), devices=["cpu", "cpu"])[0]
    assert "Data-parallel evaluation over 2 devices" in capsys.readouterr().out
    strip = lambda p: open(p).read().replace(os.path.dirname(p), "")  # noqa: E731
    assert strip(log_one) == strip(log_two)
    if task == "coord":
        assert "Median Error" in strip(log_one)


def test_num_devices_flag_on_the_cpu(ws, capsys):
    path = _net(ws, "coord", "coord_flag")
    cli.main(_args(ws, "coord", path) + ["--num_devices", "3"])
    assert "Data-parallel evaluation over 3 devices" in capsys.readouterr().out


def test_too_few_cards_raise_jax_error(monkeypatch):
    """More --num_devices than cards: the JAX CLI's ValueError and words."""
    opt = cli.config_parser().parse_args(["urbanscape", "--num_devices", "2"])
    monkeypatch.setattr(cli, "select_device_from_env", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="^requested 2 devices, found 1$"):
        cli.eval_devices(opt)
