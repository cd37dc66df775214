"""The port's visualize CLI against the JAX package's, on the port's own files.

A tiny coord net trained by the port's train CLI leaves an `output.log`; its
eval CLI, run with `--save_pred --plot`, leaves `*_pose_errors.npy` and npz
dumps and, for coord, no plot (as the JAX CLI). Every parser agrees with the
JAX package's on those files, and each plot of `main` and `semantic_plotter`
is written under the JAX package's file name.
"""
import glob
import pathlib

import numpy as np
import pytest
import torch

from crossloc_tpu.cli import visualize as jvis
from crossloc_tpu_torch import data
from crossloc_tpu_torch.cli import test_single_task as test_cli
from crossloc_tpu_torch.cli import train_single_task as train_cli
from crossloc_tpu_torch.cli import visualize as vis

IMG_H = 32


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(output dir, the png files the coord eval with --plot left there)."""
    root = tmp_path_factory.mktemp("ws")
    for seed, (section, n) in enumerate((("train_sim", 4), ("val_sim", 2))):
        data.write_fake_dataset(str(root / "datasets" / "urbanscape" / section), n=n,
                                img_h=IMG_H, img_w=48, focal=40.0, seed=seed, scene="plane")
    mp = pytest.MonkeyPatch()
    try:
        mp.chdir(root)
        out = train_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny",
                              "--batch_size", "2", "--epochs", "2", "--sim_data_chunk", "1.0",
                              "--real_data_chunk", "0.0", "--datasets_dir",
                              str(root / "datasets"), "--image_height", str(IMG_H),
                              "--device", "cpu"])
    finally:
        mp.undo()
    test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny",
                   "--network_in", f"{out}/model.net", "--section", "val_sim", "--datasets_dir",
                   str(root / "datasets"), "--image_height", str(IMG_H), "--batch_size", "2",
                   "--save_pred", "--plot", "--device", "cpu"])
    return out, sorted(p.name for p in pathlib.Path(out).rglob("*.png"))


def test_coord_plot_writes_nothing(run):
    assert run[1] == []


def test_log_parsers_match_jax_on_the_port_s_log(run):
    log = f"{run[0]}/output.log"
    got, ref = vis.parse_training_log(log), jvis.parse_training_log(log)
    assert set(got) == set(ref) and len(got["loss"]) == 4
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(got["iteration"], [2, 4, 6, 8])
    for kw in ("Total loss", "Valid", "Epoch", "Avg Time"):
        np.testing.assert_array_equal(vis.extract_keyword_series(log, kw),
                                      jvis.extract_keyword_series(log, kw))
    for w in (1, 3, 100):
        np.testing.assert_array_equal(vis.moving_average(got["loss"], w),
                                      jvis.moving_average(ref["loss"], w))


def test_empty_log_parses_like_jax(tmp_path):
    log = tmp_path / "output.log"
    log.write_text("no iteration lines\n")
    got, ref = vis.parse_training_log(str(log)), jvis.parse_training_log(str(log))
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}


def test_pose_errors_load_like_jax(run):
    out = run[0]
    pred_dirs = sorted(glob.glob(f"{out}/coord_pred_*"))
    assert pred_dirs
    for paths in ([out], pred_dirs):
        got, ref = vis.load_pose_errors(paths), jvis.load_pose_errors(paths)
        assert len(got[0]) == 2
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_plots_are_written_under_jax_s_names(run, tmp_path, capsys):
    out = run[0]
    for side, mod in (("jax", jvis), ("port", vis)):
        d = tmp_path / side
        d.mkdir()
        mod.main([f"{out}/output.log", "--out", str(d / "curves.png"), "--window", "2"])
        mod.main([f"{out}/output.log", "--keywords", "Total loss", "Valid", "--out",
                  str(d / "kw.png")])
        mod.main(["--pose_errors", out, "--out", str(d / "cdf.png")])
        net = d / "run" / "model.net"
        net.parent.mkdir()
        rng = np.random.default_rng(0)
        path = mod.semantic_plotter(rng.uniform(0, 1, (2, 16, 24, 3)),
                                    rng.integers(0, 6, (2, 16, 24)),
                                    rng.integers(0, 6, (2, 16, 24, 1)).astype(np.float32),
                                    str(net), "val_sim", 3)
        assert path == str(net.parent / "sm_section_val_sim_batch_3.png")
    names = {side: sorted(p.name for p in (tmp_path / side).rglob("*.png"))
             for side in ("jax", "port")}
    assert names["port"] == names["jax"] == ["cdf.png", "curves.png", "kw.png",
                                             "sm_section_val_sim_batch_3.png"]
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "pose-error CDF" in ln]
    assert len(lines) == 2 and lines[0].split(" to ")[0] == lines[1].split(" to ")[0]
