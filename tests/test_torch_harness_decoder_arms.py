"""The decoder-finetune ablation arms of the unchanged bash harness on the
port, against the JAX package's run of the same scripts on the same frames:
`decoder_finetune_real_only.sh` and `decoder_finetune_pairwise_only.sh`
over seeded coord, depth and normal donors given through ENC_COORD /
ENC_DEPTH / ENC_NORMAL (tiny nets at 32x48, one epoch, B=2; the port on
`--device cpu`). Compared: the folder names, the files written, the
`output.log` lines with floats masked and the `.net` key sets; the port's
frozen towers are their donors' encoders bit for bit."""
import pytest
import torch

from crossloc_tpu_torch import compat
from test_torch_harness_twins import (PACKAGES, TRAINING, run_side_by_side, same_net_keys,
                                      same_text_files, seeded_donor, tree, twins)

STEM = "urbanscape-coord-decoder_coord_free_depth_normal-senc-pt1.00-ip-ft1.00-unc-MLE-e1-lr0.0001"
FOLDERS = {"decoder_finetune_real_only.sh": f"{STEM}-real_only-ip-rc1.00-tiny",
           "decoder_finetune_pairwise_only.sh": f"{STEM}-pairwise-ip-rc1.00-tiny"}
SECTIONS = ("train_drone_real", "train_drone_sim", "val_drone_real")


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """Both scripts in both packages, four processes at a time; the
    workspaces and the donors."""
    root = tmp_path_factory.mktemp("decoder_arms")
    ws = twins(root, SECTIONS)
    donors = {f"ENC_{task.upper()}": seeded_donor(root / "weights" / task / "model.net", task, seed)
              for seed, task in enumerate(("coord", "depth", "normal"))}
    run_side_by_side({(pkg, script): lambda w=ws[pkg], s=script: w.script(
        TRAINING / s, "urbanscape", "coord", "TINY", "1.0", "in_place", "1.0", "MLE", "0",
        **donors) for pkg in PACKAGES for script in FOLDERS})
    return ws, donors


def test_the_port_writes_the_jax_package_s_folders_and_files(arms):
    ws, _ = arms
    jax_tree = tree(ws["jax"])
    assert sorted(jax_tree) == sorted(f"{sub}/{name}" for sub in ("output", "ckpts")
                                      for name in FOLDERS.values())
    assert tree(ws["port"]) == jax_tree


@pytest.mark.parametrize("script", sorted(FOLDERS))
def test_decoder_finetune_arm_matches_jax(arms, script):
    ws, donors = arms
    folder = FOLDERS[script]
    assert same_text_files(ws, f"output/{folder}", "output.log") == ["output.log"]
    assert same_net_keys(ws, f"output/{folder}") == ["model.net"]
    assert same_net_keys(ws, f"ckpts/{folder}") == ["ckpt_iter_0000002.net"]
    trained = compat.load_net(str(ws["port"].root / "output" / folder / "model.net"))
    for tower, task in ((2, "depth"), (3, "normal")):
        donor = compat.load_net(donors[f"ENC_{task.upper()}"])
        enc = {k[len("encoder."):]: v for k, v in donor.items() if k.startswith("encoder.")}
        assert all(torch.equal(trained[f"mlr_encoder_{tower}.{k}"], v) for k, v in enc.items())
