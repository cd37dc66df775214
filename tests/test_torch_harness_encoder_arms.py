"""The encoder arms of the unchanged bash harness on the port, against the
JAX package's run of the same scripts on the same frames.

`encoder_finetune.sh` (in place, then again in the same workspace so that
its `--auto_resume` path runs, and out of place) from one seeded donor
given through ENC_PRETRAINED, `encoder_pretrain_real_only.sh` (out of
place) and `encoder_pretrain_pairwise_only.sh`, then
`validate_encoder_finetune.sh` and `validate_encoder_pretrain_{real,pairwise}_only.sh`
on val_drone_real with each package's `select_ckpt.py --task coord`. Tiny
nets at 32x48, one epoch, B=2; the port on `--device cpu`. Compared: the
folder names, the files written, the `output.log` and `results_*.txt`
lines with floats masked, the `.net` key sets and the resume bookkeeping.
"""
import re

import pytest

from test_torch_harness_twins import (PACKAGES, TRAINING, mask, run_side_by_side, same_net_keys,
                                      same_text_files, seeded_donor, tree, twins)

FT_IP = "urbanscape-coord-sclean_training_ip-unc-MLE-e1-lr0.0001-pairs-ip-rc1.00-tiny-finetune"
FT_OOP = "urbanscape-coord-sclean_training_oop-unc-MLE-e1-lr0.0001-pairs-oop-rc1.00-tiny-finetune"
REAL_ONLY = "urbanscape-coord-sclean_training-unc-MLE-e1-lr0.0002-real_only-oop-rc1.00-tiny"
PAIRWISE_ONLY = "urbanscape-coord-sclean_training-unc-MLE-e1-lr0.0002-pairs-ip-rc1.00-tiny"
SECTIONS = ("train_drone_real", "train_drone_sim", "val_drone_real", "train_oop_drone_real",
            "train_oop_drone_sim")


@pytest.fixture(scope="module")
def arms(tmp_path_factory):
    """Every script in both packages: {package: {step: stdout}}, the
    workspaces. Two chains a package, four processes at a time."""
    root = tmp_path_factory.mktemp("encoder_arms")
    ws = twins(root, SECTIONS)
    donor = seeded_donor(root / "donor" / "model.net", "coord", 0)
    args = ("urbanscape", "coord", "TINY", "0.0")

    def chain_finetune(w):
        ft = lambda dom: w.script(TRAINING / "encoder_finetune.sh", *args, dom, "1.0", "MLE", "0",
                                  ENC_PRETRAINED=donor)
        return dict(ft_ip=ft("in_place"), ft_ip_again=ft("in_place"),
                    val_ft=w.validate("validate_encoder_finetune.sh", FT_IP),
                    ft_oop=ft("out_of_place"))

    def chain_pretrain(w):
        return dict(
            real_only=w.script(TRAINING / "encoder_pretrain_real_only.sh", *args,
                               "out_of_place", "1.0", "MLE", "0"),
            val_real_only=w.validate("validate_encoder_pretrain_real_only.sh", REAL_ONLY),
            pairwise_only=w.script(TRAINING / "encoder_pretrain_pairwise_only.sh", *args,
                                   "in_place", "1.0", "MLE", "0"),
            val_pairwise_only=w.validate("validate_encoder_pretrain_pairwise_only.sh",
                                         PAIRWISE_ONLY))

    done = run_side_by_side({(pkg, chain): lambda c=chain, w=ws[pkg]: c(w)
                             for pkg in PACKAGES for chain in (chain_finetune, chain_pretrain)})
    outs = {pkg: {**done[(pkg, chain_finetune)], **done[(pkg, chain_pretrain)]}
            for pkg in PACKAGES}
    return ws, outs


def test_the_port_writes_the_jax_package_s_folders_and_files(arms):
    ws, _ = arms
    jax_tree = tree(ws["jax"])
    assert sorted(jax_tree) == sorted(f"{sub}/{name}" for sub in ("output", "ckpts") for name in (
        FT_IP, FT_OOP, REAL_ONLY, PAIRWISE_ONLY))
    assert tree(ws["port"]) == jax_tree


@pytest.mark.parametrize("folder", [FT_IP, FT_OOP, REAL_ONLY, PAIRWISE_ONLY],
                         ids=["encoder_finetune_in_place", "encoder_finetune_out_of_place",
                              "encoder_pretrain_real_only", "encoder_pretrain_pairwise_only"])
def test_training_script_matches_jax(arms, folder):
    """The output folder's log, flag and weights; the checkpoint folder's
    weights; each `.net` with the JAX run's keys and shapes."""
    ws, _ = arms
    assert same_text_files(ws, f"output/{folder}", "output.log") == ["output.log"]
    nets = same_net_keys(ws, f"output/{folder}")
    # a run from --network_in snapshots to model_resume.net, its --auto_resume
    # rerun to model_auto_resume.net (the JAX CLI's rule); a fresh run to model.net
    assert nets == {FT_IP: ["model_auto_resume.net", "model_resume.net"],
                    FT_OOP: ["model_resume.net"]}.get(folder, ["model.net"])
    assert same_net_keys(ws, f"ckpts/{folder}")
    for pkg in PACKAGES:
        assert (ws[pkg].root / "output" / folder / "FLAG_training_done.nodata").exists()


def test_encoder_finetune_resume_bookkeeping_matches_jax(arms):
    """The second in-place invocation: the first left a finished folder with
    output.log and model_resume.net, so --auto_resume holds; it resumes from
    that folder's own weight file, re-runs the log's last epoch and appends
    to output.log."""
    ws, outs = arms

    def effective(text):
        return [ln for ln in text.splitlines() if ln.startswith("Effective")]

    for pkg in PACKAGES:
        assert effective(outs[pkg]["ft_ip"]) == ["Effective auto resume: False",
                                                 "Effective epoch extension: False"]
        assert effective(outs[pkg]["ft_ip_again"]) == ["Effective auto resume: True",
                                                       "Effective epoch extension: False"]
    lines = {pkg: mask((ws[pkg].root / "output" / FT_IP / "output.log").read_text(), ws[pkg])
             for pkg in PACKAGES}
    assert lines["port"] == lines["jax"]
    for pkg in PACKAGES:
        text = (ws[pkg].root / "output" / FT_IP / "output.log").read_text()
        assert [ln.split("INFO: ")[1] for ln in text.splitlines() if "Automatic resume" in ln] == [
            f"***** Automatic resume training from {ws[pkg].root}/output/{FT_IP}/model_resume.net "
            "*****"]
    iterations = [ln.split("Iteration:")[1].split(", Total")[0].split()
                  for ln in lines["port"] if "Iteration:" in ln]
    # 4 pairwise frames at B=2: iterations 2, 4, then the resumed epoch 0 goes on from 4
    assert iterations == [["2,", "Epoch:", "0"], ["4,", "Epoch:", "0"], ["6,", "Epoch:", "0"],
                          ["8,", "Epoch:", "0"]]
    assert sorted(p.name for p in (ws["port"].root / "ckpts" / FT_IP).glob("ckpt_iter_*")) == [
        "ckpt_iter_0000002.net", "ckpt_iter_0000006.net"]


@pytest.mark.parametrize("step,folder", [("val_ft", FT_IP), ("val_real_only", REAL_ONLY),
                                         ("val_pairwise_only", PAIRWISE_ONLY)],
                         ids=["validate_encoder_finetune", "validate_encoder_pretrain_real_only",
                              "validate_encoder_pretrain_pairwise_only"])
def test_validation_script_matches_jax(arms, step, folder):
    """Results files per checkpoint and overall, pose files, the selected
    checkpoint's flag and the selector's words."""
    ws, outs = arms
    results = same_text_files(ws, f"ckpts/{folder}", "results_*.txt")
    assert "results_overall.txt" in results
    assert "results_ckpt_iter_0000002.net_task_coord.txt" in results
    same_text_files(ws, f"ckpts/{folder}", "*_poses.txt")
    # one flag naming a swept checkpoint; which one follows each run's numbers
    for pkg in PACKAGES:
        flags = [p.name for p in (ws[pkg].root / "ckpts" / folder).glob("FLAG_SELECTED_*")]
        assert len(flags) == 1 and f"results_ckpt_iter_{flags[0][19:26]}.net_task_coord.txt" in \
            results, flags
    selected = {pkg: [re.sub(r"\d{7}", "<iter>", ln) for ln in outs[pkg][step].splitlines()
                      if ln.startswith("Checkpoint selection flag")] for pkg in PACKAGES}
    assert selected["port"] == selected["jax"] != []
