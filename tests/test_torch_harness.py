"""The unchanged bash harness drives the port through its shims.

A workspace links `crossloc_tpu_torch/harness/*.py` where the scripts call
`python3 train_single_task.py` and the like (as `examples/dress_rehearsal.sh`
links the JAX package's root shims); the scripts run on the CPU
(`--device cpu` through EXTRA_ARGS). The coord arm: `encoder_pretrain.sh
urbanscape coord TINY`, `validate_encoder_pretrain.sh` and the port's
`select_ckpt.py`, which leaves `FLAG_SELECTED_ITER_*.nodata`. The decoder
arm: `decoder_finetune.sh` over seeded coord, depth and normal donors given
through ENC_COORD / ENC_DEPTH / ENC_NORMAL, then
`validate_decoder_finetune.sh`, which leaves its results file. The task
arms: `encoder_pretrain.sh` for coord, depth, normal and (with UNC=none)
semantics, `validate_encoder_pretrain.sh` and `select_ckpt.py --task` for
each of the three new tasks, then `decoder_finetune_plus_semantics.sh` over
the four donors just trained and `validate_decoder_finetune.sh` on its
four-tower net. These frames are the noise scene: the plane scene's normals
equal the nodata marker.
"""
import os
import pathlib
import subprocess

import pytest
import torch

from crossloc_tpu_torch import compat, data, models

REPO = pathlib.Path(__file__).resolve().parent.parent
HARNESS = REPO / "crossloc_tpu_torch" / "harness"


def _workspace(root, sections, shims, scene="plane"):
    for seed, section in enumerate(sections):
        data.write_fake_dataset(str(root / "datasets" / "urbanscape" / section), n=4 if
                                section == "train_sim" else 2, img_h=32, img_w=48, focal=40.0,
                                seed=seed, scene=scene)
    for shim in shims:
        os.symlink(HARNESS / shim, root / shim)
    common = f"--batch_size 2 --datasets_dir {root / 'datasets'} --image_height 32 --device cpu"
    # two threads a process: the suite's other workers share the CPU
    env = dict(os.environ, CKPT_DIR=str(root / "ckpts"), OMP_NUM_THREADS="2",
               EXTRA_ARGS=f"--epochs 1 {common}")
    env.pop("PYTHONPATH", None)  # the shims find the repository themselves

    def run(cmd, cwd, **extra_env):
        out = subprocess.run(cmd, cwd=cwd, env=dict(env, **extra_env), capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        return out.stdout

    return run, common


def test_coord_arm_of_the_harness_runs_on_the_port(tmp_path):
    run, common = _workspace(tmp_path, ("train_sim", "val_sim"),
                             ("train_single_task.py", "test_single_task.py"))
    run(["bash", str(REPO / "script_clean_training" / "encoder_pretrain.sh"), "urbanscape",
         "coord", "TINY", "1.0", "in_place", "0.0", "MLE", "0"], tmp_path)
    name = "urbanscape-coord-sclean_training-unc-MLE-e1-lr0.0002-sim_only-sc1.00-tiny"
    assert (tmp_path / "output" / name / "FLAG_training_done.nodata").exists()
    ckpts = tmp_path / "ckpts" / name
    assert sorted(p.name for p in ckpts.glob("ckpt_iter_*.net")) == ["ckpt_iter_0000002.net"]

    run(["bash", str(REPO / "script_clean_validation" / "validate_encoder_pretrain.sh"),
         "urbanscape", "coord", "TINY", "MLE", "0"], tmp_path,
        CKPT_DIR=str(ckpts), MIN_CKPT_ITER="0", EXTRA_ARGS=common)
    assert (ckpts / "results_ckpt_iter_0000002.net_task_coord.txt").exists()

    out = run(["python3", str(HARNESS / "select_ckpt.py"), "--task", "coord"], ckpts)
    assert "FLAG_SELECTED_ITER_0000002.nodata" in out
    assert (ckpts / "FLAG_SELECTED_ITER_0000002.nodata").exists()


def test_decoder_finetune_arm_of_the_harness_runs_on_the_port(tmp_path):
    run, common = _workspace(tmp_path, ("train_drone_real", "train_drone_sim", "val_drone_real"),
                             ("finetune_decoder_single_task.py", "test_single_task.py"))
    donors = {}
    for seed, task in enumerate(("coord", "depth", "normal")):
        net = models.build_network(task, "MLE", tiny=True)
        models.init_weights(net, torch.Generator().manual_seed(seed))
        (tmp_path / "weights" / task).mkdir(parents=True)
        donors[f"ENC_{task.upper()}"] = str(tmp_path / "weights" / task / "model.net")
        compat.save_net(donors[f"ENC_{task.upper()}"], net)
    run(["bash", str(REPO / "script_clean_training" / "decoder_finetune.sh"), "urbanscape",
         "coord", "TINY", "1.0", "in_place", "1.0", "MLE", "0"], tmp_path, **donors)
    name = ("urbanscape-coord-decoder_coord_free_depth_normal-senc-pt1.00-ip-ft1.00-unc-MLE-e1-"
            "lr0.0001-pairwise-ip-rc1.00-tiny")
    assert (tmp_path / "output" / name / "FLAG_training_done.nodata").exists()
    ckpts = tmp_path / "ckpts" / name
    assert sorted(p.name for p in ckpts.glob("ckpt_iter_*.net")) == ["ckpt_iter_0000002.net"]

    run(["bash", str(REPO / "script_clean_validation" / "validate_decoder_finetune.sh"),
         "urbanscape", "coord", "TINY", "MLE", "0"], tmp_path,
        CKPT_DIR=str(ckpts), MIN_CKPT_ITER="0", EXTRA_ARGS=common)
    results = ckpts / "results_ckpt_iter_0000002.net_task_coord.txt"
    assert "Median Error" in results.read_text()


TASK_UNC = {"coord": "MLE", "depth": "MLE", "normal": "MLE", "semantics": "none"}


def _pretrain_name(task):
    unc = "no_unc-fullsize" if task == "semantics" else "unc-MLE"
    return f"urbanscape-{task}-sclean_training-{unc}-e1-lr0.0002-sim_only-sc1.00-tiny"


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """`encoder_pretrain.sh` for the four tasks in one workspace."""
    root = tmp_path_factory.mktemp("tasks")
    run, common = _workspace(root, ("train_sim", "val_sim", "train_drone_real",
                                    "train_drone_sim", "val_drone_real"),
                             ("train_single_task.py", "test_single_task.py",
                              "finetune_decoder_single_task.py"), scene="noise")
    for task, unc in TASK_UNC.items():
        run(["bash", str(REPO / "script_clean_training" / "encoder_pretrain.sh"), "urbanscape",
             task, "TINY", "1.0", "in_place", "0.0", unc, "0"], root)
        assert (root / "output" / _pretrain_name(task) / "FLAG_training_done.nodata").exists()
    return root, run, common


@pytest.mark.parametrize("task", ["depth", "normal", "semantics"])
def test_task_arm_of_the_harness_runs_on_the_port(pretrained, task):
    root, run, common = pretrained
    ckpts = root / "ckpts" / _pretrain_name(task)
    # semantics writes a ckpt_iter file every epoch, the others every 5 (one here)
    assert sorted(p.name for p in ckpts.glob("ckpt_iter_*.net")) == ["ckpt_iter_0000002.net"]
    run(["bash", str(REPO / "script_clean_validation" / "validate_encoder_pretrain.sh"),
         "urbanscape", task, "TINY", TASK_UNC[task], "0"], root,
        CKPT_DIR=str(ckpts), MIN_CKPT_ITER="0", EXTRA_ARGS=common)
    results = ckpts / f"results_ckpt_iter_0000002.net_task_{task}.txt"
    head = {"depth": "RMS error, mean:", "normal": "angular prediction error, mean:",
            "semantics": "Mean IoU, mean:"}[task]
    assert head in results.read_text()
    out = run(["python3", str(HARNESS / "select_ckpt.py"), "--task", task], ckpts)
    assert "FLAG_SELECTED_ITER_0000002.nodata" in out
    assert (ckpts / "FLAG_SELECTED_ITER_0000002.nodata").exists()


def test_semantics_decoder_finetune_arm_runs_over_the_port_s_donors(pretrained):
    """Four towers, from the coord, depth, normal and semantics (DUC) nets the
    port just pretrained; the finetuned net serves from its folder's name."""
    root, run, common = pretrained
    donors = {f"ENC_{t.upper()}": str(root / "output" / _pretrain_name(t) / "model.net")
              for t in TASK_UNC}
    run(["bash", str(REPO / "script_clean_training" / "decoder_finetune_plus_semantics.sh"),
         "urbanscape", "coord", "TINY", "1.0", "in_place", "1.0", "MLE", "0"], root, **donors)
    name = ("urbanscape-coord-decoder_coord_free_depth_normal_semantics-senc-pt1.00-ip-ft1.00-"
            "unc-MLE-e1-lr0.0001-pairwise-ip-rc1.00-tiny")
    assert (root / "output" / name / "FLAG_training_done.nodata").exists()
    trained = compat.load_net(str(root / "output" / name / "model.net"))
    semantics = compat.load_net(donors["ENC_SEMANTICS"])
    assert torch.equal(trained["mlr_encoder_4.conv1.weight"], semantics["encoder.conv1.weight"])
    ckpts = root / "ckpts" / name
    run(["bash", str(REPO / "script_clean_validation" / "validate_decoder_finetune.sh"),
         "urbanscape", "coord", "TINY", "MLE", "0"], root,
        CKPT_DIR=str(ckpts), MIN_CKPT_ITER="0", EXTRA_ARGS=common)
    assert "Median Error" in (ckpts / "results_ckpt_iter_0000002.net_task_coord.txt").read_text()
