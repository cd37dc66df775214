"""The unchanged bash harness drives the port through its shims.

A workspace links `crossloc_tpu_torch/harness/*.py` where the scripts call
`python3 train_single_task.py` and the like (as `examples/dress_rehearsal.sh`
links the JAX package's root shims); the scripts run on the CPU
(`--device cpu` through EXTRA_ARGS). The coord arm: `encoder_pretrain.sh
urbanscape coord TINY`, `validate_encoder_pretrain.sh` and the port's
`select_ckpt.py`, which leaves `FLAG_SELECTED_ITER_*.nodata`. The decoder
arm: `decoder_finetune.sh` over seeded coord, depth and normal donors given
through ENC_COORD / ENC_DEPTH / ENC_NORMAL, then
`validate_decoder_finetune.sh`, which leaves its results file.
"""
import os
import pathlib
import subprocess

import torch

from crossloc_tpu_torch import compat, data, models

REPO = pathlib.Path(__file__).resolve().parent.parent
HARNESS = REPO / "crossloc_tpu_torch" / "harness"


def _workspace(root, sections, shims):
    for seed, section in enumerate(sections):
        data.write_fake_dataset(str(root / "datasets" / "urbanscape" / section), n=4 if
                                section == "train_sim" else 2, img_h=32, img_w=48, focal=40.0,
                                seed=seed, scene="plane")
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
