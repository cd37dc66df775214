"""The unchanged bash harness drives the port through its shims.

A workspace links `crossloc_tpu_torch/harness/{train,test}_single_task.py`
where the scripts call `python3 train_single_task.py` (as
`examples/dress_rehearsal.sh` links the JAX package's root shims); then
`encoder_pretrain.sh urbanscape coord TINY`, `validate_encoder_pretrain.sh`
and the port's `select_ckpt.py` run on the CPU (`--device cpu` through
EXTRA_ARGS) and leave `FLAG_SELECTED_ITER_*.nodata`.
"""
import os
import pathlib
import subprocess

from crossloc_tpu_torch import data

REPO = pathlib.Path(__file__).resolve().parent.parent
HARNESS = REPO / "crossloc_tpu_torch" / "harness"


def test_coord_arm_of_the_harness_runs_on_the_port(tmp_path):
    for section, seed in (("train_sim", 0), ("val_sim", 1)):
        data.write_fake_dataset(str(tmp_path / "datasets" / "urbanscape" / section), n=4,
                                img_h=32, img_w=48, focal=40.0, seed=seed, scene="plane")
    for shim in ("train_single_task.py", "test_single_task.py"):
        os.symlink(HARNESS / shim, tmp_path / shim)
    common = f"--batch_size 2 --datasets_dir {tmp_path / 'datasets'} --image_height 32 --device cpu"
    # two threads a process: the suite's other workers share the CPU
    env = dict(os.environ, CKPT_DIR=str(tmp_path / "ckpts"), OMP_NUM_THREADS="2",
               EXTRA_ARGS=f"--epochs 1 {common}")
    env.pop("PYTHONPATH", None)  # the shims find the repository themselves

    def run(cmd, cwd, **extra_env):
        out = subprocess.run(cmd, cwd=cwd, env=dict(env, **extra_env), capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
        return out.stdout

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
