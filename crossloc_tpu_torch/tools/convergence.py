"""The coord net's convergence run through the unchanged bash harness
(counterpart of `tools/tpu_convergence.py`), on the card.

Per-module parity tests and short runs cannot catch faults that show only
when the whole system trains for thousands of steps; a full net trained from
scratch that localizes held-out frames can. The run:

  1. writes the learnable plane scene (`data.write_fake_dataset(scene="plane")`:
     a textured world plane, so a net trained on some poses generalizes to
     held-out ones): 480 train_sim frames (seed 0) and 16 val_sim frames
     (seed 1) at 480x720, focal 480;
  2. phase 1: `script_clean_training/encoder_pretrain.sh urbanscape coord FULL
     1.0 in_place 0.0 MLE 0` through the port's `harness/` shims, with
     EXTRA_ARGS `--batch_size 12 --bf16 --snapshot_every_epochs 5
     --learningrate 2e-3 --no_lr_scheduling`, 100 epochs;
  3. phase 2: an `--epoch_plus` extension to 150 epochs in two
     arms, each from phase 1's weights with fresh Adam moments, in its own
     copy of the work directory (their output folders have one name):
     `ref` with the LR schedule on (the resumed step puts it at x0.25, 5e-4,
     as the reference and the JAX tool's docstring intend) and `jax` with
     `--no_lr_scheduling` (2e-3, as the JAX package's run 3 trained: its
     resume restarts optax's schedule, ROADMAP R5 and R7);
  4. sweeps every checkpoint folder with the unchanged
     `script_clean_validation/validate_encoder_pretrain.sh` (MIN_CKPT_ITER=0),
     one eval CLI process per folder, and parses the `results_*.txt` files.

Prints the held-out trajectory per checkpoint and one JSON line per arm
(`loss_first`, `loss_last`, `t_first`, `t_final`, `t_best`, `r_final`,
`pct_10m10deg`, `pct_5m5deg`, `steps`, `step_ms`, `wall_s`, `device`), and
holds each arm to the JAX tool's bars: loss_last < 0.5 loss_first, t_final <
0.5 t_first and t_final < `--final_t_max` (4.0). `step_ms` is the training
CLI processes' wall per logged step (process start, data and snapshots
included). Rerun with the same `--workdir`, it skips finished stages; a cut
training stage resumes through the harness's own `--auto_resume` (the
stage's wall is then that of the run that finished it).

    python -m crossloc_tpu_torch.tools.convergence --workdir DIR   # the card
    python -m crossloc_tpu_torch.tools.convergence --smoke         # CPU mechanics

The JAX tool's protocol flags `--frames`, `--val_frames`, `--epochs`, `--lr`,
`--const_lr` (phase 1 at a constant LR; on by default, `--no-const_lr`
turns the schedule on) and `--extend_epochs` (the arms' epochs; 0 runs
phase 1 alone) default to the run above.

`--smoke` runs the same stages on the CPU (`--device cpu`) at 32x48 with the
tiny net, 4 frames and 1 + 1 epochs, and holds no bar: a few steps do not
converge. Without `--smoke` the run needs a CUDA card and does not fall back
to the CPU.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

from ..cli.visualize import parse_training_log
from ..train import multistep_lr
from ..utils.profiling import StopWatch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HARNESS = os.path.join(REPO, "crossloc_tpu_torch", "harness")
ARMS = ("ref", "jax")
LR = 2e-3  # JAX run 3's (BENCH_NOTES.md): the reference's 2e-4 is tuned for far longer runs
_RESULT_LINES = {"Median Error": re.compile(r"Median Error: ([-\d.]+) deg, ([-\d.]+) m"),
                 "10m10deg": re.compile(r"10m10deg: ([\d.]+)%"),
                 "5m5deg": re.compile(r"5m5deg: ([\d.]+)%")}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", default=None, help="keep (and resume) the run here")
    p.add_argument("--smoke", action="store_true",
                   help="CPU mechanics check: 32x48, tiny net, 4 frames, 1 + 1 epochs")
    p.add_argument("--final_t_max", type=float, default=4.0,
                   help="required final held-out median translation error (scene units; "
                        "the scene's footprint is about 300)")
    # the JAX tool's protocol flags; the defaults are the run above
    p.add_argument("--frames", type=int, default=None, help="train frames (480; smoke 4)")
    p.add_argument("--val_frames", type=int, default=None, help="held-out frames (16; smoke 2)")
    p.add_argument("--epochs", type=int, default=None, help="phase 1 epochs (100; smoke 1)")
    p.add_argument("--lr", type=float, default=LR, help="--learningrate of every stage")
    p.add_argument("--const_lr", action=argparse.BooleanOptionalAction, default=True,
                   help="phase 1 without the MultiStepLR schedule (--no_lr_scheduling); "
                        "--no-const_lr turns it on")
    p.add_argument("--extend_epochs", type=int, default=None,
                   help="epochs of the --epoch_plus arms after phase 1 (50; smoke 1); 0 runs "
                        "phase 1 alone")
    return p.parse_args(argv)


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def run(cmd, cwd, env, log_path):
    """Run one harness command; its output goes to `log_path`."""
    print(f"+ {' '.join(cmd)}  (cwd {cwd}, log {log_path})", flush=True)
    with open(log_path, "w") as f:
        rc = subprocess.run(cmd, cwd=cwd, env=env, stdout=f, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        with open(log_path) as f:
            sys.stderr.write(f.read()[-4000:])
        raise SystemExit(f"command failed rc={rc}: {' '.join(cmd)}")


def _stage_dir(ws: str, name: str) -> str:
    """A work directory with the harness shims linked in, as the scripts
    call `python3 train_single_task.py` in their working directory."""
    d = os.path.join(ws, name)
    os.makedirs(d, exist_ok=True)
    for shim in ("train_single_task.py", "test_single_task.py"):
        if not os.path.lexists(os.path.join(d, shim)):
            os.symlink(os.path.join(HARNESS, shim), os.path.join(d, shim))
    return d


def _output_dir(stage_dir: str, epochs: int) -> str:
    """The one output folder of the stage's run of `epochs` epochs, or ''."""
    found = glob.glob(os.path.join(stage_dir, "output", f"urbanscape-coord-*-e{epochs}-lr*"))
    if len(found) > 1:
        raise RuntimeError(f"more than one -e{epochs} output folder in {stage_dir}: {found}")
    return found[0] if found else ""


def _done(out_dir: str) -> bool:
    return bool(out_dir) and os.path.exists(os.path.join(out_dir, "FLAG_training_done.nodata"))


def _sweep(folder: str) -> list:
    """(iteration, median t, median r, % within 10m/10deg, % within 5m/5deg)
    per checkpoint of `folder`, from its results files."""
    rows = []
    for res in glob.glob(os.path.join(folder, "results_ckpt_iter_*.net_task_coord.txt")):
        it = int(re.search(r"ckpt_iter_(\d+)", os.path.basename(res)).group(1))
        vals = {}
        with open(res) as f:
            for line in f:
                for key, pat in _RESULT_LINES.items():
                    m = pat.match(line)
                    if m and key not in vals:
                        vals[key] = [float(v) for v in m.groups()]
        if len(vals) != len(_RESULT_LINES):
            raise RuntimeError(f"{res} lacks a line of {sorted(_RESULT_LINES)}")
        r, t = vals["Median Error"]
        rows.append((it, t, r, vals["10m10deg"][0], vals["5m5deg"][0]))
    return sorted(rows)


class Timings:
    """Wall seconds of each finished stage, kept in the work directory so a
    rerun that skips a stage still reports it."""

    def __init__(self, ws: str):
        self.path = os.path.join(ws, "stage_seconds.json")
        self.sw = StopWatch()
        self.seconds = {}
        if os.path.exists(self.path):
            with open(self.path) as f:
                self.seconds = json.load(f)

    def finished(self, name: str) -> None:
        self.seconds[name] = self.sw.totals[name]
        with open(self.path, "w") as f:
            json.dump(self.seconds, f, indent=1)


def main(argv=None) -> list:
    args = parse_args(argv)
    smoke = args.smoke
    if not smoke:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("convergence: no CUDA card (use --smoke for the CPU check)")
    ws = os.path.abspath(args.workdir or tempfile.mkdtemp(prefix="convergence."))
    os.makedirs(ws, exist_ok=True)
    img_h, img_w, focal = (32, 48, 40.0) if smoke else (480, 720, 480.0)
    frames = args.frames or (4 if smoke else 480)
    val_frames = args.val_frames or (2 if smoke else 16)
    epochs = args.epochs or (1 if smoke else 100)
    extend = args.extend_epochs if args.extend_epochs is not None else (1 if smoke else 50)
    total = epochs + extend
    batch = 2 if smoke else 12
    depth = "TINY" if smoke else "FULL"
    device = "cpu" if smoke else nvidia_smi_line()
    print(f"== workdir {ws} ({'smoke, CPU' if smoke else device}): {frames} frames, "
          f"{epochs} + {total - epochs} epochs, B={batch}, {img_h}x{img_w}", flush=True)
    times = Timings(ws)

    env = dict(os.environ)
    env.pop("PYTHONPATH", None)  # the shims find the repository themselves
    if smoke:
        env["OMP_NUM_THREADS"] = "2"
    common = (f"--batch_size {batch} --datasets_dir {ws}/datasets --image_height {img_h}"
              + (" --device cpu" if smoke else ""))
    train_args = f"{common} --bf16 --snapshot_every_epochs 5 --learningrate {args.lr}"
    pretrain = ["bash", os.path.join(REPO, "script_clean_training", "encoder_pretrain.sh"),
                "urbanscape", "coord", depth, "1.0", "in_place", "0.0", "MLE", "0"]

    ready = os.path.join(ws, "datasets", "READY")
    if not os.path.exists(ready):
        print("== 1. the plane scene", flush=True)
        from .. import data

        with times.sw.section("data"):
            for section, n, seed in (("train_sim", frames, 0), ("val_sim", val_frames, 1)):
                root = os.path.join(ws, "datasets", "urbanscape", section)
                shutil.rmtree(root, ignore_errors=True)
                data.write_fake_dataset(root, n=n, img_h=img_h, img_w=img_w, focal=focal,
                                        seed=seed, scene="plane")
        times.finished("data")
        open(ready, "w").close()

    p1 = _stage_dir(ws, "phase1")
    if not _done(_output_dir(p1, epochs)):
        print(f"== 2. phase 1: {epochs} epochs at {'a constant ' if args.const_lr else ''}"
              f"{args.lr:g}", flush=True)
        with times.sw.section("phase1"):
            run(pretrain, p1, dict(env, CKPT_DIR=os.path.join(p1, "ckpts"), EXTRA_ARGS=(
                f"--epochs {epochs} {train_args}"
                + (" --no_lr_scheduling" if args.const_lr else ""))),
                os.path.join(ws, "phase1.log"))
        times.finished("phase1")
    p1_out = _output_dir(p1, epochs)
    if not _done(p1_out):
        raise RuntimeError(f"phase 1 left no finished output folder in {p1}")

    arms = ARMS if extend else ()
    arm_outs = {}
    for arm in arms:
        d = _stage_dir(ws, f"arm_{arm}")
        if not _done(_output_dir(d, total)):
            print(f"== 3. phase 2, arm {arm}: --epoch_plus to {total} epochs", flush=True)
            src = os.path.join(d, "output", os.path.basename(p1_out))
            if not os.path.exists(src):
                shutil.copytree(p1_out, src)
            with times.sw.section(f"arm_{arm}"):
                run(pretrain, d, dict(env, CKPT_DIR=os.path.join(d, "ckpts"), EXTRA_ARGS=(
                    f"--epochs {total} --epoch_plus {train_args}"
                    + (" --no_lr_scheduling" if arm == "jax" else ""))),
                    os.path.join(ws, f"arm_{arm}.log"))
            times.finished(f"arm_{arm}")
        arm_outs[arm] = _output_dir(d, total)
        if not _done(arm_outs[arm]):
            raise RuntimeError(f"arm {arm} left no finished output folder in {d}")

    folders = {"phase1": (p1, p1_out)}
    folders.update({arm: (os.path.dirname(os.path.dirname(o)), o) for arm, o in arm_outs.items()})
    sweeps = {}
    for tag, (stage_dir, out_dir) in folders.items():
        ckpts = os.path.join(stage_dir, "ckpts", os.path.basename(out_dir))
        marker = os.path.join(ws, f"sweep_{tag}.done")
        if not os.path.exists(marker):
            print(f"== 4. sweep {ckpts}", flush=True)
            for f in glob.glob(os.path.join(ckpts, "results_*.txt")):
                os.remove(f)  # results files are appended to
            with times.sw.section(f"sweep_{tag}"):
                run(["bash", os.path.join(REPO, "script_clean_validation",
                                          "validate_encoder_pretrain.sh"),
                     "urbanscape", "coord", depth, "MLE", "0"], stage_dir,
                    dict(env, CKPT_DIR=ckpts, MIN_CKPT_ITER="0", EXTRA_ARGS=common),
                    os.path.join(ws, f"sweep_{tag}.log"))
            times.finished(f"sweep_{tag}")
            open(marker, "w").close()
        sweeps[tag] = _sweep(ckpts)
        if not sweeps[tag]:
            raise RuntimeError(f"no results parsed in {ckpts}")

    results, failed = [], []
    for arm in arms or ("phase1",):
        traj = sweeps["phase1"] + (sweeps[arm] if arm in arm_outs else [])
        print(f"\narm {arm}: held-out val_sim per checkpoint (iteration, median t, median r, "
              f"% within 10m/10deg, % within 5m/5deg):")
        for it, t, r, p10, p5 in traj:
            print(f"  iter {it:>8d}: t {t:8.2f}  r {r:7.1f}  {p10:5.1f}%  {p5:5.1f}%")
        # the arm's output.log holds phase 1's lines too (--epoch_plus copies it)
        loss = parse_training_log(os.path.join(arm_outs.get(arm, p1_out), "output.log"))["loss"]
        k = max(1, len(loss) // 20)
        wall = times.seconds["phase1"] + times.seconds.get(f"arm_{arm}", 0.0)
        # the LR of the first extension epoch (the re-run last epoch of
        # phase 1 runs at phase 1's last scheduled LR)
        lr = multistep_lr(args.lr, frames // batch, enabled=arm == "ref")(
            epochs * (frames // batch))
        out = dict(metric="convergence", arm=arm, mode="smoke" if smoke else "card", lr_phase2=lr,
                   loss_first=float(np.mean(loss[:k])), loss_last=float(np.mean(loss[-k:])),
                   t_first=traj[0][1], t_final=traj[-1][1], t_best=min(r[1] for r in traj),
                   r_final=traj[-1][2], pct_10m10deg=traj[-1][3], pct_5m5deg=traj[-1][4],
                   checkpoints=len(traj), steps=len(loss), step_ms=1e3 * wall / len(loss),
                   wall_s=wall, device=device, workdir=ws)
        bars = dict(loss=out["loss_last"] < 0.5 * out["loss_first"],
                    t_half=out["t_final"] < 0.5 * out["t_first"],
                    t_max=out["t_final"] < args.final_t_max)
        out["bars"] = bars
        print(json.dumps(out), flush=True)
        results.append(out)
        if not smoke and not all(bars.values()):
            failed.append(arm)
    print("stage seconds: " + json.dumps(times.seconds))
    if failed:
        raise SystemExit(f"CONVERGENCE RUN FAILED: arm(s) {failed} missed a bar")
    print("CONVERGENCE RUN PASSED" if not smoke else "CONVERGENCE SMOKE PASSED")
    return results


if __name__ == "__main__":
    main()
