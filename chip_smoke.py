"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase, one card
    python3 chip_smoke.py --phases card,kernels

Phases:
  card     print the card, turn TF32 off for the phases that call no CLI,
           build every CUDA source (nvcc, in parallel) and print the build
           time;
  kernels  hold each kernel against its plain PyTorch version at every shape
           of the main paths (f32 and bf16, ReLU on and off; K1 in the design
           its planner picks and in the three-pass design, and once with
           |mean|/std = 1000; the MLR merge norm at C=1536 and 2048; the DUC
           conv's norm at C=64-384, 60x90, B=12 and B=8; ProjHead's four
           norms, 30x45 to 8x12, C=512 and 2048, B=8; K1's
           backward at the training batch and at the finetune batch, with
           C=1536 and 2048, the DUC widths and ProjHead's shapes, in the
           design its planner picks and in the
           four-kernel design, and once with |mean|/std = 1000) and time
           them: device time from CUDA graphs with the L2 evicted between
           calls, and host-inclusive call time, the two designs of K1 and
           of K1-bwd in turns (three-pass or four-kernel, planned, planned,
           three-pass or four-kernel),
           beside the plain version, one PyTorch library call and the bytes
           bound; totals over one forward / step of the coord net (28 calls)
           and of the finetune path (67 K1, 33 K1-bwd); the stems' sums
           (planned, old, bound) in the kernels line; K1 at the stems at
           bench's B=128 bf16 in both designs against the plain twin, timed
           in turns, and stem1's two rejected grid backwards beside the
           four-kernel design;
  forward  full-width coord+MLE net at 480x720, B=8, seeded weights: kernel
           path against the same net through the plain norm, and 28 kernel
           launches per forward; a full-width ProjHead on that net's encoder
           output, forward and backward (4 K1 and 4 K1-bwd launches) against
           the plain norm; the full-width VanillaNetwork (grayscale, no norm,
           no K1 launch) on the card against the CPU;
  serve    write a 480x720 scene, save a seeded `.net`, run the port's
           `test_single_task` in-process on cuda (the main path: results_*.txt,
           finite poses, kernel launches counted on that run), again with
           --bf16; GT-oracle solver accuracy against the CPU; img/s.
  train    the port's `train_single_task` on cuda with the encoder-pretrain
           settings on a 480x720 plane scene (K1 and K1-bwd launches counted
           per step), its model.net served by `test_single_task` on cuda,
           one step's gradients on the card against the CPU, 10 steps on one
           batch, a --bf16 run, and the train-step time at B=12;
  finetune the port's `finetune_decoder_single_task` on cuda with
           decoder_finetune.sh's settings (coord + depth + normal towers from
           seeded full-width donors, the coord tower trains) on a 480x720
           pairwise plane scene: 67 K1 and 33 K1-bwd launches per step, the
           frozen towers bit-identical to their donors, its model.net served
           by `test_single_task` on cuda (num_mlr from the folder name), a
           --bf16 run, one step's trainable gradients on the card against the
           CPU, and the finetune-step time at B=8;
  tasks    the port's `train_single_task` on cuda with encoder_pretrain.sh's
           settings for depth and normal (MLE, --hardclamp 10) and semantics
           (--fullsize, the DUC head): 28 + 28 and 29 + 29 launches per step,
           each model.net served on val_sim by `test_single_task` (its report
           lines finite), card gradients against the CPU for normal and
           semantics, the step times at B=12, a --bf16 semantics run, and TF32
           left off by the CLIs' own setup (ROADMAP F1);
  e2e      DSAC end to end: one step of the full-width coord net at B=12
           with the permissive solver config (28 + 28 launches, a positive
           loss), one step on a two-mode input with the CLI's solver config
           (card gradients against the CPU), the graphed pose loss against
           the eager one (`graph`), the solver's coordinate gradient
           against float64 on that input and on the label coordinates, P3P at
           the step's 1,536 minimal sets against float64, `train_single_task
           --e2e_pose_loss --e2e_warmup_epochs 1` on cuda (f32 and --bf16,
           each served) and the e2e step time;
  parallel data parallelism on the one card, full-width coord + MLE net at
           480x720, f32: (a) `train_single_task` as 2 ranks through
           CROSSLOC_* (gloo over CUDA tensors: NCCL refuses two ranks on one
           device), global B=12, 2 epochs of 24 identical frames, 28 + 28
           launches per step on each rank, rank 1 writing nothing, its
           model.net served; (b) one step's averaged gradient against one
           process at B=12, within twice the spread of single-process
           gradients; (c) the same with --zero, its update against DP's;
           (d) --zero --ckpt_backend orbax for 1 epoch, --epoch_plus to 2,
           against the uninterrupted run; (e) an NCCL group at world size 1;
           (f) the hypothesis-sharded solver on 2 ranks against solve_batch;
           (g) data-parallel eval over [cuda:0, cuda:0]; the step times
           (two ranks on one card, not a scaling figure);
  spatial  the mesh's spatial and model axes, full-width coord + MLE net at
           480x720, f32, TF32 off: (1) the four cross-shard GroupNorm entries
           (K1-shard-stats, -apply, K1-bwd-shard-sums, -apply) at every
           Conv->GN input of the net, B=4, split into 2 and 4 row blocks, each
           against its plain twin and the blocks merged against the plain K1
           twin on the whole image, forward and backward; at 2 blocks in f32
           and bf16 (bf16 held against the twins too): the CUDA kernels one
           call of each entry launches (torch.profiler; one), each entry's
           time with the L2 evicted beside its bytes bound, each direction's
           warm pair (one graph: a flush, the first entry, a copy of the
           gathered tensor, the second entry) beside the pair bounds and the
           split's own traffic, and in f32 the unsharded K1 on the whole
           image and PyTorch's sum, copy and add of the same bytes; (2) two
           ranks sharing the card
           over gloo, spatial 2, global B=4: the forward and one step's loss
           and gradient
           against one process (the parallel phase's tolerance), each
           rank's own cross-shard launches per step, two steps' walls, and a
           third step traced on each rank (its kernels' and copies' device
           time beside its wall); (3)
           `dryrun_multichip(4, "cuda")`: (data 2 x spatial 2), then (data 2
           x model 2), four ranks on the card; (4) the walls per global step
           beside the card's name and power limit (ranks sharing one card:
           not a scaling figure);
  loader   the host data path: the host's headers, libraries and cores; the
           native image decoder built (g++) and held against PIL on 480x720
           frames of the plane scene (the same bits; resized to 240 rows
           within 1e-2); crossloc_tpu_torch/tools/loader_bench.py with the
           coord step times (this run's train phase, else PERF.md §5's); the
           training CLI with encoder_pretrain.sh's settings, --bf16, B=12,
           96 frames, 2 epochs, once with the native decoder and once with
           PIL: wall and loader wait per step, 28 + 28 launches per step, no
           image of the native run read by PIL; K1 at bench's six shapes
           (B=128, bf16, stem1 1.4e9 elements) against the plain twin;
           crossloc_tpu_torch/tools/bench.py at B=128 (bf16 image -> pose,
           28 K1 launches per batch). Without the decoder's headers it says
           so and measures PIL alone;
  arms     the eight harness scripts no other phase runs, with their own flags,
           through the CLIs in process at full width (480x720, f32), one batch
           of frames per section, one epoch: encoder_finetune.sh in place
           (twice: the second resumes from the folder's model_resume.net) and
           out of place, encoder_pretrain_{real,pairwise}_only.sh (28 + 28
           launches per step), decoder_finetune_{real,pairwise}_only.sh over
           the finetuned coord net and seeded depth and normal donors (67 + 33
           per step), validate_encoder_finetune.sh and
           validate_encoder_pretrain_{real,pairwise}_only.sh (the eval CLI over
           each checkpoint folder, 28 per checkpoint, then select_ckpt); the
           JAX CLIs' folder names, flags and results files, finite losses;
           then the quickstart twin on cuda (400 steps of the tiny net, B=4,
           96x144); `arms.json` in the out dir. The kernels phase holds K1 and
           K1-bwd at the tiny net's shapes (B=4 and B=2, 96x144) too;
  profile  (extra, not in the default run) the CUDA kernels of one K1 and
           K1-bwd call at the stems in both designs, with the three-pass
           split (one for K1, at most two for a grid K1-bwd); kernel-time
           breakdown of one image -> pose batch, one coord and one semantics
           training step, one finetune step and one e2e step with
           torch.profiler;
  converge (extra) the coord net's convergence run through the unchanged
           encoder_pretrain.sh and validate_encoder_pretrain.sh
           (crossloc_tpu_torch/tools/convergence.py: 480 plane frames at
           480x720, B=12, --bf16, 100 epochs at 2e-3, then 50 more in two LR
           arms), held to the JAX tool's bars;
  rehearsal (extra) crossloc_tpu_torch/examples/dress_rehearsal.sh on cuda: the
           experiment matrix through the unchanged harness, the e2e, kill and
           resume, and out-of-place arms; logs in `<out-dir>/rehearsal/`;
  e2e_ab   (extra) crossloc_tpu_torch/tools/e2e_ab.py on cuda for --labels corrupt
           and clean at --lr_e2e 3e-4, 3e-5 and 3e-6: held-out medians, walls
           and per-step times in `<out-dir>/e2e_ab/e2e_ab.jsonl`.
  graph    (extra) the DSAC* cell's pose loss replayed from its CUDA graphs
           (`ransac/graph.py`) against the eager loss at B=12, 60 x 90 cells,
           64 hypotheses: loss and gradient gaps, host and wall ms a call,
           kernel ms and count, the capture's seconds; `e2e_graph.json`.
The gradient checks' float64 reference runs on the card with the plain twins.

Prints the card's name and power limit, one JSON line of kernels, and last
`{"ok": true, "device": {...}}`. Exits non-zero if any phase fails, if no
CUDA device is present, or if the port's package is not beside this file.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(HERE, "crossloc_tpu_torch", "build", "smoke")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM, non-tensor-core fp32
FLUSH_BYTES = 96 << 20  # written between timed calls: more than the 50 MB L2
BATCH = 8
TRAIN_BATCH = 12  # script_clean_training/encoder_pretrain.sh
IMG_H, IMG_W = 480, 720
# the training CLI as script_clean_training/encoder_pretrain.sh runs it (coord)
PRETRAIN_ARGS = ["urbanscape", "--task", "coord", "--inittolerance", "50.0", "--softclamp",
                 "100", "--hardclamp", "1000", "--learningrate", "2e-4", "--batch_size",
                 str(TRAIN_BATCH), "--uncertainty", "MLE", "--auto_resume",
                 "--sim_data_chunk", "1.0", "--real_data_chunk", "0.0", "--device", "cuda"]

FT_BATCH = 8  # script_clean_training/decoder_finetune.sh
# the finetune CLI as script_clean_training/decoder_finetune.sh runs it
FINETUNE_ARGS = ["urbanscape", "--task", "coord", "--inittolerance", "50.0", "--softclamp",
                 "100", "--hardclamp", "1000", "--learningrate", "1e-4", "--batch_size",
                 str(FT_BATCH), "--uncertainty", "MLE", "--auto_resume", "--real_data_domain",
                 "in_place", "--real_data_chunk", "1.0", "--sim_data_chunk", "0.0",
                 "--encoders", "coord", "depth", "normal", "--reuse_coord_encoder",
                 "--unfreeze_coord_encoder", "--no_lr_scheduling", "--device", "cuda"]
FT_TASKS = ("coord", "depth", "normal")
# the per-task flags of script_clean_training/_lib.sh::task_flags, with
# encoder_pretrain.sh's uncertainty (semantics: none)
TASK_FLAGS = {"depth": ["--hardclamp", "10", "--uncertainty", "MLE"],
              "normal": ["--hardclamp", "10", "--uncertainty", "MLE"],
              "semantics": ["--fullsize", "--uncertainty", "none"]}
# (task, scene, extra flags) of the tasks phase's runs
TASK_RUNS = [("depth", "plane", []), ("normal", "noise", []), ("semantics", "plane", [])]
# the first words of each report's lines (eval/reports.py)
TASK_REPORT_LINES = {
    "depth": ("absolute relative error, mean:", "RMS error, mean:"),
    "normal": ("angular prediction error, mean:",),
    "semantics": ("Pixel accuracy, mean:", "Mean IoU, mean:", "Frequency weighted IoU, mean:")}
# the coord train step at B=12, 480x720 on an H100 at 700 W (PERF.md §5): the loader
# phase's consumer times when the train phase has not measured them this run
STEP_MS_RECORDED = {"bfloat16": 38.14, "float32": 274.89}
LOADER_FRAMES = 96  # 8 steps of 12 per epoch
BENCH_BATCH = 128  # tools/bench.py's default batch, as the root bench.py's
FT_FWD, FT_BWD = 67, 33  # K1 per forward (3 x 17 + 5 + 11), K1-bwd per step (17 + 5 + 11)
# the permissive solver config of the JAX package's DSAC test
# (tests/test_train.py:411-416): an untrained net then has valid hypotheses
E2E_PERMISSIVE = dict(inlier_threshold=5000.0, max_pixel_error=10000.0)

# (C, H, W, relu, layers per forward) of the 28 Conv->GN layers at 480x720
GN_PATH_SHAPES = [
    (32, 480, 720, True, 1),   # stem1
    (64, 240, 360, True, 1),   # stem2
    (128, 120, 180, True, 1),  # stem3
    (256, 60, 90, True, 4),    # stem4, res1_1..3
    (512, 60, 90, True, 20),   # res2_1..3, enc/dec add_res, res3, fc1, fc2
    (512, 60, 90, False, 1),   # res2_skip
]
# the MLR merge norm over 3 towers (this path) and 4 (with semantics); in no
# 28-layer total
MLR_SHAPES = [(1536, 60, 90, False, 0), (2048, 60, 90, False, 0)]
# the DUC conv's norm at 480x720: C = 64 x the output channels (depth 1 + 1,
# normal 2 + 1, coord 3 + 1 with --fullsize; semantics 6 on its main path);
# held at the semantics training batch and the eval batch, in no 28-call total
DUC_SHAPES = [(C, 60, 90, True, 0) for C in (64, 128, 192, 256, 384)]
# ProjHead's four norms on the encoder's 60x90x512 output at 480x720: three
# stride-2 3x3 convs to 512, a 1x1 conv to out_length 2048 (64 channels a
# group); one call each per forward
PROJ_SHAPES = [(512, 30, 45, True, 1), (512, 15, 23, True, 1), (512, 8, 12, True, 1),
               (2048, 8, 12, True, 1)]
# (C, H, W, relu, K1 calls per forward, K1-bwd calls per step) of the
# finetune path: three towers forward, the first backward too, the five MLR
# norms and the decoder's eleven
FT_PATH_SHAPES = [
    (32, 480, 720, True, 3, 1),
    (64, 240, 360, True, 3, 1),
    (128, 120, 180, True, 3, 1),
    (256, 60, 90, True, 12, 4),
    (512, 60, 90, True, 41, 23),   # towers' res2 + add_res, mlr_forward, decoder
    (512, 60, 90, False, 4, 2),    # towers' res2_skip, mlr_skip
    (1536, 60, 90, False, 1, 1),   # mlr_norm
]

# the arms phase: the eight scripts' flags (script_clean_training/_lib.sh and
# each script; --epochs 1 where the scripts give hundreds), and the folder
# names the JAX CLIs write for them at full width
ARM_FRAMES, ARM_VAL_FRAMES = TRAIN_BATCH, BATCH  # one batch per section
ARM_SECTIONS = ("train_drone_real", "train_drone_sim", "train_oop_drone_real",
                "train_oop_drone_sim", "val_drone_real")
COORD_FLAGS = ["--inittolerance", "50.0", "--softclamp", "100", "--hardclamp", "1000"]
ARM_FOLDERS = {
    "encoder_finetune_ip":
        "urbanscape-coord-sclean_training_ip-unc-MLE-e1-lr0.0001-pairs-ip-rc1.00-finetune",
    "encoder_finetune_oop":
        "urbanscape-coord-sclean_training_oop-unc-MLE-e1-lr0.0001-pairs-oop-rc1.00-finetune",
    "encoder_pretrain_real_only":
        "urbanscape-coord-sclean_training-unc-MLE-e1-lr0.0002-real_only-oop-rc1.00",
    "encoder_pretrain_pairwise_only":
        "urbanscape-coord-sclean_training-unc-MLE-e1-lr0.0002-pairs-ip-rc1.00",
    "decoder_finetune_real_only": "urbanscape-coord-decoder_coord_free_depth_normal-senc-pt1.00-"
                                  "ip-ft1.00-unc-MLE-e1-lr0.0001-real_only-ip-rc1.00",
    "decoder_finetune_pairwise_only": "urbanscape-coord-decoder_coord_free_depth_normal-senc-"
                                      "pt1.00-ip-ft1.00-unc-MLE-e1-lr0.0001-pairwise-ip-rc1.00",
}
# validate_encoder_finetune.sh and validate_encoder_pretrain_{real,pairwise}_only.sh
ARM_VALIDATIONS = ("encoder_finetune_ip", "encoder_pretrain_real_only",
                   "encoder_pretrain_pairwise_only")
QUICKSTART_STEPS = 400
# the e2e A/B's regimes and e2e learning rates (the JAX tool's default 3e-4 first)
E2E_AB_RUNS = [(labels, lr) for labels in ("corrupt", "clean") for lr in (3e-4, 3e-5, 3e-6)]

# the tiny coord net (--tiny, widths 128/128) at 96x144, the size of the
# quickstart, the e2e A/B tool and the dress rehearsal: (C, H, W, relu, K1 calls
# per forward, K1-bwd calls per step); 27 layers (no res2_skip). The rehearsal's
# four-tower decoder finetune adds the MLR skip and merge norms at 12x18
TINY_H, TINY_W = 96, 144
TINY_PATH_SHAPES = [(32, 96, 144, True, 1, 1), (64, 48, 72, True, 1, 1),
                    (128, 24, 36, True, 1, 1), (128, 12, 18, True, 24, 24)]
TINY_MLR_SHAPES = [(128, 12, 18, False, 1, 1), (512, 12, 18, False, 1, 1)]
TINY_BATCHES = (4, 2)  # e2e_ab and quickstart; the rehearsal

# the spatial phase: the global batch of its 2-rank step, the cross-shard
# entries by their names in the kernels line, and the blocks whose statistics
# one rank's apply reads (spatial 2)
SPATIAL_BATCH = 4
SHARD_ENTRIES = ("groupnorm_shard_stats", "groupnorm_shard_apply",
                 "groupnorm_shard_backward_sums", "groupnorm_shard_backward_apply")
S_GATHER = 2
SHORT = {"float32": "f32", "bfloat16": "bf16"}  # dtype names in the kernels line's keys
YARDSTICKS = ("sum", "copy", "add")  # PyTorch's passes over an entry's bytes (f32)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(fns, flush, n: int = 20, reps: int = 5) -> list:
    """Device time per call of each fn: a CUDA graph of n captured calls,
    each after `flush` (a write of FLUSH_BYTES, which evicts the 50 MB L2 so
    every call reads its input from HBM), replayed `reps` times (median),
    less the same graph of flushes alone. No host work inside the time."""
    import torch

    def graph(fn):
        fn(), flush()  # build, allocate and check configurations before capture
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                flush()
                fn()
        return g

    def replay_ms(g):
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        return sorted(ts)[len(ts) // 2]

    g0 = graph(lambda: None)
    base = replay_ms(g0)
    out = []
    for fn in fns:
        g = graph(fn)
        out.append((replay_ms(g) - base) / n)
        del g
    del g0
    return out


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-inclusive time per call: back-to-back calls between two events
    (a call's host work, when larger than its device time, sets the pace)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _path_totals(rows, col: int, keys) -> dict:
    """Per dtype, the sums over FT_PATH_SHAPES of (calls in column `col`:
    4 = K1 per forward, 5 = K1-bwd per step) x each key of the row measured
    at that (C, relu)."""
    out = {}
    for d in ("float32", "bfloat16"):
        by = {(r["C"], r["relu"]): r for r in rows if r["dtype"] == d}
        out[d] = {k: sum(s[col] * by[(s[0], s[3])][k] for s in FT_PATH_SHAPES) for k in keys}
    return out


def _where(plan) -> str:
    """A plan of K1 or K1-bwd as a row prints it."""
    if plan.design == "cluster":
        return (f"cluster of {plan.cluster} CTAs, cb={plan.cb}, {plan.threads} threads, "
                f"{plan.smem_bytes} B smem")
    if plan.design == "grid":
        held = min(plan.nbox * plan.box_rows, plan.rows_per_cta)
        return (f"grid of {plan.grid} CTAs, {plan.cluster} a unit, cb={plan.cb}, "
                f"{held} of {plan.rows_per_cta} rows held, {plan.threads} threads, "
                f"{plan.smem_bytes} B smem")
    return plan.design


def _kernel_name(name: str) -> str:
    """A CUDA kernel's own name, without its namespace, template arguments
    and parameters ("void (anonymous namespace)::gn_grid_kernel<float>(...)"
    -> "gn_grid_kernel")."""
    found = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return found.group(1) if found else name


@contextlib.contextmanager
def _old_stem_designs():
    """K1 and K1-bwd planned as before the grid design: the shapes it takes
    (the stems) run the three-pass and four-kernel designs instead."""
    from crossloc_tpu_torch.ops import groupnorm as gn

    plan, plan_backward = gn._plan, gn._plan_backward
    gn._plan = lambda *a: gn._THREE_PASS if plan(*a).design == "grid" else plan(*a)
    gn._plan_backward = lambda *a: (gn._FOUR_KERNEL if plan_backward(*a).design == "grid"
                                    else plan_backward(*a))
    try:
        yield
    finally:
        gn._plan, gn._plan_backward = plan, plan_backward


def _stem_sums(rows, old: str) -> dict:
    """Per dtype, the sums over the two stems (C=32 at 480x720, C=64 at
    240x360) of the planned design's, the old design's (`old`: the row's
    three_pass_ms or four_kernel_ms) and the bound's device ms."""
    out = {}
    for d in ("float32", "bfloat16"):
        st = [r for r in rows if r["dtype"] == d and (r["C"], r["H"]) in ((32, 480), (64, 240))]
        assert len(st) == 2, st
        out[d] = {k: sum(r[k] for r in st) for k in ("ms", old, "bound_ms")}
    return out


def _duc_row(rows, B, dtype) -> dict:
    """The row of the semantics DUC conv's norm (C=384) at batch B."""
    (row,) = [r for r in rows if r["C"] == 384 and r["B"] == B and r["dtype"] == dtype]
    return row


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _host_probe() -> dict:
    """What the host offers the native decoder: the headers under
    /usr/include, whether g++ finds zlib's (the decoder needs it; libjpeg's
    is optional), the libraries `ldconfig` lists, g++, and the cores."""
    headers = {h: os.path.exists(os.path.join("/usr/include", h))
               for h in ("png.h", "jpeglib.h", "zlib.h")}
    cxx = shutil.which("g++")
    ok = False
    if cxx:
        ok = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                            input="#include <zlib.h>\n", capture_output=True, text=True,
                            timeout=60).returncode == 0
    try:
        libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                              timeout=60).stdout
        libs = sorted({ln.split()[0] for ln in libs.splitlines()
                       if any(k in ln for k in ("libpng", "libjpeg", "libz."))})
    except OSError as e:
        libs = [f"ldconfig failed: {e}"]
    return dict(headers=headers, zlib_ok=ok, gxx=cxx, libraries=libs,
                usable_cores=len(os.sched_getaffinity(0)), cpu_count=os.cpu_count())


def _on_target(net, target):
    """`net` with the value of its coordinate channels replaced by `target`
    [B, h, w, 3] and their gradient passed on to the net unchanged: the
    solver sees a chosen input, and the backward runs through the whole net."""
    import torch

    class OnTarget(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net, self.num_task_channel = net, net.num_task_channel

        def forward(self, x):
            out = self.net(x)
            c = out[..., :3]
            return torch.cat([c - c.detach() + target, out[..., 3:]], dim=-1)

    return OnTarget()


class Smoke:
    def __init__(self, iters: int, out_dir: str):
        self.iters = iters
        self.out_dir = out_dir  # JSON and profile tables
        self.kernels = {}  # name -> dict of the kernels line
        self.launches = {}  # main path -> {kernel name: launches counted on that path's run}
        self.device_name = None
        self.train_step_ms = {}  # dtype name -> the train phase's step ms, when it ran

    # -- phase 1 -----------------------------------------------------------
    def phase_card(self):
        import torch

        self.device_name = torch.cuda.get_device_name(0)
        log(f"card: {self.device_name} | {nvidia_smi_line()} | torch {torch.__version__} "
            f"cuda {torch.version.cuda} python {sys.version.split()[0]}")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
        from crossloc_tpu_torch.ops import _build

        t0 = time.perf_counter()
        names = _build.all_sources()
        _build.build(names)
        for n in names:
            _build.library(n)
        log(f"built {names} in {time.perf_counter() - t0:.2f} s "
            f"(per source: {_build.build_seconds})")
        for n, rep in _build.ptxas_report.items():
            for line in rep.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas[{n}]: {line.strip()}")

    # -- phase 2 -----------------------------------------------------------
    def phase_kernels(self):
        import torch

        flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
        flush = flush_buf.zero_
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows, worst = self._forward_rows(flush, gen, BATCH, GN_PATH_SHAPES + MLR_SHAPES)
        duc_rows = []
        for B in (TRAIN_BATCH, BATCH):
            r, w = self._forward_rows(flush, gen, B, DUC_SHAPES)
            duc_rows += r
            worst = max(worst, w)
        proj_rows, w = self._forward_rows(flush, gen, BATCH, PROJ_SHAPES)
        worst = max(worst, w)
        self._large_mean_check()
        keys = ("ms", "three_pass_ms", "plain_ms", "library_ms", "bound_ms")
        tot = {d: {k: sum(r["per_forward"] * r[k] for r in rows if r["dtype"] == d) for k in keys}
               for d in ("float32", "bfloat16")}
        ft = _path_totals(rows, 4, keys)
        # the semantics net: the coord net's 28 layers and the DUC conv's (C=384)
        sem = {d: {k: tot[d][k] + _duc_row(duc_rows, BATCH, d)[k] for k in keys} for d in tot}
        proj = {d: {k: sum(r[k] for r in proj_rows if r["dtype"] == d) for k in keys}
                for d in tot}
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "k1_shapes.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), flush_bytes=FLUSH_BYTES,
                           rows=rows, duc_rows=duc_rows, proj_rows=proj_rows, per_forward=tot,
                           per_finetune_forward=ft, per_semantics_forward=sem,
                           per_projhead_forward=proj), f, indent=1)
        for dname, t in tot.items():
            log(f"K1 over one {dname} forward's 28 calls (B={BATCH}, 480x720), device time: "
                f"planned {t['ms']:.4f} ms, three-pass {t['three_pass_ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
        for dname, t in ft.items():
            log(f"K1 over one {dname} finetune forward's {FT_FWD} calls (B={FT_BATCH}, 480x720, "
                f"3 towers + MLR + decoder), device time: planned {t['ms']:.4f} ms, three-pass "
                f"{t['three_pass_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
        for dname, t in sem.items():
            log(f"K1 over one {dname} semantics forward's 29 calls (B={BATCH}, 480x720, the DUC "
                f"conv's at C=384), device time: planned {t['ms']:.4f} ms, three-pass "
                f"{t['three_pass_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
        for dname, t in proj.items():
            log(f"K1 over one {dname} ProjHead forward's 4 calls (B={BATCH}, from 60x90x512), "
                f"device time: planned {t['ms']:.4f} ms, three-pass {t['three_pass_ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
        f32 = tot["float32"]
        stems = _stem_sums(rows, "three_pass_ms")
        for dname, t in stems.items():
            log(f"K1 over the two stems, {dname}, B={BATCH}: planned {t['ms']:.4f} ms, "
                f"three-pass {t['three_pass_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"(bound / planned = {t['bound_ms'] / t['ms']:.1%})")
        self.kernels["groupnorm"] = dict(
            name="groupnorm", route="cuda", source="crossloc_tpu_torch/csrc/groupnorm.cu",
            replaces="crossloc_tpu/ops/pallas_groupnorm.py:57",
            max_abs_err=worst, ms=f32["ms"], plain_ms=f32["plain_ms"],
            library_ms=f32["library_ms"], bound_ms=f32["bound_ms"], bound_by="bytes",
            three_pass_ms=f32["three_pass_ms"],
            **{f"stems_{SHORT[d]}_{k}": stems[d][key]
               for d in ("float32", "bfloat16")
               for k, key in (("ms", "ms"), ("old_ms", "three_pass_ms"),
                              ("bound_ms", "bound_ms"))})
        self._backward_kernel(flush)
        self._bench_stem_rows(flush)
        self._tiny_kernels(flush, gen)

    def _tiny_kernels(self, flush, gen):
        """K1 and K1-bwd at the tiny net's shapes at 96x144 (TINY_PATH_SHAPES;
        the MLR norms at B=2), f32 and bf16, each design against the plain
        twin as at the full width, timed; totals over one 27-call forward and
        step per batch in `k1_tiny_shapes.json`."""
        shapes = {B: TINY_PATH_SHAPES + (TINY_MLR_SHAPES if B == 2 else []) for B in TINY_BATCHES}
        fwd, bwd, worst = {}, {}, [0.0, 0.0]
        for seed, B in enumerate(TINY_BATCHES, start=6):
            fwd[B], w = self._forward_rows(flush, gen, B, [s[:5] for s in shapes[B]])
            worst[0] = max(worst[0], w)
            bwd[B], w = self._backward_rows(flush, B, [s[:4] for s in shapes[B]], seed=seed)
            worst[1] = max(worst[1], w)
        totals = {}
        for B in TINY_BATCHES:
            for kind, rows, col, keys in (
                    ("k1", fwd[B], 4, ("ms", "three_pass_ms", "plain_ms", "library_ms", "bound_ms")),
                    ("k1_bwd", bwd[B], 5, ("ms", "four_kernel_ms", "plain_ms", "library_ms",
                                           "bound_ms"))):
                for d in ("float32", "bfloat16"):
                    by = {(r["C"], r["H"], r["relu"]): r for r in rows if r["dtype"] == d}
                    t = {k: sum(sh[col] * by[(sh[0], sh[1], sh[3])][k] for sh in TINY_PATH_SHAPES)
                         for k in keys}
                    totals[f"{kind}_B{B}_{d}"] = t
                    other = "three-pass" if kind == "k1" else "four-kernel"
                    log(f"{'K1' if kind == 'k1' else 'K1-bwd'} over one {d} tiny-net "
                        f"{'forward' if kind == 'k1' else 'step'}'s 27 calls (B={B}, "
                        f"{TINY_H}x{TINY_W}), device time: planned {t['ms']:.4f} ms, {other} "
                        f"{t[keys[1]]:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                        f"(bound / planned = {t['bound_ms'] / t['ms']:.1%})")
        with open(os.path.join(self.out_dir, "k1_tiny_shapes.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), flush_bytes=FLUSH_BYTES,
                           forward_rows=[r for B in TINY_BATCHES for r in fwd[B]],
                           backward_rows=[r for B in TINY_BATCHES for r in bwd[B]],
                           totals=totals), f, indent=1)
        for name, w, kind in (("groupnorm", worst[0], "k1"), ("groupnorm_backward", worst[1],
                                                              "k1_bwd")):
            k = self.kernels[name]
            k["max_abs_err"] = max(k["max_abs_err"], w)
            k["tiny_B4_ms"] = totals[f"{kind}_B4_float32"]["ms"]
            k["tiny_B4_bound_ms"] = totals[f"{kind}_B4_float32"]["bound_ms"]

    def _forward_rows(self, flush, gen, B, shapes):
        """K1 at each (C, H, W, relu, layers per forward) of `shapes`, batch B,
        f32 and bf16, ReLU on and off, in the design `_plan` picks and in the
        three-pass design, each against the plain twin, and timed at the
        path's ReLU: device time (CUDA graphs, L2 evicted) and call time of
        the two designs in turns (three-pass, planned, planned, three-pass),
        the plain twin, one library call (`F.group_norm` + ReLU) and the
        bytes bound. Returns (rows, worst f32 |y - plain| of the planned
        design)."""
        import torch
        import torch.nn.functional as F

        from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import _plan, _three_pass

        rows, worst = [], 0.0
        for C, H, W, relu_path, count in shapes:
            G = min(32, C)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype)[6:]
                plan = _plan(B, H, W, C, G, dtype)
                x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * 2.0 + 3.0).to(dtype)
                scale = torch.randn(C, device="cuda", generator=gen)
                bias = torch.randn(C, device="cuda", generator=gen)
                for relu in (True, False):
                    ref = group_norm_relu_plain(x, scale, bias, G, 1e-5, relu)
                    for design, fn in (("planned", group_norm_relu), ("three_pass", _three_pass)):
                        y = fn(x, scale, bias, G, 1e-5, relu)
                        torch.cuda.synchronize()
                        err = (y.float() - ref.float()).abs()
                        # f32: reassociation of fp32 sums only; bf16: one bf16
                        # rounding step of the output (2^-7 relative) apart
                        atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 2.0**-7)
                        ok = bool((err <= atol + rtol * ref.float().abs()).all())
                        mx = float(err.max())
                        if design == "planned" and dtype == torch.float32:
                            worst = max(worst, mx)
                        name = plan.design if design == "planned" else "three_pass"
                        log(f"  K1 {name} C={C} {H}x{W} B={B} {dname} relu={relu}: max_abs_err="
                            f"{mx:.3e} (limit {atol:g} + {rtol:g}*|ref|) {'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(f"K1 {name} disagrees with plain at C={C} {H}x{W} "
                                                 f"B={B} {dtype} relu={relu}")
                    del y, ref
                relu = relu_path
                planned = lambda: group_norm_relu(x, scale, bias, G, 1e-5, relu)
                three = lambda: _three_pass(x, scale, bias, G, 1e-5, relu)
                # in turns: three-pass, planned, planned, three-pass
                dev = device_ms([three, planned, planned, three], flush)
                call = [cuda_ms(f, self.iters) for f in (three, planned, planned, three)]
                xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, no copy
                sw, sb = scale.to(dtype), bias.to(dtype)

                def lib_call():
                    o = F.group_norm(xc, G, sw, sb, 1e-5)
                    return torch.relu_(o) if relu else o

                p_ms, l_ms = device_ms(
                    [lambda: group_norm_relu_plain(x, scale, bias, G, 1e-5, relu), lib_call],
                    flush, n=5)
                nbytes = 2 * x.numel() * x.element_size() + 2 * C * 4
                bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, 8 * x.numel() / FP32_FLOPS)
                row = dict(C=C, H=H, W=W, B=B, dtype=dname, relu=relu, design=plan.design,
                           cluster=plan.cluster, cb=plan.cb, threads=plan.threads, grid=plan.grid,
                           ms=(dev[1] + dev[2]) / 2, call_ms=(call[1] + call[2]) / 2,
                           three_pass_ms=(dev[0] + dev[3]) / 2,
                           three_pass_call_ms=(call[0] + call[3]) / 2, turns_ms=dev,
                           turns_call_ms=call, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound,
                           per_forward=count)
                rows.append(row)
                log(f"  K1 time C={C} {H}x{W} B={B} {dname} relu={relu} [{_where(plan)}]: device "
                    f"{row['ms']:.4f} ms (three-pass {row['three_pass_ms']:.4f}; turns "
                    + "/".join(f"{t:.4f}" for t in dev) + f"), call {row['call_ms']:.4f} ms "
                    f"(three-pass {row['three_pass_call_ms']:.4f}), plain {p_ms:.4f} ms, "
                    f"F.group_norm(+relu) {l_ms:.4f} ms, bytes bound {bound:.4f} ms "
                    f"(bound / device = {bound / row['ms']:.1%})")
                del x
        return rows, worst

    def _backward_kernel(self, flush):
        """K1's backward at the coord net's shapes at B=TRAIN_BATCH (the
        28-call totals) and at the finetune path's and the MLR widths' at
        B=FT_BATCH (the 33-call totals), both designs, and at |mu|/std =
        1000."""
        shapes = [s[:4] for s in GN_PATH_SHAPES]
        rows, worst = self._backward_rows(flush, TRAIN_BATCH, shapes, seed=1)
        ft_shapes = [s[:4] for s in FT_PATH_SHAPES] + [s[:4] for s in MLR_SHAPES[1:]]
        ft_rows, ft_worst = self._backward_rows(flush, FT_BATCH, ft_shapes, seed=2)
        duc_rows = []
        for seed, B in enumerate((TRAIN_BATCH, FT_BATCH), start=3):
            r, w = self._backward_rows(flush, B, [s[:4] for s in DUC_SHAPES], seed=seed)
            duc_rows += r
            worst = max(worst, w)
        proj_rows, w = self._backward_rows(flush, BATCH, [s[:4] for s in PROJ_SHAPES], seed=5)
        worst = max(worst, w)
        self._large_mean_backward_check()
        options = self._stem1_backward_options(flush)
        keys = ("ms", "four_kernel_ms", "plain_ms", "library_ms", "bound_ms")
        tot = {d: {k: sum(c * r[k] for r in rows for (C, H, W, relu, c) in GN_PATH_SHAPES
                          if r["dtype"] == d and (r["C"], r["relu"]) == (C, relu)) for k in keys}
               for d in ("float32", "bfloat16")}
        ft = _path_totals(ft_rows, 5, keys)
        sem = {d: {k: tot[d][k] + _duc_row(duc_rows, TRAIN_BATCH, d)[k] for k in keys}
               for d in tot}
        proj = {d: {k: sum(r[k] for r in proj_rows if r["dtype"] == d) for k in keys}
                for d in tot}
        with open(os.path.join(self.out_dir, "k1_backward_shapes.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), flush_bytes=FLUSH_BYTES,
                           rows=rows + ft_rows, duc_rows=duc_rows, proj_rows=proj_rows,
                           per_step=tot, per_finetune_step=ft, per_semantics_step=sem,
                           per_projhead_step=proj, stem1_options=options), f, indent=1)
        for dname, t in tot.items():
            log(f"K1-bwd over one {dname} training step's 28 calls (B={TRAIN_BATCH}, 480x720), "
                f"device time: planned {t['ms']:.4f} ms, four-kernel {t['four_kernel_ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
        for dname, t in ft.items():
            log(f"K1-bwd over one {dname} finetune step's {FT_BWD} calls (B={FT_BATCH}, 480x720), "
                f"device time: planned {t['ms']:.4f} ms, four-kernel {t['four_kernel_ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
        for dname, t in sem.items():
            log(f"K1-bwd over one {dname} semantics step's 29 calls (B={TRAIN_BATCH}, 480x720, "
                f"the DUC conv's at C=384), device time: planned {t['ms']:.4f} ms, four-kernel "
                f"{t['four_kernel_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
        for dname, t in proj.items():
            log(f"K1-bwd over one {dname} ProjHead backward's 4 calls (B={BATCH}), device time: "
                f"planned {t['ms']:.4f} ms, four-kernel {t['four_kernel_ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms")
        f32 = tot["float32"]
        stems = _stem_sums(rows, "four_kernel_ms")
        for dname, t in stems.items():
            log(f"K1-bwd over the two stems, {dname}, B={TRAIN_BATCH}: planned {t['ms']:.4f} ms, "
                f"four-kernel {t['four_kernel_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
                f"(bound / planned = {t['bound_ms'] / t['ms']:.1%})")
        self.kernels["groupnorm_backward"] = dict(
            name="groupnorm_backward", route="cuda", source="crossloc_tpu_torch/csrc/groupnorm.cu",
            replaces="crossloc_tpu/ops/pallas_groupnorm.py:141",
            max_abs_err=max(worst, ft_worst), ms=f32["ms"], plain_ms=f32["plain_ms"],
            library_ms=f32["library_ms"], bound_ms=f32["bound_ms"], bound_by="bytes",
            four_kernel_ms=f32["four_kernel_ms"],
            **{f"stems_{SHORT[d]}_{k}": stems[d][key]
               for d in ("float32", "bfloat16")
               for k, key in (("ms", "ms"), ("old_ms", "four_kernel_ms"),
                              ("bound_ms", "bound_ms"))})

    def _stem1_backward_options(self, flush):
        """The grid backward at stem1 (B=TRAIN_BATCH, f32 and bf16, ReLU),
        whose x + dy at 64 bytes a pixel (44 MB an image) outgrow the card's
        shared memory, in the two plans the planner passes over: (a) 32-byte
        channel blocks held whole, (b) 64-byte blocks holding what the card
        takes and streaming the rest; each against the plain twin and timed
        in turns with the four-kernel design it keeps (four-kernel, a, b, b,
        a, four-kernel)."""
        import torch

        from crossloc_tpu_torch.ops import group_norm_relu_backward_plain, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import (_SMS, _four_kernel_backward,
                                                      _grid_backward, _grid_plan_block, _launch)

        C, H, W, relu, _ = GN_PATH_SHAPES[0]
        B, G, out = TRAIN_BATCH, 32, []
        gen = torch.Generator(device="cuda").manual_seed(13)
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.empty((), dtype=dtype).element_size()
            x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * 2.0 + 3.0).to(dtype)
            s = torch.randn(C, device="cuda", generator=gen)
            b = torch.randn(C, device="cuda", generator=gen)
            pre = group_norm_relu_plain(x.float(), s, b, G, 1e-5, False)
            dy = (torch.randn(x.shape, device="cuda", generator=gen) * (pre.abs() > 1e-3)).to(dtype)
            del pre
            st = torch.empty(B, G, 2, device="cuda")
            _launch(x, s, b, G, 1e-5, relu, st)
            ref = group_norm_relu_backward_plain(x, s, b, dy, G, 1e-5, relu)
            plans = {"a_32_byte_blocks": _grid_plan_block(B, H * W, C, G, item, 2, 32 // item,
                                                          False, _SMS)[1],
                     "b_64_byte_streaming": _grid_plan_block(B, H * W, C, G, item, 2, 64 // item,
                                                             True, _SMS)[1]}
            rel = 1e-4 + (2.0**-7 if dtype == torch.bfloat16 else 0.0)
            for name, plan in plans.items():
                got = _grid_backward(x, s, b, st, dy, G, relu, plan)
                torch.cuda.synchronize()
                for a_, r_ in zip(got, ref):
                    a_, r_ = a_.float(), r_.float()
                    lim = 1e-4 * r_.abs().max() + (rel * r_.abs() if r_.dim() == 4 else 0.0)
                    if not bool(((a_ - r_).abs() <= lim).all()):
                        raise AssertionError(f"K1-bwd stem1 option {name} disagrees with plain")
                del got
            del ref
            fns = [lambda: _four_kernel_backward(x, s, b, st, dy, G, relu)] + [
                (lambda p=p: _grid_backward(x, s, b, st, dy, G, relu, p)) for p in plans.values()]
            dev = device_ms(fns + fns[::-1], flush)
            ms = [(dev[i] + dev[-1 - i]) / 2 for i in range(len(fns))]
            row = dict(dtype=str(dtype)[6:], B=B, four_kernel_ms=ms[0], turns_ms=dev,
                       **{f"{n}_ms": t for n, t in zip(plans, ms[1:])},
                       plans={n: p._asdict() for n, p in plans.items()})
            out.append(row)
            log(f"  K1-bwd stem1 options C={C} {H}x{W} B={B} {row['dtype']}: four-kernel "
                f"{ms[0]:.4f} ms, (a) 32-byte blocks [{_where(plans['a_32_byte_blocks'])}] "
                f"{ms[1]:.4f} ms, (b) 64-byte streaming [{_where(plans['b_64_byte_streaming'])}] "
                f"{ms[2]:.4f} ms (turns " + "/".join(f"{t:.4f}" for t in dev) + "); both held "
                "against the plain twin")
            del x, dy
        return out

    def _stem_kernels_per_call(self):
        """At each stem (B=8, f32 and bf16): the CUDA kernels one call of K1
        and of K1-bwd launches in the planned design and in the old one, with
        each kernel's device us (one torch.profiler session); the planned K1
        must be one kernel, the planned K1-bwd at most two where it takes the
        grid design. Prints the three-pass split (stats, finalize, apply)."""
        import torch

        from crossloc_tpu_torch.ops.groupnorm import (_four_kernel_backward, _launch,
                                                      _plan_backward, _three_pass,
                                                      group_norm_relu_backward)

        calls, keep = [], []
        for C, H, W, relu, _ in GN_PATH_SHAPES[:2]:
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device="cuda").manual_seed(C)
                x = (torch.randn(BATCH, H, W, C, device="cuda", generator=gen) * 2 + 3).to(dtype)
                s = torch.randn(C, device="cuda", generator=gen)
                b = torch.randn(C, device="cuda", generator=gen)
                dy = torch.randn(x.shape, device="cuda", generator=gen).to(dtype)
                st = torch.empty(BATCH, 32, 2, device="cuda")
                keep.append((x, s, b, dy, st))
                grid_bwd = _plan_backward(BATCH, H, W, C, 32, dtype).design == "grid"
                for name, fn in (
                        ("K1 planned", lambda x=x, s=s, b=b, st=st, r=relu:
                            _launch(x, s, b, 32, 1e-5, r, st)),
                        ("K1 three-pass", lambda x=x, s=s, b=b, r=relu:
                            _three_pass(x, s, b, 32, 1e-5, r)),
                        ("K1-bwd planned", lambda x=x, s=s, b=b, st=st, dy=dy, r=relu:
                            group_norm_relu_backward(x, s, b, st, dy, 32, r)),
                        ("K1-bwd four-kernel", lambda x=x, s=s, b=b, st=st, dy=dy, r=relu:
                            _four_kernel_backward(x, s, b, st, dy, 32, r))):
                    calls.append((name, C, H, W, str(dtype)[6:], grid_bwd, fn))
        report = []
        for (name, C, H, W, dname, grid_bwd, _), ks in zip(
                calls, self._kernels_per_call([c[-1] for c in calls], times=True)):
            ks = [(_kernel_name(n), us) for n, us in ks]
            log(f"  {name} C={C} {H}x{W} B={BATCH} {dname}: {len(ks)} CUDA kernels: "
                + ", ".join(f"{n} {us:.1f} us" for n, us in ks))
            report.append(dict(call=name, C=C, dtype=dname, kernels=ks))
            if name == "K1 planned" and len(ks) != 1:
                raise AssertionError(f"K1 at C={C} launched {len(ks)} kernels, not 1")
            if name == "K1-bwd planned" and grid_bwd and len(ks) > 2:
                raise AssertionError(f"K1-bwd at C={C} launched {len(ks)} kernels")
        del keep
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "k1_stem_kernels.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), calls=report), f,
                      indent=1)

    def _bench_stem_rows(self, flush):
        """K1 at the stems at `tools/bench.py`'s shapes (B=BENCH_BATCH, bf16,
        the path's ReLU): the planned design and the three-pass one, each
        held against the plain twin (on chunks of images, as
        `_bench_k1_check`) and timed in turns (three-pass, planned, planned,
        three-pass; CUDA graphs of 3 calls, the L2 evicted), beside the
        bytes bound. Written to `k1_bench_stems.json`."""
        import torch

        from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import _plan, _three_pass

        gen = torch.Generator(device="cuda").manual_seed(4)
        B, chunk, rows = BENCH_BATCH, 16, []
        atol, rtol = 1e-2, 2.0**-7
        for C, H, W, relu, _ in GN_PATH_SHAPES[:2]:
            x = torch.empty(B, H, W, C, device="cuda", dtype=torch.bfloat16)
            for i in range(0, B, chunk):
                x[i:i + chunk] = torch.randn(x[i:i + chunk].shape, device="cuda",
                                             generator=gen) * 2.0 + 3.0
            scale = torch.randn(C, device="cuda", generator=gen)
            bias = torch.randn(C, device="cuda", generator=gen)
            plan = _plan(B, H, W, C, 32, torch.bfloat16)
            worst = {}
            for design, fn in (("planned", group_norm_relu), ("three_pass", _three_pass)):
                y = fn(x, scale, bias, 32, 1e-5, relu)
                torch.cuda.synchronize()
                worst[design] = 0.0
                for i in range(0, B, chunk):
                    ref = group_norm_relu_plain(x[i:i + chunk], scale, bias, 32, 1e-5,
                                                relu).float()
                    err = (y[i:i + chunk].float() - ref).abs()
                    if not bool((err <= atol + rtol * ref.abs()).all()):
                        raise AssertionError(f"K1 {design} disagrees with plain at bench's C={C} "
                                             f"{H}x{W} B={B}")
                    worst[design] = max(worst[design], float(err.max()))
                    del ref, err
                del y
                torch.cuda.empty_cache()
            planned = lambda: group_norm_relu(x, scale, bias, 32, 1e-5, relu)
            three = lambda: _three_pass(x, scale, bias, 32, 1e-5, relu)
            dev = device_ms([three, planned, planned, three], flush, n=3, reps=3)
            bound = 1e3 * (2 * x.numel() * x.element_size() + 2 * C * 4) / HBM_BYTES_PER_S
            row = dict(C=C, H=H, W=W, B=B, dtype="bfloat16", relu=relu, design=plan.design,
                       cluster=plan.cluster, cb=plan.cb, grid=plan.grid,
                       ms=(dev[1] + dev[2]) / 2, three_pass_ms=(dev[0] + dev[3]) / 2,
                       turns_ms=dev, bound_ms=bound, max_abs_err=worst)
            rows.append(row)
            log(f"  K1 bench stem C={C} {H}x{W} B={B} bfloat16 relu={relu} [{_where(plan)}]: "
                f"max_abs_err planned {worst['planned']:.3e}, three-pass "
                f"{worst['three_pass']:.3e} (limit {atol:g} + {rtol:g}*|ref|) ok; device "
                f"{row['ms']:.4f} ms (three-pass {row['three_pass_ms']:.4f}; turns "
                + "/".join(f"{t:.4f}" for t in dev) + f"), bytes bound {bound:.4f} ms "
                f"(bound / device = {bound / row['ms']:.1%})")
            del x
            torch.cuda.empty_cache()
        with open(os.path.join(self.out_dir, "k1_bench_stems.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), rows=rows), f, indent=1)

    def _backward_rows(self, flush, B, shapes, seed):
        """K1's backward at each (C, H, W, relu) of `shapes`, batch B, f32 and
        bf16, ReLU on and off, in the design `_plan_backward` picks and in
        the four-kernel design, each against the autograd of the plain twin,
        and timed at the path's ReLU: device time (CUDA graphs, L2 evicted)
        and call time of the two designs in turns (four-kernel, planned,
        planned, four-kernel), the plain twin (host-inclusive events: its
        autograd is not captured in a graph), the library's two calls
        (threshold_backward + native_group_norm_backward on NCHW copies, its
        own layout) and the bytes bound (x and dy read once, dx written
        once). Returns (rows, worst f32 |dx - plain| of the planned design)."""
        import torch

        from crossloc_tpu_torch.ops import (group_norm_relu_backward,
                                            group_norm_relu_backward_plain, group_norm_relu_plain)
        from crossloc_tpu_torch.ops.groupnorm import _four_kernel_backward, _launch, _plan_backward

        gen = torch.Generator(device="cuda").manual_seed(seed)
        rows, worst = [], 0.0
        for C, H, W, relu_path in shapes:
            G = min(32, C)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype)[6:]
                plan = _plan_backward(B, H, W, C, G, dtype)
                x = (torch.randn(B, H, W, C, device="cuda", generator=gen) * 2.0 + 3.0).to(dtype)
                scale = torch.randn(C, device="cuda", generator=gen)
                bias = torch.randn(C, device="cuda", generator=gen)
                # dy is zero where the plain pre-activation lies within 1e-3 of
                # the ReLU's kink: the kernel's statistics round in another
                # order, which may flip the mask of such a cell
                pre = group_norm_relu_plain(x.float(), scale, bias, G, 1e-5, False)
                dy = (torch.randn(B, H, W, C, device="cuda", generator=gen)
                      * (pre.abs() > 1e-3)).to(dtype)
                del pre
                for relu in (True, False):
                    stats = torch.empty(B, G, 2, device="cuda")
                    _launch(x, scale, bias, G, 1e-5, relu, stats)  # the forward writes them
                    ref = group_norm_relu_backward_plain(x, scale, bias, dy, G, 1e-5, relu)
                    for design, fn in (("planned", group_norm_relu_backward),
                                       ("four_kernel", _four_kernel_backward)):
                        got = fn(x, scale, bias, stats, dy, G, relu)
                        torch.cuda.synchronize()
                        # f32: dx within 1e-4 * max|ref| + 1e-4 * |ref|, dscale
                        # and dbias within 1e-4 * max|ref| (fp32 sums in another
                        # order); bf16: one bf16 ulp of dx (2^-7 * |ref|) beyond
                        # that (both sides round an fp32 dx to bf16)
                        rel = 1e-4 + (2.0**-7 if dtype == torch.bfloat16 else 0.0)
                        errs, ok = [], True
                        for name, a, r in zip(("dx", "dscale", "dbias"), got, ref):
                            a, r = a.float(), r.float()
                            err = (a - r).abs()
                            lim = 1e-4 * r.abs().max() + (rel * r.abs() if name == "dx" else 0.0)
                            ok = ok and bool((err <= lim).all())
                            errs.append(float(err.max()))
                        if dtype == torch.float32 and design == "planned":
                            worst = max(worst, errs[0])
                        name = plan.design if design == "planned" else "four_kernel"
                        log(f"  K1-bwd {name} C={C} {H}x{W} B={B} {dname} relu={relu}: max_abs_err "
                            f"dx {errs[0]:.3e} (max|dx| {float(ref[0].float().abs().max()):.3e}), "
                            f"dscale {errs[1]:.3e}, dbias {errs[2]:.3e} {'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(f"K1-bwd {name} disagrees with plain at C={C} "
                                                 f"{H}x{W} {dtype} relu={relu}")
                        del got
                    del ref
                relu = relu_path
                stats = torch.empty(B, G, 2, device="cuda")
                _launch(x, scale, bias, G, 1e-5, relu, stats)
                planned = lambda: group_norm_relu_backward(x, scale, bias, stats, dy, G, relu)
                four = lambda: _four_kernel_backward(x, scale, bias, stats, dy, G, relu)
                # in turns: four-kernel, planned, planned, four-kernel
                dev = device_ms([four, planned, planned, four], flush)
                call = [cuda_ms(f, self.iters) for f in (four, planned, planned, four)]
                plain = cuda_ms(lambda: group_norm_relu_backward_plain(
                    x, scale, bias, dy, G, 1e-5, relu), iters=3, warmup=1)
                xc = x.permute(0, 3, 1, 2).contiguous()
                dyc = dy.permute(0, 3, 1, 2).contiguous()
                sw, sb = scale.to(dtype), bias.to(dtype)
                out, mean, rstd = torch.ops.aten.native_group_norm(xc, sw, sb, B, C, H * W, G,
                                                                   1e-5)
                yl = torch.relu(out)

                def lib_call():
                    g = torch.ops.aten.threshold_backward(dyc, yl, 0.0) if relu else dyc
                    return torch.ops.aten.native_group_norm_backward(
                        g, xc, mean, rstd, sw, B, C, H * W, G, [True, True, True])

                (lib,) = device_ms([lib_call], flush, n=5)
                nbytes = 3 * x.numel() * x.element_size() + (4 * C + 2 * B * G) * 4
                bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, 12 * x.numel() / FP32_FLOPS)
                row = dict(C=C, H=H, W=W, B=B, dtype=dname, relu=relu, design=plan.design,
                           cluster=plan.cluster, cb=plan.cb, smem_bytes=plan.smem_bytes,
                           grid=plan.grid,
                           ms=(dev[1] + dev[2]) / 2, four_kernel_ms=(dev[0] + dev[3]) / 2,
                           turns_ms=dev, call_ms=(call[1] + call[2]) / 2,
                           four_kernel_call_ms=(call[0] + call[3]) / 2, turns_call_ms=call,
                           plain_ms=plain, library_ms=lib, bound_ms=bound)
                rows.append(row)
                log(f"  K1-bwd time C={C} {H}x{W} B={B} {dname} relu={relu} [{_where(plan)}]: "
                    f"device "
                    f"{row['ms']:.4f} ms (four-kernel {row['four_kernel_ms']:.4f}; turns "
                    + "/".join(f"{t:.4f}" for t in dev) + f"), call {row['call_ms']:.4f} ms "
                    f"(four-kernel {row['four_kernel_call_ms']:.4f}), plain {plain:.4f} ms, "
                    f"library {lib:.4f} ms, bytes bound {bound:.4f} ms "
                    f"(bound / device = {bound / row['ms']:.1%})")
                del x, dy, xc, dyc, out, yl
        return rows, worst

    def _large_mean_backward_check(self):
        """K1-bwd on an f32 input with mean 1000 and std 1 at the 512-channel
        path shape (the cluster design), ReLU on and off, each design
        against the float64 autograd: per tensor within today's f32
        tolerance plus the plain twin's own largest distance from float64."""
        import torch

        from crossloc_tpu_torch.ops import group_norm_relu_backward_plain, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import (_four_kernel_backward, _launch,
                                                      _plan_backward, group_norm_relu_backward)

        C, H, W, G, mean = 512, 60, 90, 32, 1000.0
        if _plan_backward(BATCH, H, W, C, G, torch.float32).design != "cluster":
            raise AssertionError("the |mu|/std = 1000 shape does not take the cluster design")
        gen = torch.Generator(device="cuda").manual_seed(12)
        x = torch.randn(BATCH, H, W, C, device="cuda", generator=gen) + mean
        scale = torch.randn(C, device="cuda", generator=gen)
        bias = torch.randn(C, device="cuda", generator=gen)
        pre = group_norm_relu_plain(x, scale, bias, G, 1e-5, False)
        dy = torch.randn(x.shape, device="cuda", generator=gen) * (pre.abs() > 1e-3)
        del pre
        for relu in (True, False):
            leaves = [t.double().requires_grad_() for t in (x, scale, bias)]
            xd = leaves[0].reshape(BATCH, H * W, G, C // G)
            mu = xd.mean(dim=(1, 3), keepdim=True)
            var = (xd - mu).square().mean(dim=(1, 3), keepdim=True)
            y = ((xd - mu) / torch.sqrt(var + 1e-5)).reshape(x.shape) * leaves[1] + leaves[2]
            exact = torch.autograd.grad(torch.relu(y) if relu else y, leaves, dy.double())
            del leaves, xd, mu, var, y
            plain = group_norm_relu_backward_plain(x, scale, bias, dy, G, 1e-5, relu)
            stats = torch.empty(BATCH, G, 2, device="cuda")
            _launch(x, scale, bias, G, 1e-5, relu, stats)
            for name, fn in (("cluster", group_norm_relu_backward),
                             ("four_kernel", _four_kernel_backward)):
                got = fn(x, scale, bias, stats, dy, G, relu)
                torch.cuda.synchronize()
                msgs, ok = [], True
                for t, a, p, e in zip(("dx", "dscale", "dbias"), got, plain, exact):
                    e_k = (a.double() - e).abs()
                    e_p = float((p.double() - e).abs().max())
                    lim = 1e-4 * e.abs().max() + (1e-4 * e.abs() if t == "dx" else 0.0) + e_p
                    ok = ok and bool((e_k <= lim).all())
                    msgs.append(f"{t} {float(e_k.max()):.3e} (plain {e_p:.3e}, max|f64| "
                                f"{float(e.abs().max()):.3e})")
                log(f"  K1-bwd {name} |mu|/std=1000 C={C} {H}x{W} B={BATCH} f32 relu={relu}: "
                    f"max|K1-bwd - f64| " + ", ".join(msgs) + " (limit: 1e-4*max|f64| [+ "
                    f"1e-4*|f64| for dx] + max|plain - f64|) " + ("ok" if ok else "FAIL"))
                if not ok:
                    raise AssertionError(f"K1-bwd {name} loses precision at |mu|/std = 1000")
                del got

    def _large_mean_check(self):
        """f32 input with mean 1000 and std 1 at the 512-channel path shape:
        each design against float64 (two f32 roundings of mu allowed beyond
        the f32 tolerance) and against the plain twin (whose own distance
        from float64 is allowed on top)."""
        import torch

        from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import _three_pass

        C, H, W, G, mean = 512, 60, 90, 32, 1000.0
        gen = torch.Generator(device="cuda").manual_seed(11)
        x = torch.randn(BATCH, H, W, C, device="cuda", generator=gen) + mean
        scale = torch.randn(C, device="cuda", generator=gen)
        bias = torch.randn(C, device="cuda", generator=gen)
        xd = x.double().reshape(BATCH, H * W, G, C // G)
        mu = xd.mean(dim=(1, 3), keepdim=True)
        var = (xd - mu).square().mean(dim=(1, 3), keepdim=True)
        exact = ((xd - mu) / torch.sqrt(var + 1e-5)).reshape(x.shape) * scale.double() + bias.double()
        plain = group_norm_relu_plain(x, scale, bias, G, 1e-5, False).double()
        e_plain = (plain - exact).abs()
        limit = 1e-4 + 1e-4 * exact.abs() + 2 * 2.0**-23 * mean * scale.double().abs()
        for name, fn in (("planned", group_norm_relu), ("three_pass", _three_pass)):
            y = fn(x, scale, bias, G, 1e-5, False).double()
            e_exact, e_vs_plain = (y - exact).abs(), (y - plain).abs()
            ok = bool((e_exact <= limit).all()) and bool((e_vs_plain <= limit + e_plain).all())
            log(f"  K1 {name} |mu|/std=1000 C={C} {H}x{W} f32: max|K1 - f64| "
                f"{float(e_exact.max()):.3e}, max|K1 - plain| {float(e_vs_plain.max()):.3e}, "
                f"max|plain - f64| {float(e_plain.max()):.3e} (limit vs f64: 1e-4 + 1e-4*|ref| "
                f"+ 2*2^-23*|mu|*|gamma|; vs plain: that + |plain - f64|) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K1 {name} loses precision at |mu|/std = 1000")

    # -- phase 3 -----------------------------------------------------------
    def phase_forward(self):
        import torch

        from crossloc_tpu_torch import models, ops
        from crossloc_tpu_torch.models import layers

        gen = torch.Generator().manual_seed(2021)
        model = models.init_weights(models.build_network("coord", "MLE"), gen)
        model.to("cuda").eval().to(memory_format=torch.channels_last)
        images = torch.rand(BATCH, IMG_H, IMG_W, 3, generator=gen).cuda()

        def forward_pair(dtype):
            """(kernel-path output, plain-norm output, launches per forward, ms, plain ms)."""
            model.dtype = dtype
            with torch.no_grad():
                n0 = ops.group_norm_relu.launches
                y = model(images)
                torch.cuda.synchronize()
                per_fwd = ops.group_norm_relu.launches - n0
                fwd_ms = cuda_ms(lambda: model(images), iters=5, warmup=1)
                layers.group_norm_relu = ops.group_norm_relu_plain  # reference run only
                try:
                    ref = model(images)
                    plain_ms = cuda_ms(lambda: model(images), iters=3, warmup=1)
                finally:
                    layers.group_norm_relu = ops.group_norm_relu
            shape = (BATCH, IMG_H // 8, IMG_W // 8, 4)
            if tuple(y.shape) != shape or not bool(torch.isfinite(y).all()):
                raise AssertionError(f"forward output {tuple(y.shape)} not finite {shape}")
            if per_fwd != 28:
                raise AssertionError(f"expected 28 K1 launches per forward, got {per_fwd}")
            return y, ref, per_fwd, fwd_ms, plain_ms

        def rel(a, ref, rms=False):
            """Per output channel: max (or rms) |a - ref| / std(ref); the worst channel."""
            d = (a.float() - ref).abs()
            d = d.square().mean(dim=(0, 1, 2)).sqrt() if rms else d.amax(dim=(0, 1, 2))
            return float((d / ref.std(dim=(0, 1, 2))).max())

        y32, ref32, n, ms, pms = forward_pair(torch.float32)
        err32 = rel(y32, ref32)
        log(f"forward float32 B={BATCH} {IMG_H}x{IMG_W}: {n} K1 launches; max|kernel - plain| "
            f"/ std = {err32:.3e} (limit 1e-3: only the statistics' summation order differs); "
            f"net {ms:.2f} ms/batch with K1, {pms:.2f} ms with the plain norm")
        if err32 > 1e-3:
            raise AssertionError("f32 kernel path disagrees with the plain-norm net")
        # bf16: both paths round every norm output to bf16, so they differ by
        # rounding noise carried through 28 layers; the kernel path must be
        # as close to the f32 net as the plain bf16 path is
        yb, refb, n, ms, pms = forward_pair(torch.bfloat16)
        e_k, e_p = rel(yb, ref32, rms=True), rel(refb, ref32, rms=True)
        log(f"forward bfloat16: {n} K1 launches; rms error vs the f32 net / std: kernel path "
            f"{e_k:.3e}, plain-norm path {e_p:.3e} (limit: kernel <= 1.25 x plain + 1e-3); "
            f"max|kernel - plain| / std = {rel(yb, refb.float()):.3e}; "
            f"net {ms:.2f} ms/batch with K1, {pms:.2f} ms with the plain norm")
        if e_k > 1.25 * e_p + 1e-3:
            raise AssertionError("bf16 kernel path is less accurate than the plain bf16 net")
        model.dtype = torch.float32
        with torch.no_grad():
            feats = model.encoder(images)
        del model
        self._projhead(feats)
        del feats
        self._vanilla()

    def _projhead(self, feats):
        """Full-width ProjHead (out_length 2048) on the coord encoder's f32
        output [B, 60, 90, 512], forward and backward of a seeded projection
        of its features: 4 K1 and 4 K1-bwd launches, counted on that run,
        against the same head through the plain norm and its autograd
        (features within 1e-3 of their spread; each gradient within 1e-3 of
        its norm + 1e-6 of the global norm)."""
        import torch

        from crossloc_tpu_torch import models, ops
        from crossloc_tpu_torch.models import layers

        head = models.init_weights(models.ProjHead(), torch.Generator().manual_seed(3)).cuda()
        x = feats.detach().clone().requires_grad_()
        w = torch.randn(feats.shape[0], 2048, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))

        def step():
            head.zero_grad()
            x.grad = None
            out = head(x)
            (out * w).sum().backward()
            return out.detach(), [p.grad for p in head.parameters()] + [x.grad]

        ops.group_norm_relu.launches = ops.group_norm_relu_backward.launches = 0
        out, grads = step()
        torch.cuda.synchronize()
        fwd, bwd = ops.group_norm_relu.launches, ops.group_norm_relu_backward.launches
        self.launches["projhead"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        ms = cuda_ms(step, iters=10, warmup=2)
        layers.group_norm_relu = ops.group_norm_relu_plain  # reference run only
        try:
            ref, ref_grads = step()
            plain_ms = cuda_ms(step, iters=5, warmup=1)
        finally:
            layers.group_norm_relu = ops.group_norm_relu
        e_out = float((out - ref).abs().max() / ref.std())
        total = float(torch.sqrt(sum(g.double().square().sum() for g in ref_grads)))
        e_g = [float((g - r).norm()) / (float(r.norm()) + 1e-3 * total)
               for g, r in zip(grads, ref_grads)]
        log(f"ProjHead f32 B={feats.shape[0]} from {tuple(feats.shape[1:])} to "
            f"{tuple(out.shape[1:])}: {fwd} K1 and {bwd} K1-bwd launches; max|kernel - plain| "
            f"/ std = {e_out:.3e} (limit 1e-3); worst gradient |kernel - plain| / (|g| + 1e-3 "
            f"|g_all|) = {max(e_g):.3e} (limit 1e-3, input gradient {e_g[-1]:.3e}); forward + "
            f"backward {ms:.2f} ms with K1 and K1-bwd, {plain_ms:.2f} ms with the plain norm")
        if (fwd, bwd) != (4, 4) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"ProjHead: expected 4 + 4 launches and finite features, got "
                                 f"{fwd} + {bwd}")
        if e_out > 1e-3 or max(e_g) > 1e-3:
            raise AssertionError("ProjHead's kernel path disagrees with the plain norm")

    def _vanilla(self):
        """Full-width VanillaNetwork, grayscale 480x720, B=8, seeded weights:
        the card's f32 forward (cuDNN, TF32 off) within 1e-3 of max|ref| of
        the CPU's, and no K1 launch (the net has no norm)."""
        import torch

        from crossloc_tpu_torch import models, ops

        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is on")
        gen = torch.Generator().manual_seed(4)
        net = models.init_weights(models.VanillaNetwork(mean_init=[1.0, -2.0, 3.0]), gen).eval()
        x = torch.rand(BATCH, IMG_H, IMG_W, 1, generator=gen)
        t0 = time.perf_counter()
        with torch.no_grad():
            ref = net(x)
        cpu_s = time.perf_counter() - t0
        net.cuda().to(memory_format=torch.channels_last)
        ops.group_norm_relu.launches = 0
        with torch.no_grad():
            y = net(x.cuda())
            torch.cuda.synchronize()
            n = ops.group_norm_relu.launches
            ms = cuda_ms(lambda: net(x.cuda()), iters=5, warmup=1)
        err = float((y.cpu() - ref).abs().max() / ref.abs().max())
        log(f"VanillaNetwork f32 B={BATCH} {IMG_H}x{IMG_W}x1 -> {tuple(y.shape[1:])}: {n} K1 "
            f"launches; max|card - CPU| / max|CPU| = {err:.3e} (limit 1e-3); {ms:.2f} ms a "
            f"forward on the card (input copy included), {cpu_s:.1f} s on the CPU")
        if n != 0 or tuple(y.shape) != (BATCH, IMG_H // 8, IMG_W // 8, 3) or err > 1e-3:
            raise AssertionError("VanillaNetwork on the card disagrees with the CPU")

    # -- phase 4 -----------------------------------------------------------
    def phase_serve(self):
        import re

        import numpy as np
        import torch

        from crossloc_tpu_torch import compat, data, eval as evaluation, models, ops, ransac
        from crossloc_tpu_torch.cli import test_single_task as cli
        from crossloc_tpu_torch.inference import make_localizer

        n_frames = 2 * BATCH
        shutil.rmtree(WORK_DIR, ignore_errors=True)
        scene = os.path.join(WORK_DIR, "datasets", "urbanscape", "val_drone_real")
        t0 = time.perf_counter()
        data.write_fake_dataset(scene, n=n_frames, img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=7)
        net_dir = os.path.join(WORK_DIR, "output", "urbanscape-coord-unc-MLE-smoke")
        os.makedirs(net_dir)
        model = models.init_weights(models.build_network("coord", "MLE"),
                                    torch.Generator().manual_seed(2021))
        compat.save_net(os.path.join(net_dir, "model.net"), model)
        log(f"wrote a {n_frames}-frame {IMG_H}x{IMG_W} scene and a seeded model.net "
            f"in {time.perf_counter() - t0:.1f} s")

        # the main path: the port's eval CLI, in-process, on cuda
        ops.group_norm_relu.launches = 0
        t0 = time.perf_counter()
        logs = cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                         "--network_in", net_dir, "--section", "val_drone_real",
                         "--datasets_dir", os.path.join(WORK_DIR, "datasets"),
                         "--save_pred", "--device", "cuda"])
        torch.cuda.synchronize()
        launches = ops.group_norm_relu.launches
        log(f"test_single_task on cuda: {time.perf_counter() - t0:.1f} s wall for {n_frames} "
            f"frames (first batch includes cuDNN autotuning), {launches} K1 launches")
        self.launches["serve"] = dict(groupnorm=launches)
        if launches != 28 * math.ceil(n_frames / BATCH):
            raise AssertionError(f"K1 launched {launches} times on the main path")
        text = open(logs[0]).read()
        if not re.search(r"Median Error:\s+(\d+.\d+) deg, (\d+.\d+) m", text):
            raise AssertionError(f"no median line in {logs[0]}")
        pred_dir = os.path.join(net_dir, "coord_pred_model.net_val_drone_real")
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"]
                 for f in sorted(os.listdir(pred_dir))]
        if len(poses) != n_frames or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("missing or non-finite poses")
        log(f"results: {logs[0]} ({len(poses)} finite poses)")

        # the same CLI with --bf16: convs and K1 in bf16 (not the counted run)
        n0 = ops.group_norm_relu.launches
        cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--network_in",
                  net_dir, "--section", "val_drone_real", "--datasets_dir",
                  os.path.join(WORK_DIR, "datasets"), "--save_pred", "--bf16", "--device", "cuda"])
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"] for f in sorted(os.listdir(pred_dir))]
        n_bf16 = ops.group_norm_relu.launches - n0
        log(f"test_single_task --bf16 on cuda: {n_bf16} K1 launches, "
            f"{sum(np.isfinite(p).all() for p in poses)} finite poses")
        if n_bf16 != launches or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("the --bf16 eval run is off")

        # the solver on the card, fed the exact scene coordinates (GT oracle),
        # against the same solve on the CPU with the same hypothesis draws
        ds = data.CamLocDataset(scene)
        batch = ds.collate(range(BATCH))
        coords = torch.from_numpy(batch["coord"])
        focal = torch.from_numpy(batch["focal"])
        cfg = ransac.RansacConfig()
        N = coords.shape[1] * coords.shape[2]
        idx = torch.randint(0, N, (BATCH, cfg.hypotheses * cfg.sample_rounds, 4),
                            generator=torch.Generator().manual_seed(3))
        res_gpu = ransac.solve_batch(coords.cuda(), focal.cuda(), (IMG_H, IMG_W), cfg, idx=idx)
        res_cpu = ransac.solve_batch(coords, focal, (IMG_H, IMG_W), cfg, idx=idx)
        errs = [evaluation.pose_err(batch["pose"][b], res_gpu.cam_to_world[b].cpu())
                for b in range(BATCH)]
        t_med = float(np.median([e[0] for e in errs]))
        r_med = float(np.median([e[1] for e in errs]))
        d_pose = float((res_gpu.pose_w2c6.cpu() - res_cpu.pose_w2c6).abs().max())
        same = int((res_gpu.chosen.cpu() == res_cpu.chosen).sum())
        log(f"GT-oracle solve on cuda: median {t_med:.4f} m / {r_med:.4f} deg (limit 0.1 m / "
            f"0.1 deg); vs CPU on the same draws: chosen equal {same}/{BATCH}, "
            f"max |pose6 diff| {d_pose:.2e} (limit 1e-2)")
        if not (t_med < 0.1 and r_med < 0.1 and d_pose < 1e-2):
            raise AssertionError("solver on the card is off")

        # throughput of image -> pose (net + solver) at B=8, 480x720, f32
        model.to("cuda").eval().to(memory_format=torch.channels_last)
        wire = torch.from_numpy(data.images_to_wire(batch["image"])).cuda()
        images = data.images_from_wire(wire)
        localize = make_localizer(model, cfg)
        gen = torch.Generator(device="cuda").manual_seed(2021)
        focal_d = focal.cuda()
        times = {}
        for name, fn in (
            ("net", lambda: model(images)),
            ("solver", lambda: ransac.solve_batch(
                coords.cuda(), focal_d, (IMG_H, IMG_W), cfg, generator=gen)),
            ("net+solver", lambda: localize(images, focal_d, generator=gen)),
        ):
            with torch.no_grad():
                times[name] = cuda_ms(fn, iters=5, warmup=2)
        log(f"image->pose at B={BATCH} {IMG_H}x{IMG_W} f32 on {self.device_name} "
            f"({nvidia_smi_line()}): net+solver {times['net+solver']:.2f} ms/batch = "
            f"{1e3 * BATCH / times['net+solver']:.1f} img/s; net alone "
            f"{times['net']:.2f} ms, solver alone {times['solver']:.2f} ms")
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "serve.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), batch=BATCH,
                           ms=times, img_s=1e3 * BATCH / times["net+solver"],
                           oracle_median_m=t_med, oracle_median_deg=r_med), f, indent=1)
        shutil.rmtree(WORK_DIR, ignore_errors=True)

    # -- phase 5 -----------------------------------------------------------
    def phase_train(self):
        import re

        import numpy as np

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.cli import test_single_task as test_cli
        from crossloc_tpu_torch.cli import train_single_task as train_cli
        from crossloc_tpu_torch.utils import read_training_log

        n_frames = 2 * TRAIN_BATCH
        work = WORK_DIR + "_train"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        t0 = time.perf_counter()
        data.write_fake_dataset(os.path.join(datasets, "urbanscape", "train_sim"), n=n_frames,
                                img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=0, scene="plane")
        data.write_fake_dataset(os.path.join(datasets, "urbanscape", "val_drone_real"), n=BATCH,
                                img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=1, scene="plane")
        log(f"wrote a {n_frames}-frame train_sim and a {BATCH}-frame val_drone_real plane scene "
            f"at {IMG_H}x{IMG_W} in {time.perf_counter() - t0:.1f} s")

        def train(session, extra):
            return self._run_cli(train_cli.main, work, PRETRAIN_ARGS + [
                "--datasets_dir", datasets, "--ckpt_dir", os.path.join(work, "ckpts"),
                "--session", session, *extra])

        # the main path: encoder pretraining, 2 epochs of 2 steps
        out_dir, losses, fwd, bwd, wall = train("smoke", ["--epochs", "2"])
        steps = 2 * n_frames // TRAIN_BATCH
        log(f"train_single_task on cuda (B={TRAIN_BATCH}, {IMG_H}x{IMG_W}, f32, 2 epochs): "
            f"{wall:.1f} s wall for {steps} steps, losses {losses}, {fwd} K1 and {bwd} K1-bwd "
            f"launches")
        self.launches["train"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if fwd != 28 * steps or bwd != 28 * steps:
            raise AssertionError(f"expected {28 * steps} K1 and K1-bwd launches, got {fwd}/{bwd}")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        if read_training_log(os.path.join(out_dir, "output.log"), n_frames) != (2 * n_frames, 1):
            raise AssertionError("output.log does not parse to (iteration 48, epoch 1)")
        ckpt_dir = os.path.join(work, "ckpts", os.path.basename(out_dir))
        ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_iter_"))
        for f in ("model.net", "FLAG_training_done.nodata"):
            if not os.path.exists(os.path.join(out_dir, f)):
                raise AssertionError(f"{f} not written")
        if not ckpts or not os.path.exists(os.path.join(ckpt_dir, "FLAG_training_done.nodata")):
            raise AssertionError("ckpt_iter_*.net or the checkpoint FLAG not written")
        log(f"written: model.net, {ckpts}, FLAG_training_done.nodata (both directories)")

        # serve what was trained
        logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                              "--network_in", os.path.join(out_dir, "model.net"), "--section",
                              "val_drone_real", "--datasets_dir", datasets, "--save_pred",
                              "--device", "cuda"])
        pred_dir = os.path.join(out_dir, "coord_pred_model.net_val_drone_real")
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"]
                 for f in sorted(os.listdir(pred_dir))]
        median = re.findall(r"Median Error:\s+(\d+.\d+) deg, (\d+.\d+) m", open(logs[0]).read())
        log(f"served the trained model.net on cuda: {logs[0]}, {len(poses)} poses, median "
            f"{median[-1][1]} m / {median[-1][0]} deg after {steps} steps")
        if len(poses) != BATCH or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("missing or non-finite poses from the trained net")

        self._gradients_against_cpu(datasets)
        self._fixed_batch_descends(datasets)

        _, losses16, fwd16, bwd16, wall16 = train("smoke_bf16", ["--epochs", "1", "--bf16"])
        log(f"train_single_task --bf16 on cuda: {wall16:.1f} s, losses {losses16}, {fwd16} K1 "
            f"and {bwd16} K1-bwd launches")
        if fwd16 != 28 * 2 or bwd16 != 28 * 2 or not all(math.isfinite(v) for v in losses16):
            raise AssertionError("the --bf16 training run is off")
        self.train_step_ms = {k: v["ms"] for k, v in self._step_time(datasets).items()}
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 6 -----------------------------------------------------------
    def phase_finetune(self):
        import re

        import numpy as np
        import torch

        from crossloc_tpu_torch import compat, data, models, ops
        from crossloc_tpu_torch.cli import finetune_decoder_single_task as ft_cli
        from crossloc_tpu_torch.cli import test_single_task as test_cli
        from crossloc_tpu_torch.utils import read_training_log

        n_frames = FT_BATCH  # per pairwise root: 2 * FT_BATCH frames, 2 steps an epoch
        work = WORK_DIR + "_finetune"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        t0 = time.perf_counter()
        for seed, section in enumerate(("train_drone_real", "train_drone_sim", "val_drone_real")):
            data.write_fake_dataset(os.path.join(datasets, "urbanscape", section), n=n_frames,
                                    img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=seed,
                                    scene="plane")
        # full-width task-pretrain donors, in folders that name their task
        donors = {}
        for seed, task in enumerate(FT_TASKS, start=1):
            net = models.build_network(task, "MLE", mean=[0.0] * models.task_channels(task))
            models.init_weights(net, torch.Generator().manual_seed(seed))
            os.makedirs(os.path.join(work, "weights", task))
            donors[task] = os.path.join(work, "weights", task, "model.net")
            compat.save_net(donors[task], net)
        log(f"wrote a pairwise plane scene ({n_frames} frames each of train_drone_real, "
            f"train_drone_sim, val_drone_real at {IMG_H}x{IMG_W}) and three full-width donors "
            f"in {time.perf_counter() - t0:.1f} s")

        def finetune(session, extra):
            return self._run_cli(ft_cli.main, work, FINETUNE_ARGS + [
                "--coord_weight", donors["coord"], "--depth_weight", donors["depth"],
                "--normal_weight", donors["normal"], "--datasets_dir", datasets, "--image_height",
                str(IMG_H), "--ckpt_dir", os.path.join(work, "ckpts"), "--session", session,
                *extra])

        # the main path: decoder finetuning, 2 epochs of 2 steps
        out_dir, losses, fwd, bwd, wall = finetune("smoke", ["--epochs", "2"])
        steps = 2 * (2 * n_frames) // FT_BATCH
        log(f"finetune_decoder_single_task on cuda (B={FT_BATCH}, {IMG_H}x{IMG_W}, f32, 2 epochs, "
            f"3 towers): {wall:.1f} s wall for {steps} steps, losses {losses}, {fwd} K1 and {bwd} "
            f"K1-bwd launches ({fwd / steps:g} and {bwd / steps:g} per step)")
        self.launches["finetune"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if fwd != FT_FWD * steps or bwd != FT_BWD * steps:
            raise AssertionError(f"expected {FT_FWD} K1 and {FT_BWD} K1-bwd launches per step, got "
                                 f"{fwd}/{bwd} over {steps} steps")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        if read_training_log(os.path.join(out_dir, "output.log"), 2 * n_frames) != (
                4 * n_frames, 1):
            raise AssertionError("output.log does not parse to (iteration 32, epoch 1)")
        ckpt_dir = os.path.join(work, "ckpts", os.path.basename(out_dir))
        ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.startswith("ckpt_iter_"))
        for d in (out_dir, ckpt_dir):
            if not os.path.exists(os.path.join(d, "FLAG_training_done.nodata")):
                raise AssertionError(f"no FLAG_training_done.nodata in {d}")
        if not ckpts or not os.path.exists(os.path.join(out_dir, "model.net")):
            raise AssertionError("model.net or ckpt_iter_*.net not written")
        log(f"written: {os.path.basename(out_dir)}/model.net, output.log, {ckpts}, "
            f"FLAG_training_done.nodata (both directories)")

        # the depth and normal towers are their donors' encoders, bit for bit;
        # the coord tower, the MLR blocks and the decoder trained
        trained = compat.load_net(os.path.join(out_dir, "model.net"))
        init = self._mlr_model("cpu").state_dict()
        for tower, task in ((2, "depth"), (3, "normal")):
            enc = {k[8:]: v for k, v in compat.load_net(donors[task]).items()
                   if k.startswith("encoder.")}
            same = all(torch.equal(trained[f"mlr_encoder_{tower}.{k}"], v) for k, v in enc.items())
            if not same or len(enc) != sum(k.startswith(f"mlr_encoder_{tower}.") for k in trained):
                raise AssertionError(f"frozen tower {tower} ({task}) changed in training")
        coord = compat.load_net(donors["coord"])
        moved = {"tower 1": not torch.equal(trained["mlr_encoder_1.conv1.weight"],
                                            coord["encoder.conv1.weight"]),
                 "decoder": not torch.equal(trained["decoder.fc3.weight"],
                                            coord["decoder.fc3.weight"])}
        moved.update({k: not torch.equal(trained[k], init[k]) for k in (
            "mlr_skip.0.weight", "mlr_norm.weight", "mlr_forward.0.weight", "mlr_forward.6.weight")})
        log(f"towers 2 and 3 bit-identical to the depth and normal donors; changed by training: "
            f"{moved}")
        if not all(moved.values()):
            raise AssertionError("a trainable part of the net did not change")

        # serve the finetuned net: num_mlr = 3 from the folder name
        ops.group_norm_relu.launches = 0
        logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                              "--network_in", os.path.join(out_dir, "model.net"), "--section",
                              "val_drone_real", "--datasets_dir", datasets, "--image_height",
                              str(IMG_H), "--save_pred", "--device", "cuda"])
        torch.cuda.synchronize()
        served = ops.group_norm_relu.launches
        self.launches["finetune_serve"] = dict(groupnorm=served)
        pred_dir = os.path.join(out_dir, "coord_pred_model.net_val_drone_real")
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"] for f in sorted(os.listdir(pred_dir))]
        median = re.findall(r"Median Error:\s+(\d+.\d+) deg, (\d+.\d+) m", open(logs[0]).read())
        log(f"served the finetuned model.net on cuda: {logs[0]}, {len(poses)} poses, {served} K1 "
            f"launches, median {median[-1][1]} m / {median[-1][0]} deg after {steps} steps")
        if served != FT_FWD or len(poses) != n_frames or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("the finetuned net did not serve")

        _, losses16, fwd16, bwd16, wall16 = finetune("smoke_bf16", ["--epochs", "1", "--bf16"])
        log(f"finetune_decoder_single_task --bf16 on cuda: {wall16:.1f} s, losses {losses16}, "
            f"{fwd16} K1 and {bwd16} K1-bwd launches")
        if fwd16 != FT_FWD * 2 or bwd16 != FT_BWD * 2 or not all(math.isfinite(v) for v in losses16):
            raise AssertionError("the --bf16 finetune run is off")

        def make(dev, dtype=None):
            return self._mlr_model(dev, dtype, donors)

        # f32 on the card, with or without K1 and cuDNN, sits further from
        # float64 at this net's stems than the CPU's f32 does (PERF.md §6):
        # the card's plain twin sets the rounding the kernels may add to
        self._gradients_against_cpu(datasets, make, section="train_drone_real",
                                    yardstick=("cpu", "card_plain"))
        self._step_time(datasets, make, FT_BATCH, "train_drone_real", "finetune.json")
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 7 -----------------------------------------------------------
    def phase_tasks(self):
        """Encoder pretraining and serving of the depth, normal and semantics
        nets through the CLIs, as `encoder_pretrain.sh` and
        `validate_encoder_pretrain.sh` run them."""
        import torch

        from crossloc_tpu_torch import data

        work = WORK_DIR + "_tasks"
        shutil.rmtree(work, ignore_errors=True)
        n_frames = 2 * TRAIN_BATCH
        t0 = time.perf_counter()
        # the plane scene's normals, (0, 0, -1), equal the nodata marker in
        # every cell: the normal task trains on the noise scene
        for scene in ("plane", "noise"):
            for seed, (section, n) in enumerate((("train_sim", n_frames), ("val_sim", BATCH))):
                data.write_fake_dataset(os.path.join(work, scene, "urbanscape", section), n=n,
                                        img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=seed,
                                        scene=scene)
        log(f"wrote {n_frames}-frame train_sim and {BATCH}-frame val_sim sections of the plane "
            f"and the noise scene at {IMG_H}x{IMG_W} in {time.perf_counter() - t0:.1f} s")

        # ROADMAP F1: the CLI's own setup turns TF32 off (torch's default is
        # on); `_run_cli` checks both flags after each run
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        report = {}
        for task, scene, extra in TASK_RUNS:
            datasets = os.path.join(work, scene)
            report[task] = self._task_run(task, datasets, work, extra)
            if task == TASK_RUNS[0][0]:
                log(f"TF32 set on before the {task} run; after it: cudnn.allow_tf32="
                    f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
                    f"{torch.backends.cuda.matmul.allow_tf32}")
            unc = None if task == "semantics" else "MLE"
            if task in ("normal", "semantics"):
                # as for the finetune net, the card's f32 (with or without the
                # kernels) may sit further from float64 than the CPU's: the
                # card's plain twin sets the rounding the kernels may add to
                self._gradients_against_cpu(
                    datasets, lambda dev, dtype=None: self._model(dev, dtype, task, unc),
                    yardstick=("cpu", "card_plain"), task=task, unc=unc)
            report[task]["step"] = self._step_time(
                datasets, lambda dev, dtype=None: self._model(dev, dtype, task, unc),
                out_name=f"tasks_{task}.json", task=task, unc=unc)

        # semantics once more with --bf16
        datasets = os.path.join(work, "plane")
        out_dir, losses, fwd, bwd, wall = self._task_train(
            "semantics", datasets, work, "smoke_bf16", ["--epochs", "1", "--bf16"])
        log(f"train_single_task --task semantics --bf16 on cuda: {wall:.1f} s, losses {losses}, "
            f"{fwd} K1 and {bwd} K1-bwd launches")
        if fwd != 29 * 2 or bwd != 29 * 2 or not all(math.isfinite(v) for v in losses):
            raise AssertionError("the --bf16 semantics run is off")
        report["semantics_bf16"] = dict(losses=losses, k1=fwd, k1_bwd=bwd, wall_s=wall)
        with open(os.path.join(self.out_dir, "tasks.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), runs=report), f,
                      indent=1)
        shutil.rmtree(work, ignore_errors=True)

    # -- phase 8 -----------------------------------------------------------
    def phase_e2e(self):
        """DSAC end-to-end training: one step of the full-width coord net at
        B=12 with the permissive solver config (launches, a positive loss
        from an untrained net), one step on a well-conditioned two-mode input
        with the CLI's solver config and its gradients on the card against
        the CPU, the solver's coordinate gradient against float64 on the two
        inputs of `_e2e_solver_oracle`, P3P's forward and implicit backward at
        the step's minimal sets against float64, the training CLI with
        --e2e_pose_loss (f32 and --bf16, each model.net served), and the e2e
        step's time, memory and launches (its staged profile: the `profile`
        phase)."""
        work, datasets = self._e2e_scene()
        out = dict(device=self.device_name, smi=nvidia_smi_line())
        out["permissive_step"] = self._e2e_permissive_step(datasets)
        out["step_check"] = self._e2e_step_check(datasets)
        out["graph"] = self._e2e_graph(datasets)
        out["oracle"] = self._e2e_solver_oracle(datasets)
        out["p3p"] = self._e2e_p3p(datasets)
        out["cli"] = {tag: self._e2e_cli(datasets, work, tag, extra)
                      for tag, extra in (("f32", []), ("bf16", ["--bf16"]))}
        out["step_time"] = self._e2e_step_time(datasets)
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "e2e.json"), "w") as f:
            json.dump(out, f, indent=1)
        shutil.rmtree(work, ignore_errors=True)

    @staticmethod
    def _e2e_scene():
        """(work dir, datasets dir) with a 24-frame 480x720 plane train_sim and
        an 8-frame val_drone_real."""
        from crossloc_tpu_torch import data

        work = WORK_DIR + "_e2e"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        data.write_fake_dataset(os.path.join(datasets, "urbanscape", "train_sim"),
                                n=2 * TRAIN_BATCH, img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=0,
                                scene="plane")
        data.write_fake_dataset(os.path.join(datasets, "urbanscape", "val_drone_real"), n=BATCH,
                                img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=1, scene="plane")
        return work, datasets

    @staticmethod
    def _dtypes():
        import torch

        return (torch.float32, torch.bfloat16)

    @staticmethod
    def _e2e_idx():
        """Seeded hypothesis draws of one e2e step at B=12: [B, H * rounds, 4]
        over the 60 x 90 cells."""
        import torch

        return torch.randint(0, (IMG_H // 8) * (IMG_W // 8), (TRAIN_BATCH, 16 * 8, 4),
                             generator=torch.Generator().manual_seed(7))

    @staticmethod
    def _e2e_inputs(labels):
        """{name: float64 coordinates [B, 60, 90, 3]} made from the batch's
        (augmented) label coordinates plus 5 cm of seeded noise. "converged":
        that alone; every hypothesis refines to the one pose the labels
        give. "two_mode": the right half of each image turned 5 degrees about
        the vertical through the image's mean coordinate, a second rigid
        mode: hypotheses refine to either pose, their pose losses differ and
        the softmax over the scores is not saturated, so the gradient through
        the scores and P3P is a real one."""
        import torch

        from crossloc_tpu_torch.geometry import rodrigues

        lab = labels.double()
        noise = torch.randn(lab.shape, generator=torch.Generator().manual_seed(4),
                            dtype=torch.float64) * 0.05
        mean = lab.flatten(1, 2).mean(1)[:, None, None, :]
        R = rodrigues(torch.tensor([0.0, 0.0, math.radians(5.0)], dtype=torch.float64))
        right = (torch.arange(lab.shape[2]) >= lab.shape[2] // 2)[None, None, :, None]
        return {"converged": lab + noise,
                "two_mode": torch.where(right, (lab - mean) @ R.T + mean, lab) + noise}

    def _e2e_permissive_step(self, datasets):
        """One DSAC step of the full-width seeded net at B=12, 480x720, f32,
        with the permissive solver config (an untrained net's coordinates
        then have valid hypotheses): 28 K1 and 28 K1-bwd launches, a finite
        positive loss and a non-zero coord-head gradient."""
        import torch

        from crossloc_tpu_torch import ops, ransac
        from crossloc_tpu_torch.train import TrainState, make_dsac_train_step, make_optimizer

        cfg = ransac.RansacConfig(hypotheses=16, sample_rounds=8, train_refine_steps=2,
                                  **E2E_PERMISSIVE)
        model = self._model("cuda")
        state = TrainState(model, make_optimizer(model.parameters(), 2e-4))
        batch = self._train_batch(datasets, TRAIN_BATCH, "cuda")
        step = make_dsac_train_step(model, cfg)
        ops.group_norm_relu.launches = ops.group_norm_relu_backward.launches = 0
        m = step(state, batch, idx=self._e2e_idx().cuda())
        torch.cuda.synchronize()
        fwd, bwd = ops.group_norm_relu.launches, ops.group_norm_relu_backward.launches
        loss, head = float(m["loss"]), float(model.decoder.fc3.weight.grad.norm())
        log(f"e2e step B={TRAIN_BATCH} {IMG_H}x{IMG_W} f32 (tau {cfg.inlier_threshold:g} px): "
            f"loss {loss:.6f}, coord-head |grad| {head:.3e}, {fwd} K1 and {bwd} K1-bwd launches, "
            f"valid hypotheses {float(m['valid_share']):.1%}")
        self.launches["e2e_step"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if (fwd, bwd) != (28, 28):
            raise AssertionError(f"expected 28 K1 and 28 K1-bwd launches, got {fwd}/{bwd}")
        if not (math.isfinite(loss) and loss > 0 and head > 0):
            raise AssertionError("the e2e loss is not positive or the coord head got no gradient")
        del model, state
        return dict(loss=loss, coord_head_grad=head, k1=fwd, k1_bwd=bwd,
                    valid_share=float(m["valid_share"]))

    def _e2e_step_check(self, datasets):
        """One DSAC step at B=12, 480x720, f32, seeded weights and draws, the
        CLI's solver config, with the value of the net's coordinates moved
        onto the "two_mode" input of `_e2e_inputs` (`_on_target`; the
        gradient flows through the whole net, K1-bwd included): 28 K1 and 28
        K1-bwd launches, and the card's gradients against the CPU's under
        the yardstick rule (the larger of the CPU's and the card plain twin's
        f32 distance from float64 with the card's plain twins). Decisions
        that differ card vs CPU are printed."""
        import torch

        from crossloc_tpu_torch import ops
        from crossloc_tpu_torch.train import dsac_step as dsac_mod
        from crossloc_tpu_torch.train import make_dsac_train_step

        idx = self._e2e_idx()
        target = self._e2e_inputs(self._train_batch(datasets, TRAIN_BATCH, "cpu").labels)[
            "two_mode"]
        aux, launches = {}, {}
        loss_fn, graphed_cls = dsac_mod.expected_pose_loss, dsac_mod.GraphedPoseLoss

        def step(state, b):
            run = f"{b.images.device.type}{64 if b.images.dtype == torch.float64 else 32}"
            model = state.model
            state.model = _on_target(model, target.to(b.images.device, b.images.dtype))

            def recording(*a, **k):
                loss, x = loss_fn(*a, **k)
                aux.setdefault(run, x)
                return loss, x

            # a fresh step's one call runs eagerly; `_e2e_graph` holds the replays
            class Recording(graphed_cls):
                def __call__(self, *a, **k):
                    loss, x = super().__call__(*a, **k)
                    aux.setdefault(run, x)
                    return loss, x

            dsac_mod.expected_pose_loss, dsac_mod.GraphedPoseLoss = recording, Recording
            ops.group_norm_relu.launches = ops.group_norm_relu_backward.launches = 0
            try:
                m = make_dsac_train_step(state.model)(state, b, idx=idx.to(b.images.device))
                torch.cuda.synchronize()
            finally:
                dsac_mod.expected_pose_loss, dsac_mod.GraphedPoseLoss = loss_fn, graphed_cls
                state.model = model
            launches.setdefault(run, (ops.group_norm_relu.launches,
                                      ops.group_norm_relu_backward.launches))
            return m

        losses, grads = self._gradients_against_cpu(datasets, step=step, batch_size=TRAIN_BATCH,
                                                    yardstick=("cpu", "card_plain"))
        fwd, bwd = launches["cuda32"]
        flips = {k: int((aux["cuda32"][k].cpu() != aux["cpu32"][k]).sum())
                 for k in ("hyp_valid", "inliers")}
        share = float(aux["cuda32"]["hyp_valid"].float().mean())
        log(f"e2e step on the two-mode input, B={TRAIN_BATCH} {IMG_H}x{IMG_W} f32 (tau 10 px): "
            f"loss {losses['card']:.6f}, {fwd} K1 and {bwd} K1-bwd launches, valid hypotheses "
            f"{share:.1%}; decisions that differ card vs CPU: hyp_valid {flips['hyp_valid']} of "
            f"{aux['cpu32']['hyp_valid'].numel()}, refined inlier counts {flips['inliers']} of "
            f"{aux['cpu32']['inliers'].numel()}")
        if (fwd, bwd) != (28, 28):
            raise AssertionError(f"expected 28 K1 and 28 K1-bwd launches, got {fwd}/{bwd}")
        return dict(losses=losses, k1=fwd, k1_bwd=bwd, flips=flips, valid_share=share)

    def phase_graph(self):
        """The e2e solver's CUDA graphs alone (`_e2e_graph`), to
        `<out-dir>/e2e_graph.json`."""
        work, datasets = self._e2e_scene()
        out = dict(device=self.device_name, smi=nvidia_smi_line(),
                   graph=self._e2e_graph(datasets))
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "e2e_graph.json"), "w") as f:
            json.dump(out, f, indent=1)
        shutil.rmtree(work, ignore_errors=True)

    def _e2e_graph(self, datasets, calls: int = 5):
        """The graphed pose loss (`ransac/graph.py`) against the eager
        `expected_pose_loss` at the DSAC* cell's shapes: B=12, 60 x 90 cells,
        64 hypotheses of 8 rounds, 2 refinement steps, tau 10 px, w_trans
        100, on the "two_mode" input of `_e2e_inputs`, `calls` calls each
        with fresh draws, forward and backward. Held: the loss and the
        coordinates' gradient within 1e-6 of the eager's (relative), the
        same valid hypotheses. Reported per call, for both: host ms (the
        call and its backward enqueued), wall ms (CUDA events around them,
        synchronised) and, from one profiled call, the device's kernel ms
        and kernel count; and the capture's seconds (the graphed loss's
        second call, after an eager one of each: both captures and a
        replay)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from crossloc_tpu_torch import ransac
        from crossloc_tpu_torch.ransac.graph import GraphedPoseLoss
        from crossloc_tpu_torch.ransac.solver import draw_minimal_sets, solver_precision

        b = self._train_batch(datasets, TRAIN_BATCH, "cuda")
        coords = self._e2e_inputs(b.labels.cpu())["two_mode"].float().cuda()
        cfg = ransac.RansacConfig(hypotheses=64, sample_rounds=8, train_refine_steps=2)
        lcfg = ransac.PoseLossConfig(w_trans=100.0)
        hw = (IMG_H, IMG_W)
        n_cells = coords.shape[1] * coords.shape[2]
        gen = torch.Generator(device="cuda").manual_seed(21)
        graphed = GraphedPoseLoss()
        fns = {"eager": ransac.expected_pose_loss, "graphed": graphed}

        def call(name, idx):
            c = coords.clone().requires_grad_()
            loss, aux = fns[name](c, b.poses, b.focal.reshape(-1)[0], hw, cfg, lcfg,
                                  pp_shift=b.pp_shift, idx=idx)
            with solver_precision(c.device):
                loss.backward()
            return loss.detach(), c.grad, aux["hyp_valid"]

        def gap(a, ref):
            return float((a - ref).double().norm() / max(float(ref.double().norm()), 1e-30))

        first_s = {}
        # the process's first solve loads its kernels; the graphed loss's
        # first call is eager, its second captures
        for name in ("eager", "graphed", "capture"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call("graphed" if name == "capture" else name,
                 draw_minimal_sets(TRAIN_BATCH, n_cells, cfg, gen, "cuda"))
            torch.cuda.synchronize()
            first_s[name] = time.perf_counter() - t0
        capture_s = first_s["capture"]
        gaps, times = [], {n: [] for n in fns}
        for _ in range(calls):
            idx = draw_minimal_sets(TRAIN_BATCH, n_cells, cfg, gen, "cuda")
            got = {}
            for name in fns:
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                got[name] = call(name, idx)
                host = (time.perf_counter() - t0) * 1e3
                end.record()
                end.synchronize()
                times[name].append((host, start.elapsed_time(end)))
            (gl, gg, gv), (el, eg, ev) = got["graphed"], got["eager"]
            gaps.append(dict(loss=gap(gl, el), grad=gap(gg, eg), loss_value=float(el),
                             hyp_valid_equal=bool(torch.equal(gv, ev)),
                             valid_share=float(ev.float().mean())))
        busy = {}
        for name in fns:
            idx = draw_minimal_sets(TRAIN_BATCH, n_cells, cfg, gen, "cuda")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call(name, idx)
                torch.cuda.synchronize()
            ms, n, _ = self._kernel_groups(prof)
            busy[name] = dict(kernel_ms=ms, kernels=n)
        out = dict(eager_first_s=first_s["eager"], graphed_first_s=first_s["graphed"],
                   capture_s=capture_s,
                   captures=graphed.captures, replays=graphed.replays,
                   gaps=gaps, busy=busy)
        for name, ts in times.items():
            out[name] = dict(host_ms=statistics.median(t[0] for t in ts),
                             wall_ms=statistics.median(t[1] for t in ts))
        log(f"e2e solver graph B={TRAIN_BATCH} {IMG_H}x{IMG_W} f32 on {self.device_name} "
            f"({nvidia_smi_line()}): the process's first eager call {first_s['eager']:.3f} s, "
            f"the graphed loss's first (eager) {first_s['graphed']:.3f} s, its second (capture "
            f"and replay) {capture_s:.3f} s; per call "
            "(forward + backward), "
            + "; ".join(f"{n} host {out[n]['host_ms']:.2f} ms, wall {out[n]['wall_ms']:.2f} ms, "
                        f"{busy[n]['kernels']} kernels {busy[n]['kernel_ms']:.2f} ms"
                        for n in fns)
            + "; largest gaps loss {:.3e}, grad {:.3e}".format(max(g["loss"] for g in gaps),
                                                               max(g["grad"] for g in gaps)))
        bad = [g for g in gaps if g["loss"] > 1e-6 or g["grad"] > 1e-6 or not g["hyp_valid_equal"]]
        if bad:
            raise AssertionError(f"the graphed pose loss differs from the eager one: {bad}")
        if (graphed.captures, graphed.replays) != (1, calls + 2):
            raise AssertionError(f"expected 1 capture and {calls + 2} replays, got "
                                 f"{graphed.captures} and {graphed.replays}")
        return out

    def _e2e_solver_oracle(self, datasets):
        """The expected pose loss and its gradient with respect to the
        coordinates at B=12, 60 x 90 cells, the CLI's solver config, at
        injected draws, on both inputs of `_e2e_inputs`, in four runs: card
        f32, CPU f32, card f64 and CPU f64. Held, per input:
          - the card's float64 gradient against the CPU's, per image whose
            float64 decisions agree: within 1e-6 of its norm (every op of the
            path, P3P's backward included, computes the same on the card);
          - P3P's forward and implicit backward at the card f32 run's own
            minimal sets, fed that run's own cotangents: the card's f32
            within 1e-3 of the norm plus twice the CPU's f32 distance from
            the CPU's float64 (the gradient checks' rule: a few
            ill-conditioned sets carry most of either error).
        Held on "two_mode" only: over the images whose decisions (valid
        hypotheses, first valid round) agree in all four runs, at least half,
        the card's f32 gradient within 1e-3 of the norm plus twice the CPU's
        f32 distance from the card's float64; and P3P's share of the float64
        gradient there at least 10 %, so that the check holds P3P's path.
        Reported: per image errors, P3P's share and the largest |dL/dscore|.
        On "converged" every hypothesis refines to one pose, the true
        dL/dscore is 0 and the f32 one is the rounding of the hypotheses'
        pose losses (arccos near 1), which the scores and P3P carry into the
        coordinates: the f32 gradient is reported, not held."""
        import torch

        from crossloc_tpu_torch import ransac
        from crossloc_tpu_torch.geometry import p3p_from_4pts
        from crossloc_tpu_torch.ransac import loss as loss_mod
        from crossloc_tpu_torch.ransac import solver as solver_mod

        batch = self._train_batch(datasets, TRAIN_BATCH, "cpu")
        cfg = ransac.RansacConfig(hypotheses=16, sample_rounds=8, train_refine_steps=2)
        idx = self._e2e_idx()
        B, H, Rr = TRAIN_BATCH, cfg.hypotheses, cfg.sample_rounds
        p3p, score = solver_mod.p3p_from_4pts, loss_mod.soft_inlier_score

        def run(coords, dev, dt):
            rec = {}

            def p3p_recording(X4, P4, cam):
                R, t, err4, valid = p3p(X4, P4, cam)
                rec.update(X4=X4.detach(), P4=P4, cam=cam.detach(), valid=valid,
                           good=(valid & (err4 < cfg.inlier_threshold)).reshape(B, H, Rr).cpu())
                R.register_hook(lambda g: rec.__setitem__("gR", g))
                t.register_hook(lambda g: rec.__setitem__("gt", g))
                X4.register_hook(lambda g: rec.__setitem__("gX4", g.detach().cpu().double()))
                return R, t, err4, valid

            def score_recording(*a, **k):
                s = score(*a, **k)
                s.register_hook(lambda g: rec.__setitem__("gs", g.detach().cpu().double()))
                return s

            solver_mod.p3p_from_4pts, loss_mod.soft_inlier_score = p3p_recording, score_recording
            try:
                c = coords.to(dev, dt).clone().requires_grad_()
                loss, aux = ransac.expected_pose_loss(
                    c, batch.poses.to(dev, dt), batch.focal.to(dev, dt), (IMG_H, IMG_W), cfg,
                    pp_shift=batch.pp_shift.to(dev, dt), idx=idx.to(dev))
                loss.backward()
            finally:
                solver_mod.p3p_from_4pts, loss_mod.soft_inlier_score = p3p, score
            rec.update(loss=float(loss.detach()), grad=c.grad.detach().cpu().double(),
                       first=torch.argmax(rec["good"].to(torch.uint8), dim=2),
                       **{k: v.cpu() for k, v in aux.items() if k != "per_image"})
            return rec

        def p3p_part(r):
            """The part of the coordinate gradient P3P's backward put into the
            cells of the minimal sets, [B, N, 3]."""
            out = torch.zeros(B, (IMG_H // 8) * (IMG_W // 8), 3, dtype=torch.float64)
            return out.scatter_add_(1, idx.reshape(B, -1, 1).expand(-1, -1, 3),
                                    r["gX4"].reshape(B, -1, 3))

        def agree(a, b):
            return (a["hyp_valid"] == b["hyp_valid"]).all(1) & (a["first"] == b["first"]).all(1)

        out, failed = {}, []
        for name, coords in self._e2e_inputs(batch.labels).items():
            res = {r: run(coords, dev, dt) for r, dev, dt in (
                ("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                ("card64", "cuda", torch.float64), ("cpu64", "cpu", torch.float64))}
            g64 = res["card64"]["grad"].flatten(1)
            n64 = g64.norm(dim=1).clamp(min=1e-30)
            per = {r: ((res[r]["grad"].flatten(1) - g64).norm(dim=1) / n64).tolist()
                   for r in ("card", "cpu", "cpu64")}
            same64 = agree(res["card64"], res["cpu64"])
            same = same64 & agree(res["card"], res["card64"]) & agree(res["cpu"], res["card64"])
            d = {r: float((res[r]["grad"].flatten(1) - g64)[same].norm()) for r in ("card", "cpu")}
            ref = float(g64[same].norm())
            p3p_share = float(p3p_part(res["card64"]).flatten(1)[same].norm()) / ref
            f64_worst = max((v for v, s in zip(per["cpu64"], same64.tolist()) if s), default=0.0)
            gs = {r: res[r]["gs"].abs().amax(1).tolist() for r in ("card", "cpu", "card64")}
            flips = {k: int((res["card"][k] != res["cpu"][k]).sum())
                     for k in ("hyp_valid", "first", "inliers")}
            share = float(res["card"]["hyp_valid"].float().mean())
            wit = self._p3p_witness(res["card"], p3p_from_4pts)
            log(f"e2e solver on the {name} input (label coordinates + 5 cm"
                + (", right half turned 5 deg" if name == "two_mode" else "")
                + f"), B={B}, tau {cfg.inlier_threshold:g} px: loss card "
                f"{res['card']['loss']:.6f}, CPU {res['cpu']['loss']:.6f}, f64 card "
                f"{res['card64']['loss']:.6f} / CPU {res['cpu64']['loss']:.6f}; valid hypotheses "
                f"{share:.1%}; decisions that differ card vs CPU (f32): {flips}; images whose "
                f"decisions agree in all runs {int(same.sum())} of {B}; over them |dL/dcoords - "
                f"f64| / |f64| card {d['card'] / ref:.3e}, CPU f32 {d['cpu'] / ref:.3e}"
                + (" (limit: card <= 1e-3 + 2 x CPU)" if name == "two_mode" else " (reported)")
                + f", P3P's share of the f64 gradient {p3p_share:.3f}; f64 card vs CPU, worst "
                f"image {f64_worst:.3e} (limit 1e-6, {int(same64.sum())} images); per image card "
                + ", ".join(f"{v:.1e}" for v in per["card"]) + "; CPU "
                + ", ".join(f"{v:.1e}" for v in per["cpu"]) + "; per image max |dL/dscore| card "
                + ", ".join(f"{v:.1e}" for v in gs["card"]) + "; CPU "
                + ", ".join(f"{v:.1e}" for v in gs["cpu"]) + "; f64 "
                + ", ".join(f"{v:.1e}" for v in gs["card64"]))
            log(f"  P3P at the card run's {wit['sets']} minimal sets and cotangents ({wit['valid']} "
                f"valid in all runs), |gX - gX_f64 (CPU)|: card {wit['card']:.3e}, CPU f32 "
                f"{wit['cpu']:.3e} of {wit['norm']:.3e} (limit: card <= 1e-3 x norm + 2 x CPU); "
                f"the card run's own gX against the card's recomputation: {wit['recorded']:.3e}")
            if int(same64.sum()) < B // 2 or f64_worst > 1e-6:
                failed.append(f"{name}: float64 card vs CPU")
            if wit["card"] > 1e-3 * wit["norm"] + 2 * wit["cpu"]:
                failed.append(f"{name}: P3P at the e2e sets")
            if name == "two_mode" and (int(same.sum()) < B // 2 or not share > 0.5
                                       or d["card"] > 1e-3 * ref + 2 * d["cpu"]
                                       or not p3p_share >= 0.1):
                failed.append(f"{name}: f32 gradient on the card")
            out[name] = dict(losses={r: v["loss"] for r, v in res.items()}, rel_err={
                r: v / ref for r, v in d.items()}, per_image=per, flips=flips,
                images_agreeing=int(same.sum()), valid_share=share, p3p_share=p3p_share,
                f64_card_vs_cpu=f64_worst, max_dl_dscore=gs, p3p_witness=wit)
        if failed:
            raise AssertionError(f"the solver's gradient on the card is off: {failed}")
        return out

    @staticmethod
    def _p3p_witness(rec, p3p_from_4pts):
        """P3P's forward and implicit backward at the minimal sets of a
        recorded card run, fed that run's cotangents (gR, gt), on the card
        (f32), the CPU (f32) and the CPU (f64): distances of gX from the
        CPU's f64 over the sets valid in all three, and of the run's recorded
        gX from the card's recomputation."""
        import torch

        X4, P4, cam = (rec[k].double().cpu() for k in ("X4", "P4", "cam"))
        gR, gt = rec["gR"].double().cpu(), rec["gt"].double().cpu()
        res = {}
        for r, dev, dt in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                           ("cpu64", "cpu", torch.float64)):
            X = X4.to(dev, dt).requires_grad_()
            R, t, _, valid = p3p_from_4pts(X, P4.to(dev, dt), cam.to(dev, dt))
            torch.autograd.backward([R, t], [gR.to(dev, dt), gt.to(dev, dt)])
            res[r] = (X.grad.detach().cpu().double(), valid.cpu())
        both = res["card"][1] & res["cpu"][1] & res["cpu64"][1]
        ref = res["cpu64"][0][both]
        return dict(sets=int(both.numel()), valid=int(both.sum()), norm=float(ref.norm()),
                    card=float((res["card"][0][both] - ref).norm()),
                    cpu=float((res["cpu"][0][both] - ref).norm()),
                    recorded=float((rec["gX4"].reshape(res["card"][0].shape)
                                    - res["card"][0]).norm()))

    def _e2e_p3p(self, datasets):
        """P3P's forward and implicit backward on the card at the e2e step's
        12 x 16 x 8 = 1,536 minimal sets, of the seeded net's coordinates and
        of the scene's label coordinates, with a seeded cotangent, against
        float64 on the CPU; the CPU's float32 is the yardstick: the card's
        error may be at most twice it."""
        import torch

        batch = self._train_batch(datasets, TRAIN_BATCH, "cuda")
        with torch.no_grad():
            coords = self._model("cuda")(batch.images)[..., :3].float()
        return {src: self._p3p_sets(src, c, batch) for src, c in (
            ("net", coords), ("labels", batch.labels))}

    def _p3p_sets(self, src, coords, batch):
        import torch

        from crossloc_tpu_torch import ransac
        from crossloc_tpu_torch.geometry import p3p_from_4pts
        from crossloc_tpu_torch.ransac.solver import solver_inputs

        cfg = ransac.RansacConfig()
        c, grid, cams = solver_inputs(coords, batch.focal.reshape(-1)[0], (IMG_H, IMG_W), cfg,
                                      batch.pp_shift)
        idx = self._e2e_idx().cuda()
        X4 = c[torch.arange(TRAIN_BATCH, device="cuda")[:, None, None], idx].cpu().double()
        P4, K = grid[idx].cpu().double(), cams[:, None].cpu().double()
        gen = torch.Generator().manual_seed(3)
        gR, gt = torch.randn(X4.shape[:2] + (3, 3), generator=gen, dtype=torch.float64), \
            torch.randn(X4.shape[:2] + (3,), generator=gen, dtype=torch.float64)
        res = {}
        for run, dev, dt in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("cpu64", "cpu", torch.float64)):
            X = X4.to(dev, dt).requires_grad_()
            R, t, _, valid = p3p_from_4pts(X, P4.to(dev, dt), K.to(dev, dt))
            ((R * gR.to(dev, dt)).sum() + (t * gt.to(dev, dt)).sum()).backward()
            res[run] = [v.detach().cpu().double() for v in (R, t, X.grad)] + [valid.cpu()]
        both = res["card"][3] & res["cpu"][3] & res["cpu64"][3]

        def err(run, i):
            return float((res[run][i] - res["cpu64"][i])[both].norm())

        ref = {i: float(res["cpu64"][i][both].norm()) for i in range(3)}
        rows = {name: dict(card=err("card", i), cpu=err("cpu", i), norm=ref[i])
                for i, name in enumerate(("R", "t", "grad_X"))}
        valid_diff = int((res["card"][3] != res["cpu64"][3]).sum())
        log(f"P3P on the card at {both.numel()} minimal sets ({src} coordinates; valid in "
            f"all runs {int(both.sum())}, "
            f"validity differs card vs f64 on {valid_diff}), |x - x_f64| over the valid sets: "
            + ", ".join(f"{k} card {v['card']:.3e} / CPU f32 {v['cpu']:.3e} of {v['norm']:.3e}"
                        for k, v in rows.items())
            + " (limit: card <= 2 x CPU f32 + 1e-6 x norm)")
        if any(v["card"] > 2 * v["cpu"] + 1e-6 * v["norm"] for v in rows.values()):
            raise AssertionError("P3P on the card is further from float64 than the CPU's f32")
        return dict(sets=both.numel(), valid=int(both.sum()), validity_differs=valid_diff,
                    errors=rows)

    def _e2e_cli(self, datasets, work, tag, extra):
        """The training CLI with encoder_pretrain.sh's settings and
        --e2e_pose_loss --e2e_warmup_epochs 1 --epochs 2 (epoch 0 the proxy
        loss, epoch 1 the expected pose loss; 2 steps each), its -e2e folder,
        log lines and launches, and model.net served on cuda."""
        import re

        import numpy as np

        from crossloc_tpu_torch.cli import test_single_task as test_cli
        from crossloc_tpu_torch.cli import train_single_task as train_cli

        records = []
        make = train_cli.make_dsac_train_step

        def recording_maker(*a, **k):
            step = make(*a, **k)

            def recorded(*sa, **sk):
                m = step(*sa, **sk)
                records.append({k: float(v) for k, v in m.items()})
                return m

            return recorded

        train_cli.make_dsac_train_step = recording_maker
        try:
            out_dir, losses, fwd, bwd, wall = self._run_cli(train_cli.main, work, PRETRAIN_ARGS + [
                "--datasets_dir", datasets, "--ckpt_dir", os.path.join(work, "ckpts"),
                "--session", f"e2e_{tag}", "--e2e_pose_loss", "--e2e_warmup_epochs", "1",
                "--epochs", "2", *extra])
        finally:
            train_cli.make_dsac_train_step = make
        steps = 4
        text = open(os.path.join(out_dir, "output.log")).read()
        valid = re.findall(r"Epoch:\s+1, Total loss: [-\w.]+, Valid: ([\d.]+)%", text)
        log(f"train_single_task --e2e_pose_loss {' '.join(extra)} on cuda (B={TRAIN_BATCH}, "
            f"{IMG_H}x{IMG_W}, 1 proxy + 1 e2e epoch): {os.path.basename(out_dir)}, {wall:.1f} s "
            f"wall, losses {losses}, {fwd} K1 and {bwd} K1-bwd launches; per e2e step: valid "
            "hypotheses " + ", ".join(f"{r['valid_share']:.1%}" for r in records)
            + f", gradient entries zeroed {[int(r['nonfinite']) for r in records]}, steps with "
            f"zeroed gradients {sum(r['nonfinite'] > 0 for r in records)}")
        self.launches[f"e2e_cli_{tag}"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if "-e2e-" not in os.path.basename(out_dir) or len(records) != 2:
            raise AssertionError("no -e2e folder, or not 2 e2e steps")
        if fwd != 28 * steps or bwd != 28 * steps:
            raise AssertionError(f"expected {28 * steps} K1 and K1-bwd launches, got {fwd}/{bwd}")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses) or valid != [
                "100.0", "100.0"]:
            raise AssertionError(f"log lines: losses {losses}, e2e valid {valid}")
        logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                              "--network_in", os.path.join(out_dir, "model.net"), "--section",
                              "val_drone_real", "--datasets_dir", datasets, "--save_pred",
                              "--device", "cuda"])
        pred_dir = os.path.join(out_dir, "coord_pred_model.net_val_drone_real")
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"] for f in sorted(os.listdir(pred_dir))]
        log(f"served the e2e model.net on cuda: {logs[0]}, {len(poses)} poses")
        if len(poses) != BATCH or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("the e2e net did not serve")
        return dict(folder=os.path.basename(out_dir), losses=losses, k1=fwd, k1_bwd=bwd,
                    wall_s=wall, e2e_steps=records)

    def _e2e_step_setup(self, datasets, dtype):
        """(state, step fn) of the CLI's e2e step at B=12: augmentation of
        uint8 images, forward, expected pose loss (the CLI's solver config),
        backward, Adam."""
        import torch

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.train import (TrainBatch, TrainState, make_dsac_train_step,
                                              make_optimizer)

        B = TRAIN_BATCH
        images, labels, poses, focal = (t.cuda() for t in self._host_batch(datasets, B))
        wire = torch.from_numpy(data.images_to_wire(images.cpu().numpy())).cuda()
        draws = data.draw_augmentation(torch.Generator().manual_seed(0), B).to("cuda")
        model = self._model("cuda", dtype)
        state = TrainState(model, make_optimizer(model.parameters(), 2e-4))
        dsac = make_dsac_train_step(model)
        gen = torch.Generator(device="cuda").manual_seed(0)

        def step():
            im, lab, po, fo, pp = data.augment_batch(data.images_from_wire(wire), labels, poses,
                                                     focal, draws)
            return dsac(state, TrainBatch(im, po, lab, fo, pp), generator=gen)

        return state, step

    def _e2e_step_time(self, datasets):
        """The e2e step between CUDA events at B=12, f32 (TF32 off) and bf16,
        with peak memory and K1 / K1-bwd launches per step."""
        import torch

        from crossloc_tpu_torch import ops

        out = {}
        for dtype in self._dtypes():
            state, step = self._e2e_step_setup(datasets, dtype)
            step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.group_norm_relu.launches = ops.group_norm_relu_backward.launches = 0
            ms = cuda_ms(step, iters=5, warmup=1)
            per = (ops.group_norm_relu.launches / 6, ops.group_norm_relu_backward.launches / 6)
            peak = torch.cuda.max_memory_allocated() / 2**30
            name = str(dtype)[6:]
            out[name] = dict(ms=ms, img_s=1e3 * TRAIN_BATCH / ms, peak_gib=peak, k1=per[0],
                             k1_bwd=per[1])
            log(f"e2e step B={TRAIN_BATCH} {IMG_H}x{IMG_W} {name} on {self.device_name} "
                f"({nvidia_smi_line()}): {ms:.2f} ms = {1e3 * TRAIN_BATCH / ms:.1f} img/s, peak "
                f"memory {peak:.2f} GiB, {per[0]:g} K1 and {per[1]:g} K1-bwd launches per step")
            del state, step
        return out

    def _profile_e2e(self, datasets, dtype):
        """One e2e step under torch.profiler (wall, device busy and idle, by
        kernel group), then one step in stages (net forward, solver forward,
        solver backward, net backward, Adam), each in a profiler session of
        its own that ends with a sync: the kernels, device ms and wall of
        each stage."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from crossloc_tpu_torch import data, ransac
        from crossloc_tpu_torch.train import TrainBatch, apply_gradients

        state, step = self._e2e_step_setup(datasets, dtype)
        step(), step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, n, groups = self._kernel_groups(prof)
        name = str(dtype)[6:]
        log(f"profile e2e step {name} B={TRAIN_BATCH} {IMG_H}x{IMG_W}: wall {wall:.2f} ms, device "
            f"busy {busy:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}, {n} kernels; "
            "by group: " + ", ".join(f"{k} {v[0]} launches {v[1]:.2f} ms"
                                     for k, v in sorted(groups.items())))
        with open(os.path.join(self.out_dir, f"profile_e2e_{name}.txt"), "w") as f:
            f.write(f"{self.device_name} | {nvidia_smi_line()}\n")
            f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))

        images, labels, poses, focal = (t.cuda() for t in self._host_batch(datasets, TRAIN_BATCH))
        batch = TrainBatch(data.normalize_images(images), poses, labels, focal, None)
        model = state.model
        params = list(model.parameters())
        state.optimizer.adam.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cfg = ransac.RansacConfig(hypotheses=16, sample_rounds=8, train_refine_steps=2)
        held = {}

        def net_forward():
            held["out"] = model(batch.images)[..., :3].float()
            held["coords"] = held["out"].detach().requires_grad_()

        def solver_forward():
            held["loss"] = ransac.expected_pose_loss(held["coords"], batch.poses, batch.focal,
                                                     (IMG_H, IMG_W), cfg, generator=gen)[0]

        stages = {"net_forward": net_forward, "solver_forward": solver_forward,
                  "solver_backward": lambda: held["loss"].backward(),
                  "net_backward": lambda: held["out"].backward(held["coords"].grad),
                  "adam": lambda: apply_gradients(state, params)}
        by_stage = {}
        for st, fn in stages.items():  # one profiler session per stage
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                st_wall = (time.perf_counter() - t0) * 1e3
            st_busy, st_n, _ = self._kernel_groups(prof)
            by_stage[st] = [st_n, st_busy, st_wall]
        log(f"profile e2e step {name}, staged (a sync after each stage): " + ", ".join(
            f"{k} {v[0]} kernels {v[1]:.2f} ms device / {v[2]:.2f} ms wall"
            for k, v in by_stage.items()))
        return dict(wall_ms=wall, busy_ms=busy, kernels=n, groups=groups, stages=by_stage)

    # -- phase 9 -----------------------------------------------------------
    def phase_parallel(self):
        """Data parallelism on the one card: two ranks share it (gloo over
        CUDA tensors; NCCL refuses two ranks on one device), and NCCL runs at
        world size 1. Full-width coord + MLE net at 480x720, f32, TF32 off.
        (a) the training CLI as 2 processes through CROSSLOC_*, global B=12;
        (b) one step's averaged gradient against one process at B=12; (c)
        ZeRO: the CLI with --zero and (b) sharded; (d) --zero --ckpt_backend
        orbax for 1 epoch, then --epoch_plus to 2; (e) an NCCL group; (f) the
        hypothesis-sharded solver; (g) data-parallel eval over [cuda:0,
        cuda:0]."""
        import re

        import numpy as np
        import torch
        import torch.distributed as dist

        from crossloc_tpu_torch import compat, data, ops, parallel, ransac
        from crossloc_tpu_torch.cli import test_single_task as test_cli
        from crossloc_tpu_torch.tools import parallel_check as pc
        from crossloc_tpu_torch.utils import read_training_log

        work = WORK_DIR + "_parallel"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        report_dir = os.path.join(self.out_dir, "parallel")
        os.makedirs(report_dir, exist_ok=True)
        n_frames, B = 2 * TRAIN_BATCH, TRAIN_BATCH
        steps = 2 * (n_frames // B)  # 2 epochs
        smi = nvidia_smi_line()
        t0 = time.perf_counter()
        # identical frames: a 2-rank run then equals one process at the global batch
        train = os.path.join(datasets, "urbanscape", "train_sim")
        data.write_fake_dataset(train, n=1, img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=0,
                                scene="plane")
        for sub in os.listdir(train):
            files = sorted(os.listdir(os.path.join(train, sub)))
            for i in range(1, n_frames):
                ext = files[0].split("frame_00000")[1]
                shutil.copyfile(os.path.join(train, sub, files[0]),
                                os.path.join(train, sub, f"frame_{i:05d}{ext}"))
        data.write_fake_dataset(os.path.join(datasets, "urbanscape", "val_drone_real"), n=BATCH,
                                img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=1, scene="plane")
        log(f"wrote {n_frames} identical train_sim frames and a {BATCH}-frame val_drone_real "
            f"plane scene at {IMG_H}x{IMG_W} in {time.perf_counter() - t0:.1f} s")

        def cli_ranks(tag, epochs, extra, shared):
            """The training CLI as ranks 0 and 1 through CROSSLOC_* (a file://
            store), each under a 300 s timeout: (rank 0's output dir, its log,
            per-rank launch counts)."""
            cwds = [os.path.join(work, tag if shared else f"{tag}_rank{r}") for r in (0, 1)]
            args = PRETRAIN_ARGS + ["--datasets_dir", datasets, "--ckpt_dir",
                                    os.path.join(work, "ckpts"), "--session", "par",
                                    "--epochs", str(epochs), "--image_height", str(IMG_H),
                                    *extra]
            procs = []
            for r, cwd in enumerate(cwds):
                os.makedirs(cwd, exist_ok=True)
                env = dict(os.environ, PYTHONPATH=HERE,
                           CROSSLOC_COORDINATOR="file://" + os.path.join(work, f"{tag}.store"),
                           CROSSLOC_NUM_PROCESSES="2", CROSSLOC_PROCESS_ID=str(r))
                logf = open(os.path.join(report_dir, f"{tag}_rank{r}.log"), "w")
                procs.append((subprocess.Popen(
                    [sys.executable, "-m", "crossloc_tpu_torch.tools.parallel_check",
                     os.path.join(work, f"{tag}_counts{r}.json"),
                     "crossloc_tpu_torch.cli.train_single_task", *args],
                    cwd=cwd, env=env, stdout=logf, stderr=subprocess.STDOUT), logf))
            try:
                for r, (p, _) in enumerate(procs):
                    rc = p.wait(timeout=300)
                    if rc != 0:
                        raise AssertionError(f"{tag}: rank {r} exited {rc} (see "
                                             f"{report_dir}/{tag}_rank{r}.log)")
            finally:
                for p, logf in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                    logf.close()
            counts = [json.load(open(os.path.join(work, f"{tag}_counts{r}.json")))
                      for r in (0, 1)]
            outs = glob.glob(os.path.join(cwds[0], "output", f"*-e{epochs}-*"))
            text = open(os.path.join(outs[0], "output.log")).read()
            return outs[0], text, counts

        def step_ms(text):
            """Rank 0's step times after the first (Avg Time is per global sample)."""
            t = [float(v) * B * 1e3 for v in re.findall(r"Avg Time: ([\d.]+)s", text)]
            return [round(v, 1) for v in t[1:]]

        def backends(text):
            return sorted(set(re.findall(r"Process group: backend (\w+)", text)))

        # (a) data parallelism through the CLI
        out_a, log_a, counts_a = cli_ranks("dp", 2, [], shared=False)
        fwd_a = [c["groupnorm"] for c in counts_a]
        bwd_a = [c["groupnorm_backward"] for c in counts_a]
        self.launches["parallel"] = dict(groupnorm=sum(fwd_a), groupnorm_backward=sum(bwd_a))
        losses_a = [float(v) for v in re.findall(r"Total loss: ([-\w.]+),", log_a)]
        ms_a = step_ms(log_a)
        log(f"(a) train_single_task as 2 ranks on one card (backend {backends(log_a)}), global "
            f"B={B}, local {B // 2}, {steps} steps: losses {losses_a}, launches per rank "
            f"K1 {fwd_a} / K1-bwd {bwd_a} (expected {28 * steps} each)")
        line = f"(global batch {B}, local {B // 2})"
        if any(n != 28 * steps for n in fwd_a + bwd_a):
            raise AssertionError("launches per rank are not 28 + 28 per step")
        if f"Multi-host data-parallel training: 2 processes x 1 local devices {line}" not in log_a:
            raise AssertionError("the data-parallel log line is missing")
        if read_training_log(os.path.join(out_a, "output.log"), n_frames) != (2 * n_frames, 1):
            raise AssertionError("output.log does not count global samples")
        if os.path.exists(os.path.join(work, "dp_rank1", "output")):
            raise AssertionError("rank 1 wrote into its output tree")
        if len(losses_a) != steps or not all(math.isfinite(v) for v in losses_a):
            raise AssertionError(f"losses {losses_a}")
        logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                              "--network_in", os.path.join(out_a, "model.net"), "--section",
                              "val_drone_real", "--datasets_dir", datasets, "--save_pred",
                              "--device", "cuda"])
        pred_dir = os.path.join(out_a, "coord_pred_model.net_val_drone_real")
        poses = [np.load(os.path.join(pred_dir, f))["pose_pred"] for f in sorted(os.listdir(pred_dir))]
        if len(poses) != BATCH or not all(np.isfinite(p).all() for p in poses):
            raise AssertionError("the data-parallel model.net serves no finite poses")
        log(f"(a) rank 1 wrote nothing; model.net served on cuda: {len(poses)} finite poses "
            f"({logs[0]})")

        # (d) then (c): ZeRO with DCP checkpoints, 1 epoch, then --epoch_plus to 2
        out_c, log_c, counts_c = cli_ranks("zero", 1, ["--zero", "--ckpt_backend", "orbax"],
                                           shared=True)
        ms_c = step_ms(log_c)
        fwd_c = [c["groupnorm"] for c in counts_c]
        if "with ZeRO parameter sharding" not in log_c or any(n != 28 * steps // 2 for n in fwd_c):
            raise AssertionError(f"ZeRO run: log line or launches {fwd_c} off")
        if sorted(d for d in os.listdir(out_c) if d.isdigit()) != [str(steps // 2)]:
            raise AssertionError(f"no DCP step directory in {out_c}")
        out_d, log_d, counts_d = cli_ranks("zero", 2, ["--zero", "--ckpt_backend", "orbax",
                                                       "--epoch_plus"], shared=True)
        tail = log_d.split("Restored full train state", 1)[-1]
        if tail == log_d or "=== Epoch: 0 ===" in tail:
            raise AssertionError("the --epoch_plus run did not restore the DCP state")
        losses_d = [float(v) for v in re.findall(r"Total loss: ([-\w.]+),", tail)]
        net_a = compat.load_net(os.path.join(out_a, "model.net"))
        net_d = compat.load_net(os.path.join(out_d, "model_epoch_plus_resume.net"))
        diffs = sorted(float((net_a[k].double() - net_d[k].double()).abs().max()) for k in net_a)
        d_loss = max(abs(x - y) for x, y in zip(losses_d, losses_a[steps // 2:]))
        log(f"(c) --zero: 2 ranks, launches per rank K1 {fwd_c}, backend {backends(log_c)}; "
            f"(d) --ckpt_backend orbax saved {out_c}/{steps // 2}/, --epoch_plus restored and "
            f"continued: losses {losses_d} against the uninterrupted DP run's "
            f"{losses_a[steps // 2:]} (max |diff| {d_loss:.3f}, limit 0.01, the printed digit); "
            f"model.net median |diff| {diffs[len(diffs) // 2]:.2e} (limit 1e-5), max "
            f"{diffs[-1]:.2e} (limit {3 * steps * 2e-4:.1e}, 3 x steps x lr)")
        if d_loss > 0.01 or diffs[len(diffs) // 2] > 1e-5 or diffs[-1] > 3 * steps * 2e-4:
            raise AssertionError("the resumed ZeRO run left the uninterrupted trajectory")

        # (b), (c) and (f) on two ranks of one process group, one spawn
        batch = self._train_batch(datasets, B, "cpu")
        spec = dict(state_dict=self._model("cpu").state_dict(),
                    batch=dict(images=batch.images, poses=batch.poses, labels=batch.labels,
                               focal=batch.focal, pp_shift=batch.pp_shift),
                    kind="coord", uncertainty="MLE", mean=list(data.get_label_mean(
                        "urbanscape", "coord")), tiny=False, zero=False, steps=3, lr=2e-4,
                    device="cuda")
        model = self._model("cuda")
        compat.load_net(os.path.join(out_a, "model.net"), model)
        val = data.CamLocDataset(os.path.join(datasets, "urbanscape", "val_drone_real"),
                                 image_height=IMG_H).collate(range(BATCH))
        with torch.no_grad():
            images = data.images_from_wire(torch.from_numpy(val["image"]).cuda())
            coords = model.eval()(data.normalize_images(images))[..., :3].float().cpu()
        del model
        cfg = ransac.RansacConfig()
        idx = torch.randint(0, coords.shape[1] * coords.shape[2],
                            (BATCH, cfg.hypotheses * cfg.sample_rounds, 4),
                            generator=torch.Generator().manual_seed(5))
        solver_spec = dict(coords=coords, focal=torch.from_numpy(val["focal"]),
                           image_hw=(IMG_H, IMG_W), ransac={}, idx=idx, device="cuda")
        outs = {k: os.path.join(work, f"{k}.pt") for k in ("dp", "zero", "solver")}
        t0 = time.perf_counter()
        pc.run_ranks(pc.checks, 2, ([(pc.step_check, (spec, outs["dp"])),
                                     (pc.step_check, (dict(spec, zero=True), outs["zero"])),
                                     (pc.solver_check, (solver_spec, outs["solver"]))],),
                     device="cuda", timeout=300, threads=4)
        log(f"(b, c, f) two ranks of one group: {time.perf_counter() - t0:.1f} s")
        dp, zero, sharded = (torch.load(outs[k], weights_only=False)
                             for k in ("dp", "zero", "solver"))
        ref1, ref2 = pc.step_check(dict(spec, steps=0)), pc.step_check(dict(spec, steps=0))
        halves = [pc.step_check(dict(spec, steps=0, batch={k: (v[s] if v.dim() and k in (
            "images", "poses", "labels") else v) for k, v in spec["batch"].items()}))
            for s in (slice(0, B // 2), slice(B // 2, B))]
        split = {n: (halves[0]["grads"][n] + halves[1]["grads"][n]) / 2 for n in ref1["grads"]}

        def dist_max(a, b):
            return max(float((a[n].double() - b[n].double()).abs().max()) for n in a)

        gmax = max(float(g.abs().max()) for g in ref1["grads"].values())
        spread = max(dist_max(ref1["grads"], ref2["grads"]), dist_max(ref1["grads"], split))
        tol = max(2 * spread, 1e-6 * gmax)
        err_dp, err_zero = dist_max(dp["grads"], ref1["grads"]), dist_max(zero["grads"],
                                                                           ref1["grads"])
        upd = sorted(float((zero["params"][n].double() - dp["params"][n].double()).abs().max())
                     for n in dp["params"])
        log(f"(b) DP gradient at B={B} vs one process: max |diff| {err_dp:.3e}; (c) ZeRO "
            f"{err_zero:.3e}; limit {tol:.3e} = 2 x the spread of single-process gradients "
            f"({dist_max(ref1['grads'], ref2['grads']):.3e} between two runs, "
            f"{dist_max(ref1['grads'], split):.3e} against the two halves), max |g| {gmax:.3e}; "
            f"backend {dp['backend']}; launches per rank and step {dp['launches']} (DP) "
            f"{zero['launches']} (ZeRO); ZeRO's parameters after {spec['steps']} steps against "
            f"DP's: median |diff| {upd[len(upd) // 2]:.2e}, max {upd[-1]:.2e} (limit "
            f"{2 * spec['lr'] * spec['steps']:.1e}: a near-zero gradient whose sign differs "
            f"moves an Adam update by 2 x lr)")
        if max(err_dp, err_zero) > tol or upd[-1] > 2 * spec["lr"] * spec["steps"]:
            raise AssertionError("the data-parallel gradient or the ZeRO update is off")
        if {tuple(n) for n in dp["launches"] + zero["launches"]} != {(28, 28)}:
            raise AssertionError("launches per rank and step are not 28 + 28")

        ref = ransac.solve_batch(coords.cuda(), solver_spec["focal"].cuda(), (IMG_H, IMG_W),
                                 cfg, idx=idx.cuda())
        same = int((sharded["chosen"] == ref.chosen.cpu()).sum())
        d6 = float(((sharded["pose_w2c6"] - ref.pose_w2c6.cpu()).abs()
                    / ref.pose_w2c6.cpu().abs().clamp(min=1.0)).max())
        log(f"(f) sharded solver, 2 ranks x {cfg.hypotheses // 2} of {cfg.hypotheses} "
            f"hypotheses on the served net's B={BATCH} coordinates: chosen equal "
            f"{same}/{BATCH}, max relative |pose6 diff| {d6:.2e} (limit 1e-5)")
        if same != BATCH or d6 > 1e-5:
            raise AssertionError("the sharded solver disagrees with solve_batch")

        # (e) NCCL at world size 1, through the port's initialize_distributed
        parallel.initialize_distributed("file://" + os.path.join(work, "nccl.store"), 1, 0,
                                        device="cuda")
        try:
            nccl = dist.get_backend()
            t = torch.arange(4.0, device="cuda")
            dist.all_reduce(t)
            one = ransac.solve_batch_hypsharded(coords.cuda(), solver_spec["focal"].cuda(),
                                                (IMG_H, IMG_W), cfg, idx=idx.cuda())
        finally:
            dist.destroy_process_group()
        same1 = bool(torch.equal(one.pose_w2c6, ref.pose_w2c6))
        log(f"(e) world-size-1 group: backend {nccl}, all_reduce {t.tolist()}, sharded solver "
            f"equal to solve_batch: {same1}")
        if nccl != "nccl" or t.tolist() != [0.0, 1.0, 2.0, 3.0] or not same1:
            raise AssertionError("the NCCL group is off")

        # (g) data-parallel eval over [cuda:0, cuda:0]: batches of 5 and 3, padded
        # to 6 and 4. cuDNN's f32 convs round by batch size (the one-device
        # eval at batch 8 and at 5 differ so too) and the seeded net's solves
        # amplify it, so the card holds the two parts apart: the coordinates
        # to f32 rounding, and the poses exactly against one solve per CLI
        # batch of the data-parallel run's own coordinates with the draws the
        # CLI makes (generator 2021, once per batch)
        runs = {}
        for tag, devices in (("one", None), ("two", ["cuda:0", "cuda:0"])):
            d = os.path.join(work, f"eval_{tag}")
            os.makedirs(d)
            shutil.copy(os.path.join(out_a, "model.net"), d)
            log_g = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                                   "--network_in", os.path.join(d, "model.net"), "--section",
                                   "val_drone_real", "--datasets_dir", datasets, "--batch_size",
                                   "5", "--save_pred", "--device", "cuda"], devices=devices)[0]
            pred = os.path.join(d, "coord_pred_model.net_val_drone_real")
            runs[tag] = dict(text=open(log_g).read().replace(d, ""), preds=[
                np.load(os.path.join(pred, f)) for f in sorted(os.listdir(pred))])
        c_one = np.stack([p["coord_pred"] for p in runs["one"]["preds"]])
        c_two = np.stack([p["coord_pred"] for p in runs["two"]["preds"]])
        d_coord = float(np.abs(c_one - c_two).max())
        gen = torch.Generator(device="cuda").manual_seed(2021)
        d_pose = 0.0
        for lo, hi in ((0, 5), (5, BATCH)):
            c = torch.from_numpy(c_two[lo:hi]).permute(0, 2, 3, 1).contiguous().cuda()
            idx = torch.randint(0, c.shape[1] * c.shape[2],
                                (hi - lo, cfg.hypotheses * cfg.sample_rounds, 4),
                                generator=gen, device="cuda")
            res = ransac.solve_batch(c, torch.from_numpy(val["focal"][lo:hi]).cuda(),
                                     (IMG_H, IMG_W), cfg, idx=idx)
            got = np.stack([p["pose_pred"] for p in runs["two"]["preds"][lo:hi]])
            ref_p = res.cam_to_world.cpu().numpy()
            d_pose = max(d_pose, float((np.abs(got - ref_p) / np.maximum(np.abs(ref_p), 1.0))
                                       .max()))
        same_lines = sum(a == b for a, b in zip(runs["one"]["text"].splitlines(),
                                                runs["two"]["text"].splitlines()))
        log(f"(g) data-parallel eval over [cuda:0, cuda:0], batches of 5 and 3: coordinates "
            f"max |diff| {d_coord:.3e} m against one device (limit {1e-5 * np.abs(c_one).max():.3e}"
            f" = 1e-5 of max |coord|); poses against one solve per batch of its coordinates and "
            f"the CLI's draws: max relative |diff| {d_pose:.2e} (limit 1e-5); report lines equal "
            f"to the one-device run's: {same_lines} of {len(runs['one']['text'].splitlines())}")
        if d_coord > 1e-5 * np.abs(c_one).max() or d_pose > 1e-5:
            raise AssertionError("data-parallel eval is off")

        if torch.cuda.device_count() > 1:
            x = torch.randn(2, 60, 90, 512, device="cuda:1")
            s, b = torch.rand(512, device="cuda:1") + 0.5, torch.randn(512, device="cuda:1")
            err = float((ops.group_norm_relu(x, s, b) - ops.group_norm_relu_plain(
                x, s, b, 32)).abs().max())
            log(f"K1 on cuda:1 against its plain version: max_abs_err {err:.2e}")
            if err > 1e-4:
                raise AssertionError("K1 on the second card is off")
        else:
            log("one card: K1 on a second device ordinal waits for a machine with two")

        times = dict(dp_cli_step_ms=ms_a, zero_cli_step_ms=ms_c, dp_step_ms=dp["step_ms"],
                     zero_step_ms=zero["step_ms"])
        log(f"step times, two ranks on one card, not a scaling figure ({smi}): per global step "
            f"of {B}, rank 0's wall from the step's start to its loss, steps 2-3: DP "
            f"{dp['step_ms'][1]:.2f}, {dp['step_ms'][2]:.2f} ms, ZeRO {zero['step_ms'][1]:.2f}, "
            f"{zero['step_ms'][2]:.2f} ms; through the CLI (rank 0's Avg Time x {B}, 1 ms "
            f"granularity x {B}, the first step left out): DP {ms_a}, ZeRO {ms_c}")
        with open(os.path.join(self.out_dir, "parallel.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=smi, note="two ranks on one card, not "
                           "a scaling figure", batch=B, **times, grad_err_dp=err_dp,
                           grad_err_zero=err_zero, grad_tol=tol, grad_spread=spread,
                           grad_max=gmax, zero_update_max=upd[-1], solver_pose_rel=d6,
                           launches_per_rank=dict(dp=fwd_a, bwd=bwd_a)), f, indent=1)
        shutil.rmtree(work, ignore_errors=True)

    # -- the mesh's spatial and model axes -------------------------------------
    def phase_spatial(self):
        """The cross-shard kernels against their twins at the net's shapes,
        the 2-rank spatial step against one process, and the dry run on four
        ranks (module docstring)."""
        import torch

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.tools import parallel_check as pc
        from crossloc_tpu_torch.tools.multichip import dryrun_multichip

        B, smi = SPATIAL_BATCH, nvidia_smi_line()
        self._shard_kernels(B)

        # (2) two ranks, spatial 2, against one process
        work = WORK_DIR + "_spatial"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        data.write_fake_dataset(os.path.join(datasets, "urbanscape", "train_sim"), n=B,
                                img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=0, scene="plane")
        batch = self._train_batch(datasets, B, "cpu")
        spec = dict(state_dict=self._model("cpu").state_dict(),
                    batch=dict(images=batch.images, poses=batch.poses, labels=batch.labels,
                               focal=batch.focal, pp_shift=batch.pp_shift),
                    kind="coord", uncertainty="MLE",
                    mean=list(data.get_label_mean("urbanscape", "coord")), tiny=False,
                    zero=False, steps=3, lr=2e-4, device="cuda", mesh=dict(data=1, spatial=2),
                    profile=True)  # the third step traced on each rank
        out = os.path.join(work, "step.pt")
        t0 = time.perf_counter()
        pc.run_ranks(pc.step_check, 2, (spec, out), device="cuda", timeout=300, threads=4)
        log(f"(2) two ranks of one group (spatial 2): {time.perf_counter() - t0:.1f} s")
        sp = torch.load(out, weights_only=False)
        one = dict(spec, mesh=None, steps=0, profile=False)
        ref1, ref2 = pc.step_check(dict(one, steps=1)), pc.step_check(one)

        def halves_of(run):
            """The mean gradient of the batch's two halves, each one step."""
            hs = [run(dict(one, batch={k: (v[s] if v.dim() and k in (
                "images", "poses", "labels") else v) for k, v in spec["batch"].items()}))
                for s in (slice(0, B // 2), slice(B // 2, B))]
            return {n: (hs[0]["grads"][n] + hs[1]["grads"][n]) / 2 for n in ref1["grads"]}

        split = halves_of(pc.step_check)
        # the same steps with the stems' norms on the designs they took before
        # the grid design (three-pass, four-kernel: still the port's beyond
        # the grid's reach): another reduction order of one process
        with _old_stem_designs():
            old1 = pc.step_check(dict(one, steps=1))
            old_split = halves_of(pc.step_check)

        def dist_max(a, b):
            return max(float((a[n].double() - b[n].double()).abs().max()) for n in a)

        gmax = max(float(g.abs().max()) for g in ref1["grads"].values())
        spreads = {"between two runs": dist_max(ref1["grads"], ref2["grads"]),
                   "against the two halves": dist_max(ref1["grads"], split),
                   "against the stems' old designs": dist_max(ref1["grads"], old1["grads"]),
                   "the old designs against their two halves": dist_max(old1["grads"], old_split)}
        spread = max(spreads.values())
        tol = max(2 * spread, 1e-6 * gmax)
        err = dist_max(sp["grads"], ref1["grads"])
        pmax = float(ref1["preds"].abs().max())
        fwd_err = float((sp["preds"] - ref1["preds"]).abs().max())
        first = ref1["loss"][0]
        d_loss = abs(sp["loss"][0] - first) / abs(first)
        ranks = sp["by_rank"]  # each rank's own counts, per step
        counts = [[dict(zip(SHARD_ENTRIES, c)) for c in r["shard_launches"]] for r in ranks]
        self.launches["spatial"] = {n: sum(c[i] for r in ranks for c in r["shard_launches"])
                                    for i, n in enumerate(SHARD_ENTRIES)}
        walls = sp["step_ms"][:-1]  # the traced step's wall is the profile's
        prof = [r["profile"] for r in ranks]
        log(f"(2) spatial 2, global B={B} at {IMG_H}x{IMG_W}: forward max |diff| {fwd_err:.3e} "
            f"against one process (limit {1e-4 * pmax:.3e} = 1e-4 of max |pred|); gradient max "
            f"|diff| {err:.3e} (limit {tol:.3e} = 2 x the spread of single-process gradients: "
            + ", ".join(f"{v:.3e} {k}" for k, v in spreads.items()) + f"; max |g| {gmax:.3e}); "
            f"first step's loss {sp['loss'][0]:.6f} against {first:.6f} (relative {d_loss:.2e}, "
            f"limit 1e-5); launches per step, each rank's own: cross-shard "
            f"{[r['shard_launches'] for r in ranks]}, K1 / K1-bwd "
            f"{[r['launches'] for r in ranks]}; backend {sp['backend']}")
        if fwd_err > 1e-4 * pmax or err > tol or d_loss > 1e-5:
            raise AssertionError("the spatial step disagrees with one process")
        if (any(n != 28 for r in counts for c in r for n in c.values())
                or any(set(r["launches"]) != {(0, 0)} for r in ranks)):
            raise AssertionError("the spatial step did not run 28 launches of each cross-shard "
                                 "entry per step on every rank (and none of the unsharded K1)")
        log(f"(2) the third step traced on each rank (torch.profiler, {smi}): " + "; ".join(
            f"rank {i}: wall {p['wall_ms']:.2f} ms to the end of its device work, its kernels "
            f"{p['kernel_ms']:.2f} ms ({p['kernels']} launches), its copies and memsets "
            f"{p['copy_ms']:.2f} ms, the rest {p['wall_ms'] - p['kernel_ms'] - p['copy_ms']:.2f} "
            f"ms" for i, p in enumerate(prof)))

        # (3) the dry run on four ranks of the card
        t0 = time.perf_counter()
        dry = dryrun_multichip(4, "cuda", timeout=300)
        log(f"(3) dryrun_multichip(4, 'cuda') in {time.perf_counter() - t0:.1f} s: " + json.dumps(
            {k: v for k, v in dry.items() if k != "device"}))

        log(f"(4) walls per global step, ranks sharing one card over gloo, not a scaling figure "
            f"({smi}): spatial 2 at B={B} {IMG_H}x{IMG_W}, rank 0's step from its start to its "
            f"loss: {', '.join(f'{t:.2f}' for t in walls)} ms; dry run (full net, "
            f"64x96, B=4, one step each, the first): data 2 x spatial 2 "
            f"{dry['spatial_step_ms']:.2f} ms, data 2 x model 2 {dry['model_step_ms']:.2f} ms")
        with open(os.path.join(self.out_dir, "spatial.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=smi, note="ranks sharing one card, not "
                           "a scaling figure", batch=B, step_ms=walls, profile=prof,
                           grad_err=err, grad_tol=tol, grad_spread=spread, grad_max=gmax,
                           forward_err=fwd_err, loss=sp["loss"], loss_one_process=first,
                           launches_by_rank_step=counts, dryrun=dry), f, indent=1)
        shutil.rmtree(work, ignore_errors=True)

    def _shard_kernels(self, B):
        """(1) of the spatial phase: the four cross-shard entries at each
        Conv->GN input of the coord net at 480x720 (f32), split into 2 and 4
        row blocks; each entry against its twin on the same inputs, the
        blocks merged against the plain K1 twin on the whole image; at 2
        blocks, in f32 and in bf16, `_shard_times` (the kernels per call,
        each entry and each direction's warm pair timed beside the bounds);
        the totals over the net's 28 calls and the kernels line's rows."""
        import torch

        from crossloc_tpu_torch import ops

        flush_buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
        flush = flush_buf.zero_  # the L2 evicted by a write, as in the kernels phase
        gen = torch.Generator(device="cuda").manual_seed(11)
        worst = {n: 0.0 for n in SHARD_ENTRIES}
        rows = []
        for C, H, W, relu, count in GN_PATH_SHAPES:
            G = min(32, C)
            x = torch.randn(B, H, W, C, device="cuda", generator=gen) * 2.0 + 3.0
            s = torch.rand(C, device="cuda", generator=gen) + 0.5
            b = torch.randn(C, device="cuda", generator=gen)
            # dy is zero where the plain pre-activation lies within 1e-3 of the
            # ReLU's kink: the merged statistics round in another order than the
            # whole image's, which may flip the mask of such a cell
            pre = ops.group_norm_relu_plain(x, s, b, G, 1e-5, False)
            dy = torch.randn(B, H, W, C, device="cuda", generator=gen) * (pre.abs() > 1e-3)
            del pre
            whole = ops.group_norm_relu_plain(x, s, b, G, 1e-5, relu)
            dx_w, ds_w, db_w = ops.group_norm_relu_backward_plain(x, s, b, dy, G, 1e-5, relu)
            for S in (2, 4):
                xs = [t.contiguous() for t in x.chunk(S, 1)]
                dys = [t.contiguous() for t in dy.chunk(S, 1)]
                st = torch.stack([ops.group_norm_shard_stats(t, G) for t in xs])
                st_p = torch.stack([ops.group_norm_shard_stats_plain(t, G) for t in xs])
                # mean and variance of each block: O(1) numbers beside the M2 sums
                e_st = float(torch.cat([(st[..., 1] - st_p[..., 1]).abs(),
                                        (st[..., 2] / st[..., 0] - st_p[..., 2] / st_p[..., 0])
                                        .abs()]).max())
                ys, stats, e_y = [], [], 0.0
                for t in xs:
                    y, so = ops.group_norm_shard_apply(t, s, b, st, G, 1e-5, relu)
                    yp, _ = ops.group_norm_shard_apply_plain(t, s, b, st, G, 1e-5, relu)
                    e_y = max(e_y, float((y - yp).abs().max()))
                    ys.append(y)
                    stats.append(so)
                e_whole = float((torch.cat(ys, 1) - whole).abs().max())
                sums = torch.stack([ops.group_norm_shard_backward_sums(t, s, b, so, d, G, relu)
                                    for t, so, d in zip(xs, stats, dys)])
                sums_p = torch.stack([ops.group_norm_shard_backward_sums_plain(
                    t, s, b, so, d, G, relu) for t, so, d in zip(xs, stats, dys)])
                e_sums = float((sums - sums_p).abs().max())
                smax = float(sums_p.abs().max())
                dxs, ds, db, e_dx = [], 0, 0, 0.0
                for i, (t, so, d) in enumerate(zip(xs, stats, dys)):
                    got = ops.group_norm_shard_backward_apply(t, s, b, so, d, sums, i, G, H * W,
                                                              relu)
                    ref = ops.group_norm_shard_backward_apply_plain(t, s, b, so, d, sums, i, G,
                                                                    H * W, relu)
                    e_dx = max(e_dx, float((got[0] - ref[0]).abs().max()))
                    dxs.append(got[0])
                    ds, db = ds + got[1], db + got[2]
                e_dx_whole = float((torch.cat(dxs, 1) - dx_w).abs().max())
                e_dsb = max(float((ds - ds_w).abs().max()) / float(ds_w.abs().max()),
                            float((db - db_w).abs().max()) / float(db_w.abs().max()))
                dxmax = float(dx_w.abs().max())
                torch.cuda.synchronize()
                for n, e in zip(SHARD_ENTRIES, (e_st, e_y, e_sums, e_dx)):
                    worst[n] = max(worst[n], e)
                ok = (e_st <= 1e-4 and e_y <= 1e-4 and e_whole <= 1e-4 and e_sums <= 1e-4 * smax
                      and e_dx <= 1e-4 * dxmax and e_dx_whole <= 1e-4 * dxmax and e_dsb <= 1e-4)
                log(f"  cross-shard C={C} {H}x{W} B={B} relu={relu}, {S} blocks: stats "
                    f"{e_st:.2e} (mean, var), apply {e_y:.2e}, merged against the whole image "
                    f"{e_whole:.2e} (limits 1e-4); bwd sums {e_sums:.2e} (limit 1e-4 x "
                    f"{smax:.3g}), bwd apply dx {e_dx:.2e}, merged dx {e_dx_whole:.2e} (limits "
                    f"1e-4 x {dxmax:.3g}), dscale/dbias relative {e_dsb:.2e} (limit 1e-4) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"cross-shard entries disagree at C={C} {H}x{W} {S} "
                                         f"blocks relu={relu}")
            # timing at 2 blocks: one block's calls, as one rank of spatial 2
            # runs them, in f32 (the kernels line's rows) and in bf16
            row = dict(C=C, H=H // 2, W=W, B=B, relu=relu, per_forward=count)
            row.update(self._shard_times(x, dy, s, b, G, relu, flush, C in (32, 512) and relu))
            del whole, dx_w
            # bf16: dy zero near the kink of the bf16 input's own pre-activation
            x = x.bfloat16()
            pre = ops.group_norm_relu_plain(x, s, b, G, 1e-5, False)
            dy = (dy * (pre.abs() > 1e-3)).bfloat16()
            del pre
            row["bfloat16"] = self._shard_times(x, dy, s, b, G, relu, flush,
                                                C in (32, 512) and relu)
            rows.append(row)
            del x, dy
        keys = ("fwd_bound_ms", "fwd_split_ms", "bwd_bound_ms", "bwd_split_ms", "warm_fwd_ms",
                "warm_bwd_ms", "copy_fwd_ms", "copy_bwd_ms")
        tot, pair = {}, {}
        for dname, get in (("float32", lambda r: r), ("bfloat16", lambda r: r["bfloat16"])):
            tot[dname] = {k: {n: sum(r["per_forward"] * get(r)[k][n] for r in rows)
                              for n in SHARD_ENTRIES} for k in ("ms", "bound_ms")}
            pair[dname] = {k: sum(r["per_forward"] * get(r)[k] for r in rows) for k in keys}
            t, p = tot[dname]["ms"], pair[dname]
            log(f"cross-shard entries over one {dname} forward and backward's 28 calls of one "
                f"rank of spatial 2 (B={B}, a 240x720 block of 480x720), device time: cold (L2 "
                f"evicted before each call) "
                + ", ".join(f"{n} {t[n]:.4f} ms (bound {tot[dname]['bound_ms'][n]:.4f})"
                            for n in SHARD_ENTRIES)
                + f"; forward pair cold {t[SHARD_ENTRIES[0]] + t[SHARD_ENTRIES[1]]:.4f} ms, warm "
                f"{p['warm_fwd_ms']:.4f} ms (one graph: flush, stats, the gathered copy "
                f"{p['copy_fwd_ms']:.4f} ms, apply) against one read + one write "
                f"{p['fwd_bound_ms']:.4f} ms and the split's own traffic {p['fwd_split_ms']:.4f} "
                f"ms; backward pair cold {t[SHARD_ENTRIES[2]] + t[SHARD_ENTRIES[3]]:.4f} ms, warm "
                f"{p['warm_bwd_ms']:.4f} ms (copy {p['copy_bwd_ms']:.4f} ms) against "
                f"{p['bwd_bound_ms']:.4f} / {p['bwd_split_ms']:.4f} ms")
        f32 = tot["float32"]
        plain = {n: sum(r["per_forward"] * r["plain_ms"][n] for r in rows) for n in SHARD_ENTRIES}
        extra = {k: sum(r["per_forward"] * r[k] for r in rows)
                 for k in ("k1_whole_ms", "library_stats_ms")}
        extra["yardstick_ms"] = {k: sum(r["per_forward"] * r["yardstick_ms"][k] for r in rows)
                                 for k in YARDSTICKS}
        log(f"  f32 plain twins {', '.join(f'{n} {plain[n]:.4f} ms' for n in SHARD_ENTRIES)}; "
            f"the unsharded K1 on the whole images {extra['k1_whole_ms']:.4f} ms; torch.var_mean "
            f"in place of the stats {extra['library_stats_ms']:.4f} ms; PyTorch's passes over "
            f"the same blocks: "
            + ", ".join(f"{k} {extra['yardstick_ms'][k]:.4f} ms" for k in YARDSTICKS))
        per_call = {n: sorted({t["kernels_per_call"][n] for r in rows
                               for t in (r, r["bfloat16"]) if t["kernels_per_call"]})
                    for n in SHARD_ENTRIES}
        with open(os.path.join(self.out_dir, "k1_shard_shapes.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), rows=rows,
                           per_forward=tot, pairs=pair, plain_ms=plain, extra=extra,
                           worst=worst, kernels_per_call=per_call), f, indent=1)
        sources = dict(zip(SHARD_ENTRIES, ["crossloc_tpu/ops/pallas_groupnorm.py:57"] * 2
                           + ["crossloc_tpu/ops/pallas_groupnorm.py:141"] * 2))
        # no single library call computes the apply or the backward entries
        library = dict.fromkeys(SHARD_ENTRIES, None)
        library[SHARD_ENTRIES[0]] = extra["library_stats_ms"]
        for n in SHARD_ENTRIES:
            self.kernels[n] = dict(
                name=n, route="cuda", source="crossloc_tpu_torch/csrc/groupnorm.cu",
                replaces=sources[n], max_abs_err=worst[n], ms=f32["ms"][n], plain_ms=plain[n],
                library_ms=library[n], bound_ms=f32["bound_ms"][n], bound_by="bytes",
                cuda_kernels_per_call=per_call[n][0])

    @staticmethod
    def _kernels_per_call(fns, times: bool = False) -> list:
        """The names of the CUDA kernels one call of each fn launches (with
        `times`, (name, device us) pairs): one torch.profiler session, the
        calls separated by a marker kernel (a fill of a one-element tensor);
        tried three times where the trace lost a marker (the card's profiler
        has returned an empty trace now and then)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        mark = torch.empty(1, device="cuda")
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for fn in fns:
                    mark.fill_(1.0)
                    fn()
                mark.fill_(1.0)
                torch.cuda.synchronize()
            events = sorted((e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA),
                            key=lambda e: e.time_range.start)
            groups = []
            for e in events:
                if "fill" in e.name.lower():
                    groups.append([])
                elif groups:
                    groups[-1].append((e.name, e.time_range.elapsed_us()) if times else e.name)
            if len(groups) == len(fns) + 1 and not groups[-1]:
                return groups[:-1]
        raise AssertionError(f"the profiler's trace lost markers: {[e.name for e in events]}")

    def _shard_times(self, x, dy, s, b, G, relu, flush, count_kernels):
        """One rank's block of spatial 2 (the upper half of x's rows): each
        cross-shard entry's device time with the L2 evicted before every call
        (CUDA graphs), its bytes bound, and each direction's warm pair (one
        graph a repetition: a flush, the first entry, a device copy of this
        rank's part of the gathered tensor standing in for the exchange, the
        second entry) beside the pair bounds; in f32 also the plain twins, the
        unsharded K1 on the whole image, torch.var_mean in place of the stats,
        and PyTorch's sum, copy and add of the block as yardsticks. With `count_kernels`, the CUDA kernels of one call of each
        entry (torch.profiler), which must be one. The bf16 entries are held
        against their twins here (f32 outputs to 1e-4 of their scale, bf16
        ones to one rounding: 1e-2 + 2^-7 relative)."""
        import torch

        from crossloc_tpu_torch import ops

        f32 = x.dtype == torch.float32
        B, H, W, C = x.shape
        xs = [t.contiguous() for t in x.chunk(2, 1)]
        d0 = dy.chunk(2, 1)[0].contiguous()
        st = torch.stack([ops.group_norm_shard_stats(t, G) for t in xs])
        _, so = ops.group_norm_shard_apply(xs[0], s, b, st, G, 1e-5, relu)
        own = ops.group_norm_shard_backward_sums(xs[0], s, b, so, d0, G, relu)
        sums = torch.stack([own, own])
        entries = [
            (lambda: ops.group_norm_shard_stats(xs[0], G),
             lambda: ops.group_norm_shard_stats_plain(xs[0], G)),
            (lambda: ops.group_norm_shard_apply(xs[0], s, b, st, G, 1e-5, relu),
             lambda: ops.group_norm_shard_apply_plain(xs[0], s, b, st, G, 1e-5, relu)),
            (lambda: ops.group_norm_shard_backward_sums(xs[0], s, b, so, d0, G, relu),
             lambda: ops.group_norm_shard_backward_sums_plain(xs[0], s, b, so, d0, G, relu)),
            (lambda: ops.group_norm_shard_backward_apply(xs[0], s, b, so, d0, sums, 0, G, H * W,
                                                         relu),
             lambda: ops.group_norm_shard_backward_apply_plain(xs[0], s, b, so, d0, sums, 0, G,
                                                               H * W, relu))]
        if not f32:
            for i, (n, (kern, twin)) in enumerate(zip(SHARD_ENTRIES, entries)):
                for got, ref in zip(*(o if isinstance(o, tuple) else (o,)
                                      for o in (kern(), twin()))):
                    bf16_out = got.dtype == x.dtype
                    got, ref = got.float(), ref.float()
                    err = (got - ref).abs()
                    if bf16_out:  # y, dx: one bf16 rounding apart
                        ok = bool((err <= 1e-2 + 2.0**-7 * ref.abs()).all())
                    elif i == 0:  # (count, mean, M2): each to 1e-4 of itself
                        ok = bool((err <= 1e-4 * ref.abs().clamp(min=1.0)).all())
                    else:  # f32 statistics and sums: to 1e-4 of their scale
                        ok = float(err.max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
                    if not ok:
                        raise AssertionError(f"{n} disagrees with its twin in bf16 at C={C} "
                                             f"{H // 2}x{W} B={B} relu={relu}: max |diff| "
                                             f"{float(err.max()):.3e}")
        counts = {}
        if count_kernels:
            for n, names in zip(SHARD_ENTRIES, self._kernels_per_call([e[0] for e in entries])):
                counts[n] = len(names)
                log(f"  {n} C={C} {H // 2}x{W} B={B} {str(x.dtype)[6:]}: one call launches "
                    f"{len(names)} CUDA kernel(s): {sorted(set(names))}")
                if len(names) != 1:
                    raise AssertionError(f"{n} launched {len(names)} CUDA kernels in one call")
        gfwd = st.clone()
        gbwd = sums.clone()

        def fwd_pair():
            gfwd[0].copy_(ops.group_norm_shard_stats(xs[0], G))
            ops.group_norm_shard_apply(xs[0], s, b, gfwd, G, 1e-5, relu)

        def bwd_pair():
            gbwd[0].copy_(ops.group_norm_shard_backward_sums(xs[0], s, b, so, d0, G, relu))
            ops.group_norm_shard_backward_apply(xs[0], s, b, so, d0, gbwd, 0, G, H * W, relu)

        kern = device_ms([e[0] for e in entries], flush)
        warm_fwd, warm_bwd, copy_fwd, copy_bwd = device_ms(
            [fwd_pair, bwd_pair, lambda: gfwd[0].copy_(st[1]), lambda: gbwd[0].copy_(own)], flush)
        n_el, item = xs[0].numel(), x.element_size()
        # each entry's least traffic: what it must read and write once
        moved = [n_el * item + B * G * 3 * 4,
                 2 * n_el * item + S_GATHER * B * G * 3 * 4 + 2 * C * 4,
                 2 * n_el * item + B * 2 * C * 4,
                 3 * n_el * item + S_GATHER * B * 2 * C * 4 + 2 * C * 4]
        ops_per = [4, 6, 8, 10]  # fp32 operations per element of x
        bound = [1e3 * max(m / HBM_BYTES_PER_S, o * n_el / FP32_FLOPS)
                 for m, o in zip(moved, ops_per)]
        out = dict(ms=dict(zip(SHARD_ENTRIES, kern)), bound_ms=dict(zip(SHARD_ENTRIES, bound)),
                   fwd_bound_ms=1e3 * 2 * n_el * item / HBM_BYTES_PER_S,
                   fwd_split_ms=1e3 * 3 * n_el * item / HBM_BYTES_PER_S,
                   bwd_bound_ms=1e3 * 3 * n_el * item / HBM_BYTES_PER_S,
                   bwd_split_ms=1e3 * 5 * n_el * item / HBM_BYTES_PER_S,
                   warm_fwd_ms=warm_fwd, warm_bwd_ms=warm_bwd, copy_fwd_ms=copy_fwd,
                   copy_bwd_ms=copy_bwd, kernels_per_call=counts)
        if f32:
            plain = device_ms([e[1] for e in entries], flush, n=5)
            k1_whole = device_ms([lambda: ops.group_norm_relu(x, s, b, G, 1e-5, relu)], flush)[0]
            # the one library call that computes an entry's function: the stats'
            # per-(image, group) mean and variance (M2 is variance x count)
            lib_stats = device_ms([lambda: torch.var_mean(
                xs[0].view(B, H // 2 * W, G, C // G), dim=(1, 3), correction=0)], flush)[0]
            # PyTorch's own passes over the same bytes, yardsticks beside the
            # entries: a sum of x (the stats' read), a copy of x (the apply's
            # read and write) and x + dy (the backward apply's three tensors)
            buf = torch.empty_like(xs[0])
            yard = device_ms([lambda: xs[0].sum(), lambda: buf.copy_(xs[0]),
                              lambda: torch.add(xs[0], d0, out=buf)], flush)
            out.update(plain_ms=dict(zip(SHARD_ENTRIES, plain)), k1_whole_ms=k1_whole,
                       library_stats_ms=lib_stats, yardstick_ms=dict(zip(YARDSTICKS, yard)))
        log(f"  cross-shard time C={C} {H // 2}x{W} (a block of {H}) B={B} {str(x.dtype)[6:]} "
            f"relu={relu} [{ops.groupnorm._shard_plan(B, H // 2 * W, C, G, x.dtype, 1)}; "
            f"backward {ops.groupnorm._shard_plan(B, H // 2 * W, C, G, x.dtype, 2)}]: "
            + ", ".join(f"{n} {kern[i]:.4f} ms (bound {bound[i]:.4f})"
                        for i, n in enumerate(SHARD_ENTRIES))
            + f"; forward pair cold {kern[0] + kern[1]:.4f} ms, warm {warm_fwd:.4f} ms (copy "
            f"{copy_fwd:.4f}) against one read of x and one write of y "
            f"{out['fwd_bound_ms']:.4f} ms and the split's two reads {out['fwd_split_ms']:.4f} "
            f"ms; backward pair cold {kern[2] + kern[3]:.4f} ms, warm {warm_bwd:.4f} ms (copy "
            f"{copy_bwd:.4f}) against {out['bwd_bound_ms']:.4f} / {out['bwd_split_ms']:.4f} ms"
            + (f"; plain {', '.join(f'{p:.4f}' for p in plain)} ms; unsharded K1 on the whole "
               f"image {k1_whole:.4f} ms; torch.var_mean on the block {lib_stats:.4f} ms; "
               f"PyTorch's sum, copy and x + dy of the block {', '.join(f'{t:.4f}' for t in yard)}"
               f" ms" if f32 else ""))
        return out

    def _run_cli(self, main, work, args):
        """A training CLI's `main(args)` in process, in `work`, with the launch
        counts set to 0 just before it; (output dir, logged losses, K1 and
        K1-bwd launches, wall s). Every CLI turns TF32 off itself (ROADMAP
        F1): checked after each run."""
        import re

        import torch

        from crossloc_tpu_torch import ops

        cwd = os.getcwd()
        os.chdir(work)
        ops.group_norm_relu.launches = 0
        ops.group_norm_relu_backward.launches = 0
        t = time.perf_counter()
        try:
            out_dir = main(args)
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t
        fwd, bwd = ops.group_norm_relu.launches, ops.group_norm_relu_backward.launches
        tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        if any(tf32):
            raise AssertionError(f"the CLI left TF32 on: cudnn {tf32[0]}, matmul {tf32[1]}")
        text = open(os.path.join(out_dir, "output.log")).read()
        losses = [float(v) for v in re.findall(r"Total loss: ([-\w.]+),", text)]
        return out_dir, losses, fwd, bwd, wall

    def _task_train(self, task, datasets, work, session, extra):
        """The training CLI on cuda with `encoder_pretrain.sh`'s flags for
        `task` (`_run_cli`)."""
        from crossloc_tpu_torch.cli import train_single_task as train_cli

        return self._run_cli(train_cli.main, work, [
            "urbanscape", "--task", task, *TASK_FLAGS[task], "--learningrate", "2e-4",
            "--batch_size", str(TRAIN_BATCH), "--auto_resume", "--sim_data_chunk", "1.0",
            "--real_data_chunk", "0.0", "--datasets_dir", datasets, "--image_height", str(IMG_H),
            "--ckpt_dir", os.path.join(work, "ckpts"), "--session", session, "--device", "cuda",
            *extra])

    def _task_run(self, task, datasets, work, extra):
        """Train `task` 2 epochs through the CLI (its K1 / K1-bwd launches
        per step counted), then serve its model.net on val_sim through the
        eval CLI (launches counted) and check the results file."""
        import re

        import torch

        from crossloc_tpu_torch import ops
        from crossloc_tpu_torch.cli import test_single_task as test_cli

        per_step = 29 if task == "semantics" else 28
        out_dir, losses, fwd, bwd, wall = self._task_train(task, datasets, work, "smoke",
                                                           ["--epochs", "2", *extra])
        steps = 4  # 2 epochs of 24 frames at B=12
        log(f"train_single_task --task {task} on cuda (B={TRAIN_BATCH}, {IMG_H}x{IMG_W}, f32, "
            f"2 epochs): {wall:.1f} s wall for {steps} steps, losses {losses}, {fwd} K1 and {bwd} "
            f"K1-bwd launches ({fwd / steps:g} and {bwd / steps:g} per step)")
        self.launches[f"tasks_{task}"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if fwd != per_step * steps or bwd != per_step * steps:
            raise AssertionError(f"expected {per_step} K1 and K1-bwd launches per step, got "
                                 f"{fwd}/{bwd} over {steps} steps")
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        for f in ("model.net", "FLAG_training_done.nodata"):
            if not os.path.exists(os.path.join(out_dir, f)):
                raise AssertionError(f"{f} not written")

        ops.group_norm_relu.launches = 0
        unc = "none" if task == "semantics" else "MLE"
        logs = test_cli.main(["urbanscape", "--task", task, "--uncertainty", unc,
                              *(["--fullsize"] if task == "semantics" else []), "--network_in",
                              os.path.join(out_dir, "model.net"), "--section", "val_sim",
                              "--datasets_dir", datasets, "--image_height", str(IMG_H),
                              "--device", "cuda"])
        torch.cuda.synchronize()
        served = ops.group_norm_relu.launches
        self.launches[f"tasks_serve_{task}"] = dict(groupnorm=served)
        text = open(logs[0]).read()
        heads = TASK_REPORT_LINES[task]
        nums = [float(v) for h in heads
                for v in re.findall(re.escape(h) + r"[^\n]*?(-?\d+\.\d+)", text)]
        log(f"served the {task} model.net on cuda: {logs[0]}, {served} K1 launches; "
            + "; ".join(line for line in text.splitlines() if line.startswith(heads)))
        if served != per_step or len(nums) != len(heads) or not all(map(math.isfinite, nums)):
            raise AssertionError(f"the {task} net did not serve: {served} K1 launches, {nums}")
        return dict(losses=losses, k1=fwd, k1_bwd=bwd, wall_s=wall, served_k1=served,
                    results=[ln for ln in text.splitlines() if ln.startswith(heads)])

    def _host_batch(self, datasets, n, section="train_sim", task="coord"):
        """(raw images, labels, poses, focal) of the first n frames of
        `section` as CPU tensors, the images read back from the batch's uint8
        wire; semantics labels as the training CLI sends
        them (uint8 class ids, [n, H, W, 1])."""
        import torch

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.cli.train_single_task import labels_to_wire

        b = data.CamLocDataset(os.path.join(datasets, "urbanscape", section), coord=task == "coord",
                               depth=task == "depth", normal=task == "normal",
                               semantics=task == "semantics", image_height=IMG_H).collate(range(n))
        labels = dict(b, **labels_to_wire(b, task))[task]
        return (data.images_from_wire(torch.from_numpy(b["image"])), torch.from_numpy(labels),
                torch.from_numpy(b["pose"]), torch.tensor(float(b["focal"][0])))

    def _train_batch(self, datasets, n, device, augment=True, seed=0, section="train_sim",
                     task="coord"):
        """(normalised images, poses, labels, focal, pp_shift) of the first n
        frames of `section`, augmented on the CPU with fixed draws, on `device`."""
        import torch

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.train import TrainBatch

        images, labels, poses, focal = self._host_batch(datasets, n, section, task)
        if augment:
            draws = data.draw_augmentation(torch.Generator().manual_seed(seed), n)
            images, labels, poses, focal, pp = data.augment_batch(
                images, labels, poses, focal, draws, semantics=task == "semantics")
        else:
            images, pp = data.normalize_images(images), None
        return TrainBatch(*(None if t is None else t.to(device)
                            for t in (images, poses, labels, focal, pp)))

    def _model(self, device, dtype=None, task="coord", unc="MLE"):
        """The training CLI's net for `task` (semantics full size), seeded."""
        import torch

        from crossloc_tpu_torch import data, models

        m = models.build_network(task, unc, fullsize=task == "semantics",
                                 mean=list(data.get_label_mean("urbanscape", task)))
        models.init_weights(m, torch.Generator().manual_seed(2021)).to(device)
        if dtype is not None:
            m.dtype = dtype
        return m.to(memory_format=torch.channels_last) if device == "cuda" else m

    def _mlr_model(self, device, dtype=None, donors=None):
        """The finetune CLI's net: three full-width towers, the first
        trainable, seeded MLR blocks; towers and decoder wired from the donor
        `.net` files when given."""
        import torch

        from crossloc_tpu_torch import data, models
        from crossloc_tpu_torch.cli import common

        m = models.build_network("coord", "MLE", num_mlr=3, num_unfrozen_encoder=1,
                                 mean=list(data.get_label_mean("urbanscape", "coord")))
        models.init_weights(m, torch.Generator().manual_seed(2021))
        if donors is not None:
            common.wire_mlr_weights(m, [donors[t] for t in FT_TASKS], True)
        m.to(device)
        if dtype is not None:
            m.dtype = dtype
        return m.to(memory_format=torch.channels_last) if device == "cuda" else m

    def _gradients_against_cpu(self, datasets, make_model=None, section="train_sim",
                               yardstick=("cpu",), task="coord", unc="MLE", step=None,
                               batch_size=2):
        """One step at full width, 480x720, B=2 (`batch_size`), same weights
        and batch: the card (K1, K1-bwd, TF32 off) against the CPU (plain
        twins) in float32, and both against a float64 run with the card's
        plain twins ("f64"). `step(state, batch)` is the update (default:
        `train_step` of the task). Only trainable parameters have a
        gradient; frozen ones must have none.
        Returns ({run: loss}, {run: {name: gradient}}).

        Four card runs, all reported: "card", the path as it runs, which the
        limit holds; "card_native", cuDNN off (PyTorch's own CUDA
        convolutions, im2col and an fp32 GEMM); "card_plain_bwd", K1's
        forward with the plain twin's backward; "card_plain", the plain twin
        for every norm. They tell the kernels' rounding from the rest of the
        card's. The f32 rounding the limit allows is the largest distance
        from float64 of the plain f32 runs named in `yardstick` (the CPU's,
        and for some nets also the card's plain twin's)."""
        import contextlib

        import torch

        from crossloc_tpu_torch.models import layers
        from crossloc_tpu_torch.ops import groupnorm as gn
        from crossloc_tpu_torch.train import TrainBatch, TrainState, make_optimizer, train_step

        @contextlib.contextmanager
        def variant(run):
            cudnn = torch.backends.cudnn.flags(enabled=run != "card_native", benchmark=False,
                                              deterministic=False, allow_tf32=False)
            saved = layers.group_norm_relu, gn.group_norm_relu_backward
            if run in ("card_plain", "f64"):
                layers.group_norm_relu = gn.group_norm_relu_plain
            if run == "card_plain_bwd":
                gn.group_norm_relu_backward = (
                    lambda x, s, b, st, dy, G, relu: gn.group_norm_relu_backward_plain(
                        x, s, b, dy, G, gn.GN_EPS, relu))
            try:
                with cudnn:
                    yield
            finally:
                layers.group_norm_relu, gn.group_norm_relu_backward = saved

        make_model = make_model or self._model
        step = step or (lambda state, b: train_step(state, b, task, unc))
        grads, losses = {}, {}
        batch = self._train_batch(datasets, batch_size, "cpu", section=section, task=task)
        cards = ("card", "card_native", "card_plain_bwd", "card_plain")
        for run, dev, dtype in ([(c, "cuda", torch.float32) for c in cards]
                                + [("cpu", "cpu", torch.float32), ("f64", "cuda", torch.float64)]):
            model = make_model(dev)
            if dtype == torch.float64:
                model.double().dtype = torch.float64
            trainable = [p for p in model.parameters() if p.requires_grad]
            state = TrainState(model, make_optimizer(trainable, 2e-4))
            b = TrainBatch(*(t.to(dev, dtype) for t in batch))
            t = time.perf_counter()
            with variant(run):
                m = step(state, b)
            losses[run] = float(m["loss"])
            named = dict(model.named_parameters())
            if any(p.grad is not None for p in named.values() if not p.requires_grad):
                raise AssertionError("a frozen parameter has a gradient")
            grads[run] = {k: p.grad.detach().double().cpu() for k, p in named.items()
                          if p.requires_grad}
            log(f"  one step, {run}: loss {losses[run]:.6f}, grad norm "
                f"{float(m['grad_norm']):.6f}, {len(grads[run])} of {len(named)} tensors "
                f"trainable, {time.perf_counter() - t:.1f} s")
            del model, state

        def dist(a, b):
            return {k: float((grads[a][k] - g).norm()) for k, g in grads[b].items()}

        norm = {k: float(g.norm()) for k, g in grads["cpu"].items()}
        total = float(torch.sqrt(sum(g.square().sum() for g in grads["f64"].values())))
        d_cpu64 = dist("cpu", "f64")
        d_yard = [dist(y, "f64") for y in yardstick]
        ref = {k: max(d[k] for d in d_yard) for k in norm}
        failed = False
        for card in cards:
            d_cc, d_c64 = dist(card, "cpu"), dist(card, "f64")
            rel = {k: d_cc[k] / max(norm[k], 1e-30) for k in norm}
            worst = sorted(rel, key=rel.get, reverse=True)[:4]
            log(f"{task} gradients {card} vs CPU (f32) at B={batch_size} {IMG_H}x{IMG_W}: "
                f"|g_card - g_cpu| / "
                f"|g_cpu| median {sorted(rel.values())[len(rel) // 2]:.3e} over {len(rel)} "
                f"tensors, {sum(v > 1e-3 for v in rel.values())} above 1e-3; worst "
                + ", ".join(f"{k} {rel[k]:.3e} (card vs f64 {d_c64[k] / norm[k]:.3e}, CPU f32 "
                            f"vs f64 {d_cpu64[k] / norm[k]:.3e}, |g| {norm[k]:.3e})"
                            for k in worst)
                + f"; global |g| {total:.3e}")
            # per tensor, the card within 1e-3 of the CPU's gradient, or no
            # further from the float64 gradient than 1e-3 of its norm plus
            # twice the f32 rounding allowed (for the coord net, the CPU f32
            # path's own distance from float64), plus 1e-6 of the global norm
            # (the bias of stem1's conv has a true gradient of zero: a
            # GroupNorm of one channel per group removes it)
            over = {name: [k for k in norm if rel[k] > 1e-3 and d_c64[k] > 1e-3 * norm[k]
                           + 2 * r[k] + 1e-6 * total]
                    for name, r in (("CPU f32 rounding", d_cpu64), ("yardstick", ref))}
            d_loss = abs(losses[card] - losses["cpu"]) / abs(losses["cpu"])
            log(f"  {card}: tensors over the limit with the CPU f32's rounding: "
                f"{over['CPU f32 rounding']}; with the rounding of {'/'.join(yardstick)}: "
                f"{over['yardstick']}; loss vs CPU rel {d_loss:.3e} (limit 1e-4)")
            failed = failed or (card == "card" and bool(over["yardstick"] or d_loss > 1e-4))
        if failed:
            raise AssertionError(f"{task}: card gradients disagree with the CPU's")
        return losses, grads

    def _fixed_batch_descends(self, datasets):
        import torch

        from crossloc_tpu_torch.train import TrainState, make_optimizer, train_step

        model = self._model("cuda")
        state = TrainState(model, make_optimizer(model.parameters(), 2e-4))
        batch = self._train_batch(datasets, 2, "cuda", augment=False)
        losses = [float(train_step(state, batch, "coord", "MLE")["loss"]) for _ in range(10)]
        log(f"10 steps on one fixed batch (B=2, no augmentation): losses "
            + ", ".join(f"{v:.2f}" for v in losses))
        if not losses[-1] < losses[0]:
            raise AssertionError("the loss did not go down on a fixed batch")

    def _step_time(self, datasets, make_model=None, batch_size=TRAIN_BATCH,
                   section="train_sim", out_name="train.json", task="coord", unc="MLE"):
        """One training step (augmentation of uint8 images, forward, loss,
        backward, Adam over the trainable parameters) at `batch_size`,
        between CUDA events, f32 (TF32 off) and bf16, with img/s and peak
        memory; returns {dtype: {ms, img_s, peak_gib}}."""
        import torch

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.train import TrainBatch, TrainState, make_optimizer, train_step

        make_model = make_model or self._model
        B = batch_size
        images, labels, poses, focal = (t.cuda() for t in self._host_batch(datasets, B, section,
                                                                             task))
        wire = torch.from_numpy(data.images_to_wire(images.cpu().numpy())).cuda()
        draws = data.draw_augmentation(torch.Generator().manual_seed(0), B).to("cuda")
        out = {}
        os.makedirs(self.out_dir, exist_ok=True)
        for dtype in (torch.float32, torch.bfloat16):
            model = make_model("cuda", dtype)
            trainable = [p for p in model.parameters() if p.requires_grad]
            state = TrainState(model, make_optimizer(trainable, 2e-4))

            def step():
                im, lab, po, fo, pp = data.augment_batch(data.images_from_wire(wire), labels,
                                                         poses, focal, draws,
                                                         semantics=task == "semantics")
                return train_step(state, TrainBatch(im, po, lab, fo, pp), task, unc)

            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(step, iters=5, warmup=2)
            peak = torch.cuda.max_memory_allocated() / 2**30
            name = str(dtype)[6:]
            out[name] = dict(ms=ms, img_s=1e3 * B / ms, peak_gib=peak)
            log(f"{out_name[:-5]} step ({task}) B={B} {IMG_H}x{IMG_W} {name} on {self.device_name} "
                f"({nvidia_smi_line()}): {ms:.2f} ms = {1e3 * B / ms:.1f} img/s, "
                f"peak memory {peak:.2f} GiB")
            del model, state
        with open(os.path.join(self.out_dir, out_name), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), batch=B, task=task,
                           steps=out), f, indent=1)
        return out

    # -- phase 10 ----------------------------------------------------------
    def phase_loader(self):
        """The host data path on the card machine: the probe, the native
        decoder's build and its bits against PIL, `tools/loader_bench.py`,
        the training CLI with each decoder, and `tools/bench.py`."""
        import numpy as np
        import torch

        from crossloc_tpu_torch import data, native, ops
        from crossloc_tpu_torch.data import dataset as tds
        from crossloc_tpu_torch.tools import bench, loader_bench

        probe = _host_probe()
        for k, v in probe.items():
            log(f"host probe: {k}: {v}")
        report = dict(device=self.device_name, smi=nvidia_smi_line(), probe=probe)
        t0 = time.perf_counter()
        built = native.ensure_built(quiet=False)
        report["native"] = dict(built=built, build_s=native.build_seconds,
                                wall_s=time.perf_counter() - t0, error=native.build_error(),
                                library=str(native.library_path()))
        if built:
            how = ("found built" if native.build_seconds is None
                   else f"built in {native.build_seconds:.2f} s (g++ -O3, no -march)")
            log(f"native decoder {how}: {native.library_path()}")
        elif probe["zlib_ok"]:
            raise AssertionError(f"zlib's header is there but the native decoder did not build: "
                                 f"{native.build_error()}")
        else:
            log("the card machine cannot build the native decoder: zlib's header is missing "
                f"({native.build_error().splitlines()[0]}); PIL alone below")
        if built and not native.jpeg():
            log("no jpeglib.h: the native decoder is built without libjpeg (PNG native, JPEG "
                "through PIL)")

        work = WORK_DIR + "_loader"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        scene = os.path.join(datasets, "urbanscape", "train_sim")
        t0 = time.perf_counter()
        data.write_fake_dataset(scene, n=LOADER_FRAMES, img_h=IMG_H, img_w=IMG_W, focal=480.0,
                                seed=0, scene="plane")
        log(f"wrote a {LOADER_FRAMES}-frame {IMG_H}x{IMG_W} plane scene in "
            f"{time.perf_counter() - t0:.1f} s")
        rgb = os.path.join(scene, "rgb")
        paths = [os.path.join(rgb, f) for f in sorted(os.listdir(rgb))]
        if built:
            same, worst = 0, 0.0
            for p in paths[:8]:
                img = native.load_image_std_height(p, IMG_H)  # the native decoder, no fallback
                same += int(img is not None and np.array_equal(
                    img, tds._resize_height(tds._load_image(p), IMG_H)))
                half = native.load_image_std_height(p, IMG_H // 2)
                if half is None:
                    raise AssertionError(f"the native decoder could not read {p}")
                worst = max(worst, float(np.abs(
                    half - tds._resize_height(tds._load_image(p), IMG_H // 2)).max()))
            log(f"native against PIL on 8 frames: {same}/8 the same bits at {IMG_H}x{IMG_W}; "
                f"resized to {IMG_H // 2} rows max |diff| {worst:.3e} (limit 1e-2)")
            report["native_vs_pil"] = dict(same_bits=same, resized_max_abs=worst)
            if same != 8 or not worst < 1e-2:
                raise AssertionError("the native decoder disagrees with PIL")

        steps_ms = {d: self.train_step_ms.get(d, STEP_MS_RECORDED[d]) for d in ("bfloat16", "float32")}
        source = "this run's train phase" if self.train_step_ms else "the recorded card run (PERF.md §5)"
        log(f"loader_bench with the coord step times of {source}: {steps_ms} ms")
        report["loader_bench"] = loader_bench.main([
            "--step-ms", str(steps_ms["bfloat16"]), str(steps_ms["float32"]),
            "--workdir", work])

        decoders = ["native", "PIL"] if built else ["PIL"]
        report["cli"] = {}
        for dec in decoders:
            report["cli"][dec] = r = self._loader_cli_run(dec, datasets, work)
            log(f"train_single_task --bf16 with the {dec} decoder (dataset says "
                f"{r['decoder']!r}, {r['fallbacks']} reads fell back to PIL): {r['steps']} steps, CLI wall {r['wall_s']:.2f} s = "
                f"{r['wall_ms_per_step']:.1f} ms a step, batch to batch {r['loop_ms_per_step']:.1f} "
                f"ms (median; mean {r['loop_ms_mean']:.1f}), waits on the loader "
                f"{r['wait_ms_per_step']:.2f} ms a step from each epoch's third batch on "
                f"({r['first_wait_ms']} ms for the first two), the uint8 wire conversion "
                f"{r['wire_ms_per_step']:.1f} ms a step on the main thread, "
                f"{r['k1_per_step']:g} + {r['k1_bwd_per_step']:g} norm launches a step")
            if r["decoder"] != dec:
                raise AssertionError(f"the dataset used {r['decoder']}, not {dec}")
            if r["fallbacks"]:
                raise AssertionError(f"{r['fallbacks']} images were read by PIL in the {dec} run")
            if r["k1_per_step"] != 28 or r["k1_bwd_per_step"] != 28:
                raise AssertionError("expected 28 + 28 norm launches a step")
            if r["launches"]:
                self.launches[f"loader_{dec}"] = r["launches"]

        report["bench_k1"] = self._bench_k1_check()
        ops.group_norm_relu.launches = 0
        out = bench.run(BENCH_BATCH, 10, "cuda")  # counts the timed batches' launches
        log(json.dumps(out))
        self.launches["bench"] = dict(groupnorm=ops.group_norm_relu.launches)
        report["bench"] = out
        if out["k1_launches_per_batch"] != 28 or not out["value"] > 0:
            raise AssertionError(f"bench: {out}")
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "loader.json"), "w") as f:
            json.dump(report, f, indent=1)
        shutil.rmtree(work, ignore_errors=True)

    def _bench_k1_check(self):
        """K1 at the shapes `tools/bench.py` gives it: the 28-layer path's
        six shapes at B=BENCH_BATCH in bf16, each at the path's ReLU, the
        whole batch in one launch (stem1 holds 1.4e9 elements, 2.8 GB) and
        held against the plain twin, which runs on chunks of images (the
        norm is per image) to bound its fp32 temporaries. The tolerance is
        `_forward_rows`' bf16 one."""
        import torch

        from crossloc_tpu_torch.ops import group_norm_relu, group_norm_relu_plain
        from crossloc_tpu_torch.ops.groupnorm import _plan

        gen = torch.Generator(device="cuda").manual_seed(3)
        B, chunk, rows = BENCH_BATCH, 16, []
        atol, rtol = 1e-2, 2.0**-7
        for C, H, W, relu, _ in GN_PATH_SHAPES:
            G = min(32, C)
            x = torch.empty(B, H, W, C, device="cuda", dtype=torch.bfloat16)
            for i in range(0, B, chunk):
                x[i:i + chunk] = torch.randn(x[i:i + chunk].shape, device="cuda",
                                             generator=gen) * 2.0 + 3.0
            scale = torch.randn(C, device="cuda", generator=gen)
            bias = torch.randn(C, device="cuda", generator=gen)
            y = group_norm_relu(x, scale, bias, G, 1e-5, relu)
            torch.cuda.synchronize()
            worst, ok = 0.0, True
            for i in range(0, B, chunk):
                ref = group_norm_relu_plain(x[i:i + chunk], scale, bias, G, 1e-5, relu).float()
                err = (y[i:i + chunk].float() - ref).abs()
                ok = ok and bool((err <= atol + rtol * ref.abs()).all())
                worst = max(worst, float(err.max()))
                del ref, err
            design = _plan(B, H, W, C, G, torch.bfloat16).design
            log(f"  K1 {design} C={C} {H}x{W} B={B} bfloat16 relu={relu} (bench's shape, "
                f"{x.numel():,} elements): max_abs_err={worst:.3e} (limit {atol:g} + "
                f"{rtol:g}*|ref|) {'ok' if ok else 'FAIL'}")
            rows.append(dict(C=C, H=H, W=W, B=B, relu=relu, design=design, elements=x.numel(),
                             max_abs_err=worst, ok=ok))
            del x, y
            torch.cuda.empty_cache()
            if not ok:
                raise AssertionError(f"K1 disagrees with plain at bench's C={C} {H}x{W} B={B}")
        return rows

    def _loader_cli_run(self, decoder, datasets, work):
        """The training CLI with encoder_pretrain.sh's settings, --bf16, 2
        epochs over the loader scene, with `decoder` ("PIL": the native
        decoder reported unavailable in-process). The Loader's iterator is
        wrapped to time each wait, and the CLI's `images_to_wire` to time the
        conversion; the dataset is taken from `build_train_loader` to read
        its `decoder` and its `fallbacks` (reads the native decoder left to
        PIL; none may happen in the native run)."""
        from crossloc_tpu_torch import native
        from crossloc_tpu_torch.cli import common
        from crossloc_tpu_torch.cli import train_single_task as train_cli
        from crossloc_tpu_torch.data import pipeline

        waits, yields, seen = [], [], {}  # per epoch: waits and the times batches came
        wire_s = []  # the CLI's uint8 wire conversion of each batch's images, main thread
        orig_iter, orig_build, orig_available, orig_wire = (
            pipeline.Loader.__iter__, common.build_train_loader, native.available,
            train_cli.images_to_wire)

        def timed_wire(images):
            t0 = time.perf_counter()
            out = orig_wire(images)
            wire_s.append(time.perf_counter() - t0)
            return out

        def timed_iter(loader):
            it = orig_iter(loader)
            waits.append([])
            yields.append([])
            while True:
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                waits[-1].append(t1 - t0)
                yields[-1].append(t1)
                yield batch

        def build(*a, **k):
            out = orig_build(*a, **k)
            seen["dataset"] = out[0]
            return out

        pipeline.Loader.__iter__ = timed_iter
        common.build_train_loader = build
        train_cli.images_to_wire = timed_wire
        if decoder == "PIL":
            native.available = lambda: False
        try:
            out_dir, losses, fwd, bwd, wall = self._run_cli(train_cli.main, work, PRETRAIN_ARGS + [
                "--datasets_dir", datasets, "--ckpt_dir", os.path.join(work, "ckpts"),
                "--session", f"loader_{decoder}", "--epochs", "2", "--bf16",
                "--image_height", str(IMG_H)])
        finally:
            pipeline.Loader.__iter__ = orig_iter
            common.build_train_loader = orig_build
            native.available = orig_available
            train_cli.images_to_wire = orig_wire
        steps = 2 * LOADER_FRAMES // TRAIN_BATCH
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"losses {losses}")
        # the CLI's device_prefetch pulls two batches at an epoch's start, then
        # one per step: the waits and batch-to-batch times from the third
        # batch on are the steady state (snapshots fall inside a few gaps)
        later = [w for ep in waits for w in ep[2:]]
        gaps = sorted(b - a for ep in yields for a, b in zip(ep[1:], ep[2:]))
        ds = seen["dataset"]
        return dict(decoder=ds.decoder, fallbacks=ds.fallbacks, steps=steps,
                    batches_per_epoch=[len(ep) for ep in waits],
                    wall_s=wall, wall_ms_per_step=1e3 * wall / steps,
                    loop_ms_per_step=1e3 * gaps[len(gaps) // 2],
                    loop_ms_mean=1e3 * sum(gaps) / len(gaps),
                    wait_ms_per_step=1e3 * sum(later) / len(later),
                    first_wait_ms=[round(1e3 * (ep[0] + ep[1]), 2) for ep in waits],
                    wire_ms_per_step=1e3 * sum(wire_s) / len(wire_s),
                    k1_per_step=fwd / steps, k1_bwd_per_step=bwd / steps,
                    launches=dict(groupnorm=fwd, groupnorm_backward=bwd), losses=losses)

    # -- extra phase, not in the default run ---------------------------------
    def phase_profile(self):
        """Where the time of one image -> pose batch, one training step (coord
        and semantics), one finetune step and one e2e step goes, by kernel
        group (torch.profiler), and the device's busy share of the wall time;
        first, the CUDA kernels of one K1 and K1-bwd call at the stems."""
        self._stem_kernels_per_call()
        self._profile_serve()
        self._profile_step(self._model, TRAIN_BATCH, "train")
        self._profile_step(lambda dev, dtype: self._model(dev, dtype, "semantics", None),
                           TRAIN_BATCH, "semantics", task="semantics")
        self._profile_step(self._mlr_model, FT_BATCH, "finetune")
        work, datasets = self._e2e_scene()
        for dtype in self._dtypes():
            self._profile_e2e(datasets, dtype)
        shutil.rmtree(work, ignore_errors=True)

    @staticmethod
    def _kernel_groups(prof):
        """(device busy ms, kernel count, {group: [launches, ms]}) of a trace."""
        import torch

        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        groups = {}
        for e in kernels:
            n = e.name.lower()
            key = ("K1-bwd groupnorm (grid)" if "gnb_grid" in n
                   else "K1-bwd groupnorm" if "gnb_" in n
                   else "K1 groupnorm (grid)" if "gn_grid" in n
                   else "K1 groupnorm" if any(k in n for k in ("gn_stats", "gn_finalize",
                                                               "gn_apply", "gn_cluster",
                                                               "gn_shard"))
                   else "conv" if any(k in n for k in ("fprop", "dgrad", "wgrad", "conv", "xmma",
                                                      "cutlass", "implicit_gemm", "cudnn"))
                   else "other")
            g = groups.setdefault(key, [0, 0.0])
            g[0] += 1
            g[1] += e.time_range.elapsed_us() / 1e3
        return sum(g[1] for g in groups.values()), len(kernels), groups

    def _profile_step(self, make_model, B, tag, task="coord"):
        """One training step (augmentation, forward, loss, backward, Adam) of
        `make_model`'s net at batch B, 480x720, f32 and bf16, on a seeded
        synthetic batch (semantics: class ids on the image canvas)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        from crossloc_tpu_torch import data
        from crossloc_tpu_torch.train import TrainBatch, TrainState, make_optimizer, train_step

        gen = torch.Generator(device="cuda").manual_seed(5)
        wire = torch.randint(0, 256, (B, IMG_H, IMG_W, 3), device="cuda", generator=gen,
                             dtype=torch.uint8)
        mean = torch.tensor(data.get_label_mean("urbanscape", "coord"), device="cuda")
        labels = mean + 20 * torch.randn(B, IMG_H // 8, IMG_W // 8, 3, device="cuda",
                                         generator=gen)
        if task == "semantics":
            labels = torch.randint(0, 6, (B, IMG_H, IMG_W, 1), device="cuda", generator=gen,
                                   dtype=torch.uint8)
        poses = torch.eye(4, device="cuda").repeat(B, 1, 1)
        poses[:, :3, 3] = mean - torch.tensor([0.0, 0.0, 90.0], device="cuda")
        focal = torch.tensor(480.0, device="cuda")
        draws = data.draw_augmentation(torch.Generator().manual_seed(0), B).to("cuda")
        for dtype in (torch.float32, torch.bfloat16):
            model = make_model("cuda", dtype)
            trainable = [p for p in model.parameters() if p.requires_grad]
            state = TrainState(model, make_optimizer(trainable, 2e-4))

            def step():
                im, lab, po, fo, pp = data.augment_batch(data.images_from_wire(wire), labels,
                                                         poses, focal, draws,
                                                         semantics=task == "semantics")
                return float(train_step(state, TrainBatch(im, po, lab, fo, pp), task,
                                        None if task == "semantics" else "MLE")["loss"])

            step(), step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy, n, groups = self._kernel_groups(prof)
            name = str(dtype)[6:]
            log(f"profile {tag} step {name} B={B} {IMG_H}x{IMG_W}: wall {wall:.2f} ms, device "
                f"busy {busy:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}, {n} "
                f"kernels; by group: " + ", ".join(
                    f"{k} {v[0]} launches {v[1]:.2f} ms" for k, v in sorted(groups.items())))
            with open(os.path.join(self.out_dir, f"profile_{tag}_{name}.txt"), "w") as f:
                f.write(f"{self.device_name} | {nvidia_smi_line()}\n")
                f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
            del model, state

    def _profile_serve(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from crossloc_tpu_torch import models, ransac
        from crossloc_tpu_torch.inference import make_localizer

        model = models.init_weights(models.build_network("coord", "MLE"),
                                    torch.Generator().manual_seed(2021))
        model.to("cuda").eval().to(memory_format=torch.channels_last)
        images = torch.rand(BATCH, IMG_H, IMG_W, 3, device="cuda")
        focal = torch.full((BATCH,), 480.0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(2021)
        localize = make_localizer(model, ransac.RansacConfig())
        for dtype in (torch.float32, torch.bfloat16):
            model.dtype = dtype
            localize(images, focal, generator=gen)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                localize(images, focal, generator=gen)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            busy, n_kernels, groups = self._kernel_groups(prof)
            log(f"profile {str(dtype)[6:]} B={BATCH} {IMG_H}x{IMG_W} net+solver: wall {wall:.2f} ms, "
                f"device busy {busy:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}, "
                f"{n_kernels} kernels; by group: "
                + ", ".join(f"{k} {v[0]} launches {v[1]:.2f} ms" for k, v in sorted(groups.items())))
            os.makedirs(self.out_dir, exist_ok=True)
            with open(os.path.join(self.out_dir, f"profile_{str(dtype)[6:]}.txt"), "w") as f:
                f.write(f"{self.device_name} | {nvidia_smi_line()}\n")
                f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
        model.dtype = torch.float32

    # -- phase: the harness arms ---------------------------------------------
    def phase_arms(self):
        """The eight scripts the earlier phases did not run, with their own
        flags, through the CLIs in process at full width (480x720, f32), one
        batch of frames per section and one epoch: encoder_finetune.sh in
        place (twice: the second run resumes), out of place,
        encoder_pretrain_{real,pairwise}_only.sh, decoder_finetune_{real,
        pairwise}_only.sh over the in-place finetune's coord net and seeded
        depth and normal donors, validate_encoder_finetune.sh and
        validate_encoder_pretrain_{real,pairwise}_only.sh (the eval CLI over
        each checkpoint folder, then select_ckpt); then the quickstart twin
        on cuda. Each run's K1 / K1-bwd launches are counted."""
        import re

        import numpy as np
        import torch

        from crossloc_tpu_torch import compat, data, models, ops
        from crossloc_tpu_torch.cli import finetune_decoder_single_task as ft_cli
        from crossloc_tpu_torch.cli import select_ckpt
        from crossloc_tpu_torch.cli import test_single_task as test_cli
        from crossloc_tpu_torch.cli import train_single_task as train_cli
        from crossloc_tpu_torch.examples import quickstart

        t_phase = time.perf_counter()
        work = WORK_DIR + "_arms"
        shutil.rmtree(work, ignore_errors=True)
        datasets = os.path.join(work, "datasets")
        ckpts = os.path.join(work, "ckpts")
        t0 = time.perf_counter()
        for seed, section in enumerate(ARM_SECTIONS):
            data.write_fake_dataset(os.path.join(datasets, "urbanscape", section),
                                    n=ARM_VAL_FRAMES if section.startswith("val") else ARM_FRAMES,
                                    img_h=IMG_H, img_w=IMG_W, focal=480.0, seed=seed,
                                    scene="plane")
        donors = {}
        for seed, task in enumerate(FT_TASKS):
            net = models.build_network(task, "MLE", mean=[0.0] * models.task_channels(task))
            models.init_weights(net, torch.Generator().manual_seed(seed))
            os.makedirs(os.path.join(work, "weights", task))
            donors[task] = os.path.join(work, "weights", task, "model.net")
            compat.save_net(donors[task], net)
        log(f"wrote {len(ARM_SECTIONS)} plane sections at {IMG_H}x{IMG_W} ({ARM_FRAMES} frames, "
            f"val {ARM_VAL_FRAMES}) and three full-width donors in "
            f"{time.perf_counter() - t0:.1f} s")
        common = ["--epochs", "1", "--datasets_dir", datasets, "--image_height", str(IMG_H),
                  "--ckpt_dir", ckpts, "--device", "cuda"]
        enc = ["urbanscape", "--task", "coord", *COORD_FLAGS, "--batch_size", str(TRAIN_BATCH),
               "--uncertainty", "MLE", "--auto_resume"]
        runs = {
            "encoder_finetune_ip": (train_cli.main, enc + [
                "--learningrate", "1e-4", "--real_data_domain", "in_place", "--real_data_chunk",
                "1.0", "--sim_data_chunk", "0.00", "--network_in", donors["coord"], "--session",
                "clean_training_ip", "--no_lr_scheduling"]),
            "encoder_finetune_oop": (train_cli.main, enc + [
                "--learningrate", "1e-4", "--real_data_domain", "out_of_place",
                "--real_data_chunk", "1.0", "--sim_data_chunk", "0.00", "--network_in",
                donors["coord"], "--session", "clean_training_oop", "--no_lr_scheduling"]),
            "encoder_pretrain_real_only": (train_cli.main, enc + [
                "--learningrate", "2e-4", "--real_data_domain", "out_of_place",
                "--real_data_chunk", "1.0", "--sim_data_chunk", "0.0", "--real_only",
                "--session", "clean_training"]),
            "encoder_pretrain_pairwise_only": (train_cli.main, enc + [
                "--learningrate", "2e-4", "--real_data_domain", "in_place", "--real_data_chunk",
                "1.0", "--sim_data_chunk", "0.0", "--session", "clean_training"]),
        }
        report = {}

        def check_run(name, out_dir, losses, fwd, bwd, wall, per_fwd, per_bwd, files):
            steps = len(losses)
            log(f"{name} on cuda ({IMG_H}x{IMG_W}, f32, 1 epoch): {wall:.1f} s wall for "
                f"{steps} steps, losses {losses}, {fwd} K1 and {bwd} K1-bwd launches")
            if os.path.basename(out_dir) != ARM_FOLDERS[name.split(" ")[0]]:
                raise AssertionError(f"{name} wrote {os.path.basename(out_dir)}, the JAX CLI "
                                     f"{ARM_FOLDERS[name.split(' ')[0]]}")
            if not steps or not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{name}: losses {losses}")
            if fwd != per_fwd * steps or bwd != per_bwd * steps:
                raise AssertionError(f"{name}: expected {per_fwd} K1 and {per_bwd} K1-bwd "
                                     f"launches per step, got {fwd}/{bwd} over {steps} steps")
            ckpt_dir = os.path.join(ckpts, os.path.basename(out_dir))
            for f in files + ["FLAG_training_done.nodata"]:
                if not os.path.exists(os.path.join(out_dir, f)):
                    raise AssertionError(f"{name}: {f} not written")
            if not (glob.glob(os.path.join(ckpt_dir, "ckpt_iter_*.net"))
                    and os.path.exists(os.path.join(ckpt_dir, "FLAG_training_done.nodata"))):
                raise AssertionError(f"{name}: no ckpt_iter_*.net or flag in {ckpt_dir}")
            report[name] = dict(steps=steps, losses=losses, k1=fwd, k1_bwd=bwd, wall_s=wall)
            self.launches[f"arms_{name.replace(' ', '_')}"] = dict(groupnorm=fwd,
                                                                   groupnorm_backward=bwd)

        for name, (main, args) in runs.items():
            out_dir, losses, fwd, bwd, wall = self._run_cli(main, work, args + common)
            check_run(name, out_dir, losses, fwd, bwd, wall, 28, 28,
                      ["model_resume.net"] if "finetune" in name else ["model.net"])
            if name == "encoder_finetune_ip":
                # the same command again: --auto_resume now holds and resumes
                # from the folder's own model_resume.net (the JAX CLI's rule)
                n_log = len(losses)
                out_dir, losses, fwd, bwd, wall = self._run_cli(main, work, args + common)
                check_run(name + " resumed", out_dir, losses[n_log:], fwd, bwd, wall, 28, 28,
                          ["model_resume.net", "model_auto_resume.net"])
                text = open(os.path.join(out_dir, "output.log")).read()
                want = (f"***** Automatic resume training from {out_dir}/model_resume.net "
                        "*****")
                if want not in text:
                    raise AssertionError("the second encoder_finetune run did not resume from "
                                         "its folder's model_resume.net")
                coord_donor = os.path.join(out_dir, "model_resume.net")

        dec = FINETUNE_ARGS[:-2] + [
            "--coord_weight", coord_donor, "--depth_weight", donors["depth"], "--normal_weight",
            donors["normal"], "--session", "enc-pt1.00-ip-ft1.00"]
        for name, extra in (("decoder_finetune_real_only", ["--real_only"]),
                            ("decoder_finetune_pairwise_only", [])):
            out_dir, losses, fwd, bwd, wall = self._run_cli(ft_cli.main, work,
                                                            dec + extra + common)
            check_run(name, out_dir, losses, fwd, bwd, wall, FT_FWD, FT_BWD, ["model.net"])

        for name in ARM_VALIDATIONS:
            ckpt_dir = os.path.join(ckpts, ARM_FOLDERS[name])
            ops.group_norm_relu.launches = 0
            t = time.perf_counter()
            logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE",
                                  "--section", "val_drone_real", "--network_in", ckpt_dir,
                                  "--min_ckpt_iter", "0", "--max_ckpt_iter", "1e98",
                                  "--datasets_dir", datasets, "--image_height", str(IMG_H),
                                  "--device", "cuda"])
            torch.cuda.synchronize()
            served, wall = ops.group_norm_relu.launches, time.perf_counter() - t
            cwd = os.getcwd()
            os.chdir(ckpt_dir)
            try:
                flag = select_ckpt.main(["--task", "coord"])
            finally:
                os.chdir(cwd)
            text = "".join(open(f).read() for f in logs)
            median = re.findall(r"Median Error:\s+(-?\d+.\d+) deg, (-?\d+.\d+) m", text)
            log(f"validate {name} on cuda: {len(logs)} checkpoint(s) in {wall:.1f} s, {served} K1 "
                f"launches, medians {median}, {flag}")
            self.launches[f"arms_validate_{name}"] = dict(groupnorm=served)
            if (served != 28 * len(logs) or len(median) != len(logs)
                    or not all(math.isfinite(float(v)) for m in median for v in m)
                    or not os.path.exists(os.path.join(ckpt_dir, "results_overall.txt"))
                    or len(glob.glob(os.path.join(ckpt_dir, "FLAG_SELECTED_ITER_*.nodata"))) != 1):
                raise AssertionError(f"validate {name}: no results, selection or finite medians")
            report[f"validate_{name}"] = dict(checkpoints=len(logs), k1=served, wall_s=wall,
                                              medians=median)

        ops.group_norm_relu.launches = 0
        ops.group_norm_relu_backward.launches = 0
        t = time.perf_counter()
        t_err, r_err = quickstart.main(steps=QUICKSTART_STEPS, device="cuda")
        torch.cuda.synchronize()
        fwd, bwd = ops.group_norm_relu.launches, ops.group_norm_relu_backward.launches
        wall = time.perf_counter() - t
        log(f"quickstart on cuda ({QUICKSTART_STEPS} steps, B=4, 96x144, tiny): {wall:.1f} s, "
            f"{fwd} K1 and {bwd} K1-bwd launches, pose errors {t_err.round(3)} m, "
            f"{r_err.round(3)} deg")
        self.launches["arms_quickstart"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
        if fwd != 27 * (QUICKSTART_STEPS + 1) or bwd != 27 * QUICKSTART_STEPS:
            raise AssertionError(f"quickstart: {fwd}/{bwd} launches, expected "
                                 f"{27 * (QUICKSTART_STEPS + 1)}/{27 * QUICKSTART_STEPS}")
        if not (np.isfinite(t_err).all() and np.isfinite(r_err).all() and (t_err < 1e3).all()
                and (r_err <= 180).all()):
            raise AssertionError(f"quickstart pose errors {t_err} m, {r_err} deg")
        report["quickstart"] = dict(k1=fwd, k1_bwd=bwd, wall_s=wall, t_err=t_err.tolist(),
                                    r_err=r_err.tolist())
        report["phase_wall_s"] = time.perf_counter() - t_phase
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "arms.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), **report), f, indent=1)
        shutil.rmtree(work, ignore_errors=True)

    # -- extra: the dress rehearsal ------------------------------------------
    def phase_rehearsal(self):
        """`crossloc_tpu_torch/examples/dress_rehearsal.sh <ws> cuda`: the whole
        experiment matrix through the unchanged harness on the card, in its
        own processes; its output and each run's output.log and results
        files go to `<out-dir>/rehearsal/`."""
        ws = WORK_DIR + "_rehearsal"
        dst = os.path.join(self.out_dir, "rehearsal")
        shutil.rmtree(ws, ignore_errors=True)
        os.makedirs(dst, exist_ok=True)
        t = time.perf_counter()
        with open(os.path.join(dst, "rehearsal.log"), "w") as f:
            rc = subprocess.run(["bash", os.path.join(HERE, "crossloc_tpu_torch", "examples",
                                                      "dress_rehearsal.sh"), ws, "cuda"],
                                stdout=f, stderr=subprocess.STDOUT, timeout=1800).returncode
        wall = time.perf_counter() - t
        for f in glob.glob(os.path.join(ws, "output", "*", "output.log")):
            shutil.copy(f, os.path.join(dst, os.path.basename(os.path.dirname(f)) + ".log"))
        for f in glob.glob(os.path.join(ws, "ckpts", "*", "results_*.txt")):
            shutil.copy(f, os.path.join(dst, f.split(os.sep)[-2] + "_" + os.path.basename(f)))
        text = open(os.path.join(dst, "rehearsal.log")).read()
        log(f"dress rehearsal on cuda: rc {rc} in {wall:.1f} s; "
            + "; ".join(ln for ln in text.splitlines() if ln.startswith("== ")))
        if rc != 0 or "== dress rehearsal PASSED" not in text:
            raise AssertionError(f"the dress rehearsal failed (rc {rc}):\n{text[-3000:]}")
        with open(os.path.join(dst, "rehearsal.json"), "w") as f:
            json.dump(dict(device=self.device_name, smi=nvidia_smi_line(), rc=rc, wall_s=wall),
                      f, indent=1)
        shutil.rmtree(ws, ignore_errors=True)

    # -- extra: the proxy-vs-e2e A/B -----------------------------------------
    def phase_e2e_ab(self):
        """`crossloc_tpu_torch/tools/e2e_ab.py` on cuda for each label regime
        at --lr_e2e 3e-4 (the JAX default), 3e-5 and 3e-6: each run's JSON
        line, wall, per-step times and K1 / K1-bwd launches to
        `<out-dir>/e2e_ab/e2e_ab.jsonl`."""
        import torch

        from crossloc_tpu_torch import ops
        from crossloc_tpu_torch.tools import e2e_ab

        dst = os.path.join(self.out_dir, "e2e_ab")
        os.makedirs(dst, exist_ok=True)
        lines = []
        for labels, lr in E2E_AB_RUNS:
            ops.group_norm_relu.launches = 0
            ops.group_norm_relu_backward.launches = 0
            t = time.perf_counter()
            out, timing = e2e_ab.run(e2e_ab.parse_args(["--labels", labels, "--lr_e2e", str(lr),
                                                        "--device", "cuda"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            fwd, bwd = ops.group_norm_relu.launches, ops.group_norm_relu_backward.launches
            self.launches[f"e2e_ab_{labels}_{lr:g}"] = dict(groupnorm=fwd, groupnorm_backward=bwd)
            line = dict(out, wall_s=wall, k1=fwd, k1_bwd=bwd, device=self.device_name,
                        smi=nvidia_smi_line(), **timing)
            log("e2e_ab " + json.dumps(line))
            lines.append(line)
            with open(os.path.join(dst, "e2e_ab.jsonl"), "a") as f:
                f.write(json.dumps(line) + "\n")
            steps = out["pre"] + 2 * out["cont"]
            # the net runs once a step and once per held-out evaluation (3)
            if fwd != 27 * (steps + 3) or bwd != 27 * steps:
                raise AssertionError(f"e2e_ab {labels} {lr}: {fwd}/{bwd} launches")
            vals = [out[a][k] for a in ("init", "proxy", "e2e") for k in ("t", "r")]
            if not all(math.isfinite(v) for v in vals[:4]):
                raise AssertionError(f"e2e_ab {labels} {lr}: the init or proxy arm is not finite")

    # -- extra: the convergence run ------------------------------------------
    def phase_converge(self):
        """The coord net's convergence run through the unchanged harness
        (`crossloc_tpu_torch/tools/convergence.py`: 480 plane frames, 100
        epochs, then two 50-epoch arms); its logs and JSON lines go to
        `<out-dir>/converge/`."""
        from crossloc_tpu_torch.tools import convergence

        ws = WORK_DIR + "_converge"
        dst = os.path.join(self.out_dir, "converge")
        os.makedirs(dst, exist_ok=True)
        try:
            results = convergence.main(["--workdir", ws])
        except SystemExit as e:  # the driver's failures (a missed bar, a failed stage)
            raise AssertionError(f"convergence run failed: {e}") from None
        finally:
            for f in glob.glob(os.path.join(ws, "*.log")) + glob.glob(os.path.join(ws, "*.json")):
                shutil.copy(f, dst)
            for f in glob.glob(os.path.join(ws, "*", "ckpts", "*", "results_*.txt")):
                shutil.copy(f, os.path.join(dst, f.split(os.sep)[-4] + "_" + os.path.basename(f)))
        with open(os.path.join(dst, "converge.json"), "w") as f:
            json.dump(results, f, indent=1)

    def kernels_line(self) -> str:
        """The kernels JSON line: `launches` sums each main path's counted run
        (`launches_by_path` lists them); times are the 28-call totals, beside
        them the other design's (`three_pass_ms`, `four_kernel_ms`)."""
        out = []
        for name, v in self.kernels.items():
            by_path = {p: n[name] for p, n in self.launches.items() if name in n}
            out.append(dict(v, launches=sum(by_path.values()), launches_by_path=by_path))
        return json.dumps({"kernels": out})


PHASES = ("card", "kernels", "forward", "serve", "train", "finetune", "tasks", "e2e", "parallel",
          "spatial", "loader", "arms")
EXTRA_PHASES = ("profile", "converge", "rehearsal", "e2e_ab", "graph")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out-dir", default=WORK_DIR + "_report",
                    help="where the per-shape, serve and profile files go")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]

    if not os.path.isdir(os.path.join(HERE, "crossloc_tpu_torch")):
        print("chip_smoke: the crossloc_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke needs a GPU",
              file=sys.stderr)
        return 3

    smoke = Smoke(args.iters, os.path.abspath(args.out_dir))
    failed = []
    for p in phases:
        if p not in PHASES + EXTRA_PHASES:
            print(f"unknown phase {p}", file=sys.stderr)
            return 2
        t0 = time.perf_counter()
        log(f"== phase {p}")
        try:
            getattr(smoke, f"phase_{p}")()
        except Exception:
            traceback.print_exc()
            failed.append(p)
            log(f"== phase {p} FAILED after {time.perf_counter() - t0:.1f} s")
            if p == "card":
                break
            continue
        log(f"== phase {p} ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    log(smoke.kernels_line())
    log(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
