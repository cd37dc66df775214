"""Proxy-vs-e2e training A/B (counterpart of `tools/e2e_ab.py`), on the card.

DSAC*'s core claim is that end-to-end expected-pose-loss training beats the
proxy reprojection loss on final pose accuracy. This measures that claim for
the port's `--e2e_pose_loss` step from one shared proxy-pretrained init,
with matched step budget, optimizer and data order, on the held-out median
pose error:

  1. the plane scene at 96x144, focal 120: `--frames` train frames and 12
     held-out frames from `np.random.default_rng(0)` (the JAX tool's draws
     in its order);
  2. the tiny coord net (no uncertainty head, seeded weights), `--pre`
     proxy steps at a constant 2e-3, batches drawn by `default_rng(1)`;
  3. two arms of `--cont` steps from that shared init, each with a fresh
     Adam and the same batches (`default_rng(2)`): the proxy loss at
     `--lr_cont`, and the DSAC expected pose loss
     (`train/dsac_step.py::make_dsac_train_step`, the training solver
     config) at `--lr_e2e` (default `--lr_cont`).

Label regimes: `--labels corrupt` (default) adds a smooth per-frame bias
field and 15 % gross outliers to the training coordinates (`corrupt_labels`,
draws from `default_rng(7)`): the proxy loss fits them, the e2e arm trains
from the ground-truth poses alone. `--labels clean` keeps exact labels, where
e2e has no information advantage.

The held-out evaluation solves with the default `RansacConfig` and draws
from a torch generator seeded 99 (JAX PRNG draws cannot be reproduced).
Prints each arm's held-out medians, the wall of each phase, and last the
JAX tool's JSON line (`platform` holds `--device`).

    python -m crossloc_tpu_torch.tools.e2e_ab [--labels corrupt|clean] [--lr_e2e 3e-5]
    python -m crossloc_tpu_torch.tools.e2e_ab --device cpu --pre 2 --cont 1 --frames 8 --batch 2

Without CUDA and without `--device cpu` it raises.
"""
from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

from .. import data, models
from ..device import resolve_device
from ..eval.metrics import pose_err
from ..ransac import RansacConfig, solve_batch
from ..train import TrainBatch, TrainState, make_dsac_train_step, make_optimizer, train_step

H, W, F = 96, 144, 120.0
VAL_FRAMES = 12


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--labels", choices=["corrupt", "clean"], default="corrupt")
    p.add_argument("--pre", type=int, default=600, help="shared pretrain steps")
    p.add_argument("--cont", type=int, default=300, help="per-arm continue steps")
    p.add_argument("--lr_cont", type=float, default=3e-4,
                   help="continue-phase LR for the proxy arm")
    p.add_argument("--lr_e2e", type=float, default=None,
                   help="continue-phase LR for the e2e arm (default: same as --lr_cont); "
                        "DSAC* runs its e2e phase at a far lower LR than supervised "
                        "pretraining (1e-6 against 1e-4)")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (default; raises without CUDA) or cpu")
    p.add_argument("--json", type=str, default=None)
    return p.parse_args(argv)


def corrupt_labels(labels, rng):
    """Smooth per-frame bias field + 15% gross outliers: spatially
    correlated, like real sparse-init / SfM error (not iid noise)."""
    B, h, w, _ = labels.shape
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    out = labels.copy()
    for i in range(B):
        for c in range(3):
            a, bx, by, ph = rng.uniform(4, 9), rng.uniform(2, 5), rng.uniform(2, 5), rng.uniform(0, 6)
            out[i, ..., c] += a * np.sin(bx * xx + by * yy + ph)
        n_out = int(0.15 * h * w)
        sel = rng.choice(h * w, n_out, replace=False)
        flat = out[i].reshape(-1, 3)
        flat[sel] += rng.uniform(-50, 50, size=(n_out, 3))
    return out


def scene(frames: int):
    """The JAX tool's frames: (train images, clean train coordinates, train
    poses, held-out images, held-out poses), numpy."""
    rng = np.random.default_rng(0)
    tr = [data.synth_sample(rng, H, W, F, scene="plane") for _ in range(frames)]
    va = [data.synth_sample(rng, H, W, F, scene="plane") for _ in range(VAL_FRAMES)]
    return (np.stack([s["image"] for s in tr]), np.stack([s["coord"] for s in tr]),
            np.stack([s["pose"] for s in tr]), np.stack([s["image"] for s in va]),
            np.stack([s["pose"] for s in va]))


def batch_order(n_steps: int, seed: int, frames: int, batch: int):
    """The frame indices of each step: `default_rng(seed)`, without
    replacement within a batch."""
    order = np.random.default_rng(seed)
    return [order.choice(frames, size=batch, replace=False) for _ in range(n_steps)]


def run(args):
    """The A/B; (the JSON line's dict, {"walls_s": {phase: s}, "step_ms":
    {phase: ms a step}})."""
    device = resolve_device(args.device)
    tri, trc_clean, trp, vai, vap = scene(args.frames)
    if args.labels == "corrupt":
        trc = corrupt_labels(trc_clean, np.random.default_rng(7))
        lbl_err = float(np.mean(np.linalg.norm(trc - trc_clean, axis=-1)))
        print(f"label corruption: mean |delta| = {lbl_err:.2f} units")
    else:
        trc = trc_clean

    mean = [float(v) for v in np.mean(trc_clean, axis=(0, 1, 2))]
    model = models.build_network("coord", None, tiny=True, mean=mean)
    models.init_weights(model, torch.Generator().manual_seed(0))
    model.to(device)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    on = lambda a: torch.from_numpy(a).to(device)
    tri_n, vai_n = (data.normalize_images(on(a)) for a in (tri, vai))
    trp_d, trc_d, focal = on(trp), on(trc), torch.tensor(F, device=device)
    eval_cfg = RansacConfig()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def evaluate(net, tag):
        with torch.no_grad():
            preds = net(vai_n)[..., :3].float()
            res = solve_batch(preds, F, (H, W), eval_cfg,
                              generator=torch.Generator(device=device).manual_seed(99))
        poses = res.cam_to_world.cpu().numpy()
        errs = [pose_err(vap[i], poses[i]) for i in range(VAL_FRAMES)]
        t_med = float(np.median([e[0] for e in errs]))
        r_med = float(np.median([e[1] for e in errs]))
        print(f"{tag}: held-out median t={t_med:.3f} r={r_med:.3f}", flush=True)
        return t_med, r_med

    def batches(n_steps, seed):
        for idx in batch_order(n_steps, seed, args.frames, args.batch):
            i = torch.from_numpy(idx).to(device)
            yield TrainBatch(tri_n[i], trp_d[i], trc_d[i], focal)

    def state_for(net, lr):
        return TrainState(net, make_optimizer(list(net.parameters()), lr, no_lr_scheduling=True))

    walls = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[name] = time.perf_counter() - t0
        return out

    # ---- phase 0: shared proxy pretrain
    state = state_for(model, 2e-3)

    def pretrain():
        m = None
        for b in batches(args.pre, 1):
            m = train_step(state, b, "coord", None)
        return m

    m = timed("pretrain", pretrain)
    loss = float(m["loss"]) if m is not None else float("nan")
    print(f"pretrain done ({args.pre} steps, loss {loss:.2f})")
    t0, r0 = evaluate(model, "shared init   ")

    # ---- arm A: continue with the proxy loss (fresh optimizer, lower LR)
    stA = state_for(copy.deepcopy(model), args.lr_cont)
    timed("proxy", lambda: [train_step(stA, b, "coord", None) for b in batches(args.cont, 2)])
    tA, rA = evaluate(stA.model, "proxy-continue")

    # ---- arm B: continue with the expected pose loss (same data order)
    lr_e2e = args.lr_e2e if args.lr_e2e is not None else args.lr_cont
    stB = state_for(copy.deepcopy(model), lr_e2e)
    stepB = make_dsac_train_step(stB.model)
    gen = torch.Generator(device=device).manual_seed(5)
    timed("e2e", lambda: [stepB(stB, b, generator=gen) for b in batches(args.cont, 2)])
    tB, rB = evaluate(stB.model, "e2e-continue  ")
    per_step = {k: 1e3 * walls[k] / n for k, n in (("pretrain", args.pre), ("proxy", args.cont),
                                                    ("e2e", args.cont)) if n}
    print("walls (s): " + json.dumps(walls) + "  per step (ms): " + json.dumps(per_step))

    out = {"metric": "e2e_ab", "labels": args.labels, "platform": args.device,
           "pre": args.pre, "cont": args.cont, "lr_cont": args.lr_cont,
           "lr_e2e": lr_e2e,
           "init": {"t": t0, "r": r0},
           "proxy": {"t": tA, "r": rA}, "e2e": {"t": tB, "r": rB},
           "t_ratio_e2e_over_proxy": round(tB / max(tA, 1e-9), 4)}
    return out, dict(walls_s=walls, step_ms=per_step)


def main(argv=None):
    args = parse_args(argv)
    out, _ = run(args)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
