"""The multi-rank dry run (counterpart of `__graft_entry__.py::dryrun_multichip`):
one training step of the full-width coord + MLE net over an n-rank
("data", "spatial") mesh, held against the same step in one process, and at
n >= 4 a ("data", "model") arm whose parameters and Adam moments stay
sharded through the update.

    python -m crossloc_tpu_torch.tools.multichip 4 --device cpu

The ranks are processes of one host (`parallel_check.run_ranks`): gloo for
CPU ranks and for ranks that share a card, NCCL where each has its own. The
bounds are the JAX dry run's: the sharded forward within 1e-3 of the
unsharded one, parameters within 5e-4 after one Adam step, the loss within
1e-3 * (1 + |loss|). Adam's first step moves a parameter by about the
learning rate whatever its gradient, so each arm's gradient of that step is
also held against the unsharded one: to rtol 1e-5 plus the larger of JAX's
train-step bound (`tests/test_train.py:183`), 2e-4 of the largest |g|, and
twice the unsharded step's own rounding spread, the gradient's move when
the input images move by one ulp. That spread is what this random
full-width net's f32 gradients make of any change in summation order: about
2.5e-4 of the largest |g| on the CPU at 64x96, where splitting an image's
rows moves them as far, while a wrong or missing gradient moves them by
its own size.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any, Dict

import numpy as np
import torch

from .. import models
from .parallel_check import checks, run_ranks, step_check

FORWARD_TOL = 1e-3
PARAM_TOL = 5e-4
LOSS_TOL = 1e-3
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 2e-4


def _spec(n_data: int, device: str) -> Dict[str, Any]:
    """The JAX dry run's inputs, made from seed 0 with numpy: B = 2 images
    per data index at 64x96, identity cameras 50 m up, labels N(0, 20^2),
    focal 300; seeded full-width weights."""
    B, H, W = 2 * n_data, 64, 96
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(size=(B, H, W, 3)).astype(np.float32))
    labels = torch.from_numpy((rng.normal(size=(B, H // 8, W // 8, 3)) * 20).astype(np.float32))
    poses = torch.eye(4).repeat(B, 1, 1)
    poses[:, 2, 3] = 50.0
    mean = [0.0, 0.0, 0.0]
    net = models.init_weights(models.build_network("coord", "MLE", mean=mean),
                              torch.Generator().manual_seed(0))
    return dict(state_dict=net.state_dict(),
                batch=dict(images=images, poses=poses, labels=labels,
                           focal=torch.tensor(300.0), pp_shift=torch.zeros(2)),
                kind="coord", uncertainty="MLE", mean=mean, tiny=False, zero=False, steps=1,
                lr=1e-4, device=device)


def _max_diff(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in b)


def _one_ulp(spec: Dict[str, Any]) -> Dict[str, Any]:
    """The spec with each image value moved by -1, 0 or +1 ulp (seed 1)."""
    b = dict(spec["batch"])
    rng = np.random.default_rng(1)
    step = rng.integers(-1, 2, size=tuple(b["images"].shape)).astype(np.float32)
    b["images"] = b["images"] * (1 + torch.from_numpy(step) * 2.0 ** -23)
    return dict(spec, batch=b)


def _grad_check(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], atol: float,
                arm: str):
    """(max |diff|, the largest ratio of |diff| to its bound rtol * |ref| +
    atol) of an arm's gradients against the unsharded step's; raises when a
    gradient is missing or over its bound."""
    assert set(got) == set(ref), f"{arm}: gradients of {sorted(set(got) ^ set(ref))} differ"
    err = ratio = 0.0
    for k, r in ref.items():
        d = (got[k].double() - r.double()).abs()
        err = max(err, float(d.max()))
        ratio = max(ratio, float((d / (GRAD_RTOL * r.double().abs() + atol)).max()))
    assert ratio <= 1.0, (f"{arm}: gradients differ from the unsharded step's by up to {err} "
                          f"({ratio:.3g} x the bound rtol {GRAD_RTOL} + {atol})")
    return err, ratio


def dryrun_multichip(n_devices: int = 4, device: str = "cuda",
                     timeout: float = 600.0) -> Dict[str, Any]:
    """Run the dry run on `n_devices` ranks on `device` ("cuda": every rank
    on this host's cards, "cpu"); raises AssertionError when a check fails.
    Returns the measured differences, rank 0's step walls and each rank's
    launch counts."""
    spatial = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_data = n_devices // spatial
    spec = _spec(n_data, device)
    arms = {"spatial": dict(spec, mesh=dict(data=n_data, spatial=spatial))}
    if n_devices >= 4 and n_devices % 2 == 0:
        arms["model"] = dict(spec, mesh=dict(data=n_devices // 2, model=2))
    with tempfile.TemporaryDirectory(prefix="crossloc_dryrun_") as tmp:
        outs = {k: os.path.join(tmp, f"{k}.pt") for k in arms}
        t0 = time.perf_counter()
        run_ranks(checks, n_devices, ([(step_check, (s, outs[k])) for k, s in arms.items()],),
                  device=device, timeout=timeout)
        wall = time.perf_counter() - t0
        got = {k: torch.load(p, weights_only=False) for k, p in outs.items()}
    ref = step_check(dict(spec, mesh=None))  # one process, the whole batch
    ulp = step_check(dict(_one_ulp(spec), mesh=None))

    res: Dict[str, Any] = dict(n_devices=n_devices, device=device, ranks_wall_s=wall)
    res["grad_max"] = max(float(g.abs().max()) for g in ref["grads"].values())
    res["grad_spread"] = _max_diff(ulp["grads"], ref["grads"])
    atol = max(GRAD_ATOL_OF_MAX * res["grad_max"], 2 * res["grad_spread"])
    sp = got["spatial"]
    res["spatial_forward_err"] = float((sp["preds"] - ref["preds"]).abs().max())
    res["spatial_param_err"] = _max_diff(sp["params"], ref["params"])
    res["spatial_loss"], res["ref_loss"] = sp["loss"][0], ref["loss"][0]
    res["spatial_step_ms"] = sp["step_ms"][0]
    res["spatial_launches"] = [dict(k1=r["launches"][0], shard=r["shard_launches"][0])
                               for r in sp["by_rank"]]
    res["spatial_grad_err"], res["spatial_grad_of_bound"] = _grad_check(
        sp["grads"], ref["grads"], atol, "spatial")
    assert res["spatial_forward_err"] < FORWARD_TOL, (
        f"sharded forward != unsharded forward (max abs err {res['spatial_forward_err']})")
    assert res["spatial_param_err"] < PARAM_TOL, (
        f"sharded train step diverges from the unsharded step: max param diff "
        f"{res['spatial_param_err']} after one Adam update")
    assert abs(res["spatial_loss"] - res["ref_loss"]) < LOSS_TOL * (1 + abs(res["ref_loss"])), (
        res["spatial_loss"], res["ref_loss"])
    if "model" in got:
        md = got["model"]
        res["model_param_err"] = _max_diff(md["params"], ref["params"])
        res["model_loss"] = md["loss"][0]
        res["model_step_ms"] = md["step_ms"][0]
        res["model_held"] = md["held"]
        res["model_grad_err"], res["model_grad_of_bound"] = _grad_check(
            md["grads"], ref["grads"], atol, "model")
        held = md["held"]
        assert held["freed"] and held["shard"] * 2 == held["whole"], (
            f"parameters lost their model sharding after the update: {held}")
        assert res["model_param_err"] < PARAM_TOL, (
            f"parameter-sharded train step diverges from the unsharded step: max param diff "
            f"{res['model_param_err']}")
        assert abs(res["model_loss"] - res["ref_loss"]) < LOSS_TOL * (1 + abs(res["ref_loss"])), (
            res["model_loss"], res["ref_loss"])
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = dryrun_multichip(args.n_devices, args.device)
    print(json.dumps(res))
    print(f"dryrun_multichip({args.n_devices}) OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
