"""Multi-rank checks of the parallel layer on one host: start ranks joined
through a `file://` process group, run one data-parallel (or ZeRO) training
step, or the hypothesis-sharded solver, on each, and hand back what rank 0
saw. `chip_smoke.py`'s parallel phase and the CPU tests use it; the same
functions with `world=1` in the calling process are the single-process
reference.

A rank that exits non-zero or outlives its timeout fails the run (the
others are then stopped).

    python -m crossloc_tpu_torch.tools.parallel_check <counts.json> <cli module> <argv...>

runs one rank of a CLI (`main(argv)`) with K1's launch counts set to 0 just
before it and written to `counts.json` just after, beside the wall time.
"""
from __future__ import annotations

import importlib
import json
import os
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from .. import models, parallel, ransac
from ..cli.common import select_device_from_env
from ..ops import group_norm_relu, group_norm_relu_backward
from ..ransac.solver import solver_precision
from ..train import (
    CheckpointManager,
    TrainBatch,
    TrainState,
    make_dsac_train_step,
    make_optimizer,
    task_loss_fn,
    train_state_dict,
    train_step,
    update_params,
)


def _rank_main(fn: Callable, rank: int, world: int, init_method: str, device: str,
               threads: int, args: Sequence) -> None:
    torch.set_num_threads(threads)
    parallel.initialize_distributed(init_method, world, rank, device=device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), device: str = "cpu",
              timeout: float = 300.0, threads: int = 2) -> None:
    """Run `fn(*args)` on `world` spawned ranks of one process group (gloo
    for CPU ranks and for ranks sharing a card, else NCCL); raises when a
    rank fails or any is still running after `timeout` seconds."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="crossloc_pg_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, init, device, threads, tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for r, p in enumerate(procs):
                p.join(max(0.1, deadline - time.monotonic()))
                if p.is_alive():
                    raise TimeoutError(f"rank {r} still running after {timeout:.0f} s")
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def _batch_rows(spec: Dict[str, Any], rows: slice, device) -> TrainBatch:
    b = spec["batch"]
    return TrainBatch(b["images"][rows].to(device), b["poses"][rows].to(device),
                      b["labels"][rows].to(device), b["focal"].to(device),
                      b["pp_shift"].to(device))


def _forward_backward(state: TrainState, spec: Dict[str, Any], batch: TrainBatch, rows: slice):
    """One forward and backward of the step `spec["kind"]` ("coord" or
    "e2e"); returns the loss (of this rank's rows)."""
    net, dp = state.model, state.parallel
    if spec["kind"] == "e2e":  # train/dsac_step.py's forward and backward
        coords = net(batch.images)[..., :net.num_task_channel]
        coords = coords.to(torch.promote_types(coords.dtype, torch.float32))
        loss, _ = ransac.expected_pose_loss(
            coords, batch.poses, batch.focal.reshape(-1)[0], tuple(batch.images.shape[1:3]),
            ransac.RansacConfig(**spec["ransac"]), pp_shift=batch.pp_shift,
            idx=spec["idx"][rows].to(coords.device))
        with solver_precision(coords.device):
            loss.backward()
        return loss
    preds = net(batch.images)
    loss, _ = task_loss_fn("coord", preds, batch, spec["uncertainty"], net.num_task_channel,
                           count_reduce=dp.all_sum if dp is not None else None)
    loss.backward()
    return loss


def _full_gradients(state: TrainState) -> Dict[str, torch.Tensor]:
    """Name -> the averaged gradient of every trainable tensor (ZeRO shards
    all-gathered), on the CPU."""
    dp = state.parallel
    if dp is None:
        return {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()
                if p.requires_grad}
    out = {n: p.grad.detach().cpu() for n, p in dp.replicated}
    if dp.shard is not None:
        out.update({n: g.cpu() for n, g in dp.full_tensors(dp.shard.grad).items()})
    return out


def step_check(spec: Dict[str, Any], out_path: Optional[str] = None) -> Dict[str, Any]:
    """On each rank: the spec's net and its rows of the global batch; the
    averaged gradient of the first step, then `spec["steps"]` training steps
    through `train_step` (or the DSAC step with the global pool's draws).
    Returns, and rank 0 writes to `out_path`: "grads" and "params" (names
    -> CPU tensors), "loss", "grad_norm", the wall "step_ms" (the step's
    enqueue to its loss on the host) and K1's forward and backward launches
    per step on this rank, and the process group's "backend".

    spec: "state_dict", "batch" (images, poses, labels, focal, pp_shift of
    the global batch, CPU tensors), "kind", "uncertainty", "mean", "tiny",
    "zero", "steps", "lr", "grad_clip", "device", optionally "float64", and
    for "e2e" "ransac" (RansacConfig fields) and "idx" (the global pool's
    draws)."""
    state, batch, rows = _setup(spec)
    net, dp = state.model, state.parallel
    device = batch.images.device
    if dp is None:
        _forward_backward(state, spec, batch, rows)
    else:
        with dp.materialized():
            _forward_backward(state, spec, batch, rows)
            dp.reduce_gradients()
    grads = _full_gradients(state)
    for p in update_params(state):
        p.grad = None

    dsac = None
    if spec["kind"] == "e2e":
        dsac = make_dsac_train_step(net, ransac.RansacConfig(**spec["ransac"]))
    out = {"grads": grads, "loss": [], "grad_norm": [], "launches": [], "step_ms": [],
           "backend": dist.get_backend() if dist.is_initialized() else None}
    for _ in range(spec["steps"]):
        group_norm_relu.launches = group_norm_relu_backward.launches = 0
        t0 = time.perf_counter()
        if dsac is not None:
            m = dsac(state, batch, idx=spec["idx"][rows].to(device))
        else:
            m = train_step(state, batch, "coord", spec["uncertainty"])
        out["loss"].append(float(m["loss"]))  # waits for the step
        out["step_ms"].append(1e3 * (time.perf_counter() - t0))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["launches"].append((group_norm_relu.launches, group_norm_relu_backward.launches))
    if dp is not None:
        dp.gather()
    out["params"] = {n: t.detach().cpu() for n, t in net.state_dict().items()}
    if parallel.topology()[0] == 0 and out_path is not None:
        torch.save(out, out_path)
    return out


def checkpoint_check(spec: Dict[str, Any], directory: str, backend: str,
                     out_path: Optional[str] = None) -> Dict[str, Any]:
    """On each rank: `spec["steps"]` training steps, then a full-state save
    through `CheckpointManager(directory, backend=backend)`. Returns, and
    rank 0 writes, the whole state (`train_state_dict`, on the CPU)."""
    state, batch, _ = _setup(spec)
    for _ in range(spec["steps"]):
        train_step(state, batch, "coord", spec["uncertainty"])
    CheckpointManager(directory, backend=backend).save(state)
    sd = train_state_dict(state, full=True)
    out = {k: ({n: t.detach().cpu() for n, t in v.items()} if isinstance(v, dict)
               else v.detach().cpu()) for k, v in sd.items()}
    if parallel.topology()[0] == 0 and out_path is not None:
        torch.save(out, out_path)
    return out


def _setup(spec: Dict[str, Any]):
    """(state, this rank's batch, its rows) of a spec (`step_check`)."""
    rank, world = parallel.topology()
    device = select_device_from_env(spec["device"])  # the CLIs' device, TF32 off
    net = models.build_network("coord", spec["uncertainty"], tiny=spec["tiny"],
                               mean=spec["mean"])
    net.load_state_dict(spec["state_dict"])
    if spec.get("float64"):  # the whole step in float64, the solver too
        net.double().dtype = torch.float64
    net.to(device)
    if device.type == "cuda":
        net.to(memory_format=torch.channels_last)
    dp = parallel.DataParallel(net, zero=spec["zero"]) if world > 1 else None
    params = (dp.update_params() if dp is not None
              else [p for p in net.parameters() if p.requires_grad])
    state = TrainState(net, make_optimizer(params, spec["lr"], steps_per_epoch=10,
                                           grad_clip=spec.get("grad_clip")), parallel=dp)
    B = spec["batch"]["images"].shape[0] // world
    rows = slice(rank * B, (rank + 1) * B)
    batch = _batch_rows(spec, rows, device)
    if spec.get("float64"):
        batch = TrainBatch(*(t.double() for t in batch))
    return state, batch, rows


def solver_check(spec: Dict[str, Any], out_path: Optional[str] = None) -> Dict[str, Any]:
    """On each rank: `ransac.solve_batch_hypsharded` of the spec's
    coordinates with the global pool's draws `idx`. Returns, and rank 0
    writes, the result's fields as CPU tensors."""
    device = select_device_from_env(spec["device"])
    res = ransac.solve_batch_hypsharded(spec["coords"].to(device), spec["focal"],
                                        spec["image_hw"], ransac.RansacConfig(**spec["ransac"]),
                                        idx=spec["idx"].to(device))
    out = {k: v.detach().cpu() for k, v in res._asdict().items()}
    if parallel.topology()[0] == 0 and out_path is not None:
        torch.save(out, out_path)
    return out


def checks(jobs: Sequence) -> None:
    """Run `fn(*args)` for each (fn, args) of `jobs` in turn (on each rank)."""
    for fn, args in jobs:
        fn(*args)


def cli_rank(counts_path: str, module: str, argv: Sequence[str]) -> None:
    """`module.main(argv)` with K1's forward and backward launch counts set to
    0 just before and written to `counts_path` just after."""
    cli = importlib.import_module(module)
    group_norm_relu.launches = group_norm_relu_backward.launches = 0
    t0 = time.perf_counter()
    cli.main(list(argv))
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    counts = dict(rank=parallel.topology()[0], groupnorm=group_norm_relu.launches,
                  groupnorm_backward=group_norm_relu_backward.launches,
                  wall_s=time.perf_counter() - t0)
    with open(counts_path, "w") as f:
        json.dump(counts, f)


if __name__ == "__main__":
    cli_rank(sys.argv[1], sys.argv[2], sys.argv[3:])
