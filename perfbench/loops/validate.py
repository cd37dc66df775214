"""The validation loop of the port's eval CLI (`cli/test_single_task.py`,
coord task), batch for batch: the `Loader` over the test frames in order,
`dispatch` (the uint8 wire, the copy to the card, the net, hypothesis
draws, `ransac.solve_batch`) one batch ahead of `consume` (predictions and
poses to the host, the pose error and the coordinate errors against the
frames' ground truth). The window runs the section again and again, as
validating many checkpoints does, for `--seconds` and at least until the
batches the check may draw are done. Left out: the CLI's per-frame prints
and its results file.

Correct: batches of the window drawn from the seed (`check.batches` of the
first `check.from_first`) keep their predictions, hypothesis draws and
poses. After the window the plain
reference net predicts the same frames from the files, and the reference
solver solves the program's predicted coordinates with the same draws.
"""
from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from perfbench.core import scene, seeds, weights
from perfbench.core.tracer import Tracer
from perfbench.reference import net as ref_net
from perfbench.reference import ransac as ref_ransac

TRAINING = False
CHECKS = ("coord_gap", "pose_t_gap_m", "pose_r_gap_deg")


class Program:
    """The port's eval net, solver settings and input pipeline for one cell."""

    def __init__(self, cell, seed: int, workdir: str, device: str):
        from crossloc_tpu_torch import data as port_data
        from crossloc_tpu_torch import eval as port_eval
        from crossloc_tpu_torch import ransac as port_ransac
        from crossloc_tpu_torch.cli import common

        self.port_data, self.port_eval, self.port_ransac = port_data, port_eval, port_ransac
        cfg, wl = cell.config, cell.workload
        self.cfg, self.wl, self.seed = cfg, wl, seed
        height, width = cfg["image"]
        self.batch = int(wl["batch"])
        self.dev = common.select_device_from_env(device)
        self.roots = scene.write(workdir, seed, wl["scene"], height, width, cfg["subsample"],
                                 self.dev)
        ld = wl["loader"]
        self.dataset = port_data.CamLocDataset(self.roots, coord=True, image_height=height)
        self.loader = port_data.Loader(self.dataset, batch_size=self.batch,
                                       num_workers=ld["num_workers"], prefetch=ld["prefetch"])
        self.model = weights.port_model(cfg, seed, self.dev)[0].eval()
        self.ntc = cfg["net"]["num_task_channel"]
        sv = wl["solver"]
        self.rcfg = port_ransac.RansacConfig(
            hypotheses=sv["hypotheses"], inlier_threshold=sv["inlier_threshold"],
            inlier_alpha=sv["inlier_alpha"], max_pixel_error=sv["max_pixel_error"],
            subsample=cfg["subsample"], sample_rounds=sv["sample_rounds"])
        self.gen = torch.Generator(device=self.dev).manual_seed(seeds.derive(seed, "hypotheses"))
        ck = wl["check"]
        self.keep = set(seeds.rng(seed, "check").choice(ck["from_first"], ck["batches"],
                                                        replace=False).tolist())
        self.kept: List[dict] = []
        self.errors: List[tuple] = []
        self.frames = 0
        # warm-up: one pass's first batch through dispatch and consume
        idle = Tracer(False, self.dev)
        it = iter(self.loader)
        self.consume(self.dispatch(next(it), idle), -1, idle)
        it.close()
        self.kept, self.errors, self.frames = [], [], 0

    @property
    def evidence(self) -> List[dict]:
        return self.kept

    @torch.no_grad()
    def dispatch(self, batch, tracer) -> dict:
        pd = self.port_data
        dev = self.dev
        with tracer.span("data"):
            wire = torch.from_numpy(pd.images_to_wire(batch["image"]))
            n = wire.shape[0]
            x = pd.images_from_wire(wire.to(dev, non_blocking=True))
        with tracer.span("forward"):
            preds = self.model(x)
            images = torch.cat([x])[:n]
            preds = torch.cat([preds])[:n]
        with tracer.span("solve"):
            hs, ws = preds.shape[1], preds.shape[2]
            idx = torch.randint(0, hs * ws, (n, self.rcfg.hypotheses * self.rcfg.sample_rounds, 4),
                                generator=self.gen, device=dev)
            focal = torch.from_numpy(batch["focal"])
            res = self.port_ransac.solve_batch(preds[..., :self.ntc], focal.to(dev),
                                               (images.shape[1], images.shape[2]), self.rcfg,
                                               idx=idx)
        return dict(batch=batch, preds=preds, idx=idx,
                    res=SimpleNamespace(cam_to_world=torch.cat([res.cam_to_world])[:n]))

    def consume(self, d: dict, index: int, tracer):
        ev = self.port_eval
        with tracer.span("consume"):
            batch = d["batch"]
            preds = d["preds"].cpu()
            cam_to_world = d["res"].cam_to_world.cpu()
            for b in range(preds.shape[0]):
                t_err, r_err = ev.pose_err(batch["pose"][b], cam_to_world[b])
                c_err = ev.coord_errors(preds[b][None, ..., :self.ntc], batch["coord"][b][None],
                                        self.cfg["loss"]["nodata"])
                self.errors.append((t_err, r_err, float(np.mean(c_err)) if c_err.size else 0.0))
            self.frames += preds.shape[0]
            if index in self.keep:
                self.kept.append({"files": list(batch["file_name"]), "preds": preds,
                                  "idx": d["idx"].cpu(), "poses": cam_to_world,
                                  "focal": np.asarray(batch["focal"])})

    def window(self, seconds: float, tracer) -> dict:
        tr = self.wl["trace"]
        t0 = time.perf_counter()
        index, done = 0, False
        while not done:
            pending = None
            it = iter(self.loader)
            while True:
                with tracer.span("data"):
                    batch = next(it, None)
                if batch is None:
                    break
                if index == tr["skip"]:
                    tracer.start()
                d = self.dispatch(batch, tracer)
                tracer.unit()
                if pending is not None:
                    self.consume(*pending, tracer)
                pending = (d, index)
                index += 1
                if index == tr["skip"] + tr["batches"]:
                    tracer.stop()
                if time.perf_counter() - t0 >= seconds and index >= self.wl["check"]["from_first"]:
                    done = True
                    break
            # the section's end: the CLI consumes its last batch
            self.consume(*pending, tracer)
        t1 = time.perf_counter()
        it.close()
        tracer.stop()
        failed = sum(not (math.isfinite(t) and math.isfinite(r)) for t, r, _ in self.errors)
        return {"frames": self.frames, "window_s": t1 - t0, "units": index,
                "attempted": self.frames, "failed": failed}

    def close(self):
        del self.model, self.loader, self.dataset


def end_to_end(rec: dict) -> Dict[str, float]:
    return {"validate_img_s": rec["frames"] / rec["window_s"]}


# -- the reference, and the comparison that decides `correct` --------------------


def _frames(files, device):
    imgs = np.stack([scene.read_frame(f)["image"] for f in files])
    return torch.from_numpy(imgs).to(device).float() / 255.0


def ref_coords(cell, P, files, device, block: int = 16) -> torch.Tensor:
    """The reference net's predictions [n, h, w, C] of the frames `files`,
    read from disk, in blocks of `block` frames."""
    arch = ref_net.Arch.of(cell.config)
    out = []
    with torch.no_grad():
        for lo in range(0, len(files), block):
            out.append(ref_net.forward(_frames(files[lo:lo + block], device), P, arch))
    return torch.cat(out)


def solver_config(cell) -> ref_ransac.RansacConfig:
    sv = cell.workload["solver"]
    return ref_ransac.RansacConfig(
        hypotheses=sv["hypotheses"], inlier_threshold=sv["inlier_threshold"],
        inlier_alpha=sv["inlier_alpha"], max_pixel_error=sv["max_pixel_error"],
        subsample=cell.config["subsample"], sample_rounds=sv["sample_rounds"])


def ref_poses(cell, coords, focal, idx, device, tf32: bool = False) -> torch.Tensor:
    with torch.no_grad():
        return ref_ransac.solve_batch(coords[..., :3].to(device), torch.as_tensor(focal).to(device),
                                      tuple(cell.config["image"]), solver_config(cell),
                                      idx.to(device), tf32=tf32).cpu()


def control(cell, seed: int, kept: List[dict], device) -> List[dict]:
    """The reference put in the program's place in TF32: the same batches'
    predictions and poses, computed by the reference net and solver with
    TF32 matrix products and convolutions."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        P = weights.state_dict(cell.config, seed, torch.device(device))
        out = []
        for k in kept:
            preds = ref_coords(cell, P, k["files"], device).cpu()
            out.append(dict(k, preds=preds,
                            poses=ref_poses(cell, preds, k["focal"], k["idx"], device, True)))
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _rot_deg(Ra, Rb):
    Rrel = Ra.transpose(-1, -2) @ Rb
    cos_t = (Rrel[..., 0, 0] + Rrel[..., 1, 1] + Rrel[..., 2, 2] - 1.0) * 0.5
    sx = Rrel[..., 2, 1] - Rrel[..., 1, 2]
    sy = Rrel[..., 0, 2] - Rrel[..., 2, 0]
    sz = Rrel[..., 1, 0] - Rrel[..., 0, 1]
    return torch.rad2deg(torch.atan2(0.5 * torch.sqrt(sx * sx + sy * sy + sz * sz), cos_t))


def _worst(gaps: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest gap; a frame whose pose is not finite on one side only
    counts as infinitely far, on both sides as equal."""
    fa = torch.isfinite(a.flatten(1)).all(1)
    fb = torch.isfinite(b.flatten(1)).all(1)
    gaps = torch.where(fa & fb, gaps.double(), torch.where(fa | fb, math.inf, 0.0))
    return float(gaps.max())


def check(cell, seed: int, kept: List[dict], device) -> Dict[str, float]:
    """coord_gap: per frame, the distance between the program's and the
    reference's predicted coordinates over the reference's distance from
    the output mean (Frobenius norms over the frame's cells); pose gaps:
    the program's poses against the reference solver's on the program's
    own predicted coordinates and draws, translation in metres, rotation
    in degrees. Each the worst frame of the kept batches."""
    if not kept:
        return {name: math.inf for name in CHECKS}
    cfg = cell.config
    P = weights.state_dict(cfg, seed, torch.device(device))
    mean = torch.tensor(cfg["mean"])
    coord, t_gap, r_gap = [], [], []
    for k in kept:
        ref = ref_coords(cell, P, k["files"], device).cpu()[..., :3]
        got = k["preds"][..., :3]
        num = torch.linalg.vector_norm((got - ref).flatten(1), dim=1)
        den = torch.linalg.vector_norm((ref - mean).flatten(1), dim=1)
        coord.append(_worst(num / den, got, ref))
        rp = ref_poses(cell, k["preds"], k["focal"], k["idx"], device)
        gp = k["poses"]
        t_gap.append(_worst(torch.linalg.vector_norm(gp[:, :3, 3] - rp[:, :3, 3], dim=1), gp, rp))
        r_gap.append(_worst(_rot_deg(gp[:, :3, :3].double(), rp[:, :3, :3].double()), gp, rp))
    return {"coord_gap": max(coord), "pose_t_gap_m": max(t_gap), "pose_r_gap_deg": max(r_gap)}


def controls(cell, seed: int, evidence: List[dict], device) -> Dict[str, Dict[str, float]]:
    """Readings of the control (the reference in TF32 in the program's
    place) and of the program, on the same kept batches."""
    return {"program": check(cell, seed, evidence, device),
            "tf32": check(cell, seed, control(cell, seed, evidence, device), device)}
