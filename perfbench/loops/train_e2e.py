"""DSAC* end-to-end training as the port's train CLI runs it with
`--e2e_pose_loss`: the train loop's data path, augmentation, window and
comparison (`loops/train.py`), with the step replaced by
`make_dsac_train_step` (forward, the expected pose loss through the
differentiable RANSAC solver, backward, Adam) and the reference's loss by
the plain expected pose loss (`perfbench/reference/e2e.py`).

The solver and pose-loss settings are the configuration's `solver` and
`pose_loss`, built through the CLI's own `e2e_configs` from DSAC*'s flag
names, as the CLI builds them from its command line. Each step's minimal
sets `idx` [B, H * rounds, 4] are drawn on the device from (seed, epoch,
batch).

The input to the solver is on target. Seeded random weights give
coordinates that make no valid hypothesis at tau = 10 px, so the loss and
its gradient would be 0. In their place, as for the pretrained net that
DSAC* starts end-to-end training from, the net's three coordinate channels
keep their gradient and take the value of a target: the batch's augmented
labels with the right half of each image turned `turn_deg` about the
vertical through the image's mean coordinate, plus `noise_m` of noise from
(seed, epoch, batch). Two rigid modes make hypotheses that refine to
either pose, so the gradient through the scores and P3P is a real one. The
labels' empty cells get the same turn and noise far off the scene: they
stay outliers. The net's forward and backward, the solver and Adam run as
in a real job. Each step's `idx` and target are its evidence, and the
reference applies the same substitution.
"""
from __future__ import annotations

import functools
import math
import types
from typing import Dict

import torch

from perfbench.core import seeds, spec
from perfbench.reference import e2e as ref_e2e
from perfbench.reference import ransac as ref_ransac

base = spec.loop("train")

TRAINING = True
CHECKS = base.CHECKS
end_to_end = base.end_to_end


def cli_configs(config: dict):
    """(RansacConfig, PoseLossConfig) of the port for `config`: DSAC*'s
    flags through the train CLI's `e2e_configs`, then the retry rounds and
    refinement steps, which the CLI leaves at the step's defaults."""
    from crossloc_tpu_torch.cli import train_single_task as cli

    s, p = config["solver"], config["pose_loss"]
    flags = types.SimpleNamespace(
        hypotheses=s["hypotheses"], threshold=s["inlier_threshold"],
        inlieralpha=s["inlier_alpha"], maxpixelerror=s["max_pixel_error"],
        weightrot=p["w_rot"], weighttrans=p["w_trans"])
    rcfg, lcfg = cli.e2e_configs(flags, config["subsample"])
    rcfg = rcfg._replace(sample_rounds=s["sample_rounds"], train_refine_steps=s["refine_steps"])
    if lcfg.soft_clamp != p["soft_clamp"]:
        raise ValueError(f"the port's pose loss clamps at {lcfg.soft_clamp}; "
                         f"{config['name']} states {p['soft_clamp']}")
    return rcfg, lcfg


def target_of(labels, seed: int, epoch: int, batch_idx: int, on: dict):
    """The solver's input of one batch: `labels` [B, h, w, 3] with the right
    half turned `on["turn_deg"]` about the vertical (the z axis) through
    each image's mean coordinate, plus `on["noise_m"]` of normal noise
    drawn on `labels`' device from (seed, epoch, batch)."""
    gen = torch.Generator(device=labels.device).manual_seed(
        seeds.derive(seed, "target", epoch, batch_idx))
    noise = torch.randn(labels.shape, generator=gen, device=labels.device,
                        dtype=labels.dtype) * on["noise_m"]
    a = math.radians(on["turn_deg"])
    turn = torch.tensor([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                         [0.0, 0.0, 1.0]], device=labels.device, dtype=labels.dtype)
    mean = labels.flatten(1, 2).mean(1)[:, None, None, :]
    turned = ((labels - mean)[..., None, :] * turn).sum(-1) + mean
    right = (torch.arange(labels.shape[2], device=labels.device) >= labels.shape[2] // 2)
    return torch.where(right[None, None, :, None], turned, labels) + noise


class OnTarget(torch.nn.Module):
    """The port's net with the value of its coordinate channels replaced by
    `target` (set before each step) and their gradient passed on."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.num_task_channel = net.num_task_channel
        self.target = None

    def forward(self, x):
        out = self.net(x)
        c = out[..., :3]
        return torch.cat([c - c.detach() + self.target, out[..., 3:]], dim=-1)


class Program(base.Program):
    """The train loop's state and data path; the DSAC step."""

    def __init__(self, cell, seed: int, workdir: str, device: str):
        self.rcfg, self.lcfg = cli_configs(cell.config)  # before any worker starts
        self._dsac = None
        super().__init__(cell, seed, workdir, device)

    def port_step(self, tb):
        """`make_dsac_train_step` on one augmented batch, on target, with
        the batch's minimal sets drawn on the device; returns its metrics
        and {"idx", "target"} as this step's evidence."""
        if self._dsac is None:
            from crossloc_tpu_torch import train as port_train

            self.state.model = OnTarget(self.model)
            self._dsac = port_train.make_dsac_train_step(self.state.model, self.rcfg, self.lcfg,
                                                         subsample=self.cfg["subsample"])
        B, h, w = tb.labels.shape[:3]
        gen = torch.Generator(device=self.dev).manual_seed(
            seeds.derive(self.seed, "solver", self.epoch, self.batch_idx))
        idx = torch.randint(0, h * w, (B, self.rcfg.hypotheses * self.rcfg.sample_rounds, 4),
                            generator=gen, device=self.dev)
        target = target_of(tb.labels, self.seed, self.epoch, self.batch_idx,
                           self.wl["on_target"])
        self.state.model.target = target
        metrics = self._dsac(self.state, tb, idx=idx)
        return metrics, {"idx": idx, "target": target}


# -- the reference, and the comparison that decides `correct` --------------------


def pose_loss_of(cell, pred, lab, pose, focal, pp, step: int, evidence: dict, rows,
                 refine_steps=None, w_trans=None) -> torch.Tensor:
    """The reference's objective of checked step `step`: the plain expected
    pose loss of the prediction's coordinates put on the step's target,
    with its minimal sets, the reference's own poses, focal length and
    principal point, and the configuration's settings (`refine_steps` and
    `w_trans` in their place: faults)."""
    cfg = cell.config
    s, p = cfg["solver"], cfg["pose_loss"]
    extra = evidence["extra"][step]
    idx, target = extra["idx"], extra["target"]
    if rows is not None:
        idx, target = idx[rows], target[rows]
    rcfg = ref_ransac.RansacConfig(
        hypotheses=s["hypotheses"], inlier_threshold=s["inlier_threshold"],
        inlier_alpha=s["inlier_alpha"], max_pixel_error=s["max_pixel_error"],
        subsample=cfg["subsample"], sample_rounds=s["sample_rounds"])
    coords = ref_e2e.on_target(pred[..., :3], target.to(pred.device))
    return ref_e2e.expected_pose_loss(
        coords, pose, focal, pp, tuple(cfg["image"]), idx.to(pred.device), rcfg,
        s["refine_steps"] if refine_steps is None else refine_steps, p["w_rot"],
        p["w_trans"] if w_trans is None else w_trans, p["soft_clamp"])


def reference(cell, seed: int, evidence: dict, device, **kwargs) -> dict:
    """The train loop's reference under the expected pose loss, in float32
    on the CPU too (on a card it is float32 anyway): the objective's
    decisions (a hypothesis's first good round, the inlier masks, the
    refinement's acceptance) are discrete, and at the small sizes a CPU
    runs float64 flips some of them against the float32 program, each
    moving the loss by a whole hypothesis's share."""
    kwargs.setdefault("precision", "float32")
    kwargs.setdefault("loss", pose_loss_of)
    return base.reference(cell, seed, evidence, device, **kwargs)


def check(cell, seed: int, evidence: dict, device) -> Dict[str, float]:
    return base.compare(evidence, reference(cell, seed, evidence, device))


FAULTS = {  # the reference with one thing changed, read against the sound reference
    "one_refine_step": dict(refine_steps=1),
    "w_trans_1": dict(w_trans=1.0),
}


def controls(cell, seed: int, evidence: dict, device) -> Dict[str, Dict[str, float]]:
    """The train loop's readings (the program; the control, the reference
    in TF32; half of each batch left out) and those of `FAULTS`, each
    against the float32 reference."""
    ref = reference(cell, seed, evidence, device)
    tf32 = reference(cell, seed, evidence, device, precision="tf32")
    half = reference(cell, seed, evidence, device, rows=slice(0, int(cell.workload["batch"]) // 2))
    out = {"program": base.compare(evidence, ref), "tf32": base.compare(tf32, ref),
           "half_batch": base.compare(half, ref)}
    for name, change in FAULTS.items():
        got = reference(cell, seed, evidence, device,
                        loss=functools.partial(pose_loss_of, **change))
        out[name] = base.compare(got, ref)
    out["detail"] = {"program": base.explain(evidence, ref), "tf32": base.explain(tf32, ref)}
    return out
