"""The training loop of the port's train and finetune CLIs
(`cli/train_single_task.py::run_training`), step for step: the shuffled
`Loader` over the scene on disk, whose workers collate the uint8 wire
images, its batches passed through `images_to_wire` and copied ahead
through pinned memory (`device_prefetch`), the augmentation drawn per
(epoch, batch) and applied on the card (`augment_batch`), `train_step`
(forward, the coord loss, backward, Adam), then the CLI's two reads of the
step's valid rate and loss.

Left out: the CLI's log line and its snapshot writes (a `.net` file every
epoch), so that a run writes little to disk.

Set-up runs the first `checked_steps` steps through the same calls on the
same state, records what `correct` is judged on (each step's loss, the first
gradient's norm per leaf worked out from Adam's state after one step, each
leaf's change after the checked steps), and hands that state to the window. After the window the
plain reference (`perfbench/reference/`) follows the same steps from the
same seeded weights, batches and draws.

A training loop of another objective is a loop file of its own that takes
these parts (`spec.loop("train")`): a `Program` subclass whose `port_step`
calls its step of the port, a reference loss with `coord_loss`'s signature
passed to `reference`, `check` and `controls`, and its `CHECKS`. The data
path, the window, `compare` and `explain` stay these.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench.core import scene, seeds, weights
from perfbench.core.tracer import Tracer
from perfbench.reference import net as ref_net
from perfbench.reference import train as ref_train

TRAINING = True
CHECKS = ("loss_gap", "grad_gap", "change_gap")


def draw(seed: int, epoch: int, batch_idx: int, batch: int, aug: dict) -> Dict[str, torch.Tensor]:
    """One batch's augmentation draws, on the CPU, from (seed, epoch, batch)."""
    gen = torch.Generator().manual_seed(seeds.derive(seed, "augment", epoch, batch_idx))

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen)

    return {"scale": uniform((), aug["scale_min"], aug["scale_max"]),
            "angle": uniform((), -aug["rotation_deg"], aug["rotation_deg"]),
            "translation": uniform((2,), -1.0, 1.0),
            "brightness": uniform((batch,), 1 - aug["brightness"], 1 + aug["brightness"]),
            "contrast": uniform((batch,), 1 - aug["contrast"], 1 + aug["contrast"])}


class Program:
    """The port's training state and input pipeline for one cell."""

    def __init__(self, cell, seed: int, workdir: str, device: str):
        from crossloc_tpu_torch import data as port_data
        from crossloc_tpu_torch import train as port_train
        from crossloc_tpu_torch.cli import common
        from crossloc_tpu_torch.losses import CoordLossConfig

        self.port_data, self.port_train = port_data, port_train
        cfg, wl = cell.config, cell.workload
        self.cfg, self.wl, self.seed = cfg, wl, seed
        height, width = cfg["image"]
        self.batch = int(wl["batch"])
        self.dev = common.select_device_from_env(device)  # the CLIs' device and TF32 setting
        self.roots = scene.write(workdir, seed, wl["scene"], height, width, cfg["subsample"],
                                 self.dev)
        ld = wl["loader"]
        self.dataset = port_data.CamLocDataset(self.roots, coord=True, image_height=height)
        self.loader = port_data.Loader(self.dataset, batch_size=self.batch,
                                       shuffle=ld["shuffle"], drop_last=ld["drop_last"],
                                       seed=seeds.derive(seed, "loader"),
                                       num_workers=ld["num_workers"], prefetch=ld["prefetch"])
        opt = cfg["optimizer"]
        if opt["kind"] != "adam":
            raise ValueError(f"the train loop runs the port's Adam; {cfg['name']} states "
                             f"{opt['kind']}")
        model, p0 = weights.port_model(cfg, seed, self.dev)
        self.model = model
        trainable = [p for p in model.parameters() if p.requires_grad]
        self.state = port_train.TrainState(model, port_train.make_optimizer(
            trainable, opt["lr"], len(self.loader), not opt["lr_scheduling"]))
        aug = cfg["augment"]
        self.aug_cfg = port_data.AugmentConfig(
            aug_rotation=aug["rotation_deg"], aug_scale_min=aug["scale_min"],
            aug_scale_max=aug["scale_max"], aug_brightness=aug["brightness"],
            aug_contrast=aug["contrast"], aug_translation=aug["translation"],
            nodata_value=cfg["loss"]["nodata"], subsample=cfg["subsample"])
        lc = cfg["loss"]
        self.loss_cfg = CoordLossConfig(min_depth=lc["min_depth"], soft_clamp=lc["soft_clamp"],
                                        hard_clamp=lc["hard_clamp"],
                                        init_tolerance=lc["init_tolerance"],
                                        nodata_value=lc["nodata"], subsample=cfg["subsample"])
        self.epoch, self.batch_idx, self._it = 0, 0, None

        # the checked steps, through the window's own calls on this state
        idle = Tracer(False, self.dev)
        self.evidence = {"rows": [], "draws": [], "losses": [], "extra": [],
                         "steps_per_epoch": len(self.loader)}
        names = {id(p): n for n, p in model.named_parameters()}
        b1 = opt["betas"][0]
        for k in range(int(wl["checked_steps"])):
            loss, files, d, extra = self.step(idle)
            self.evidence["rows"].append(files)
            self.evidence["draws"].append(d)
            self.evidence["losses"].append(loss)
            self.evidence["extra"].append(extra)
            if k == 0:
                adam = self.state.optimizer.adam
                self.evidence["grad"] = {  # a leaf that got no gradient has no state
                    names[id(p)]: float(torch.linalg.vector_norm(adam.state[p]["exp_avg"]))
                    / (1 - b1) if adam.state.get(p) else 0.0 for p in trainable}
        with torch.no_grad():
            self.evidence["change"] = {
                names[id(p)]: float(torch.linalg.vector_norm(p - p0[names[id(p)]]))
                for p in trainable}
        del p0

    def _next_batch(self):
        pd = self.port_data
        while True:
            if self._it is None:
                self.loader.set_epoch(self.epoch)
                wire = (dict(b, image=pd.images_to_wire(b["image"])) for b in self.loader)
                self._it = pd.device_prefetch(wire, self.dev, keys=("image", "pose", "coord"))
                self.batch_idx = 0
            try:
                return next(self._it)
            except StopIteration:
                self._it = None
                self.epoch += 1

    def port_step(self, tb):
        """The port's step on one augmented batch, as the CLI calls it: its
        metrics (0-d tensors, "loss" among them) and what this step adds to
        the evidence, which the reference loss sees (None here). The CLI
        reads "valid_rate" after a step that reports one, as `train_step`
        does; its pose-loss step (`make_dsac_train_step`) reports none, and
        the CLI then reads the loss alone. A training loop of another
        objective replaces this method; it may build what its step needs
        on its first call."""
        metrics = self.port_train.train_step(self.state, tb, self.cfg["task"],
                                             self.cfg["uncertainty"], self.cfg["loss"]["nodata"],
                                             self.loss_cfg)
        return metrics, None

    def step(self, tracer):
        """One step as the CLI runs it; returns (loss, the rows' files,
        draws, the step's own evidence)."""
        pd, pt = self.port_data, self.port_train
        with tracer.span("data"):
            batch = self._next_batch()
        with tracer.span("augment"):
            B = batch["image"].shape[0]
            d = draw(self.seed, self.epoch, self.batch_idx, B, self.cfg["augment"])
            draws = pd.AugmentDraws(**d).to(self.dev)
            focal = torch.tensor(float(batch["focal"][0]), device=self.dev)
            images, labels, poses, focal, pp_shift = pd.augment_batch(
                pd.images_from_wire(batch["image"]), batch["coord"], batch["pose"], focal, draws,
                self.aug_cfg)
            tb = pt.TrainBatch(images, poses, labels, focal, pp_shift)
        with tracer.span("step"):
            metrics, extra = self.port_step(tb)
        with tracer.span("loss_read"):
            if "valid_rate" in metrics:
                float(metrics["valid_rate"])
            loss = float(metrics["loss"])
        self.batch_idx += 1
        return loss, list(batch["file_name"]), d, extra

    def window(self, seconds: float, tracer) -> dict:
        tr = self.wl["trace"]
        times: List[float] = []
        bad = 0
        t0 = last = time.perf_counter()
        while True:
            if len(times) == tr["skip"]:
                tracer.start()
            loss = self.step(tracer)[0]
            tracer.unit()
            now = time.perf_counter()
            times.append(now - last)
            last = now
            bad += not np.isfinite(loss)
            if len(times) == tr["skip"] + tr["steps"]:
                tracer.stop()
            if now - t0 >= seconds and len(times) >= 2:  # a percentile needs two steps
                break
        tracer.stop()
        return {"times": times, "window_s": last - t0, "units": len(times),
                "attempted": len(times), "failed": bad, "images": len(times) * self.batch}

    def close(self):
        self._it = None
        del self.state, self.model, self.loader, self.dataset


def end_to_end(rec: dict) -> Dict[str, float]:
    return {"train_img_s": rec["images"] / rec["window_s"],
            "train_step_p90_ms": 1e3 * statistics.quantiles(rec["times"], n=10)[8]}


# -- the reference, and the comparison that decides `correct` --------------------


def _batch(files, device):
    frames = [scene.read_frame(f) for f in files]
    img = torch.from_numpy(np.stack([f["image"] for f in frames])).to(device).float() / 255.0
    lab = torch.from_numpy(np.stack([f["coord"].transpose(1, 2, 0) for f in frames])).to(device)
    pose = torch.from_numpy(np.stack([f["pose"] for f in frames])).to(device)
    focal = torch.tensor(np.float32(frames[0]["focal"]), device=device)
    return img, lab, pose, focal


def coord_loss(cell, pred, lab, pose, focal, pp, step: int, evidence: dict,
               rows: Optional[slice]) -> torch.Tensor:
    """The reference's objective of checked step `step` on the augmented
    batch: here the coord reprojection loss (`reference/train.py`), which
    reads the prediction, the labels, the poses, the focal length and the
    principal point's shift `pp`, and not the rest.

    The rest is for an objective that needs the step's own draws, as the
    expected pose loss of end-to-end training (`train/dsac_step.py`) needs
    its hypotheses' sampled cells: its `port_step` draws them from the
    seed, hands them to the port's step and returns them as evidence;
    its loss reads them as `evidence["extra"][step]`, keeps the rows that
    `rows` keeps (None: all; a slice where a fault leaves rows out), and
    samples its scene coordinates from `pred` with them, its camera from
    `focal` and `pp`, its ground truth from `pose`."""
    return ref_train.coord_loss(pred, lab, pose, focal, pp, cell.config["loss"],
                                cell.config["subsample"])


def reference(cell, seed: int, evidence: dict, device, precision: Optional[str] = None,
              rows: Optional[slice] = None, loss: Callable = coord_loss) -> dict:
    """The plain reference's losses, first-gradient norms and changes per
    leaf over the checked steps, from the same seeded weights, rows and
    draws, under the objective `loss`. `precision`: by default float32 on a
    card and float64 on the CPU (where it costs little, and where float32
    convolutions round more coarsely than the card's); "tf32" computes it in
    TF32 (the control). `rows` keeps only those rows of each batch (a
    fault)."""
    cfg = cell.config
    dev = torch.device(device)
    precision = precision or ("float32" if dev.type == "cuda" else "float64")
    dtype = torch.float64 if precision == "float64" else torch.float32
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        P0 = {n: t.to(dtype) for n, t in weights.state_dict(cfg, seed, dev).items()}
        train = weights.trainable(cfg)
        P = {n: (t.clone().requires_grad_() if train.get(n) else t) for n, t in P0.items()}
        leaves = [n for n in P if train.get(n)]
        adam = ref_train.Adam([P[n] for n in leaves], cfg["optimizer"])
        arch, sub = ref_net.Arch.of(cfg), cfg["subsample"]
        out = {"losses": []}
        for k, (files, d) in enumerate(zip(evidence["rows"], evidence["draws"])):
            if rows is not None:
                files = files[rows]
                d = dict(d, brightness=d["brightness"][rows], contrast=d["contrast"][rows])
            img, lab, pose, focal = (t.to(dtype) for t in _batch(files, dev))
            dd = {key: v.to(dev, dtype) for key, v in d.items()}
            x, lab, pose, focal, pp = ref_train.augment(img, lab, pose, focal, dd, sub,
                                                        cfg["loss"]["nodata"])
            pred = ref_net.forward(x, P, arch)
            value = loss(cell, pred, lab, pose, focal, pp, k, evidence, rows)
            for n in leaves:
                P[n].grad = None
            value.backward()
            if k == 0:
                out["grad"] = {n: float(torch.linalg.vector_norm(P[n].grad)) for n in leaves}
            adam.step(ref_train.lr_at(k, cfg["optimizer"], evidence["steps_per_epoch"]))
            out["losses"].append(float(value.detach()))
            del pred, x, img, value
        with torch.no_grad():
            out["change"] = {n: float(torch.linalg.vector_norm(P[n] - P0[n])) for n in leaves}
        return out
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def compare(got: dict, ref: dict) -> Dict[str, float]:
    """The three numbers compared: the relative gap of the first step's
    loss; per leaf, the gap between the two first-gradient norms and between
    the two changes after the checked steps, against the reference's norm of
    that leaf or of the median leaf, whichever is larger, the worst leaf.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change. The
    later steps' losses are not compared: a cell of their loss crosses a
    validity threshold on rounding alone (PERF.md), and `explain` reports
    them."""
    def gap(a, b, scale):
        d = abs(a - b) / scale
        return d if math.isfinite(d) else math.inf

    loss_gap = gap(got["losses"][0], ref["losses"][0], abs(ref["losses"][0]))
    g_med = statistics.median(ref["grad"].values())
    c_med = statistics.median(ref["change"].values())
    grad_gap = max(gap(got["grad"][n], g, max(g, g_med)) for n, g in ref["grad"].items())
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * g_med]
    change_gap = max(gap(got["change"][n], ref["change"][n], max(ref["change"][n], c_med))
                     for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def check(cell, seed: int, evidence: dict, device, loss: Callable = coord_loss) -> Dict[str, float]:
    return compare(evidence, reference(cell, seed, evidence, device, loss=loss))


def controls(cell, seed: int, evidence: dict, device,
             loss: Callable = coord_loss) -> Dict[str, Dict[str, float]]:
    """Readings of the program, of the control (the reference in TF32 in
    the program's place) and of a fault (half of each batch left out, the
    mean taken over the rest), each against the float32 reference."""
    ref = reference(cell, seed, evidence, device, loss=loss)
    half = slice(0, int(cell.workload["batch"]) // 2)
    tf32 = reference(cell, seed, evidence, device, precision="tf32", loss=loss)
    return {"program": compare(evidence, ref), "tf32": compare(tf32, ref),
            "half_batch": compare(reference(cell, seed, evidence, device, rows=half, loss=loss),
                                  ref),
            "detail": {"program": explain(evidence, ref), "tf32": explain(tf32, ref)}}


def explain(got: dict, ref: dict, top: int = 3) -> dict:
    """Per-step loss gaps and the leaves that read worst, for the look
    behind a reading."""
    g_med = statistics.median(ref["grad"].values())
    c_med = statistics.median(ref["change"].values())
    grad = sorted(((abs(got["grad"][n] - g) / max(g, g_med), n, g) for n, g in ref["grad"].items()),
                  reverse=True)[:top]
    change = sorted(((abs(got["change"][n] - c) / max(c, c_med), n, c)
                     for n, c in ref["change"].items() if ref["grad"][n] >= 1e-3 * g_med),
                    reverse=True)[:top]
    return {"loss_steps": [abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])],
            "ref_losses": ref["losses"], "grad_worst": grad, "change_worst": change,
            "grad_median": g_med, "change_median": c_med}
