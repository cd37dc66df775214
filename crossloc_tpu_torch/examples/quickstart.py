"""Programmatic quickstart (counterpart of `examples/quickstart.py`): train on
a synthetic scene, then localize, on the card unless `--device cpu`.

The JAX example's scene from the same numpy seed (one 96x144 noise frame,
focal 120, four copies a batch), the tiny coord net with seeded weights and
the labels' mean as its output offset, Adam at a constant 3e-3, then the
differentiable RANSAC solver on the net's own predictions (default
`RansacConfig`, draws from a torch generator seeded 0) and the per-image
pose errors.

    python -m crossloc_tpu_torch.examples.quickstart [--steps N] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from crossloc_tpu_torch import data, geometry as geo, models, ransac
from crossloc_tpu_torch.device import resolve_device
from crossloc_tpu_torch.train import TrainBatch, TrainState, make_optimizer, train_step


def main(steps: int = 400, device: str = "cuda"):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    scene = data.synth_sample(rng, img_h=96, img_w=144, focal=120.0)

    B = 4
    images = torch.from_numpy(np.stack([scene["image"]] * B)).to(dev)
    labels = torch.from_numpy(np.stack([scene["coord"]] * B)).to(dev)
    poses = torch.from_numpy(np.stack([scene["pose"]] * B)).to(dev)
    focal = torch.tensor(scene["focal"], dtype=torch.float32, device=dev)
    mean = labels.reshape(-1, 3).mean(0)

    # 1. model + optimizer (reference hyperparameters)
    model = models.build_network("coord", tiny=True, mean=mean.tolist())
    models.init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev)
    state = TrainState(model, make_optimizer(list(model.parameters()), 3e-3,
                                             no_lr_scheduling=True))
    norm_images = data.normalize_images(images)

    # 2. one training step a batch: forward, coord loss, backward, Adam
    batch = TrainBatch(norm_images, poses, labels, focal)
    for i in range(steps):
        metrics = train_step(state, batch, "coord", None)
        if i % 100 == 0:
            print(f"step {i:4d}  loss {float(metrics['loss']):8.2f}  "
                  f"valid {float(metrics['valid_rate']):.2f}")

    # 3. localize from the net's own predictions
    with torch.no_grad():
        preds = model(norm_images)[..., :3].float()
    res = ransac.solve_batch(preds, float(focal), tuple(images.shape[1:3]),
                             generator=torch.Generator(device=dev).manual_seed(0))
    est = res.cam_to_world.cpu()
    t_err = np.linalg.norm(est[:, :3, 3].numpy() - scene["pose"][None, :3, 3], axis=-1)
    r_err = geo.rotation_angle_deg(est[:, :3, :3], poses[:, :3, :3].cpu()).numpy()
    print(f"pose errors: {t_err.round(2)} m, {r_err.round(2)} deg")
    return t_err, r_err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400, help="training steps")
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without CUDA) or cpu")
    a = ap.parse_args()
    main(steps=a.steps, device=a.device)
