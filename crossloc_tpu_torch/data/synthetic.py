"""Synthetic scene written to disk in the dataset contract (counterpart of
`crossloc_tpu/data/synthetic.py`, "noise" scene).

Each frame has a random cam-to-world pose, random per-cell depth and a
random-texture image; the scene-coordinate labels are exact, so a solver fed
the labels must recover the pose. Draws come from `numpy.random.default_rng(seed)`
in the same order as the JAX package's generator.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import intrinsics, invert_se3, pixel_grid, rodrigues


def synth_sample(rng: np.random.Generator, img_h: int = 480, img_w: int = 720,
                 focal: float = 480.0, subsample: int = 8) -> dict:
    """One frame: image [H, W, 3] in [0, 1], pose [4, 4], focal, coord
    [h, w, 3], depth [h, w, 1], normal [h, w, 3], semantics [H, W] raw ids."""
    h, w = img_h // subsample, img_w // subsample
    rvec = rng.normal(size=3) * 0.5
    R = rodrigues(torch.as_tensor(rvec, dtype=torch.float32)).numpy()
    t = rng.normal(size=3) * 20 + np.array([0, 0, 120.0])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R
    pose[:3, 3] = t

    K = intrinsics(focal, img_w, img_h).numpy()
    grid = pixel_grid(h, w, subsample).numpy().reshape(-1, 2)
    depth = rng.uniform(40.0, 300.0, size=grid.shape[0]).astype(np.float32)
    x = (grid[:, 0] - K[0, 2]) / K[0, 0] * depth
    y = (grid[:, 1] - K[1, 2]) / K[1, 1] * depth
    cam_pts = np.stack([x, y, depth], axis=-1)
    world = (cam_pts @ R.T + t).astype(np.float32)

    normal_w = rng.normal(size=(grid.shape[0], 3))
    normal_w /= np.linalg.norm(normal_w, axis=-1, keepdims=True)
    sem_raw = rng.choice([0, 1, 2, 3, 6, 9, 17], size=(img_h, img_w)).astype(np.int64)
    image = rng.uniform(0, 1, size=(img_h, img_w, 3)).astype(np.float32)
    return {
        "image": image,
        "pose": pose,
        "focal": float(focal),
        "coord": world.reshape(h, w, 3),
        "depth": depth.reshape(h, w, 1),
        "normal": normal_w.reshape(h, w, 3).astype(np.float32),
        "semantics": sem_raw,
    }


def write_fake_dataset(root: str, n: int = 4, img_h: int = 96, img_w: int = 144,
                       focal: float = 120.0, seed: int = 0) -> str:
    """Write rgb/ poses/ calibration/ init/ depth/ normal/ semantics/ eye/
    under `root`. `focal` may be a scalar or a sequence cycled per image."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for d in ("rgb", "poses", "calibration", "init", "depth", "normal", "semantics", "eye"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    focals = list(np.atleast_1d(np.asarray(focal, np.float64)))
    for i in range(n):
        s = synth_sample(rng, img_h, img_w, float(focals[i % len(focals)]))
        name = f"frame_{i:05d}"
        Image.fromarray((s["image"] * 255).astype(np.uint8)).save(
            os.path.join(root, "rgb", name + ".png"))
        np.savetxt(os.path.join(root, "poses", name + ".txt"), s["pose"])
        np.savetxt(os.path.join(root, "calibration", name + ".txt"), [s["focal"]])

        def save_chw(arr, sub):
            torch.save(torch.from_numpy(np.ascontiguousarray(np.transpose(arr, (2, 0, 1)))),
                       os.path.join(root, sub, name + ".pt"))

        save_chw(s["coord"], "init")
        torch.save(torch.from_numpy(s["depth"][..., 0].copy()),
                   os.path.join(root, "depth", name + ".pt"))
        save_chw(s["normal"], "normal")
        np.save(os.path.join(root, "semantics", name + ".npy"), s["semantics"])
        w2c = invert_se3(torch.from_numpy(s["pose"])).numpy()
        save_chw((s["coord"] @ w2c[:3, :3].T + w2c[:3, 3]).astype(np.float32), "eye")
    return root
