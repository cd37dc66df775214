"""Synthetic scenes written to disk in the dataset contract (counterpart of
`crossloc_tpu/data/synthetic.py`).

"noise": each frame has a random cam-to-world pose, random per-cell depth
and a random-texture image; the scene-coordinate labels are exact, so a
solver fed the labels must recover the pose, but nothing is learnable.
"plane": a fixed textured world plane seen from random poses; the image is
a function of world position, so a net can learn pixel -> coordinate.
Draws come from `numpy.random.default_rng(seed)` in the same order as the
JAX package's generator.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import intrinsics, invert_se3, pixel_grid, rodrigues


# The plane world is centred on the reference's urbanscape coordinate mean
# (data/means.py), which the train CLI takes as the decoder's output offset.
_PLANE_Z = 91.96
_PLANE_CX, _PLANE_CY = -29.34, 184.17
_SEM_IDS = np.array([0, 1, 2, 3, 6, 9, 17], np.int64)


def _plane_texture(x, y):
    """Smooth RGB texture over the world plane: per-channel linear ramps
    (an unambiguous global position) plus two sinusoid octaves of detail."""
    x = x - _PLANE_CX
    y = y - _PLANE_CY

    def mix(ramp, waves):
        v = 0.5 + 0.3 * ramp / 240.0
        v = v + sum(w * np.sin(fx * x + fy * y + p) for fx, fy, p, w in waves)
        return np.clip(v, 0.0, 1.0).astype(np.float32)

    r = mix(x, [(0.031, -0.017, 1.3, 0.1), (0.11, 0.07, 0.5, 0.08),
                (0.23, -0.19, 2.1, 0.06)])
    g = mix(y, [(0.019, 0.027, 2.9, 0.1), (-0.083, 0.099, 1.9, 0.08),
                (0.17, 0.29, 0.2, 0.06)])
    b = mix(0.7 * (x - y), [(-0.029, 0.013, 0.4, 0.1),
                            (0.093, 0.061, 2.6, 0.08),
                            (-0.27, 0.15, 1.1, 0.06)])
    return np.stack([r, g, b], axis=-1)


def _plane_raycast(R, t, K, us, vs):
    """Camera rays through pixel centres (us, vs) hit the plane z = _PLANE_Z:
    (world [..., 3], z-depth [...])."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    dirs = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us)], axis=-1)
    rd = dirs @ R.T
    z = (_PLANE_Z - t[2]) / rd[..., 2]
    world = t + z[..., None] * rd
    return world.astype(np.float32), z.astype(np.float32)


def _plane_sample(rng, img_h, img_w, focal, subsample):
    """One frame of the fixed plane world from a random pose."""
    rvec = rng.normal(size=3) * 0.1
    R = rodrigues(torch.as_tensor(rvec, dtype=torch.float32)).numpy()
    t = np.array([_PLANE_CX + rng.uniform(-30, 30),
                  _PLANE_CY + rng.uniform(-30, 30),
                  _PLANE_Z - rng.uniform(70, 110)], np.float64)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R
    pose[:3, 3] = t
    K = intrinsics(focal, img_w, img_h).numpy().astype(np.float64)

    uu, vv = np.meshgrid(np.arange(img_w) + 0.5, np.arange(img_h) + 0.5)
    world_full, _ = _plane_raycast(R, t, K, uu, vv)
    image = _plane_texture(world_full[..., 0], world_full[..., 1])

    h, w = img_h // subsample, img_w // subsample
    grid = pixel_grid(h, w, subsample).numpy().astype(np.float64)
    world, zdepth = _plane_raycast(R, t, K, grid[..., 0], grid[..., 1])
    normal_w = np.zeros((h, w, 3), np.float32)
    normal_w[..., 2] = -1.0  # the plane's normal faces the camera (-z world)
    sem_cell = (np.floor(world_full[..., 0] / 40.0)
                + np.floor(world_full[..., 1] / 40.0)).astype(np.int64)
    return {
        "image": image,
        "pose": pose,
        "focal": float(focal),
        "coord": world.reshape(h, w, 3),
        "depth": zdepth.reshape(h, w, 1),
        "normal": normal_w,
        "semantics": _SEM_IDS[np.abs(sem_cell) % len(_SEM_IDS)],
    }


def synth_sample(rng: np.random.Generator, img_h: int = 480, img_w: int = 720,
                 focal: float = 480.0, subsample: int = 8, scene: str = "noise") -> dict:
    """One frame: image [H, W, 3] in [0, 1], pose [4, 4], focal, coord
    [h, w, 3], depth [h, w, 1], normal [h, w, 3], semantics [H, W] raw ids.
    `scene` is "noise" or "plane" (module docstring)."""
    if scene == "plane":
        return _plane_sample(rng, img_h, img_w, focal, subsample)
    if scene != "noise":
        raise ValueError(f"unknown scene kind {scene!r}")
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
                       focal: float = 120.0, seed: int = 0, fullsize: bool = False,
                       scene: str = "noise") -> str:
    """Write rgb/ poses/ calibration/ init/ depth/ normal/ semantics/ eye/
    under `root`. `focal` may be a scalar or a sequence cycled per image;
    `fullsize` writes labels at full resolution (subsample 1)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for d in ("rgb", "poses", "calibration", "init", "depth", "normal", "semantics", "eye"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    focals = list(np.atleast_1d(np.asarray(focal, np.float64)))
    for i in range(n):
        s = synth_sample(rng, img_h, img_w, float(focals[i % len(focals)]),
                         subsample=1 if fullsize else 8, scene=scene)
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
