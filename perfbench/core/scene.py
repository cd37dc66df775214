"""The benchmark's scene: frames of a textured world plane written from the
seed in the CrossLoc directory contract, which the port's dataset reads.

    <root>/rgb/frame_#####.png     480x720 RGB, about 0.75 MB each
    <root>/poses/frame_#####.txt   4x4 cam-to-world
    <root>/calibration/...txt      focal length in pixels
    <root>/init/frame_#####.npy    scene coordinates [3, H/8, W/8], nodata -1

The plane lies at the urbanscape coordinate mean's height, so a net whose
output offset is that mean predicts in front of every camera. Its texture
is a function of the world position (ramps and sinusoids), plus seeded
per-pixel noise of +-`noise_levels` grey levels so that the PNGs compress
like photographs. A share `nodata_share` of the label cells carries the
nodata marker, as sky does in the real scenes. The geometry is a frozen
copy of the plane scene of the port's synthetic writer; the images are
rendered on the run's device in chunks and PNG-encoded by a thread pool,
the labels computed in numpy.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List

import numpy as np

from . import seeds

PLANE_Z = 91.96
PLANE_CX, PLANE_CY = -29.34, 184.17


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def texture(x, y):
    """RGB in [0, 1] at world (x, y) (torch tensors): per-channel ramps plus
    sinusoids."""
    import torch

    x = x - PLANE_CX
    y = y - PLANE_CY

    def mix(ramp, waves):
        v = 0.5 + 0.3 * ramp / 240.0
        for fx, fy, p, w in waves:
            v = v + w * torch.sin(fx * x + fy * y + p)
        return torch.clamp(v, 0.0, 1.0)

    r = mix(x, [(0.031, -0.017, 1.3, 0.1), (0.11, 0.07, 0.5, 0.08), (0.23, -0.19, 2.1, 0.06)])
    g = mix(y, [(0.019, 0.027, 2.9, 0.1), (-0.083, 0.099, 1.9, 0.08), (0.17, 0.29, 0.2, 0.06)])
    b = mix(0.7 * (x - y), [(-0.029, 0.013, 0.4, 0.1), (0.093, 0.061, 2.6, 0.08),
                            (-0.27, 0.15, 1.1, 0.06)])
    return torch.stack([r, g, b], dim=-1)


def camera(seed: int, root_tag: str, index: int):
    """(R, t) cam-to-world of one frame, drawn from the seed."""
    rng = seeds.rng(seed, "scene", root_tag, index)
    R = rodrigues(rng.normal(size=3) * 0.1)
    t = np.array([PLANE_CX + rng.uniform(-30, 30), PLANE_CY + rng.uniform(-30, 30),
                  PLANE_Z - rng.uniform(70, 110)])
    return R, t


def labels(seed: int, root_tag: str, index: int, R, t, focal: float, height: int, width: int,
           subsample: int, nodata_share: float) -> np.ndarray:
    """Scene coordinates [3, H/s, W/s] at the label cells' centres, float32,
    with a seeded share of nodata cells."""
    h, w = height // subsample, width // subsample
    gu, gv = np.meshgrid(np.arange(w) * subsample + subsample / 2.0,
                         np.arange(h) * subsample + subsample / 2.0)
    dirs = np.stack([(gu - width / 2.0) / focal, (gv - height / 2.0) / focal,
                     np.ones_like(gu)], axis=-1)
    rd = dirs @ R.T
    coords = (t + ((PLANE_Z - t[2]) / rd[..., 2])[..., None] * rd).astype(np.float32)
    coords[seeds.rng(seed, "nodata", root_tag, index).random((h, w)) < nodata_share] = -1.0
    return np.ascontiguousarray(coords.transpose(2, 0, 1))


def images(seed: int, root_tag: str, cams, focal: float, height: int, width: int,
           noise_levels: int, device) -> np.ndarray:
    """uint8 images [n, H, W, 3] of the cameras `cams` [(R, t), ...],
    rendered on `device`, with seeded noise."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seeds.derive(seed, "noise", root_tag,
                                                                  len(cams)))
    vs, us = torch.meshgrid(torch.arange(height, device=device, dtype=torch.float64) + 0.5,
                            torch.arange(width, device=device, dtype=torch.float64) + 0.5,
                            indexing="ij")
    dirs = torch.stack([(us - width / 2.0) / focal, (vs - height / 2.0) / focal,
                        torch.ones_like(us)], dim=-1)
    R = torch.as_tensor(np.stack([c[0] for c in cams]), device=device)
    t = torch.as_tensor(np.stack([c[1] for c in cams]), device=device)
    rd = torch.einsum("hwj,nij->nhwi", dirs, R)
    world = t[:, None, None, :] + ((PLANE_Z - t[:, 2, None, None]) / rd[..., 2])[..., None] * rd
    img = torch.round(texture(world[..., 0].float(), world[..., 1].float()) * 255.0)
    img = img + torch.randint(-noise_levels, noise_levels + 1, img.shape, generator=gen,
                              device=device)
    return torch.clamp(img, 0, 255).to(torch.uint8).cpu().numpy()


def write(base: str, seed: int, spec: dict, height: int, width: int, subsample: int,
          device="cpu", threads: int = 8, chunk: int = 32) -> List[str]:
    """Write every root of `spec` ({"roots": [[name, frames], ...], "focal",
    "noise_levels", "nodata_share"}) under `base`, the images rendered on
    `device` in chunks of `chunk` frames and encoded by `threads` threads;
    returns the root directories in order."""
    from PIL import Image

    focal = float(spec["focal"])
    roots = []
    with ThreadPoolExecutor(threads) as pool:
        futures = []
        for name, n in spec["roots"]:
            root = os.path.join(base, name)
            roots.append(root)
            for sub in ("rgb", "poses", "calibration", "init"):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
            for lo in range(0, int(n), chunk):
                idx = range(lo, min(int(n), lo + chunk))
                cams = [camera(seed, name, i) for i in idx]
                imgs = images(seed, f"{name}/{lo}", cams, focal, height, width,
                              int(spec["noise_levels"]), device)

                def one(i, img, cam, root=root, name=name):
                    stem = f"frame_{i:05d}"
                    Image.fromarray(img).save(os.path.join(root, "rgb", stem + ".png"),
                                              compress_level=1)
                    pose = np.eye(4)
                    pose[:3, :3], pose[:3, 3] = cam
                    np.savetxt(os.path.join(root, "poses", stem + ".txt"), pose)
                    np.savetxt(os.path.join(root, "calibration", stem + ".txt"), [focal])
                    np.save(os.path.join(root, "init", stem + ".npy"),
                            labels(seed, name, i, *cam, focal, height, width, subsample,
                                   float(spec["nodata_share"])))

                futures += [pool.submit(one, i, img, cam) for i, img, cam in zip(idx, imgs, cams)]
        for f in futures:
            f.result()
    return roots


def read_frame(path_rgb: str) -> dict:
    """One frame as both sides' raw inputs: the PNG's uint8 pixels, the
    pose, the focal length and the label array, read from the files."""
    from PIL import Image

    root, fname = os.path.split(os.path.dirname(path_rgb))[0], os.path.basename(path_rgb)
    stem = os.path.splitext(fname)[0]
    with Image.open(path_rgb) as im:
        image = np.asarray(im.convert("RGB"))
    return {"image": image,
            "pose": np.loadtxt(os.path.join(root, "poses", stem + ".txt")).astype(np.float32),
            "focal": float(np.loadtxt(os.path.join(root, "calibration", stem + ".txt"))),
            "coord": np.load(os.path.join(root, "init", stem + ".npy"))}
