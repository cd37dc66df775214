"""Host-side dataset over the CrossLoc directory contract, eval subset
(counterpart of `crossloc_tpu/data/dataset.py`).

    <root>/rgb/           images (png/jpg), sorted by name
    <root>/poses/         4x4 cam-to-world text matrices
    <root>/calibration/   focal length scalars (text)
    <root>/init/          scene-coordinate tensors [3, h, w]

Mode 1 (RGB + sparse ground truth) with coord labels: what the coord eval
path reads; images are the raw [0, 1] RGB (no normalisation). They are
decoded with PIL and resized to the standard height (focal rescaled to
match). Multiple roots concatenate. Other modes and labels come with the
training and other-task slices (ROADMAP queue 1, items 8 and 11).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Sequence, Union

import numpy as np

IMAGE_HEIGHT = 480  # standard input height


def _load_image(path: str) -> np.ndarray:
    """Decode to float32 RGB [H, W, 3] in [0, 1]; gray and RGBA become RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0


def _resize_height(img: np.ndarray, height: int) -> np.ndarray:
    """Resize keeping the aspect ratio so that the image height == height."""
    from PIL import Image

    h, w = img.shape[:2]
    if h == height:
        return img
    new_w = int(round(w * height / h))
    im = Image.fromarray((img * 255.0).astype(np.uint8))
    im = im.resize((new_w, height), Image.BILINEAR)
    return np.asarray(im, dtype=np.float32) / 255.0


def _load_image_resized(path: str, image_height: int):
    """(image [image_height, W', 3] float32, focal scale)."""
    img = _load_image(path)
    return _resize_height(img, image_height), image_height / img.shape[0]


def _load_tensor(path: str) -> np.ndarray:
    """Load a label tensor saved as torch .pt, .npy or .npz."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        with np.load(path) as z:
            return z[list(z.keys())[0]]
    import torch

    t = torch.load(path, map_location="cpu", weights_only=True)
    return t.numpy() if hasattr(t, "numpy") else np.asarray(t)


def _listdir_sorted(d: str) -> List[str]:
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


@dataclass
class CamLocItem:
    """One datapoint: image + pose + labels, numpy, channels-last."""

    image: np.ndarray  # [480, W, 3] float32 in [0, 1]
    pose: np.ndarray  # [4, 4] cam-to-world
    focal: float  # rescaled to the standard image height
    file_name: str
    coord: np.ndarray  # [h, w, 3]


class CamLocDataset:
    """Sequence-style dataset: raw RGB + pose + focal + coord labels."""

    def __init__(self, root_dir: Union[str, Sequence[str]], image_height: int = IMAGE_HEIGHT):
        self.image_height = image_height
        roots = [root_dir] if isinstance(root_dir, (str, os.PathLike)) else list(root_dir)
        self.rgb_files: List[str] = []
        self.pose_files: List[str] = []
        self.calib_files: List[str] = []
        self.coord_files: List[str] = []
        for base in roots:
            self.rgb_files += _listdir_sorted(os.path.join(base, "rgb"))
            self.pose_files += _listdir_sorted(os.path.join(base, "poses"))
            self.calib_files += _listdir_sorted(os.path.join(base, "calibration"))
            self.coord_files += _listdir_sorted(os.path.join(base, "init"))
        if len(self.rgb_files) != len(self.pose_files):
            raise ValueError("RGB file count does not match pose file count")

    def __len__(self) -> int:
        return len(self.rgb_files)

    def __getitem__(self, idx: int) -> CamLocItem:
        img, f_scale = _load_image_resized(self.rgb_files[idx], self.image_height)
        focal = float(np.loadtxt(self.calib_files[idx])) * f_scale
        pose = np.loadtxt(self.pose_files[idx]).astype(np.float32)
        coord = np.transpose(_load_tensor(self.coord_files[idx]), (1, 2, 0)).astype(np.float32)
        return CamLocItem(image=img, pose=pose, focal=focal, file_name=self.rgb_files[idx],
                          coord=coord)

    def collate(self, indices: Sequence[int]) -> dict:
        """Stack items into a host batch dict (numpy, NHWC)."""
        items = [self[i] for i in indices]
        return {
            "image": np.stack([it.image for it in items]),
            "pose": np.stack([it.pose for it in items]),
            "focal": np.asarray([it.focal for it in items], np.float32),
            "file_name": [it.file_name for it in items],
            "coord": np.stack([it.coord for it in items]),
        }
