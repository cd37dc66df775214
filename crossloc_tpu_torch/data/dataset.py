"""Host-side dataset over the CrossLoc directory contract (counterpart of
`crossloc_tpu/data/dataset.py`).

    <root>/rgb/           images (png/jpg), sorted by name
    <root>/poses/         4x4 cam-to-world text matrices
    <root>/calibration/   focal length scalars (text)
    <root>/init/          scene-coordinate tensors [3, h, w]   (mode 1 sparse)
    <root>/depth/         depth tensors [h, w] or mm-PNGs      (labels / mode 1 dense)
    <root>/normal/        surface-normal tensors [3, h, w]
    <root>/semantics/     raw-id label arrays [H, W] (.npy)
    <root>/eye/           camera-coordinate tensors            (mode 2)

Modes: 0 = RGB only; 1 = RGB + ground truth (sparse tensors, or dense
coordinates made from a depth PNG); 2 = RGB-D eye coordinates. Multiple
roots concatenate. Images are decoded as raw RGB and resized to the
standard height (focal rescaled to match): by the port's native decoder
(`crossloc_tpu_torch/native/`) when it builds, else by PIL; a dataset
records which in `decoder`. An item (`dataset[i]`) holds a float32 [0, 1]
image; a batch (`collate`, so the `Loader`'s) holds uint8 wire images, the
bits of `images_to_wire` of the stacked items' images, made in the thread
that collates. All augmentation and normalisation runs on the training
device (data/augment.py).
"""
from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from .. import native
from ..utils.profiling import add_counts
from .pipeline import quantize_images

IMAGE_HEIGHT = 480  # standard input height
OUTPUT_SUBSAMPLE = 8

# raw dataset class ids -> compact training ids (the reference's semantics loss)
_RAW_CLASSES = (0, 1, 2, 3, 6, 9, 17)
_NEW_CLASSES = (0, 1, 1, 2, 3, 4, 5)
NUM_SEMANTIC_CLASSES = 6


def trim_semantic_label(raw_labels: np.ndarray) -> np.ndarray:
    """Map raw {0,1,2,3,6,9,17} ids to compact {0..5} ids."""
    out = raw_labels.copy()
    for old, new in zip(_RAW_CLASSES, _NEW_CLASSES):
        out[raw_labels == old] = new
    if out.min() < 0 or out.max() > NUM_SEMANTIC_CLASSES - 1:
        raise ValueError("semantic label out of range after trimming")
    return out


def _load_rgb(path: str) -> np.ndarray:
    """Decode with PIL to uint8 RGB [H, W, 3]; gray and RGBA become RGB."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _load_image(path: str) -> np.ndarray:
    """Decode with PIL to float32 RGB [H, W, 3] in [0, 1]."""
    return _load_rgb(path).astype(np.float32) / 255.0


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


def _load_image_resized(path: str, image_height: int, on_fallback=None):
    """(image [image_height, W', 3] float32, focal scale): the native decoder
    when it is available, PIL otherwise or for a file it cannot decode
    (`on_fallback(path)` is then called). The two give the same bits when no
    resize is needed; when one is, their resamplings differ by up to about
    1e-2."""
    if native.available():
        dims = native.image_dims(path)
        if dims is not None:
            img = native.load_image_std_height(path, image_height)
            if img is not None:
                return img, image_height / dims[0]
        if on_fallback is not None:
            on_fallback(path)
    img = _load_image(path)
    return _resize_height(img, image_height), image_height / img.shape[0]


def _load_wire_image(path: str, image_height: int, on_fallback=None):
    """(image [image_height, W', 3] uint8, focal scale, direct): the bits of
    `quantize_images` of `_load_image_resized`'s image. Where the stored
    frame has the standard height (`direct`), the decoder's bytes as they
    are, no float32 image made; otherwise the float32 route, quantized,
    since a resampled float does not round-trip through bytes."""
    if native.available():
        dims = native.image_dims(path)
        if dims is not None and dims[0] == image_height:
            img = native.load_image_bytes(path, *dims)
            if img is not None:
                return img, 1.0, True
        elif dims is not None:
            img = native.load_image_std_height(path, image_height)
            if img is not None:
                return quantize_images(img), image_height / dims[0], False
        if on_fallback is not None:
            on_fallback(path)
    rgb = _load_rgb(path)
    h = rgb.shape[0]
    if h == image_height:
        return rgb, 1.0, True
    img = _resize_height(rgb.astype(np.float32) / 255.0, image_height)
    return quantize_images(img), image_height / h, False


def decoder_line(dataset) -> str:
    """The console line that says which decoder `dataset` uses, and how many
    of its files so far the native decoder could not read (PIL read them)."""
    if dataset.decoder == "native":
        jpeg = "" if native.jpeg() else "; JPEG through PIL: built without libjpeg"
        n = dataset.fallbacks
        more = f"; {n} file{'s' * (n != 1)} read by PIL so far" if n else ""
        return f"Image decoder: native ({native.library_path()}{jpeg}{more})"
    err = native.build_error()
    why = f"native build failed: {err.splitlines()[0]}" if err else "native decoder not in use"
    return f"Image decoder: PIL ({why})"


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


def _chw_to_hwc(t: np.ndarray) -> np.ndarray:
    if t.ndim == 2:
        return t[..., None].astype(np.float32)
    return np.transpose(t, (1, 2, 0)).astype(np.float32)


@dataclass
class CamLocItem:
    """One datapoint: image + pose + labels, numpy, channels-last."""

    image: np.ndarray  # [480, W, 3] float32 in [0, 1] (uint8 inside `collate`)
    pose: np.ndarray  # [4, 4] cam-to-world
    focal: float  # rescaled to the standard image height
    file_name: str
    coord: Optional[np.ndarray] = None  # [h, w, 3]
    depth: Optional[np.ndarray] = None  # [h, w, 1]
    normal: Optional[np.ndarray] = None  # [h, w, 3]
    semantics: Optional[np.ndarray] = None  # [H, W] int (trimmed ids)
    eye: Optional[np.ndarray] = None  # [h, w, 3] camera coordinates


class CamLocDataset:
    """Sequence-style dataset: raw RGB + pose + focal + the labels asked for.
    `decoder` is "native" or "PIL", the image decoder its items go through;
    `fallbacks` counts the image reads the native decoder failed and PIL did
    (the first is printed on the console)."""

    def __init__(self, root_dir: Union[str, Sequence[str]], mode: int = 1, sparse: bool = True,
                 coord: bool = True, depth: bool = False, normal: bool = False,
                 semantics: bool = False, grayscale: bool = False, raw_image: bool = False,
                 image_height: int = IMAGE_HEIGHT):
        self.mode = mode
        self.sparse = sparse
        self.grayscale = grayscale and not raw_image  # applied on the device, not here
        self.raw_image = raw_image
        self.image_height = image_height
        self.decoder = "native" if native.available() else "PIL"
        self.fallbacks = 0
        self._fallback_lock = threading.Lock()
        labelled = mode == 1 and sparse
        self.want = {"coord": coord and labelled, "depth": depth and labelled,
                     "normal": normal and labelled, "semantics": semantics and labelled}
        if labelled and not any(self.want.values()):
            raise ValueError("at least one label flag must be set in mode 1")

        roots = [root_dir] if isinstance(root_dir, (str, os.PathLike)) else list(root_dir)
        self.rgb_files: List[str] = []
        self.pose_files: List[str] = []
        self.calib_files: List[str] = []
        self.label_files = {k: [] for k in ("coord", "depth", "normal", "semantics")}
        for base in roots:
            self.rgb_files += _listdir_sorted(os.path.join(base, "rgb"))
            self.pose_files += _listdir_sorted(os.path.join(base, "poses"))
            self.calib_files += _listdir_sorted(os.path.join(base, "calibration"))
            if mode == 2:
                self.label_files["coord"] += _listdir_sorted(os.path.join(base, "eye"))
            elif labelled:
                for key, sub in (("coord", "init"), ("depth", "depth"), ("normal", "normal"),
                                 ("semantics", "semantics")):
                    if self.want[key]:
                        self.label_files[key] += _listdir_sorted(os.path.join(base, sub))
            elif mode == 1:  # dense: coordinates made from a depth map
                self.label_files["coord"] += _listdir_sorted(os.path.join(base, "depth"))
        if len(self.rgb_files) != len(self.pose_files):
            raise ValueError("RGB file count does not match pose file count")

    def __len__(self) -> int:
        return len(self.rgb_files)

    def __getitem__(self, idx: int) -> CamLocItem:
        img, f_scale = _load_image_resized(self.rgb_files[idx], self.image_height,
                                           self._fallback)
        return self._item(idx, img, f_scale)

    def _item(self, idx: int, img: np.ndarray, f_scale: float) -> CamLocItem:
        """Item `idx` around its decoded image (float32 or uint8) and the
        focal scale of its resize: the pose, calibration and labels."""
        focal = float(np.loadtxt(self.calib_files[idx])) * f_scale
        pose = np.loadtxt(self.pose_files[idx]).astype(np.float32)
        item = CamLocItem(image=img, pose=pose, focal=focal, file_name=self.rgb_files[idx])
        files = self.label_files
        if self.mode == 2:
            item.eye = _chw_to_hwc(_load_tensor(files["coord"][idx]))
        elif self.mode == 1 and self.sparse:
            for key in ("coord", "depth", "normal"):
                if self.want[key]:
                    setattr(item, key, _chw_to_hwc(_load_tensor(files[key][idx])))
            if self.want["semantics"]:
                raw = _load_tensor(files["semantics"][idx]).astype(np.int64)
                item.semantics = trim_semantic_label(raw)
        elif self.mode == 1:
            item.coord = self._dense_coords_from_depth(idx, img, pose, focal)
        return item

    def _fallback(self, path: str) -> None:
        with self._fallback_lock:
            self.fallbacks += 1
            first = self.fallbacks == 1
        if first:
            print(f"Image decoder: PIL for {path} (the native decoder cannot read it)",
                  flush=True)

    def _dense_coords_from_depth(self, idx, img, pose, focal) -> np.ndarray:
        """Scene coordinates by back-projecting a depth PNG (millimetres)
        through the cam-to-world pose: subsampled by 8 with a half-cell
        offset, pinhole back-projection, zero where depth is 0 or > 1000 m."""
        from PIL import Image

        with Image.open(self.label_files["coord"][idx]) as im:
            depth = np.asarray(im).astype(np.float64) / 1000.0  # mm -> m
        H, W = img.shape[:2]
        if depth.shape != (H, W):  # nearest resize to the standard image size
            ys = (np.arange(H) * depth.shape[0] / H).astype(int)
            xs = (np.arange(W) * depth.shape[1] / W).astype(int)
            depth = depth[ys][:, xs]

        off = OUTPUT_SUBSAMPLE // 2
        d = depth[off::OUTPUT_SUBSAMPLE, off::OUTPUT_SUBSAMPLE]
        h, w = d.shape
        gx, gy = np.meshgrid(np.arange(w) * OUTPUT_SUBSAMPLE + off,
                             np.arange(h) * OUTPUT_SUBSAMPLE + off)
        x = (gx - W / 2.0) / focal * d
        y = (gy - H / 2.0) / focal * d
        eye = np.stack([x, y, d, np.ones_like(d)], axis=-1)  # [h, w, 4]
        sc = (eye.reshape(-1, 4) @ pose.T).reshape(h, w, 4)[..., 0:3]
        sc[(d == 0) | (d > 1000)] = 0.0
        out = np.zeros((math.ceil(H / OUTPUT_SUBSAMPLE), math.ceil(W / OUTPUT_SUBSAMPLE), 3))
        out[:h, :w] = sc
        return out.astype(np.float32)

    def collate(self, indices: Sequence[int]) -> dict:
        """Stack items into a host batch dict (numpy, NHWC). `image` is the
        uint8 wire batch [B, H, W, 3]: every frame bit-equal to
        `images_to_wire` of the item's float32 image, the decoder's bytes
        as they are where no resize is needed. The frames that took that
        route are added to the enclosing span as its `direct` count (the
        Loader's `data.collate`)."""
        items, direct = [], 0
        for i in indices:
            img, f_scale, took_bytes = _load_wire_image(self.rgb_files[i], self.image_height,
                                                        self._fallback)
            items.append(self._item(i, img, f_scale))
            direct += took_bytes
        add_counts(direct=direct)
        batch = {
            "image": np.stack([it.image for it in items]),
            "pose": np.stack([it.pose for it in items]),
            "focal": np.asarray([it.focal for it in items], np.float32),
            "file_name": [it.file_name for it in items],
        }
        for key in ("coord", "depth", "normal", "semantics", "eye"):
            vals = [getattr(it, key) for it in items]
            if vals[0] is not None:
                batch[key] = np.stack(vals)
        return batch
