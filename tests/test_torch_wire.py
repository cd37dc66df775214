"""The batches' uint8 wire images against the items' float32 images.

`CamLocDataset.collate` emits `image` as uint8 in the thread that collates:
the decoder's bytes where the stored frame needs no resize, else the float32
image quantized. Each frame must be bit-equal to `images_to_wire` of the
stacked `dataset[i].image`, on every route: native and PIL decoders, with
and without a resize, at every colour type the decoders reduce to RGB, and
for files the native decoder refuses. `images_to_wire` hands a uint8 batch
on as it is; the Loader's `data.collate` span counts the direct frames.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_native import _toolchain_missing, _write_png
from torch.profiler import ProfilerActivity, profile

from crossloc_tpu_torch import data, native
from crossloc_tpu_torch.data import dataset as tds
from crossloc_tpu_torch.utils import profiling

torch.set_num_threads(2)

H, W = 24, 36  # stored frames; image_height 16 resizes them to 16 x 24


@pytest.fixture(scope="module")
def built():
    why = _toolchain_missing()
    if why:
        pytest.skip(why)
    assert native.ensure_built(), native.build_error()


def _save(path_stem, kind, rng):
    """Write one H x W frame of `kind`; returns its path."""
    rgb = rng.integers(0, 256, size=(H, W, 3), dtype=np.uint8)
    if kind == "rgb":
        path = path_stem + ".png"
        Image.fromarray(rgb).save(path)
    elif kind == "gray":
        path = path_stem + ".png"
        Image.fromarray(rgb[..., 0]).save(path)
    elif kind == "rgba":
        path = path_stem + ".png"
        Image.fromarray(np.concatenate([rgb, rgb[..., :1]], axis=-1)).save(path)
    elif kind == "palette":
        path = path_stem + ".png"
        Image.fromarray(rgb).convert("P").save(path)
    elif kind == "rgb16":  # 16-bit samples: both decoders keep the high byte
        path = path_stem + ".png"
        _write_png(path, rng.integers(0, 65536, size=(H, W, 3)).astype(np.uint16), 2, 16)
    elif kind == "jpeg":
        path = path_stem + ".jpg"
        Image.fromarray(rgb).save(path, quality=95)
    elif kind == "adam7":  # interlaced: the native decoder reads the header, refuses the data
        path = path_stem + ".png"
        _write_png(path, rgb, 2, 8, interlace=True)
    elif kind == "bmp":  # the native decoder cannot even read the header
        path = path_stem + ".bmp"
        Image.fromarray(rgb).save(path)
    else:
        raise ValueError(kind)
    return path


KINDS = ["rgb", "gray", "rgba", "palette", "rgb16", "jpeg", "adam7", "bmp"]


def _scene(root, kind, n=2):
    """A 2-frame scene whose rgb/ holds frames of `kind`."""
    data.write_fake_dataset(root, n=n, img_h=H, img_w=W, focal=30.0, seed=1)
    rgb = os.path.join(root, "rgb")
    rng = np.random.default_rng(KINDS.index(kind))
    for f in sorted(os.listdir(rgb)):
        os.remove(os.path.join(rgb, f))
        _save(os.path.join(rgb, os.path.splitext(f)[0]), kind, rng)
    return root


@pytest.mark.parametrize("image_height", [H, 16], ids=["no_resize", "resize"])
@pytest.mark.parametrize("decoder", ["native", "PIL"])
@pytest.mark.parametrize("kind", KINDS)
def test_collate_is_the_wire_of_the_items(built, tmp_path, monkeypatch, kind, decoder,
                                          image_height):
    root = _scene(str(tmp_path / "scene"), kind)
    if decoder == "PIL":
        monkeypatch.setattr(native, "available", lambda: False)
    ds = data.CamLocDataset(root, image_height=image_height)
    assert ds.decoder == decoder
    items = [ds[i] for i in range(len(ds))]
    assert all(it.image.dtype == np.float32 for it in items)
    batch = ds.collate(range(len(ds)))
    want = data.images_to_wire(np.stack([it.image for it in items]))
    assert batch["image"].dtype == np.uint8
    assert batch["image"].shape == (2, image_height, W * image_height // H, 3)
    np.testing.assert_array_equal(batch["image"], want)
    np.testing.assert_array_equal(batch["focal"], [it.focal for it in items])
    np.testing.assert_array_equal(batch["pose"], np.stack([it.pose for it in items]))
    assert batch["file_name"] == [it.file_name for it in items]


@pytest.mark.parametrize("image_height, direct", [(H, True), (16, False)],
                         ids=["no_resize", "resize"])
def test_each_route_of_a_frame(built, tmp_path, monkeypatch, image_height, direct):
    """Native bytes, native resize, native refusal to PIL, PIL alone: the
    same bits as the float32 route, and `direct` where no resize ran."""
    rng = np.random.default_rng(0)
    paths = {k: _save(str(tmp_path / k), k, rng) for k in ("rgb", "adam7", "bmp")}
    for kind, path in paths.items():
        for use_native in (True, False):
            monkeypatch.setattr(native, "available", lambda: use_native)
            fell = []
            img, scale, took = tds._load_wire_image(path, image_height, fell.append)
            ref, ref_scale = tds._load_image_resized(path, image_height)
            assert img.dtype == np.uint8 and took == direct and scale == ref_scale
            np.testing.assert_array_equal(img, data.images_to_wire(ref))
            assert fell == ([path] if use_native and kind != "rgb" else [])


def test_the_native_bytes_are_the_float_route_numerators(built, tmp_path):
    path = _save(str(tmp_path / "f"), "rgb16", np.random.default_rng(4))
    got = native.load_image_bytes(path, H, W)
    np.testing.assert_array_equal(got.astype(np.float32) / np.float32(255.0),
                                  native.load_image(path, H, W))
    assert native.load_image_bytes(path, 16, 24) is None  # this entry never resizes
    assert native.load_image_bytes(str(tmp_path / "missing.png"), H, W) is None


def test_every_byte_survives_the_float_round_trip():
    k = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(data.images_to_wire(k.astype(np.float32) / 255.0), k)
    np.testing.assert_array_equal(data.images_to_wire(np.array([-0.1, 0.5, 1.2], np.float32)),
                                  [0, 128, 255])


def _wire_spans():
    return [r.counts for r in profiling.records() if r.name == "data.wire"]


def test_images_to_wire_hands_uint8_on_unconverted():
    profiling.clear()
    batch = np.random.default_rng(0).integers(0, 256, size=(2, 4, 6, 3), dtype=np.uint8)
    floats = batch.astype(np.float32) / 255.0
    with profile(activities=[ProfilerActivity.CPU]):
        same = data.images_to_wire(batch)
        converted = data.images_to_wire(floats)
    assert same is batch
    np.testing.assert_array_equal(converted, batch)
    assert _wire_spans() == [{"bytes": 0}, {"bytes": batch.size}]
    profiling.clear()


@pytest.mark.parametrize("image_height, direct", [(H, 1.0), (16, 0.0)],
                         ids=["no_resize", "resize"])
def test_collate_span_counts_the_direct_frames(built, tmp_path, image_height, direct):
    root = str(tmp_path / "scene")
    data.write_fake_dataset(root, n=5, img_h=H, img_w=W, focal=30.0, seed=2)
    loader = data.Loader(data.CamLocDataset(root, image_height=image_height), 2,
                         num_workers=2, prefetch=1)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        batches = list(loader)
    spans = [r.counts for r in profiling.records() if r.name == "data.collate"]
    profiling.clear()
    assert sorted(s["frames"] for s in spans) == [1, 2, 2]
    assert all(s["direct"] == direct * s["frames"] for s in spans)
    assert all(b["image"].dtype == np.uint8 for b in batches)
