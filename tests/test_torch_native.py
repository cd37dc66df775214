"""The port's native image decoder (`crossloc_tpu_torch/native/`) against the
port's PIL path and against the JAX package's decoder (libpng / libjpeg).

Without a resize the native decoder gives the PIL path's bits. Against
`crossloc_tpu.native` it is bit-equal without a resize and within 1e-6 with
one (the JAX build's `-march=native` may contract multiply-adds into FMAs).
The port decodes PNG on zlib alone: PNGs written here row filter by row
filter, at every bit depth and colour type, hold it to libpng's bits.
Skips only when g++ or zlib's header is missing, and the comparisons with
the JAX package's decoder when that one does not build.
"""
import os
import re
import shutil
import struct
import subprocess
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import crossloc_tpu
from crossloc_tpu import native as jnative
from crossloc_tpu_torch import data, native
from crossloc_tpu_torch.cli import train_single_task as train_cli
from crossloc_tpu_torch.data import dataset as tds
from crossloc_tpu_torch.utils import read_training_log

torch.set_num_threads(2)

JAX_NATIVE_DIR = os.path.join(os.path.dirname(crossloc_tpu.__file__), "native")


def _toolchain_missing():
    """Why the decoder cannot build here (no g++, or no zlib.h), or None."""
    if shutil.which("g++") is None:
        return "g++ not found"
    r = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                       input="#include <zlib.h>\n", capture_output=True, text=True)
    return None if r.returncode == 0 else f"zlib's header missing: {r.stderr}"


@pytest.fixture(scope="module")
def built():
    why = _toolchain_missing()
    if why:
        pytest.skip(why)
    assert native.ensure_built(), native.build_error()


@pytest.fixture(scope="module")
def jax_built(built):
    if not jnative.ensure_built():
        pytest.skip("the JAX package's decoder did not build")


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """name -> path: RGB PNG and JPEG, gray, RGBA and palette PNGs, 60x90,
    and a 480-tall RGB PNG."""
    rng = np.random.default_rng(3)
    d = tmp_path_factory.mktemp("imgs")
    arr = rng.integers(0, 256, size=(60, 90, 3), dtype=np.uint8)
    out = {}
    for name, im, ext in (
        ("png", Image.fromarray(arr), "png"),
        ("jpeg", Image.fromarray(arr), "jpg"),
        ("gray", Image.fromarray(arr[..., 0]), "png"),
        ("rgba", Image.fromarray(np.concatenate([arr, arr[..., :1]], axis=-1)), "png"),
        ("palette", Image.fromarray(arr).convert("P"), "png"),
        ("tall", Image.fromarray(rng.integers(0, 256, size=(480, 64, 3), dtype=np.uint8)), "png"),
    ):
        out[name] = str(d / f"{name}.{ext}")
        im.save(out[name], **({"quality": 95} if ext == "jpg" else {}))
    return out


@pytest.mark.parametrize("name", ["png", "jpeg"])
def test_dims(built, images, name):
    if name == "jpeg" and not native.jpeg():
        pytest.skip("built without libjpeg: no jpeglib.h here")
    assert native.image_dims(images[name]) == (60, 90)
    assert native.image_dims(images["tall"]) == (480, 64)


def test_480_tall_png_same_bits_as_pil(built, images, tmp_path):
    root = str(tmp_path / "scene")
    data.write_fake_dataset(root, n=2, img_h=480, img_w=48, focal=480.0, seed=0, scene="plane")
    rgb = os.path.join(root, "rgb")
    for path in [images["tall"]] + [os.path.join(rgb, f) for f in sorted(os.listdir(rgb))]:
        ours = native.load_image_std_height(path, 480)  # the native decoder, no fallback
        pil = tds._resize_height(tds._load_image(path), 480)
        assert ours is not None and ours.dtype == np.float32
        np.testing.assert_array_equal(ours, pil)
        img, f_scale = tds._load_image_resized(path, 480, on_fallback=pytest.fail)
        assert f_scale == 1.0
        np.testing.assert_array_equal(img, pil)


@pytest.mark.parametrize("size", [(60, 90), (30, 45), (120, 180), (48, 71)],
                         ids=["same", "down", "up", "odd"])
@pytest.mark.parametrize("name", ["png", "jpeg", "gray", "rgba", "palette"])
def test_matches_the_jax_build(jax_built, images, name, size):
    if name == "jpeg" and not native.jpeg():
        pytest.skip("built without libjpeg: no jpeglib.h here")
    ours = native.load_image(images[name], *size)
    ref = jnative.load_image(images[name], *size)
    assert ours.shape == (*size, 3) and ours.dtype == np.float32
    if size == (60, 90):
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(native.load_image_std_height(images[name], 30),
                                  native.load_image(images[name], 30, 45))


@pytest.mark.parametrize("name", ["png", "gray", "rgba", "palette"])
def test_png_modes_without_resize_are_pil_bits(built, images, name):
    pil = np.asarray(Image.open(images[name]).convert("RGB"), dtype=np.float32) / 255.0
    np.testing.assert_array_equal(native.load_image(images[name], 60, 90), pil)


def test_missing_file_gives_none(built, tmp_path):
    missing = str(tmp_path / "nothing.png")
    assert native.image_dims(missing) is None
    assert native.load_image(missing, 8, 8) is None
    assert native.load_image_std_height(missing, 8) is None


def test_dataset_and_train_cli_say_native(built, tmp_path, monkeypatch, capsys):
    root = tmp_path / "datasets" / "urbanscape" / "train_sim"
    data.write_fake_dataset(str(root), n=2, img_h=32, img_w=48, focal=40.0, seed=0, scene="plane")
    ds = data.CamLocDataset(str(root), image_height=32)
    assert ds.decoder == "native"
    assert data.decoder_line(ds) == f"Image decoder: native ({native.library_path()})"

    monkeypatch.chdir(tmp_path)
    out_dir = train_cli.main([
        "urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny", "--batch_size", "2",
        "--epochs", "1", "--sim_data_chunk", "1.0", "--real_data_chunk", "0.0",
        "--datasets_dir", str(tmp_path / "datasets"), "--image_height", "32", "--device", "cpu"])
    console = capsys.readouterr().out
    assert f"Image decoder: native ({native.library_path()})" in console.splitlines()
    log = open(os.path.join(out_dir, "output.log")).read()
    assert "Image decoder" not in log and re.search(r"Total loss: [-\d.]+,", log)
    assert read_training_log(os.path.join(out_dir, "output.log"), 2) == (2, 0)


def test_pil_fallback_is_said(built, tmp_path, monkeypatch):
    root = str(tmp_path / "scene")
    data.write_fake_dataset(root, n=1, img_h=32, img_w=48, focal=40.0, seed=0)
    monkeypatch.setattr(native, "available", lambda: False)
    ds = data.CamLocDataset(root, image_height=32)
    assert ds.decoder == "PIL"
    assert data.decoder_line(ds) == "Image decoder: PIL (native decoder not in use)"


def test_failed_build_is_kept_not_raised(tmp_path, monkeypatch):
    bad = tmp_path / "loader.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available() is False and native.ensure_built() is False
    assert native.image_dims(str(bad)) is None and native.load_image(str(bad), 4, 4) is None
    first = native.build_error().splitlines()[0]
    assert first
    root = str(tmp_path / "scene")
    data.write_fake_dataset(root, n=1, img_h=32, img_w=48, focal=40.0, seed=0)
    ds = data.CamLocDataset(root, image_height=32)
    assert ds.decoder == "PIL" and ds[0].image.shape == (32, 48, 3)
    assert data.decoder_line(ds) == f"Image decoder: PIL (native build failed: {first})"


def test_build_lands_in_the_port_and_leaves_jax_alone(built):
    def listing():
        return sorted((f, os.stat(os.path.join(JAX_NATIVE_DIR, f)).st_mtime_ns)
                      for f in os.listdir(JAX_NATIVE_DIR))

    port_build = os.path.join(os.path.dirname(data.__file__), os.pardir, "build")
    assert os.path.samefile(native.library_path().parent, port_build)
    assert native.library_path().exists()
    before = listing()
    target = native.BUILD_DIR / f"libclloader-test-{os.getpid()}.so"
    try:
        native._build(target, quiet=True)
        assert target.exists()
    finally:
        target.unlink(missing_ok=True)
    assert listing() == before
    assert not any(p.endswith(".tmp") for p in os.listdir(native.BUILD_DIR)
                   if p.startswith(f"libclloader-test-{os.getpid()}"))


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))


def _pack_rows(arr, depth):
    """[h, w * channels] samples -> h packed rows (MSB first below 8 bits)."""
    if depth == 16:
        return [r.astype(">u2").tobytes() for r in arr]
    if depth == 8:
        return [r.astype(np.uint8).tobytes() for r in arr]
    return [np.packbits(np.unpackbits(r.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
                        .reshape(-1)).tobytes() for r in arr]


def _filter(rows, bpp):
    """Row i with filter i % 5 (None, Sub, Up, Average, Paeth)."""
    out, prev = [], bytes(len(rows[0]))
    for i, row in enumerate(rows):
        r, p = np.frombuffer(row, np.uint8).astype(np.int32), np.frombuffer(prev, np.uint8)
        a = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        b = p.astype(np.int32)
        c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = [0, a, b, (a + b) // 2,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][i % 5]
        out.append(bytes([i % 5]) + ((r - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _write_png(path, arr, ctype, depth, palette=None, interlace=False, split=True):
    """A PNG of `arr` ([h, w] or [h, w, c] samples) written by hand: every
    row filter in turn (no filter when interlaced, Adam7), the IDAT split in
    two, a tEXt chunk before it."""
    h, w = arr.shape[:2]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    flat = arr.reshape(h, w * ch)
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for y0, x0, dy, dx in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
                               (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1)):
            sub = arr[y0::dy, x0::dx]
            if sub.size:
                raw += b"".join(b"\0" + r for r in
                                _pack_rows(sub.reshape(sub.shape[0], -1), depth))
    else:
        raw = _filter(_pack_rows(flat, depth), bpp)
    data = zlib.compress(raw, 6)
    parts = [data[: len(data) // 2], data[len(data) // 2:]] if split else [data]
    png = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                                0, 0, int(interlace)))
    if palette is not None:
        png += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    png += _chunk(b"tEXt", b"Comment\0written by hand")
    png += b"".join(_chunk(b"IDAT", p) for p in parts) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


# (colour type, bit depth, channels of the samples, sample max)
PNG_KINDS = [(0, 1, 1, 1), (0, 2, 1, 3), (0, 4, 1, 15), (0, 8, 1, 255), (0, 16, 1, 65535),
             (2, 8, 3, 255), (2, 16, 3, 65535), (3, 1, 1, 1), (3, 2, 1, 3), (3, 4, 1, 15),
             (3, 8, 1, 255), (4, 8, 2, 255), (4, 16, 2, 65535), (6, 8, 4, 255),
             (6, 16, 4, 65535)]


@pytest.mark.parametrize("ctype, depth, ch, top", PNG_KINDS,
                         ids=[f"type{k[0]}-{k[1]}bit" for k in PNG_KINDS])
def test_hand_written_pngs_decode_as_libpng(jax_built, tmp_path, ctype, depth, ch, top):
    rng = np.random.default_rng(depth * 10 + ctype)
    h, w = 13, 17  # odd sizes: partial bytes at the end of packed rows
    arr = rng.integers(0, top + 1, size=(h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    palette = None
    if ctype == 3:  # fewer entries than the depth allows: missing ones are black
        palette = rng.integers(0, 256, size=(max(1, (top + 1) * 3 // 4), 3))
    path = str(tmp_path / "hand.png")
    _write_png(path, arr, ctype, depth, palette)
    ours = native.load_image(path, h, w)
    np.testing.assert_array_equal(ours, jnative.load_image(path, h, w))
    if depth == 8:  # PIL agrees on 8-bit samples
        pil = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
        np.testing.assert_array_equal(ours, pil)


def test_interlaced_png_falls_back_to_pil(built, tmp_path):
    arr = np.random.default_rng(5).integers(0, 256, size=(11, 14, 3), dtype=np.uint8)
    path = str(tmp_path / "adam7.png")
    _write_png(path, arr, 2, 8, interlace=True)
    assert native.image_dims(path) == (11, 14)
    assert native.load_image(path, 11, 14) is None  # Adam7 is left to PIL
    img, f_scale = tds._load_image_resized(path, 11)
    np.testing.assert_array_equal(img, arr / np.float32(255.0))
    assert f_scale == 1.0


def test_fallbacks_are_counted_and_said(built, tmp_path, capsys):
    root = tmp_path / "scene"
    data.write_fake_dataset(str(root), n=2, img_h=16, img_w=24, focal=20.0, seed=0)
    arr = np.random.default_rng(7).integers(0, 256, size=(16, 24, 3), dtype=np.uint8)
    first = sorted(os.listdir(root / "rgb"))[0]
    _write_png(str(root / "rgb" / first), arr, 2, 8, interlace=True)  # Adam7: PIL's
    ds = data.CamLocDataset(str(root), image_height=16)
    assert ds.decoder == "native" and ds.fallbacks == 0
    np.testing.assert_array_equal(ds[0].image, arr / np.float32(255.0))
    ds[1]
    assert ds.fallbacks == 1
    assert capsys.readouterr().out.splitlines() == [
        f"Image decoder: PIL for {root / 'rgb' / first} (the native decoder cannot read it)"]
    assert data.decoder_line(ds) == (f"Image decoder: native ({native.library_path()}; "
                                     f"1 file read by PIL so far)")


@pytest.mark.parametrize("w, h", [((1 << 24) - 1, (1 << 24) - 1), (1 << 31, 1), (1 << 15, 1 << 14)],
                         ids=["both-2^24-1", "wide-2^31", "2^29-pixels"])
def test_huge_header_gives_none(built, tmp_path, w, h):
    """Sizes read from the header are refused past 2^28 pixels before any
    allocation: None, not an aborted process."""
    path = str(tmp_path / "huge.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 6, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(b"\0" * 64)) + _chunk(b"IEND", b""))
    assert native.image_dims(path) is None
    assert native.load_image(path, 8, 8) is None
    assert native.load_image_std_height(path, 8) is None


def test_huge_target_gives_none(built, images):
    assert native.load_image(images["png"], 1 << 15, 1 << 14) is None  # nothing allocated
    assert native.load_image(images["png"], 1 << 14, 1 << 14 | 1) is None


def test_corrupt_png_gives_none(built, tmp_path):
    arr = np.random.default_rng(6).integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    path = str(tmp_path / "bad.png")
    _write_png(path, arr, 2, 8)
    blob = bytearray(open(path, "rb").read())
    at = blob.index(b"IDAT") + 10
    blob[at] ^= 0xFF  # the IDAT's CRC no longer holds
    open(path, "wb").write(bytes(blob))
    assert native.load_image(path, 8, 8) is None
    open(path, "wb").write(bytes(blob[:60]))  # cut short
    assert native.load_image(path, 8, 8) is None


def test_build_without_libjpeg(built, images, tmp_path, monkeypatch):
    """The build of a host without libjpeg (the card machine's): PNG native,
    JPEG left to PIL, and the console line says so."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_jpeg", False)
    assert native.ensure_built(), native.build_error()
    assert native.library_path().parent == tmp_path / "build"
    np.testing.assert_array_equal(native.load_image(images["png"], 60, 90),
                                  jnative.load_image(images["png"], 60, 90))
    assert native.image_dims(images["jpeg"]) is None
    assert native.load_image(images["jpeg"], 60, 90) is None
    img, _ = tds._load_image_resized(images["jpeg"], 60)
    np.testing.assert_array_equal(img, tds._load_image(images["jpeg"]))
    root = str(tmp_path / "scene")
    data.write_fake_dataset(root, n=1, img_h=16, img_w=24, focal=20.0, seed=0)
    ds = data.CamLocDataset(root, image_height=16)
    assert data.decoder_line(ds) == (f"Image decoder: native ({native.library_path()}; "
                                     f"JPEG through PIL: built without libjpeg)")
