"""The port's training data path and bookkeeping against the JAX package.

Loader order per (seed, epoch, shard); dataset items per mode and label
flag; the plane-scene writer; label means; output-directory names; log
parsing and checkpoint selection. Exact unless a line says otherwise.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from crossloc_tpu import compat as jcompat
from crossloc_tpu import data as jdata
from crossloc_tpu import utils as jutils
from crossloc_tpu.eval.select_ckpt import select_checkpoint as jselect
from crossloc_tpu_torch import compat, data, utils
from crossloc_tpu_torch.eval import select_checkpoint


class _Sized:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n, bs, drop_last", [(10, 3, True), (10, 3, False), (7, 2, True)])
def test_loader_order_matches_jax(n, bs, drop_last):
    for seed in (2021, 7):
        for rank, world in ((0, 1), (0, 3), (2, 3), (1, 2)):
            j = jdata.Loader(_Sized(n), bs, shuffle=True, seed=seed, drop_last=drop_last,
                             shard=(rank, world))
            t = data.Loader(_Sized(n), bs, shuffle=True, seed=seed, drop_last=drop_last,
                            shard=(rank, world))
            assert len(t) == len(j)
            for epoch in (0, 1, 5):
                j.set_epoch(epoch)
                t.set_epoch(epoch)
                got = [b.tolist() for b in t.index_batches()]
                assert got == [b.tolist() for b in j._index_batches()], (seed, rank, epoch)


def test_loader_default_is_in_order_with_a_short_last_batch(tmp_path):
    root = str(tmp_path / "s")
    data.write_fake_dataset(root, n=5, img_h=16, img_w=24, focal=20.0, seed=0)
    ds = data.CamLocDataset(root, image_height=16)
    batches = list(data.Loader(ds, 2))
    assert [len(b["file_name"]) for b in batches] == [2, 2, 1]
    assert [os.path.basename(f) for b in batches for f in b["file_name"]] == [
        f"frame_{i:05d}.png" for i in range(5)]


def test_device_prefetch_on_the_cpu_makes_tensors():
    batches = [{"image": np.ones((2, 3), np.uint8), "pose": np.eye(4), "focal": np.ones(2)}]
    out = list(data.device_prefetch(iter(batches), "cpu"))
    assert isinstance(out[0]["image"], torch.Tensor) and isinstance(out[0]["pose"], torch.Tensor)
    assert isinstance(out[0]["focal"], np.ndarray)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene") / "train_sim")
    jdata.write_fake_dataset(root, n=2, img_h=32, img_w=48, focal=40.0, seed=3)
    return root


def _assert_items_equal(t, j):
    np.testing.assert_array_equal(t.image, j.image)
    np.testing.assert_array_equal(t.pose, j.pose)
    assert t.focal == j.focal and t.file_name == j.file_name
    for key in ("coord", "depth", "normal", "semantics", "eye"):
        a, b = getattr(t, key), getattr(j, key)
        assert (a is None) == (b is None), key
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(mode=1, coord=True), dict(mode=1, coord=False, depth=True),
    dict(mode=1, coord=False, normal=True), dict(mode=1, coord=False, semantics=True),
    dict(mode=1, coord=True, depth=True, normal=True, semantics=True),
    dict(mode=2), dict(mode=0), dict(mode=1, grayscale=True, raw_image=True),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_dataset_items_match_jax(scene, kw):
    t = data.CamLocDataset(scene, image_height=32, **kw)
    j = jdata.CamLocDataset(scene, image_height=32, **kw)
    assert len(t) == len(j) == 2 and t.grayscale == j.grayscale
    for i in range(2):
        _assert_items_equal(t[i], j[i])
    tb, jb = t.collate([0, 1]), j.collate([0, 1])
    assert sorted(tb) == sorted(jb)


def test_mode1_without_labels_raises(scene):
    with pytest.raises(ValueError):
        data.CamLocDataset(scene, coord=False)


def test_dense_coordinates_from_a_depth_png_match_jax(tmp_path, rng):
    root = tmp_path / "dense"
    for d in ("rgb", "poses", "calibration", "depth"):
        (root / d).mkdir(parents=True)
    Image.fromarray((rng.uniform(0, 1, (40, 56, 3)) * 255).astype(np.uint8)).save(
        root / "rgb" / "f.png")
    pose = np.eye(4)
    pose[:3, 3] = [1.0, -2.0, 3.0]
    np.savetxt(root / "poses" / "f.txt", pose)
    np.savetxt(root / "calibration" / "f.txt", [50.0])
    depth_mm = rng.integers(1000, 60000, size=(80, 112)).astype(np.uint16)  # resized to 40x56
    depth_mm[3:9, 5:9] = 0  # no depth -> zero coordinates
    Image.fromarray(depth_mm).save(root / "depth" / "f.png")
    t = data.CamLocDataset(str(root), mode=1, sparse=False, image_height=40)[0]
    j = jdata.CamLocDataset(str(root), mode=1, sparse=False, image_height=40)[0]
    assert t.coord.shape == (5, 7, 3)
    np.testing.assert_array_equal(t.coord, j.coord)


@pytest.mark.parametrize("scene_kind", ["plane", "noise"])
def test_scene_writer_matches_jax(tmp_path, scene_kind):
    """The same draws in the same order. The plane scene's rotation comes from
    each package's float32 Rodrigues, which differ in the last bit now and
    then: labels and poses agree to float32 rounding, and an image pixel may
    sit one uint8 step apart where the texture crosses a rounding edge."""
    kw = dict(n=3, img_h=32, img_w=48, focal=40.0, seed=9, scene=scene_kind)
    jdata.write_fake_dataset(str(tmp_path / "j"), **kw)
    data.write_fake_dataset(str(tmp_path / "t"), **kw)
    j = jdata.CamLocDataset(str(tmp_path / "j"), coord=True, depth=True, normal=True,
                            semantics=True, image_height=32).collate([0, 1, 2])
    t = data.CamLocDataset(str(tmp_path / "t"), coord=True, depth=True, normal=True,
                           semantics=True, image_height=32).collate([0, 1, 2])
    d_img = np.abs(t["image"] - j["image"])
    assert d_img.max() <= 1.0 / 255 + 1e-7 and (d_img > 0).mean() < 0.01
    np.testing.assert_allclose(t["pose"], j["pose"], atol=1e-5)
    np.testing.assert_allclose(t["coord"], j["coord"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t["depth"], j["depth"], rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t["normal"], j["normal"], atol=1e-5)
    assert (t["semantics"] != j["semantics"]).mean() < 0.01


def test_fullsize_writes_full_resolution_labels(tmp_path):
    data.write_fake_dataset(str(tmp_path / "f"), n=1, img_h=16, img_w=24, focal=20.0,
                            fullsize=True, scene="plane")
    item = data.CamLocDataset(str(tmp_path / "f"), image_height=16)[0]
    assert item.coord.shape == (16, 24, 3)


def test_label_means_match_jax(scene):
    for sc in ("urbanscape", "naturescape", "Urbanscape-extra"):
        for task in ("coord", "depth", "normal", "semantics"):
            np.testing.assert_array_equal(data.get_label_mean(sc, task),
                                          jdata.get_label_mean(sc, task))
    kw = dict(coord=True, depth=True, normal=True, image_height=32)
    for task in ("coord", "depth", "normal"):
        np.testing.assert_allclose(
            data.get_label_mean("other", task, data.CamLocDataset(scene, **kw)),
            jdata.get_label_mean("other", task, jdata.CamLocDataset(scene, **kw)), rtol=1e-6)
    with pytest.raises(ValueError):
        data.get_label_mean("other", "coord")


def test_train_output_name_matches_jax():
    grid = [
        dict(), dict(session="clean_training", uncertainty="MLE"), dict(grayscale=True),
        dict(fullsize=True, epochs=30), dict(learning_rate=5e-5), dict(real_data_chunk=0.0),
        dict(real_data_chunk=0.5, real_data_domain="out_of_place"), dict(real_only=True),
        dict(tiny=True, network_in="x.net", debug=True), dict(e2e=True, bf16=True),
        dict(real_data_chunk=0.0, sim_data_chunk=0.25, uncertainty="MLE", tiny=True),
    ]
    for kw in grid:
        for task in ("coord", "depth"):
            assert compat.train_output_name("urbanscape", task, **kw) == \
                jcompat.train_output_name("urbanscape", task, **kw)
    with pytest.raises(ValueError):
        compat.train_output_name("urbanscape", "coord", real_data_chunk=0.0, sim_data_chunk=0.0)


def test_log_parsing_and_names_match_jax(tmp_path):
    log = tmp_path / "output.log"
    log.write_text("".join(
        f"2026-01-01 00:00:00, INFO: Iteration: {i:7d}, Epoch: {i // 4:3d}, Total loss: 1.00, "
        f"Valid: 50.0%, Avg Time: 0.100s\n" for i in range(2, 60, 2)))
    assert utils.read_training_log(str(log), 4) == jutils.read_training_log(str(log), 4)
    (tmp_path / "empty.log").write_text("no lines\n")
    assert utils.read_training_log(str(tmp_path / "empty.log"), 4) == (0, 0)
    with pytest.raises(AssertionError):
        utils.read_training_log(str(log), 1)
    for name in ("urbanscape-coord-e2e-e150-lr0.0002-sim_only", "a-e5-lr0.0001-x", "no_epoch"):
        assert utils.get_epoch_from_dirname(name) == jutils.get_epoch_from_dirname(name)
    f = "/d/val_drone_real/rgb/frame_00001.png"
    assert utils.get_unique_file_name(f) == jutils.get_unique_file_name(f)


def test_checkpoint_selection_matches_jax(tmp_path):
    dirs = {}
    for side in ("t", "j"):
        d = tmp_path / side
        d.mkdir()
        for it, med_t in ((100, 4.5), (200, 2.25), (300, 3.0)):
            (d / f"results_ckpt_iter_{it:07d}.net_task_coord.txt").write_text(
                f"Median Error: 1.50 deg, {med_t:.2f} m\n5m5deg: 40.0%\n10m7deg: 60.0%\n"
                f"20m10deg: 90.0%\n")
        dirs[side] = d
    t_flag = select_checkpoint("coord", str(dirs["t"]))
    j_flag = jselect("coord", str(dirs["j"]))
    assert os.path.basename(t_flag) == os.path.basename(j_flag) == \
        "FLAG_SELECTED_ITER_0000200.nodata"
    assert (dirs["t"] / "results_overall.txt").read_text().replace("/t/", "/j/") == \
        (dirs["j"] / "results_overall.txt").read_text()
