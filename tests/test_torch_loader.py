"""The port's `Loader(num_workers, prefetch)` against the JAX package's
`Loader` on one scene: the same batches in the same order for every worker
count (the port's uint8 images against the wire of JAX's float32 ones), and
a producer's error raised in the consumer."""
import threading

import numpy as np
import pytest
import torch

from crossloc_tpu import data as jdata
from crossloc_tpu_torch import data

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("loader") / "train_sim")
    data.write_fake_dataset(root, n=7, img_h=16, img_w=24, focal=20.0, seed=0)
    return root


@pytest.mark.parametrize("num_workers, prefetch", [(1, 1), (2, 2), (4, 3)])
@pytest.mark.parametrize("shuffle, drop_last, shard", [(True, True, (0, 1)),
                                                       (True, False, (1, 2)),
                                                       (False, False, (0, 1))])
def test_batches_and_order_match_jax(scene, num_workers, prefetch, shuffle, drop_last, shard):
    ours = data.Loader(data.CamLocDataset(scene, image_height=16), 2, shuffle=shuffle, seed=7,
                       num_workers=num_workers, prefetch=prefetch, drop_last=drop_last,
                       shard=shard)
    ref = jdata.Loader(jdata.CamLocDataset(scene, image_height=16), 2, shuffle=shuffle, seed=7,
                       num_workers=num_workers, prefetch=prefetch, drop_last=drop_last,
                       shard=shard)
    assert (ours.num_workers, ours.prefetch) == (num_workers, prefetch)
    for epoch in (0, 3):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            assert g["file_name"] == w["file_name"]
            np.testing.assert_array_equal(g["image"], jdata.images_to_wire(w)["image"])
            for key in ("pose", "focal", "coord"):
                np.testing.assert_array_equal(g[key], w[key])


class _Failing:
    """Three items; collate raises on any batch that holds index 2."""

    def __len__(self):
        return 3

    def collate(self, indices):
        if 2 in list(indices):
            raise ValueError("cannot decode item 2")
        return {"idx": list(indices)}


@pytest.mark.parametrize("num_workers", [1, 2, 4])
def test_producer_error_reaches_the_consumer(num_workers):
    loader = data.Loader(_Failing(), 1, num_workers=num_workers, prefetch=1)
    before = set(threading.enumerate())
    seen = []
    with pytest.raises(ValueError, match="cannot decode item 2"):
        for batch in loader:
            seen.append(batch["idx"])
    assert seen == [[0], [1]]
    # the producer thread has been joined by the time the error is raised
    assert not [t for t in set(threading.enumerate()) - before if "producer" in t.name]


@pytest.mark.parametrize("num_workers, prefetch", [(0, 2), (2, 0)])
def test_rejects_empty_pools(num_workers, prefetch):
    with pytest.raises(ValueError):
        data.Loader(_Failing(), 1, num_workers=num_workers, prefetch=prefetch)
