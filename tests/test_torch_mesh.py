"""The port's mesh (`crossloc_tpu_torch/parallel/mesh.py`) against the JAX
package's (`crossloc_tpu/parallel/mesh.py`): `make_mesh`'s refusals with
JAX's messages, the layout of ranks as JAX lays out its devices, and the
part of a batch each rank takes against the shards of JAX's `shard_batch`
on the 8-device virtual CPU mesh. No process group is needed: a `Mesh`
names a rank's place directly.
"""
import numpy as np
import pytest
import torch

import jax

from crossloc_tpu import parallel as jparallel
from crossloc_tpu import train as jtrain
from crossloc_tpu_torch import models, parallel
from crossloc_tpu_torch.models.layers import bilinear_resize
from crossloc_tpu_torch.parallel import Mesh, SpatialShard, mesh_shape, shard_batch
from crossloc_tpu_torch.train import TrainBatch


def test_spatial_and_model_mesh_is_refused_as_in_jax():
    with pytest.raises(ValueError, match="spatial and model"):
        jparallel.make_mesh(jax.devices(), data=2, spatial=2, model=2)
    with pytest.raises(ValueError, match="spatial and model"):
        parallel.mesh_shape(8, data=2, spatial=2, model=2)


@pytest.mark.parametrize("kw", [dict(data=3), dict(data=2, spatial=2), dict(spatial=3),
                                dict(data=1, model=4)])
def test_a_mesh_that_does_not_cover_the_ranks_is_refused(kw):
    with pytest.raises(ValueError, match=r"mesh \d+x\d+x\d+ != 8 devices"):
        jparallel.make_mesh(jax.devices(), **kw)
    with pytest.raises(ValueError, match=r"mesh \d+x\d+x\d+ != 8 devices"):
        mesh_shape(8, **kw)


def test_model_must_divide_the_32_groups():
    """JAX checks it where it shards the parameters (`param_spec`); the
    port's mesh checks it up front, with the same words."""
    params = {"w": np.zeros((3, 3, 4, 96), np.float32)}
    with pytest.raises(ValueError, match="model=3 must divide 32"):
        jparallel.param_spec(params, model=3)
    with pytest.raises(ValueError, match="model=3 must divide 32"):
        mesh_shape(6, data=2, model=3)


def test_every_rank_on_data_by_default():
    assert dict(jparallel.make_mesh(jax.devices()).shape) == {"data": 8, "spatial": 1}
    assert mesh_shape(8) == (8, 1, 1)


@pytest.mark.parametrize("shape", [(2, 2, 1), (4, 2, 1), (2, 4, 1), (2, 1, 2), (4, 1, 2)])
def test_rank_layout_is_jax_s_device_order(shape):
    """Rank r sits where JAX's `make_mesh` puts device r."""
    data, spatial, model = shape
    n = data * spatial * model
    jmesh = jparallel.make_mesh(jax.devices()[:n], data=data, spatial=spatial, model=model)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(data, spatial, model)
    for r in range(n):
        assert ids[Mesh(data, spatial, model, r).coords] == r


def _batch(B=4, H=32):
    rng = np.random.default_rng(0)
    return dict(images=rng.normal(size=(B, H, 8, 3)).astype(np.float32),
                poses=rng.normal(size=(B, 4, 4)).astype(np.float32),
                labels=rng.normal(size=(B, H // 8, 1, 3)).astype(np.float32),
                focal=rng.uniform(100, 200, size=(B,)).astype(np.float32))


def _port_batch(b, pp_shift=None):
    return TrainBatch(*(torch.from_numpy(b[k]) for k in ("images", "poses", "labels", "focal")),
                      pp_shift=pp_shift)


@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 4, 1), (2, 1, 2), (4, 1, 1)])
def test_shard_batch_gives_each_rank_jax_s_shard(shape):
    """Images and the labels' grid rows over "spatial", N over "data" (and
    "model"), poses and focal whole per image; each rank's part equals the
    shard JAX places on the device of the same index. The crop offset
    `pp_shift` is one for the whole batch and stays whole."""
    data, spatial, model = shape
    n = data * spatial * model
    b = _batch()
    jmesh = jparallel.make_mesh(jax.devices()[:n], data=data, spatial=spatial, model=model)
    jb = jparallel.shard_batch(jmesh, jtrain.TrainBatch(**b), shard_spatial=spatial > 1)
    shift = torch.tensor([1.5, -2.0])
    for r in range(n):
        part = shard_batch(Mesh(data, spatial, model, r), _port_batch(b, shift),
                           shard_spatial=spatial > 1)
        for name in ("images", "poses", "labels", "focal"):
            (shard,) = [s for s in getattr(jb, name).addressable_shards if s.device.id == r]
            np.testing.assert_array_equal(getattr(part, name).numpy(), np.asarray(shard.data),
                                          err_msg=f"rank {r}: {name}")
        assert torch.equal(part.pp_shift, shift)
        assert part.images.is_contiguous()


def test_shard_batch_refuses_an_unspanned_spatial_axis():
    b = _batch(B=8)
    jmesh = jparallel.make_mesh(jax.devices(), data=4, spatial=2)
    with pytest.raises(ValueError, match="shard_spatial=True"):
        jparallel.shard_batch(jmesh, jtrain.TrainBatch(**b))
    with pytest.raises(ValueError, match="shard_spatial=True"):
        shard_batch(Mesh(4, 2, 1, 0), _port_batch(b))
    shard_batch(Mesh(4, 2, 1, 0), _port_batch(b), shard_spatial=True)  # spanned, it goes


def test_shard_batch_refuses_what_does_not_split():
    """A batch or a height that does not divide over its axis is refused as
    JAX refuses it; the port also refuses a height that is not a multiple
    of 8 x spatial (JAX takes images of 72 rows over 2), because its shards
    must hold equal, even rows at every stride-2 layer, and the labels'
    grid rows must split as the images' do."""
    b = _batch(B=6)
    jmesh = jparallel.make_mesh(jax.devices(), data=4, spatial=2)
    with pytest.raises(ValueError):
        jparallel.shard_batch(jmesh, jtrain.TrainBatch(**b), shard_spatial=True)
    with pytest.raises(ValueError, match="a global batch of 6 does not split over 4 ranks"):
        shard_batch(Mesh(4, 2, 1, 0), _port_batch(b), shard_spatial=True)
    b = _batch(B=1, H=68)
    with pytest.raises(ValueError):
        jparallel.shard_batch(jparallel.make_mesh(jax.devices(), data=1, spatial=8),
                              jtrain.TrainBatch(**b), shard_spatial=True)
    with pytest.raises(ValueError, match="multiple of 8 x spatial = 64"):
        shard_batch(Mesh(1, 8, 1, 0), _port_batch(b), shard_spatial=True)
    b = _batch(B=2, H=72)
    jparallel.shard_batch(jparallel.make_mesh(jax.devices()[:2], data=1, spatial=2),
                          {"images": b["images"]}, shard_spatial=True)
    with pytest.raises(ValueError, match="multiple of 8 x spatial = 16"):
        shard_batch(Mesh(1, 2, 1, 0), _port_batch(b), shard_spatial=True)


def test_zero_is_refused_on_a_model_mesh():
    """ZeRO shards over "data"; a mesh with a "model" axis shards over that."""
    net = models.build_network("coord", "MLE", tiny=True)
    with pytest.raises(ValueError, match="'model' axis"):
        parallel.DataParallel(net, zero=True, mesh=Mesh(1, 1, 2, 0))


def test_resize_is_refused_on_a_block_of_rows():
    """A resize reads across rows; on a spatial shard only the identity goes."""
    x = torch.zeros(1, 8, 12, 2)
    shard = SpatialShard(None, 0, 2)
    assert bilinear_resize(x, 8, 12, spatial=shard) is x
    with pytest.raises(ValueError, match="only the identity"):
        bilinear_resize(x, 16, 24, spatial=shard)
    assert bilinear_resize(x, 16, 24).shape == (1, 16, 24, 2)


def test_the_default_mesh_creates_no_group():
    """Outside a process group the mesh is one rank, and it touches no
    collective (the data-parallel CLIs build it this way on every rank)."""
    mesh = parallel.make_mesh()
    assert (mesh.data, mesh.spatial, mesh.model, mesh.shard) == (1, 1, 1, None)
    assert mesh.spatial_group is mesh.model_group is mesh.replica_group is None


def test_the_dsac_step_refuses_a_spatial_mesh():
    """The solver needs whole images; a spatial mesh splits their rows."""
    from types import SimpleNamespace

    from crossloc_tpu_torch.train import TrainState, make_dsac_train_step, make_optimizer

    net = models.build_network("coord", "MLE", tiny=True)
    state = TrainState(net, make_optimizer(list(net.parameters()), 1e-4),
                       parallel=SimpleNamespace(mesh=Mesh(1, 2, 1, 0)))
    with pytest.raises(ValueError, match="spatial mesh"):
        make_dsac_train_step(net)(state, None)
