"""The mesh's "spatial" and "model" axes of the port against the JAX
package's meshes on the virtual CPU devices.

Single process: the cross-shard GroupNorm entries' plain twins, merged over
2 and 4 row blocks, equal the plain K1 twin on the whole image, forward and
backward; the coord loss on a block of rows, placed by its row offset,
adds up to the whole image's.

Two CPU ranks (gloo, `tools/parallel_check.py`, one spawn): the
halo-exchanged convs (k 1 and 3, stride 1 and 2) against the unsharded
conv, the tiny coord + MLE net's forward on (spatial 2) against JAX's, and
an MLR net with a frozen tower against its unsharded forward.

Four CPU ranks (one spawn): the (data 2 x spatial 2) step against JAX's
`make_mesh(data=2, spatial=2)` step with JAX's bounds
(`tests/test_train.py::test_dp_spatial_train_step_matches_single_device`:
two-pass GroupNorm, gradients of JAX's smooth surrogate to rtol 1e-5 plus
2e-4 of max|g|, the real loss to rtol 1e-5, parameters to 5e-4 after one
Adam step); the same with ZeRO; the (data 2 x model 2) step against JAX's
(`test_dp_fsdp_train_step_matches_single_device`: rtol 1e-5 plus 1e-5 of
max|g|, parameters to 2e-4 a step), its parameters sharded after the
update. Then `dryrun_multichip(4, "cpu")`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from crossloc_tpu import models as jmodels
from crossloc_tpu import parallel as jparallel
from crossloc_tpu import train as jtrain
from crossloc_tpu_torch import compat, models, ops
from crossloc_tpu_torch.tools import parallel_check as pc
from crossloc_tpu_torch.tools.multichip import dryrun_multichip
from crossloc_tpu_torch.train import TrainBatch, task_loss_fn

MEAN = [0.0, 0.0, 0.0]
IMG_H, IMG_W, B = 64, 96, 4
LR = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the cross-shard twins, one process ------------------------------------

# (B, H, W, C, groups): group sizes 2, 4, 1 and 3
SHAPES = [(2, 16, 6, 64, 32), (1, 8, 10, 128, 32), (2, 8, 4, 32, 32), (3, 8, 5, 96, 32)]


@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "no_relu"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cross_shard_twins_merge_to_the_whole_image(shape, relu, splits):
    """Stats of each block, merged; the apply on each block; the backward's
    sums of each block, added; dx of each block and dscale, dbias summed
    over the blocks: the plain K1 twin and its autograd on the whole image."""
    Bn, H, W, C, G = shape
    gen = torch.Generator().manual_seed(C + H)
    x = torch.randn(Bn, H, W, C, generator=gen) * 2.0 + 3.0
    scale, bias = torch.rand(C, generator=gen) + 0.5, torch.randn(C, generator=gen)
    dy = torch.randn(Bn, H, W, C, generator=gen)
    ref = ops.group_norm_relu_plain(x, scale, bias, G, relu=relu)
    dx_ref, ds_ref, db_ref = ops.group_norm_relu_backward_plain(x, scale, bias, dy, G, relu=relu)

    xs, dys = x.chunk(splits, dim=1), dy.chunk(splits, dim=1)
    stats = torch.stack([ops.group_norm_shard_stats(t, G) for t in xs])
    applied = [ops.group_norm_shard_apply(t, scale, bias, stats, G, relu=relu) for t in xs]
    sums = torch.stack([ops.group_norm_shard_backward_sums(t, scale, bias, st, d, G, relu)
                        for t, (_, st), d in zip(xs, applied, dys)])
    back = [ops.group_norm_shard_backward_apply(t, scale, bias, st, d, sums, i, G, H * W, relu)
            for i, (t, (_, st), d) in enumerate(zip(xs, applied, dys))]
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([y for y, _ in applied], 1).numpy(), ref.numpy(), **tol)
    np.testing.assert_allclose(torch.cat([d for d, _, _ in back], 1).numpy(), dx_ref.numpy(),
                               **tol)
    np.testing.assert_allclose(sum(s for _, s, _ in back).numpy(), ds_ref.numpy(), **tol)
    np.testing.assert_allclose(sum(b for _, _, b in back).numpy(), db_ref.numpy(), **tol)


def _row_scene(Bn=2, H=64, W=96, focal=80.0):
    """Labels on the rays of their own grid cells (identity camera, depths
    8-12 m), predictions near them: the reprojection term depends on which
    image row each grid row is."""
    rng = np.random.default_rng(3)
    h, w = H // 8, W // 8
    ys, xs = (np.arange(h) * 8 + 4.0), (np.arange(w) * 8 + 4.0)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    depth = rng.uniform(8.0, 12.0, size=(Bn, h, w))
    labels = np.stack([(gx - W / 2) / focal * depth, (gy - H / 2) / focal * depth, depth], -1)
    preds = labels + rng.normal(size=labels.shape) * 0.05
    unc = rng.uniform(0.5, 2.0, size=(Bn, h, w, 1))
    return (torch.from_numpy(np.concatenate([preds, unc], -1).astype(np.float32)),
            TrainBatch(torch.zeros(Bn, H, W, 3), torch.eye(4).repeat(Bn, 1, 1),
                       torch.from_numpy(labels.astype(np.float32)), torch.tensor(focal)))


def test_a_block_of_rows_takes_its_place_in_the_image():
    """The coord loss of each row block, with the whole image's camera and
    its grid rows (`task_loss_fn(spatial=...)`), averages to the whole
    image's loss; the second block placed at row 0 does not."""
    preds, batch = _row_scene()
    whole, _ = task_loss_fn("coord", preds, batch, "MLE", 3)

    def block(i, index):
        part = TrainBatch(batch.images[:, 32 * i:32 * (i + 1)], batch.poses,
                          batch.labels[:, 4 * i:4 * (i + 1)], batch.focal)
        return task_loss_fn("coord", preds[:, 4 * i:4 * (i + 1)], part, "MLE", 3,
                            spatial=(index, 2))[0]

    placed = (block(0, 0) + block(1, 1)) / 2
    np.testing.assert_allclose(float(placed), float(whole), rtol=1e-6)
    misplaced = (block(0, 0) + block(1, 0)) / 2
    assert abs(float(misplaced) - float(whole)) > 0.1 * abs(float(whole))


# -- multi-rank runs ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_net():
    jnet = jmodels.build_network("coord", "MLE", tiny=True, mean=MEAN)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"]
    return jnet, params


def _state_dict(params, **kw):
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN, **kw)
    return compat.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), net)


def _batch():
    """JAX's `synth_batch` (tests/test_train.py) from a numpy seed."""
    rng = np.random.default_rng(2021)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    poses[:, 2, 3] = 50.0
    return dict(images=rng.normal(size=(B, IMG_H, IMG_W, 3)).astype(np.float32), poses=poses,
                labels=(rng.normal(size=(B, IMG_H // 8, IMG_W // 8, 3)) * 20).astype(np.float32),
                focal=np.float32(300.0))


def _step_spec(params, mesh, kind="coord", steps=1, zero=False):
    b = _batch()
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    batch["pp_shift"] = torch.zeros(2)
    return dict(state_dict=_state_dict(params), batch=batch, kind=kind, uncertainty="MLE",
                mean=MEAN, tiny=True, zero=zero, steps=steps, lr=LR, device="cpu", mesh=mesh)


@pytest.fixture(scope="module")
def two_ranks(jax_net, tmp_path_factory):
    """One 2-rank spawn: the halo convs, the coord net's forward on
    (spatial 2) and an MLR net's (one trainable, one frozen tower)."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    images = torch.from_numpy(_batch()["images"])
    fwd = dict(state_dict=_state_dict(jax_net[1]), images=images, uncertainty="MLE", mean=MEAN,
               tiny=True, device="cpu", mesh=dict(data=1, spatial=2))
    mlr_net = models.init_weights(
        models.build_network("coord", "MLE", tiny=True, mean=MEAN, num_mlr=2,
                             num_unfrozen_encoder=1), torch.Generator().manual_seed(7))
    mlr = dict(fwd, state_dict=mlr_net.state_dict(), num_mlr=2, num_unfrozen_encoder=1)
    outs = {k: str(tmp / f"{k}.pt") for k in ("halo", "fwd", "mlr")}
    pc.run_ranks(pc.checks, 2, ([(pc.halo_check, ("cpu", outs["halo"])),
                                 (pc.forward_check, (fwd, outs["fwd"])),
                                 (pc.forward_check, (mlr, outs["mlr"]))],), timeout=240)
    got = {k: torch.load(p, weights_only=False) for k, p in outs.items()}
    with torch.no_grad():
        got["mlr_ref"] = mlr_net.eval()(images)
    return got


@pytest.fixture(scope="module")
def four_ranks(jax_net, tmp_path_factory):
    """One 4-rank spawn: the (data 2 x spatial 2) step with the surrogate's
    gradient, the same with ZeRO, and the (data 2 x model 2) step."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    specs = {"spatial": _step_spec(jax_net[1], dict(data=2, spatial=2), "surrogate"),
             "spatial_zero": _step_spec(jax_net[1], dict(data=2, spatial=2), "surrogate",
                                        zero=True),
             "model": _step_spec(jax_net[1], dict(data=2, model=2), "coord", steps=3)}
    outs = {k: str(tmp / f"{k}.pt") for k in specs}
    pc.run_ranks(pc.checks, 4, ([(pc.step_check, (s, outs[k])) for k, s in specs.items()],),
                 timeout=300)
    got = {k: torch.load(p, weights_only=False) for k, p in outs.items()}
    got["single"] = pc.step_check(dict(specs["spatial"], mesh=None))
    got["single_model"] = pc.step_check(dict(specs["model"], mesh=None))
    return got


def _to_port(tree):
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    return compat.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(tree)),
                                       net)


def _jax_step(jax_net, mesh_kw, batch_spec, surrogate, steps, shard_params=False):
    """(gradients, losses, params after `steps`) of JAX's step on a 4-device
    mesh, two-pass GroupNorm as the JAX dry run runs it."""
    jnet, params = jax_net
    b = _batch()
    tx = jtrain.make_optimizer(LR, steps_per_epoch=10)

    def loss_of(p, bb):
        preds = jnet.apply({"params": p}, bb.images)
        if surrogate:
            return jnp.mean(jnp.square(preds[..., :3])) + jnp.mean(preds[..., 3])
        return jtrain.task_loss_fn("coord", preds, bb, "MLE", 3)[0]

    mesh = jparallel.make_mesh(jax.devices()[:4], **mesh_kw)
    place = ((lambda t: jparallel.shard_params(mesh, t)) if shard_params
             else (lambda t: jparallel.replicate(mesh, t)))
    batch_axes = ("data", "model") if shard_params else "data"
    jmodels.set_gn_fast_variance(False)
    try:
        with mesh:
            batch = jtrain.TrainBatch(
                images=jax.device_put(b["images"], NamedSharding(mesh, batch_spec)),
                poses=jax.device_put(b["poses"], NamedSharding(mesh, P(batch_axes))),
                labels=jax.device_put(b["labels"], NamedSharding(mesh, P(batch_axes))),
                focal=jax.device_put(b["focal"], NamedSharding(mesh, P())))
            grads = jax.jit(jax.grad(loss_of))(place(params), batch)
            state = place(jtrain.TrainState(params, tx.init(params), jnp.zeros((), jnp.int32)))
            step = jax.jit(jtrain.make_train_step(jnet, tx, "coord", "MLE"))
            losses = []
            for _ in range(steps):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
    finally:
        jmodels.set_gn_fast_variance(True)
    return _to_port(grads), losses, _to_port(state.params)


def _jax_forward(jax_net, images):
    jnet, params = jax_net
    jmodels.set_gn_fast_variance(False)
    try:
        return np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(images)))
    finally:
        jmodels.set_gn_fast_variance(True)


def _assert_close(got, ref, rtol, atol_of_max, what):
    """Every tensor of `got` against `ref`'s, to rtol plus `atol_of_max` of
    the largest |value| of them all."""
    scale = max(float(ref[name].abs().max()) for name in got)
    for name, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=rtol,
                                   atol=atol_of_max * scale, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("kernel, stride", pc.HALO_CASES)
def test_halo_conv_matches_the_unsharded_conv(two_ranks, kernel, stride):
    """Output, input gradient (halo gradients sent back to their owners) and
    the weight gradient summed over the ranks."""
    for what, (err, scale) in zip(("output", "input grad", "weight grad"),
                                  two_ranks["halo"][(kernel, stride)]):
        assert err <= 1e-6 * max(1.0, scale), (what, err, scale)


@pytest.mark.parametrize("arm", ["spatial2", "data2_spatial2"])
def test_spatial_forward_matches_jax(jax_net, two_ranks, four_ranks, arm):
    """The net's output on row shards, gathered, equals JAX's unsharded
    forward of the same weights (`tests/test_models.py`'s 1e-5)."""
    got = two_ranks["fwd"] if arm == "spatial2" else four_ranks["spatial"]["preds"]
    ref = _jax_forward(jax_net, _batch()["images"])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_mlr_net_with_a_frozen_tower_shards_its_rows(two_ranks):
    np.testing.assert_allclose(two_ranks["mlr"].numpy(), two_ranks["mlr_ref"].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_spatial_step(jax_net):
    grads, _, _ = _jax_step(jax_net, dict(data=2, spatial=2), P("data", "spatial"), True, 1)
    _, losses, params = _jax_step(jax_net, dict(data=2, spatial=2), P("data", "spatial"), False, 1)
    return grads, losses, params


def test_data_spatial_step_matches_jax(four_ranks, jax_spatial_step):
    """Gradients (smooth surrogate), the coord loss and the parameters after
    one Adam step against JAX's (data 2 x spatial 2) step and against the
    port's one-process step; on CPU tensors no kernel launches."""
    got, single = four_ranks["spatial"], four_ranks["single"]
    jgrads, jlosses, jparams = jax_spatial_step
    assert set(got["grads"]) == set(jgrads) - {"mean", "decoder.mean"}
    _assert_close(got["grads"], jgrads, 1e-5, 2e-4, "jax grads")
    _assert_close(got["grads"], single["grads"], 1e-5, 2e-4, "port grads")
    np.testing.assert_allclose(got["loss"], jlosses, rtol=1e-5)
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)
    for name, p in jparams.items():
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), rtol=0, atol=5e-4,
                                   err_msg=name)
    assert got["shard_launches"] == [(0, 0, 0, 0)] and got["launches"] == [(0, 0)]
    assert [r["shard_launches"] for r in got["by_rank"]] == [[(0, 0, 0, 0)]] * 4


def test_zero_on_a_spatial_mesh_shards_over_every_rank(four_ranks):
    """`zero=True` on (data 2 x spatial 2): the shards span the data x
    spatial ranks, whose gradients the step averages alike; the step equals
    the replicated one's."""
    dp, zero = four_ranks["spatial"], four_ranks["spatial_zero"]
    assert zero["held"]["freed"] and zero["held"]["shard"] * 4 == zero["held"]["whole"]
    _assert_close(zero["grads"], dp["grads"], 1e-5, 1e-5, "grads")
    np.testing.assert_allclose(zero["loss"], dp["loss"], rtol=1e-6)
    for name, p in dp["params"].items():
        np.testing.assert_allclose(zero["params"][name].numpy(), p.numpy(), rtol=0, atol=2 * LR,
                                   err_msg=name)


def test_data_model_step_matches_jax_and_stays_sharded(jax_net, four_ranks):
    """(data 2 x model 2): the batch over the four ranks, parameters and Adam
    moments sharded over the model group; JAX's FSDP test bounds, and after
    the update each rank holds only its half of every sharded tensor. The
    losses of steps 2 and 3 are held against the port's one-process step:
    on this batch the loss falls from 171 to 32 in three Adam steps, and
    the port's one-process losses themselves sit 9e-5 (relative) from JAX's
    at step 3 (JAX's own test holds two JAX runs of one arithmetic)."""
    got, single = four_ranks["model"], four_ranks["single_model"]
    jgrads, jlosses, jparams = _jax_step(jax_net, dict(data=2, model=2), P(("data", "model")),
                                         False, 3, shard_params=True)
    _assert_close(got["grads"], jgrads, 1e-5, 1e-5, "jax grads")
    np.testing.assert_allclose(got["loss"][0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-5)
    _assert_close(got["grads"], single["grads"], 1e-5, 1e-5, "port grads")
    for name, p in jparams.items():
        np.testing.assert_allclose(got["params"][name].numpy(), p.numpy(), rtol=1e-5,
                                   atol=2e-4 * 3, err_msg=name)
    held = got["held"]
    assert held["freed"] and held["shard"] * 2 == held["whole"]


def test_dryrun_multichip_on_cpu():
    """The JAX dry run's checks and bounds on four CPU ranks: the full-width
    net's (data 2 x spatial 2) forward and step, and the (data 2 x model 2)
    arm, each arm's gradients held against the unsharded step's."""
    res = dryrun_multichip(4, "cpu", timeout=300)
    assert res["spatial_forward_err"] < 1e-3 and res["spatial_param_err"] < 5e-4
    assert res["model_held"]["freed"] and res["model_param_err"] < 5e-4
    assert res["spatial_grad_of_bound"] <= 1 and res["model_grad_of_bound"] <= 1
    assert res["spatial_launches"] == [dict(k1=(0, 0), shard=(0, 0, 0, 0))] * 4
