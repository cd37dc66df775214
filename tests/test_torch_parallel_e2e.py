"""The DSAC end-to-end step under data parallelism.

Two CPU ranks (gloo) take the gradient and three DSAC steps of the tiny
coord + MLE net (the JAX net's weights) on their halves of a global batch of
4, each with its rows of the global hypothesis pool (JAX's draws, from its
positional per-image keys), against one process on the whole batch. A random
net makes the solve ill-conditioned: in float32 the gradient sits 2.5-3 % from
float64 in both packages (`tests/test_torch_dsac_step.py`), and a batch split
moves it by as much. So the DP check runs in float64, where JAX's yardsticks
hold (gradients to rtol 1e-5 plus 1e-5 of max|g|, parameters to 2e-4 per
step), and the first step's expected loss is held against JAX's float32
data-parallel loss to 1e-4, as the single-process DSAC test does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from crossloc_tpu import models as jmodels
from crossloc_tpu import parallel as jparallel
from crossloc_tpu import ransac as jransac
from crossloc_tpu_torch import compat, models
from crossloc_tpu_torch.tools.parallel_check import run_ranks, step_check

IMG_H, IMG_W, FOCAL = 48, 64, 50.0
MEAN = [1.0, -2.0, 30.0]
STEPS, LR, B = 3, 1e-4, 4
CFG = dict(hypotheses=8, sample_rounds=4, train_refine_steps=1, refine_steps=2, gn_iters=1,
           inlier_threshold=5000.0, max_pixel_error=10000.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.default_rng(0)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    poses[:, :3, 3] = np.asarray(MEAN) - [0.0, 0.0, 30.0] + rng.normal(size=(B, 3))
    return dict(images=rng.normal(size=(B, IMG_H, IMG_W, 3)).astype(np.float32), poses=poses,
                labels=np.zeros((B, IMG_H // 8, IMG_W // 8, 3), np.float32),
                focal=np.float32(FOCAL), pp_shift=np.array([1.5, -2.25], np.float32))


@pytest.fixture(scope="module")
def jax_dp():
    """(params, JAX's DP expected loss, the global pool's draws)."""
    jnet = jmodels.build_network("coord", "MLE", tiny=True, mean=MEAN)
    params = jax.jit(jnet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 3)))["params"]
    b = _batch()
    cfg = jransac.RansacConfig(unroll=False, **CFG)
    key = jax.random.PRNGKey(3)
    mesh = jparallel.make_mesh(jax.devices()[:2], data=2)

    def loss_of(p, images, poses, pp):
        coords = jnet.apply({"params": p}, images)[..., :3].astype(jnp.float32)
        return jransac.expected_pose_loss(coords, poses, FOCAL, (IMG_H, IMG_W), key, cfg,
                                          pp_shift=pp)[0]

    with mesh:
        data = NamedSharding(mesh, P("data"))
        loss = jax.jit(loss_of)(jparallel.replicate(mesh, params),
                                jax.device_put(jnp.asarray(b["images"]), data),
                                jax.device_put(jnp.asarray(b["poses"]), data),
                                jnp.asarray(b["pp_shift"]))
    idx = np.stack([np.asarray(jax.random.randint(k, (cfg.hypotheses * cfg.sample_rounds, 4), 0,
                                                  (IMG_H // 8) * (IMG_W // 8)))
                    for k in jax.random.split(key, B)])
    return params, float(loss), idx


@pytest.mark.parametrize("zero", [False, True], ids=["dp", "zero"])
def test_e2e_step_under_dp(jax_dp, tmp_path, zero):
    params, jloss, idx = jax_dp
    net = models.build_network("coord", "MLE", tiny=True, mean=MEAN)
    spec = dict(state_dict=compat.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                                       net),
                batch={k: torch.from_numpy(np.asarray(v)) for k, v in _batch().items()},
                kind="e2e", uncertainty="MLE", mean=MEAN, tiny=True, zero=zero, steps=STEPS,
                lr=LR, grad_clip=None, device="cpu", float64=True, ransac=CFG,
                idx=torch.from_numpy(idx))
    out = str(tmp_path / "rank0.pt")
    run_ranks(step_check, 2, (spec, out), timeout=120)
    dp = torch.load(out, weights_only=False)
    single = step_check(spec)
    assert min(dp["loss"]) > 0.0
    gscale = max(float(v.abs().max()) for v in single["grads"].values())
    for name, g in dp["grads"].items():
        np.testing.assert_allclose(g.numpy(), single["grads"][name].numpy(), rtol=1e-5,
                                   atol=1e-5 * gscale, err_msg=name)
    np.testing.assert_allclose(dp["loss"], single["loss"], rtol=1e-5)
    # at the first step's (equal) weights; later steps' norms follow the
    # solve's ill-conditioning through Adam's lr-sized moves
    np.testing.assert_allclose(dp["grad_norm"][0], single["grad_norm"][0], rtol=1e-5)
    for name, p in single["params"].items():
        np.testing.assert_allclose(dp["params"][name].numpy(), p.numpy(), rtol=1e-5,
                                   atol=2e-4 * STEPS, err_msg=name)
    np.testing.assert_allclose(dp["loss"][0], jloss, rtol=1e-4)
