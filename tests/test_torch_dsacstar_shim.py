"""The port's `dsacstar` drop-in shim against the JAX package's.

The plugin's four functions on CPU tensors (`device="cpu"`; the default is
the card). Both shims draw from their own seeds (a JAX key, a torch
generator), so they are compared statistically: on noise-free coordinates
both forwards recover the ground-truth pose; on noisy ones the JAX shim's
expected loss and gradient norm lie within the spread of the port's over 8
seeds. The matched-draw comparisons are the modules' (`test_torch_dsac_loss`,
`test_torch_rgbd`).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import crossloc_tpu.compat.dsacstar_shim as jshim
from crossloc_tpu import geometry as jgeo
import crossloc_tpu_torch.compat.dsacstar_shim as dsacstar

sys.path.insert(0, str(Path(__file__).parent))
from test_ransac import synth_scene  # noqa: E402

IMG_H, IMG_W, FOCAL = 480, 720, 500.0
PP = (IMG_W / 2.0, IMG_H / 2.0)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """(NCHW scene coordinates [1, 3, 30, 45], GT cam-to-world, NCHW camera
    coordinates) of an exact 480x720 frame."""
    coords, gt = synth_scene(np.random.default_rng(0), B=1)
    nchw = torch.from_numpy(np.transpose(np.asarray(coords), (0, 3, 1, 2)).copy())
    gt = np.asarray(gt[0])
    w2c = np.linalg.inv(gt)
    cam = np.asarray(coords)[0] @ w2c[:3, :3].T + w2c[:3, 3]
    eye = torch.from_numpy(np.transpose(cam[None], (0, 3, 1, 2)).astype(np.float32).copy())
    return nchw, gt, eye


def _errors(est, gt):
    r = float(jgeo.rotation_angle_deg(jnp.asarray(est[:3, :3]), jnp.asarray(gt[:3, :3])))
    return float(np.linalg.norm(est[:3, 3] - gt[:3, 3])), r


def test_forward_rgb_recovers_the_pose_in_both(scene):
    nchw, gt, _ = scene
    out = torch.zeros((4, 4), dtype=torch.float64)
    ptr = out.data_ptr()
    assert dsacstar.forward_rgb(nchw, out, 64, 10.0, FOCAL, *PP, 100.0, 100.0, 8,
                                device="cpu") == 0
    assert out.data_ptr() == ptr and out.dtype == torch.float64  # written in place
    ref = torch.zeros((4, 4))
    jshim.forward_rgb(nchw, ref, 64, 10.0, FOCAL, *PP, 100.0, 100.0, 8)
    t_p, r_p = _errors(out.numpy(), gt)
    t_j, r_j = _errors(ref.numpy(), gt)
    assert max(t_p, t_j) < 0.05 and max(r_p, r_j) < 0.05, (t_p, r_p, t_j, r_j)


def test_forward_rgbd_recovers_the_pose_in_both(scene):
    nchw, gt, eye = scene
    out, ref = torch.zeros((4, 4)), torch.zeros((4, 4))
    assert dsacstar.forward_rgbd(nchw, eye, out, 64, 10.0, 100.0, 100.0, device="cpu") == 0
    jshim.forward_rgbd(nchw, eye, ref, 64, 10.0, 100.0, 100.0)
    t_p, r_p = _errors(out.numpy(), gt)
    t_j, r_j = _errors(ref.numpy(), gt)
    assert max(t_p, t_j) < 0.01 and max(r_p, r_j) < 0.01, (t_p, r_p, t_j, r_j)


def _within_spread(port, ref, what):
    """The JAX shim's value within the port's mean +- 4 sigma (+5 % of the
    mean) over its 8 seeds."""
    mu, sd = float(np.mean(port)), float(np.std(port))
    assert abs(ref - mu) <= 4 * sd + 0.05 * abs(mu), (what, ref, mu, sd)


@pytest.mark.parametrize("kind", ["rgb", "rgbd"])
def test_backward_fills_gradients_like_jax(scene, kind):
    nchw, gt, eye = scene
    noisy = nchw + torch.randn(nchw.shape, generator=torch.Generator().manual_seed(1)) * 0.3
    gt_t = torch.from_numpy(gt.astype(np.float32))

    def run(module, seed, **kw):
        grad = torch.full_like(nchw, float("nan"))
        if kind == "rgb":
            loss = module.backward_rgb(noisy, grad, gt_t, 16, 10.0, FOCAL, *PP, 1.0, 1.0, 100.0,
                                       100.0, 100.0, 8, seed, **kw)
        else:
            loss = module.backward_rgbd(noisy, eye, grad, gt_t, 16, 10.0, 1.0, 1.0, 100.0, 100.0,
                                        100.0, seed, **kw)
        assert np.isfinite(loss) and torch.isfinite(grad).all() and grad.abs().sum() > 0
        return loss, float(grad.norm())

    port = [run(dsacstar, seed, device="cpu") for seed in range(8)]
    ref = run(jshim, 42)
    _within_spread([p[0] for p in port], ref[0], "loss")
    _within_spread([p[1] for p in port], ref[1], "gradient norm")


def test_the_default_device_is_the_card(scene):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default is honoured")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        dsacstar.forward_rgb(scene[0], torch.zeros((4, 4)), 64, 10.0, FOCAL, *PP, 100.0, 100.0, 8)
