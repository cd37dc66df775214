"""The port's quickstart (`crossloc_tpu_torch/examples/quickstart.py`), as
`tests/test_examples.py` guards the JAX one: 30 steps on the CPU, then the
solve, finite per-image pose errors of sane size; and its scene is the JAX
example's (`data.synth_sample` on `default_rng(0)`)."""
import numpy as np
import pytest
import torch

from crossloc_tpu import data as jdata
from crossloc_tpu_torch import data
from crossloc_tpu_torch.examples import quickstart


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quickstart_runs_end_to_end():
    t_err, r_err = quickstart.main(steps=30, device="cpu")
    assert t_err.shape == (4,) and r_err.shape == (4,)
    assert np.all(np.isfinite(t_err)) and np.all(np.isfinite(r_err))
    # 30 steps is a smoke budget, not convergence: the solver must still
    # return a sane pose (a broken solve blows up to MAXLOSS scale)
    assert np.all(t_err < 1e3) and np.all(r_err <= 180.0)


def test_quickstart_scene_is_the_jax_example_s():
    """The same draws in the same order: the image, depths, normals,
    semantics and camera centre bit for bit; the rotation comes from each
    package's float32 Rodrigues (the last bit may differ), and the
    coordinates follow it to float32 rounding."""
    kw = dict(img_h=96, img_w=144, focal=120.0)
    j = jdata.synth_sample(np.random.default_rng(0), **kw)
    t = data.synth_sample(np.random.default_rng(0), **kw)
    for key in ("image", "depth", "normal", "semantics"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    np.testing.assert_array_equal(t["pose"][:3, 3], j["pose"][:3, 3])
    np.testing.assert_allclose(t["pose"], j["pose"], atol=1e-6)
    np.testing.assert_allclose(t["coord"], j["coord"], rtol=1e-5, atol=1e-3)
    assert t["focal"] == j["focal"] == 120.0


def test_quickstart_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is honoured")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        quickstart.main(steps=1)
