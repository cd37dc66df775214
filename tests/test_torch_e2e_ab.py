"""The port's proxy-vs-e2e A/B tool against the JAX package's `tools/e2e_ab.py`:
the same flags and defaults (`--device` in place of `--platform`), the same
frame draws, label corruption and batch order (bit for bit; the rotations to
float32 rounding), and a tiny CPU run whose final JSON line has the JAX
tool's keys and finite values."""
import ast
import importlib.util
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from crossloc_tpu import data as jdata
from crossloc_tpu_torch.tools import e2e_ab

JAX_TOOL = pathlib.Path(__file__).resolve().parent.parent / "tools" / "e2e_ab.py"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_e2e_ab", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flags_and_defaults_match_the_jax_tool(jax_tool):
    jax_args, port_args = vars(jax_tool.parse_args([])), vars(e2e_ab.parse_args([]))
    assert jax_args.pop("platform") == "cpu" and port_args.pop("device") == "cuda"
    assert port_args == jax_args
    argv = ["--labels", "clean", "--pre", "7", "--cont", "3", "--lr_cont", "1e-3", "--lr_e2e",
            "3e-5", "--frames", "16", "--batch", "2", "--json", "x.json"]
    jax_args, port_args = vars(jax_tool.parse_args(argv)), vars(e2e_ab.parse_args(argv))
    jax_args.pop("platform"), port_args.pop("device")
    assert port_args == jax_args
    assert (jax_tool.H, jax_tool.W, jax_tool.F) == (e2e_ab.H, e2e_ab.W, e2e_ab.F)


def test_frames_corruption_and_batch_order_are_the_jax_tool_s(jax_tool):
    """`main` of the JAX tool draws 64 (`--frames`) train and 12 held-out
    frames from `default_rng(0)`, corrupts with `default_rng(7)` and orders
    batches with `default_rng(seed).choice(frames, batch, replace=False)`."""
    frames = 6
    rng = np.random.default_rng(0)
    tr = [jdata.synth_sample(rng, 96, 144, 120.0, scene="plane") for _ in range(frames)]
    va = [jdata.synth_sample(rng, 96, 144, 120.0, scene="plane") for _ in range(12)]
    tri, trc, trp, vai, vap = e2e_ab.scene(frames)
    # the same draws in the same order: the camera centres bit for bit; the
    # rotation comes from each package's float32 Rodrigues, which differ in
    # the last bit now and then, and the rest follows it to float32 rounding
    for got, key, src in ((trp, "pose", tr), (vap, "pose", va)):
        np.testing.assert_array_equal(got[:, :3, 3], np.stack([s[key] for s in src])[:, :3, 3])
    for got, key, src, atol in ((tri, "image", tr, 1e-6), (trc, "coord", tr, 1e-3),
                                (trp, "pose", tr, 1e-6), (vai, "image", va, 1e-6),
                                (vap, "pose", va, 1e-6)):
        np.testing.assert_allclose(got, np.stack([s[key] for s in src]), rtol=1e-5, atol=atol,
                                   err_msg=key)
    np.testing.assert_array_equal(e2e_ab.corrupt_labels(trc, np.random.default_rng(7)),
                                  jax_tool.corrupt_labels(trc, np.random.default_rng(7)))
    for seed in (1, 2):
        order = np.random.default_rng(seed)
        want = [order.choice(frames, size=4, replace=False) for _ in range(5)]
        np.testing.assert_array_equal(e2e_ab.batch_order(5, seed, frames, 4), want)


def _json_keys(path):
    """The keys of the dict literal assigned to `out` in the JAX tool."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) and getattr(
                node.targets[0], "id", None) == "out":
            return {k.value for k in node.value.keys}
    raise AssertionError("no `out = {...}` in the JAX tool")


def test_a_tiny_cpu_run_prints_the_jax_tool_s_json_line(tmp_path, capsys):
    out = e2e_ab.main(["--device", "cpu", "--pre", "2", "--cont", "1", "--frames", "8",
                       "--batch", "2", "--json", str(tmp_path / "ab.json")])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == out == json.loads((tmp_path / "ab.json").read_text())
    assert set(out) == _json_keys(JAX_TOOL)
    assert out["platform"] == "cpu" and out["lr_e2e"] == out["lr_cont"] == 3e-4
    for arm in ("init", "proxy", "e2e"):
        assert set(out[arm]) == {"t", "r"} and all(map(math.isfinite, out[arm].values()))
    assert math.isfinite(out["t_ratio_e2e_over_proxy"])


def test_no_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is honoured")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        e2e_ab.main(["--pre", "1", "--cont", "1", "--frames", "4", "--batch", "2"])
