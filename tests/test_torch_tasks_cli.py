"""The port's training and eval CLIs for the depth, normal and semantics tasks
against the JAX package's CLIs, and the metrics behind the eval reports.

Same scene and the harness's flags (`encoder_pretrain.sh`: depth and normal
with MLE and `--hardclamp 10`, semantics `--fullsize` without an
uncertainty): the same output-directory and file names (semantics writes a
`ckpt_iter_*.net` every epoch), and `output.log` lines of the same format
with the same iteration and epoch numbers. The eval CLIs, fed the same
`model.net`, write results files whose lines match once the numbers are
masked; the numbers agree within 0.02 (depth and normal: the two nets'
float32 convolutions, printed to two decimals) or 0.5 points (semantics:
the argmax of nearly tied logits may flip a pixel). On identical inputs the
metrics agree within 1e-6 (depth, normal) and exactly (semantics, whose
confusion matrix counts in integers). Every CLI's setup turns TF32 off
(ROADMAP F1).
"""
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from crossloc_tpu import compat as jcompat
from crossloc_tpu import eval as jeval
from crossloc_tpu.cli import common as jcommon
from crossloc_tpu.cli import test_single_task as jtest_cli
from crossloc_tpu.cli import train_single_task as jtrain_cli
from crossloc_tpu_torch import compat, data, eval as evaluation, models
from crossloc_tpu_torch.cli import common
from crossloc_tpu_torch.cli import finetune_decoder_single_task as ft_cli
from crossloc_tpu_torch.cli import test_single_task as test_cli
from crossloc_tpu_torch.cli import train_single_task as train_cli

IMG_H, IMG_W = 32, 48
LINE = re.compile(r"Iteration:\s+(\d+), Epoch:\s+(\d+), Total loss: [-\d.]+, Valid: [\d.]+%, "
                  r"Avg Time: [\d.]+s$")
# the harness's per-task flags (script_clean_training/_lib.sh::task_flags)
TASK_FLAGS = {"depth": ["--hardclamp", "10", "--uncertainty", "MLE"],
              "normal": ["--hardclamp", "10", "--uncertainty", "MLE"],
              "semantics": ["--fullsize", "--uncertainty", "none"]}
NAMES = {"depth": "urbanscape-depth-s{}-unc-MLE-e2-lr0.0002-sim_only-sc1.00-tiny",
         "normal": "urbanscape-normal-s{}-unc-MLE-e2-lr0.0002-sim_only-sc1.00-tiny",
         "semantics": "urbanscape-semantics-s{}-no_unc-fullsize-e2-lr0.0002-sim_only-sc1.00-tiny"}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Random-label frames: the plane scene's normals, (0, 0, -1), equal the
    nodata marker in every cell."""
    root = tmp_path_factory.mktemp("ws")
    for seed, section in enumerate(("train_sim", "val_sim")):
        data.write_fake_dataset(str(root / "datasets" / "urbanscape" / section), n=4,
                                img_h=IMG_H, img_w=IMG_W, focal=40.0, seed=seed)
    return root


def _train_args(ws, task, session):
    return ["urbanscape", "--task", task, *TASK_FLAGS[task], "--batch_size", "2", "--epochs",
            "2", "--tiny", "--sim_data_chunk", "1.0", "--real_data_chunk", "0.0",
            "--datasets_dir", str(ws / "datasets"), "--image_height", str(IMG_H), "--ckpt_dir",
            str(ws / "ckpts"), "--session", session]


def _log(out_dir, session):
    text = (out_dir / "output.log").read_text().splitlines()
    iters = [LINE.search(line) for line in text if "Iteration:" in line]
    assert all(iters), "an Iteration line of another format"
    msgs = [line.split("INFO: ", 1)[1].replace(f"-s{session}-", "-sX-") for line in text
            if "INFO: " in line]
    events = ("===", "Saving", "Done")
    return ([(int(m.group(1)), int(m.group(2))) for m in iters],
            [m for m in msgs if m.startswith(events)])


def _tree(ws, name):
    return {sub: sorted(os.listdir(ws / sub / name)) for sub in ("output", "ckpts")}


@pytest.fixture(scope="module", params=sorted(TASK_FLAGS))
def trained(request, ws):
    """One task trained by both CLIs: (task, the JAX run's and the port's
    (iterations, events, tree))."""
    task = request.param
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        mp.chdir(ws)
        for session, main, extra in (("jax", jtrain_cli.main, []),
                                     ("port", train_cli.main, ["--device", "cpu"])):
            main(_train_args(ws, task, session) + extra)
            name = NAMES[task].format(session)
            runs[session] = (*_log(ws / "output" / name, session), _tree(ws, name))
    finally:
        mp.undo()
    return task, runs


def test_training_cli_matches_jax(trained):
    task, runs = trained
    (j_iters, j_events, j_tree), (t_iters, t_events, t_tree) = runs["jax"], runs["port"]
    assert t_iters == j_iters == [(2, 0), (4, 0), (6, 1), (8, 1)]
    assert t_events == j_events
    assert t_tree == j_tree
    ckpts = [f for f in t_tree["ckpts"] if f.startswith("ckpt_iter_")]
    # semantics snapshots every epoch, the others every 5
    assert ckpts == (["ckpt_iter_0000002.net", "ckpt_iter_0000008.net"] if task == "semantics"
                     else ["ckpt_iter_0000002.net"])


def _numbers_and_form(text):
    nums = [float(v) for v in re.findall(r"\d+\.\d+", text)]
    return nums, re.sub(r"\d+\.\d+", "#", text)


def test_eval_cli_matches_jax_on_the_same_weights(trained, ws):
    """Both eval CLIs serve the port-trained model.net over val_sim (the
    JAX package loads the port's file)."""
    task, _ = trained
    src = ws / "output" / NAMES[task].format("port") / "model.net"
    texts = {}
    for side, main, extra in (("jax", jtest_cli.main, []),
                              ("port", test_cli.main, ["--device", "cpu"])):
        d = ws / f"eval_{side}" / NAMES[task].format("port")
        d.mkdir(parents=True)
        shutil.copy(src, d / "model.net")
        unc = "none" if task == "semantics" else "MLE"
        logs = main(["urbanscape", "--task", task, "--uncertainty", unc, "--tiny",
                     *(["--fullsize"] if task == "semantics" else []), "--network_in",
                     str(d / "model.net"), "--section", "val_sim", "--datasets_dir",
                     str(ws / "datasets"), "--image_height", str(IMG_H), "--batch_size", "2",
                     *extra])
        results = str(d / f"results_model.net_task_{task}.txt")
        assert side == "jax" or logs == [results]
        texts[side] = open(results).read()
    (j_nums, j_form), (t_nums, t_form) = map(_numbers_and_form, (texts["jax"], texts["port"]))
    assert t_form == j_form
    heads = {"depth": "Depth accuracy:", "normal": "Surface normal accuracy:",
             "semantics": "Mean IoU, mean:"}
    assert heads[task] in texts["port"]
    assert len(t_nums) == len(j_nums) > 0 and all(np.isfinite(t_nums))
    np.testing.assert_allclose(t_nums, j_nums, atol=0.5 if task == "semantics" else 0.02)


def test_task_metrics_match_jax_on_the_same_inputs():
    rng = np.random.default_rng(0)
    depth = rng.uniform(1, 50, (3, 4, 6, 1)).astype(np.float32)
    gt_d = rng.uniform(1, 50, (3, 4, 6, 1)).astype(np.float32)
    gt_d[0, 1, 2] = -1.0
    gt_d[1, 0, 0] = 0.0
    np.testing.assert_allclose(evaluation.depth_eval(torch.from_numpy(depth), gt_d),
                               jeval.depth_eval(jnp.asarray(depth), jnp.asarray(gt_d)), rtol=1e-6)
    logits = rng.normal(size=(3, 4, 6, 2)).astype(np.float32)
    gt_n = rng.normal(size=(3, 4, 6, 3)).astype(np.float32)
    gt_n /= np.linalg.norm(gt_n, axis=-1, keepdims=True)
    gt_n[2, 3, 5] = -1.0
    np.testing.assert_allclose(evaluation.normal_eval(torch.from_numpy(logits), gt_n),
                               jeval.normal_eval(jnp.asarray(logits), jnp.asarray(gt_n)),
                               rtol=1e-6)
    sem = rng.normal(size=(3, 16, 24, 6)).astype(np.float32)
    sem[0, 0, 0] = 1.0  # a six-way tie: both take the first maximum
    gt_s = rng.integers(0, 6, (3, 16, 24))
    gt_s[1, 2:5, 3:9] = 5
    got = evaluation.semantic_eval(torch.from_numpy(sem), gt_s)
    ref = jeval.semantic_eval(jnp.asarray(sem), gt_s[..., None].astype(np.float32))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert got[0][0, 0, 0] == 0


@pytest.fixture
def net_file(tmp_path):
    """An empty model.net: the CLIs stop before they read it."""
    (tmp_path / "model.net").write_bytes(b"")
    return tmp_path / "model.net"


def test_plot_writes_the_semantics_grid(ws):
    """`--plot` with semantics: one image | prediction | label grid per batch
    beside the network, under the JAX CLI's file names."""
    net = models.init_weights(models.build_network("semantics", None, tiny=True, fullsize=True),
                              torch.Generator().manual_seed(0))
    names = {}
    for side, main, extra in (("jax", jtest_cli.main, []),
                              ("port", test_cli.main, ["--device", "cpu"])):
        d = ws / f"plot_{side}"
        d.mkdir()
        compat.save_net(str(d / "model.net"), net)
        main(["urbanscape", "--task", "semantics", "--uncertainty", "none", "--tiny",
              "--fullsize", "--plot", "--network_in", str(d / "model.net"), "--section",
              "val_sim", "--datasets_dir", str(ws / "datasets"), "--image_height", str(IMG_H),
              "--batch_size", "2", *extra])
        names[side] = sorted(p.name for p in d.glob("*.png"))
    assert names["port"] == names["jax"] == ["sm_section_val_sim_batch_0.png",
                                             "sm_section_val_sim_batch_1.png"]


class _Stop(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Stop


@pytest.mark.parametrize("which", ["train", "finetune", "eval"])
def test_cli_setup_turns_tf32_off(ws, net_file, monkeypatch, which):
    """ROADMAP F1: each CLI's device setup leaves cuDNN's and matmul's TF32
    off (torch's cuDNN default is on); the run is stopped right after it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.chdir(ws)
    base = ["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny", "--device", "cpu"]
    if which == "eval":
        monkeypatch.setattr(test_cli, "get_nodata_value", _stop)
        args = base + ["--network_in", str(net_file)]
        main = test_cli.main
    else:
        module = train_cli if which == "train" else ft_cli
        monkeypatch.setattr(module, "config_log", _stop)
        args = base + ["--sim_data_chunk", "0.0"]
        if which == "finetune":
            args += ["--encoders", "coord", "--coord_weight", str(net_file),
                     "--reuse_coord_encoder"]
        main = module.main
    with pytest.raises(_Stop):
        main(args)
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


@pytest.mark.parametrize("name", [NAMES["semantics"].format("x"),
                                  "urbanscape-depth-unc-MLE-fullsize-e150-lr0.0002-sim_only-sc1.00",
                                  "urbanscape-coord-decoder_coord_free_depth_normal_semantics-senc-"
                                  "pt1.00-ip-ft1.00-unc-MLE-e1000-lr0.0001-pairwise-ip-rc1.00"])
def test_folder_names_decode_as_in_jax(name):
    """Semantics and -fullsize folders are full size; the four-tower folder
    holds four encoders (the eval CLI builds its net from these)."""
    assert compat.read_meta_info(name) == jcompat.read_meta_info(name)
    assert compat.read_meta_info(name)[5] is True or "decoder" in name
    path = os.path.join(name, "model.net")
    assert common.infer_num_encoders(path) == jcommon.infer_num_encoders(path)


@pytest.mark.parametrize("task", ["depth", "normal", "semantics"])
def test_task_reports_are_byte_identical_to_jax(tmp_path, task):
    """The same per-batch / per-image metrics over two sections give the same
    results-file bytes and the same printed block."""
    rng = np.random.default_rng(7)
    if task == "depth":
        args = [list(rng.uniform(0, 1, 5)), list(rng.uniform(0, 50, 5))]
    elif task == "normal":
        args = [list(rng.uniform(0, 90, 5))]
    else:
        args = [[rng.uniform(0, 1, 3) for _ in range(2)] for _ in range(3)]
    texts = {}
    for side, module in (("jax", jeval), ("port", evaluation)):
        log = str(tmp_path / f"results_{side}.txt")
        fn = getattr(module, f"{'semantic' if task == 'semantics' else task}_report")
        printed = [fn(*args, log, section) for section in ("val_sim", "val_drone_real")]
        texts[side] = (printed, open(log, "rb").read())
    assert texts["port"] == texts["jax"]
