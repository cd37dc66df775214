"""The port's decoder-finetune CLI, naming and encoder checks against the JAX
package's.

`finetune_output_name`, `check_encoders` and `infer_num_encoders` give the
same names, orders, counts and errors as the JAX package's. On the CPU at
tiny widths, the port's CLI with `decoder_finetune.sh`'s flags names its
output folder as the JAX CLI does and writes the same wired weights into
its initial `model.net`; it trains with the depth and normal towers frozen
bit for bit, resumes with `--auto_resume`, and the port's eval CLI serves
the result with the tower count read from the folder name.
"""
import os

import pytest
import torch

from crossloc_tpu import compat as jcompat
from crossloc_tpu.cli import common as jcommon
from crossloc_tpu.cli import finetune_decoder_single_task as jcli
from crossloc_tpu.utils import io as jio
from crossloc_tpu_torch import compat, data, models
from crossloc_tpu_torch.cli import common
from crossloc_tpu_torch.cli import finetune_decoder_single_task as cli
from crossloc_tpu_torch.cli import test_single_task as test_cli
from crossloc_tpu_torch.utils import check_encoders

IMG_H, IMG_W = 32, 48
BASE = dict(scene="urbanscape", task="coord", encoders=["coord", "depth", "normal"],
            uncertainty="MLE", epochs=3, learning_rate=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on one CPU: two threads
    each keep torch's thread pools from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(reuse_coord_encoder=True),
    dict(reuse_coord_encoder=True, unfreeze_coord_encoder=True),
    dict(reuse_coord_encoder=True, unfreeze_coord_encoder=True, e2e=True, bf16=True),
    dict(real_only=True, session="enc-pt1.00-ip-ft1.00"),
    dict(real_data_domain="out_of_place", real_data_chunk=0.5, tiny=True),
    dict(real_data_chunk=0.0, sim_data_chunk=1.0),
    dict(real_data_chunk=0.0, sim_data_chunk=1.0, session="enc-pt1.00-ip-ft0.00"),
    dict(grayscale=True, fullsize=True, learning_rate=5e-5, network_in="x.net", debug=True,
         encoders=["coord", "depth", "normal", "semantics"]),
], ids=["plain", "frozen", "free", "e2e_bf16", "real_only", "oop", "sim_only", "zero_shot",
        "gray_full_lr_resume_debug"])
def test_finetune_output_name_matches_jax(kw):
    args = dict(BASE, **kw)
    name = compat.finetune_output_name(**args)
    assert name == jcompat.finetune_output_name(**args)
    assert common.infer_num_encoders(f"/o/{name}/model.net") == jcommon.infer_num_encoders(
        f"/o/{name}/model.net")
    assert _outcome(compat.read_meta_info, name) == _outcome(jcompat.read_meta_info, name)


def _outcome(fn, *args):
    """fn's result, or the type of what it raised."""
    try:
        return fn(*args)
    except (ValueError, NotImplementedError) as e:
        return type(e)


@pytest.mark.parametrize("kw, err", [
    (dict(real_data_chunk=0.0, sim_data_chunk=0.0), ValueError),
    (dict(real_data_chunk=1.0, sim_data_chunk=0.5), ValueError),
    (dict(real_data_domain="elsewhere"), NotImplementedError),
], ids=["no_data", "pairwise_with_sim", "domain"])
def test_finetune_output_name_errors_match_jax(kw, err):
    with pytest.raises(err):
        jcompat.finetune_output_name(**dict(BASE, **kw))
    with pytest.raises(err):
        compat.finetune_output_name(**dict(BASE, **kw))


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """Seeded tiny coord, depth and normal nets as `.net` files in folders
    named after their task; a pairwise plane scene and a val section."""
    root = tmp_path_factory.mktemp("ft")
    for i, (task, sub) in enumerate([("coord", "train_drone_real"), ("depth", "train_drone_sim"),
                                     ("normal", "val_drone_real")]):
        net = models.build_network(task, "MLE", tiny=True, mean=[0.5] * models.task_channels(task))
        models.init_weights(net, torch.Generator().manual_seed(i))
        (root / "weights" / task).mkdir(parents=True)
        compat.save_net(str(root / "weights" / task / "model.net"), net)
        data.write_fake_dataset(str(root / "datasets" / "urbanscape" / sub), n=2, img_h=IMG_H,
                                img_w=IMG_W, focal=40.0, seed=i, scene="plane")
    return root


def _weights(ws, tasks=("coord", "depth", "normal", "semantics")):
    return {t: str(ws / "weights" / t / "model.net") for t in tasks}


@pytest.mark.parametrize("encoders, err", [
    (["coord", "depth", "normal"], None),
    (["normal", "coord", "depth", "depth"], None),
    (["coord"], None),
    (["coord", "rgb"], ValueError),
    (["depth", "normal"], ValueError),
    (["coord", "semantics"], FileNotFoundError),
], ids=["cdn", "unordered", "coord_only", "unknown", "no_coord", "missing_file"])
def test_check_encoders_matches_jax(ws, encoders, err):
    w = _weights(ws)
    args = (encoders, w["coord"], w["depth"], w["normal"], w["semantics"])
    if err is not None:
        with pytest.raises(err):
            jio.check_encoders(*args)
        with pytest.raises(err):
            check_encoders(*args)
        return
    assert check_encoders(*args) == jio.check_encoders(*args)


def _args(ws, session, extra=(), reuse=True, unfreeze=True):
    w = _weights(ws)
    return ["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny", "--batch_size", "2",
            "--epochs", "1", "--learningrate", "1e-4", "--sim_data_chunk", "0.0",
            "--real_data_chunk", "1.0", "--real_data_domain", "in_place", "--auto_resume",
            "--encoders", "coord", "depth", "normal", "--coord_weight", w["coord"],
            "--depth_weight", w["depth"], "--normal_weight", w["normal"],
            "--semantics_weight", w["semantics"], "--no_lr_scheduling", "--session", session,
            "--datasets_dir", str(ws / "datasets"), "--image_height", str(IMG_H),
            "--ckpt_dir", str(ws / "ckpts"),
            *(["--reuse_coord_encoder"] if reuse else []),
            *(["--unfreeze_coord_encoder"] if unfreeze else []), *extra]


NAME = ("urbanscape-coord-decoder_coord_free_depth_normal-s{}-unc-MLE-e1-lr0.0001-pairwise-ip"
        "-rc1.00-tiny")


def test_finetune_cli_matches_jax_trains_and_serves(ws, monkeypatch):
    # the JAX CLI up to its training loop: the output folder and the wired
    # initial model.net
    jax_cwd = ws / "jax"
    jax_cwd.mkdir()
    monkeypatch.chdir(jax_cwd)
    monkeypatch.setattr(jcli, "run_training", lambda *a, **k: None)
    jcli.main(_args(ws, "cli"))
    j_init = compat.load_net(str(jax_cwd / "output" / NAME.format("cli") / "model.net"))

    # the port's CLI on the CPU, its initial model.net kept before training
    initial = {}
    real = cli.run_training

    def keep_initial(opt, output_dir, *a, **k):
        initial.update(compat.load_net(os.path.join(output_dir, "model.net")))
        return real(opt, output_dir, *a, **k)

    monkeypatch.setattr(cli, "run_training", keep_initial)
    monkeypatch.chdir(ws)
    out_dir = cli.main(_args(ws, "cli", ["--device", "cpu"]))
    assert os.path.basename(out_dir) == NAME.format("cli")
    assert set(initial) == set(j_init)
    wired = [k for k in initial if k.startswith(("mlr_encoder_", "decoder.")) or k == "mean"]
    assert {k.split(".")[0] for k in set(initial) - set(wired)} == {"mlr_skip", "mlr_forward",
                                                                    "mlr_norm"}
    for k in wired:
        assert torch.equal(initial[k], j_init[k]), k

    # training: towers 2 and 3 stay their donors' encoders, bit for bit
    trained = compat.load_net(os.path.join(out_dir, "model.net"))
    donors = {t: compat.load_net(p) for t, p in _weights(ws, ("coord", "depth", "normal")).items()}
    for tower, task in ((2, "depth"), (3, "normal")):
        for k, v in donors[task].items():
            if k.startswith("encoder."):
                assert torch.equal(trained[f"mlr_encoder_{tower}.{k[8:]}"], v), (tower, k)
    for k in ("mlr_encoder_1.conv1.weight", "mlr_forward.0.weight", "decoder.fc3.weight"):
        assert not torch.equal(trained[k], initial[k]), k
    log = open(os.path.join(out_dir, "output.log")).read()
    assert "3 network weights to load, flag_unfreeze_coord_encoder: True" in log
    assert "Saving the initialized MLR model weight to" in log
    for d in (out_dir, str(ws / "ckpts" / NAME.format("cli"))):
        assert os.path.exists(os.path.join(d, "FLAG_training_done.nodata"))
    assert os.listdir(ws / "ckpts" / NAME.format("cli")).count("ckpt_iter_0000002.net") == 1

    # a second run resumes from the MLR model.net (a strict load)
    monkeypatch.setattr(cli, "run_training", real)
    cli.main(_args(ws, "cli", ["--device", "cpu"]))
    log = open(os.path.join(out_dir, "output.log")).read()
    assert "***** Automatic resume training from" in log
    assert os.path.exists(os.path.join(out_dir, "model_auto_resume.net"))

    # the eval CLI reads num_mlr = 3 from the folder name
    logs = test_cli.main(["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny",
                          "--network_in", os.path.join(out_dir, "model.net"), "--section",
                          "val_drone_real", "--datasets_dir", str(ws / "datasets"),
                          "--image_height", str(IMG_H), "--batch_size", "2", "--device", "cpu"])
    assert "Median Error" in open(logs[0]).read()


@pytest.mark.parametrize("extra, flags, err, match", [
    ([], dict(reuse=False), ValueError, "needs --reuse_coord_encoder"),
    (["--encoders", "depth", "normal", "coord"], dict(reuse=False, unfreeze=False), ValueError,
     "list coord first"),
    (["--task", "depth"], {}, ValueError, "takes --task coord"),
    (["--e2e_pose_loss", "--task", "depth"], {}, ValueError, "requires --task coord"),
    (["--device", "cuda"], {}, RuntimeError, "CUDA was requested"),
], ids=["unfreeze_without_reuse", "coord_not_first", "task", "e2e", "cuda"])
def test_refused_flags_write_nothing(ws, monkeypatch, extra, flags, err, match):
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is honoured")
    monkeypatch.chdir(ws)
    with pytest.raises(err, match=match):
        cli.main(_args(ws, "no", ["--device", "cpu", *extra], **flags))
    assert not list(ws.glob("output/*-sno-*"))
