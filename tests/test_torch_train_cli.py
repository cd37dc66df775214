"""The port's training CLI on the CPU against the JAX package's CLI.

Same scene and flags: the same output-directory and file names, `output.log`
lines of the same format with the same iteration and epoch numbers, and the
same `--auto_resume` bookkeeping. Beyond the JAX CLI (its defects, ROADMAP
R3 and R5): a log-parse resume keeps the LR schedule's clock, and
`--snapshot_every_epochs` resumes from the last written snapshot. A `.state`
resume continues bit for bit like an uninterrupted run, and a `.net` the
port trains loads in the JAX package with the same forward.
"""
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from crossloc_tpu import compat as jcompat
from crossloc_tpu import models as jmodels
from crossloc_tpu.cli import train_single_task as jcli
from crossloc_tpu_torch import compat, data, models
from crossloc_tpu_torch.cli import train_single_task as cli

IMG_H, IMG_W = 32, 48
LINE = re.compile(r"Iteration:\s+(\d+), Epoch:\s+(\d+), Total loss: [-\d.]+, Valid: [\d.]+%, "
                  r"Avg Time: [\d.]+s$")


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
    root = tmp_path_factory.mktemp("ws")
    data.write_fake_dataset(str(root / "datasets" / "urbanscape" / "train_sim"), n=4,
                            img_h=IMG_H, img_w=IMG_W, focal=40.0, seed=0, scene="plane")
    return root


def _args(ws, session, extra=()):
    return ["urbanscape", "--task", "coord", "--batch_size", "2", "--epochs", "2", "--tiny",
            "--sim_data_chunk", "1.0", "--real_data_chunk", "0.0", "--uncertainty", "MLE",
            "--datasets_dir", str(ws / "datasets"), "--image_height", str(IMG_H),
            "--ckpt_dir", str(ws / "ckpts"), "--session", session, *extra]


def _run(main, ws, args, monkeypatch):
    monkeypatch.chdir(ws)
    main(args)


def _log_lines(out_dir):
    text = (out_dir / "output.log").read_text().splitlines()
    iters = [LINE.search(line) for line in text if "Iteration:" in line]
    assert all(iters), "an Iteration line of another format"
    msgs = [line.split("INFO: ", 1)[1] for line in text if "INFO: " in line]
    events = ("===", "*****", "Saving", "Done", "Restored", "No full-state", "Successfully")
    return ([(int(m.group(1)), int(m.group(2))) for m in iters],
            [m for m in msgs if m.startswith(events)])


def _tree(ws, name):
    return {sub: sorted(os.listdir(ws / sub / name)) for sub in ("output", "ckpts")}


@pytest.fixture(scope="module")
def jax_runs(ws):
    """The JAX CLI: one fresh two-epoch run, then the same command with
    --auto_resume."""
    mp = pytest.MonkeyPatch()
    try:
        _run(jcli.main, ws, _args(ws, "jax"), mp)
        name = "urbanscape-coord-sjax-unc-MLE-e2-lr0.0002-sim_only-sc1.00-tiny"
        fresh = (_log_lines(ws / "output" / name), _tree(ws, name))
        _run(jcli.main, ws, _args(ws, "jax", ["--auto_resume"]), mp)
        resumed = _log_lines(ws / "output" / name)
    finally:
        mp.undo()
    return fresh, resumed


def _strip(lines, session):
    return [line.replace(f"-s{session}-", "-sX-") for line in lines]


def test_fresh_run_and_auto_resume_match_jax(ws, jax_runs, monkeypatch):
    (j_fresh, j_tree), j_resumed = jax_runs
    _run(cli.main, ws, _args(ws, "port", ["--device", "cpu"]), monkeypatch)
    name = "urbanscape-coord-sport-unc-MLE-e2-lr0.0002-sim_only-sc1.00-tiny"
    t_iters, t_events = _log_lines(ws / "output" / name)
    assert t_iters == j_fresh[0] == [(2, 0), (4, 0), (6, 1), (8, 1)]
    assert _strip(t_events, "port") == _strip(j_fresh[1], "jax")
    assert _tree(ws, name) == j_tree
    assert "model.net" in j_tree["output"] and "ckpt_iter_0000002.net" in j_tree["ckpts"]

    _run(cli.main, ws, _args(ws, "port", ["--device", "cpu", "--auto_resume"]), monkeypatch)
    t_iters, t_events = _log_lines(ws / "output" / name)
    assert t_iters == j_resumed[0]
    assert _strip(t_events, "port") == _strip(j_resumed[1], "jax")
    assert t_events.count("=== Epoch: 0 ======================================") == 1


def _fake_finished_epochs(ws, session, last_epoch, epochs):
    """An output directory as a run killed in `last_epoch` leaves it: a
    model.net and a log whose last line is that epoch (2 steps an epoch)."""
    name = compat.train_output_name("urbanscape", "coord", session=session, uncertainty="MLE",
                                    epochs=epochs, real_data_chunk=0.0, tiny=True)
    out = ws / "output" / name
    out.mkdir(parents=True)
    compat.save_net(str(out / "model.net"), models.build_network("coord", "MLE", tiny=True))
    it = 4 * last_epoch + 2
    (out / "output.log").write_text(
        f"2026-01-01 00:00:00, INFO: Iteration: {it:7d}, Epoch: {last_epoch:3d}, "
        "Total loss: 1.00, Valid: 50.0%, Avg Time: 0.100s\n")
    return out


def _record_lr(monkeypatch):
    seen = []
    real = cli.train_step

    def spy(state, *a, **k):
        out = real(state, *a, **k)
        seen.append((state.step, state.optimizer.adam.param_groups[0]["lr"]))
        return out

    monkeypatch.setattr(cli, "train_step", spy)
    return seen


def test_log_parse_resume_keeps_the_lr_schedule(ws, monkeypatch):
    """ROADMAP R5: resumed in epoch 60 of 62, the first update runs at the
    LR after the epoch-50 milestone (the JAX CLI goes back to the base LR)."""
    _fake_finished_epochs(ws, "r5", last_epoch=60, epochs=62)
    seen = _record_lr(monkeypatch)
    _run(cli.main, ws, _args(ws, "r5", ["--device", "cpu", "--auto_resume", "--epochs", "62"]),
         monkeypatch)
    assert seen == [(121, 1e-4), (122, 1e-4), (123, 1e-4), (124, 1e-4)]


def test_sparse_snapshots_resume_from_the_last_written_one(ws, monkeypatch):
    """ROADMAP R3: with --snapshot_every_epochs 2, a log ending in epoch 3
    resumes at epoch 2, whose weights model.net holds."""
    out = _fake_finished_epochs(ws, "r3", last_epoch=3, epochs=4)
    _run(cli.main, ws, _args(ws, "r3", ["--device", "cpu", "--auto_resume", "--epochs", "4",
                                        "--snapshot_every_epochs", "2"]), monkeypatch)
    iters, events = _log_lines(out)
    assert [e for _, e in iters[1:]] == [2, 2, 3, 3]
    assert "=== Epoch: 2 ======================================" in events


def test_epoch_plus_with_sparse_snapshots_resumes_at_the_log_s_epoch(ws, monkeypatch):
    """ROADMAP F2: an --epoch_plus extension of a finished run written with
    --snapshot_every_epochs 2 resumes at the log's last epoch, as the JAX
    CLI's log-parse resume does (the finished run's last epoch wrote its
    model.net), not at the last multiple of 2 (epoch 2)."""
    src = _fake_finished_epochs(ws, "f2", last_epoch=3, epochs=4)
    (src / "FLAG_training_done.nodata").write_text("")
    _run(cli.main, ws, _args(ws, "f2", ["--device", "cpu", "--epoch_plus", "--epochs", "5",
                                        "--snapshot_every_epochs", "2"]), monkeypatch)
    iters, events = _log_lines(ws / "output" / src.name.replace("-e4-", "-e5-"))
    assert [e for _, e in iters] == [3, 3, 3, 4, 4]
    assert "=== Epoch: 2 ======================================" not in events


class _Interrupt(Exception):
    pass


def test_state_resume_continues_bit_for_bit(ws, monkeypatch):
    """--ckpt_backend msgpack: a run stopped after epoch 0 and resumed with
    --auto_resume ends with the bits of an uninterrupted run."""
    extra = ["--device", "cpu", "--ckpt_backend", "msgpack"]
    _run(cli.main, ws, _args(ws, "whole", extra), monkeypatch)

    real_set_epoch = data.Loader.set_epoch

    def stop_at_epoch_1(self, epoch):
        if epoch == 1:
            raise _Interrupt
        real_set_epoch(self, epoch)

    with monkeypatch.context() as m:
        m.setattr(data.Loader, "set_epoch", stop_at_epoch_1)
        with pytest.raises(_Interrupt):
            _run(cli.main, ws, _args(ws, "cut", extra), m)
    _run(cli.main, ws, _args(ws, "cut", extra + ["--auto_resume"]), monkeypatch)
    log = (ws / "output" / "urbanscape-coord-scut-unc-MLE-e2-lr0.0002-sim_only-sc1.00-tiny"
           / "output.log").read_text()
    assert "Restored full train state (step 2)" in log

    def weights(session, net):  # a resumed run snapshots to model_auto_resume.net
        return compat.load_net(str(ws / "output" / f"urbanscape-coord-s{session}-unc-MLE-e2-"
                                   "lr0.0002-sim_only-sc1.00-tiny" / net))

    a, b = weights("whole", "model.net"), weights("cut", "model_auto_resume.net")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_trained_net_loads_in_the_jax_package(ws, monkeypatch):
    """A `.net` the port trained loads in `crossloc_tpu.compat.load_net` and
    gives the same forward there (f32 convs: within 1e-3 of each output
    channel's spread)."""
    _run(cli.main, ws, _args(ws, "xfer", ["--device", "cpu", "--epochs", "1"]), monkeypatch)
    path = str(ws / "output" / "urbanscape-coord-sxfer-unc-MLE-e1-lr0.0002-sim_only-sc1.00-tiny"
               / "model.net")
    jnet = jmodels.build_network("coord", "MLE", tiny=True, mean=[-29.34, 184.17, 91.96])
    params = jcompat.load_net(path, jnet)
    net = models.build_network("coord", "MLE", tiny=True)
    compat.load_net(path, net)
    x = np.random.default_rng(0).uniform(0, 1, (2, IMG_H, IMG_W, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jnet.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - ref).max(axis=(0, 1, 2)).max() <= 1e-3 * ref.std(axis=(0, 1, 2)).min()


@pytest.mark.parametrize("flag, exc, item", [
    (["--task", "semantics", "--fullsize"], NotImplementedError, "no uncertainty head"),
    (["--task", "semantics", "--uncertainty", "none"], NotImplementedError, "requires --fullsize"),
    (["--zero"], ValueError, "requires a device mesh"),
    (["--num_devices", "3", "--batch_size", "4"], ValueError, "divisible by num_devices"),
    (["--num_devices", "3", "--batch_size", "3", "--zero"], ValueError,
     "data=3 must divide 32"),
])
def test_unported_flags_raise(ws, monkeypatch, flag, exc, item):
    """What the port refuses, before anything is written: the semantics
    configurations the JAX package's `build_network` refuses, and the
    parallel flags a run cannot honour (the JAX CLI's words)."""
    with pytest.raises(exc, match=item):
        _run(cli.main, ws, _args(ws, "no", ["--device", "cpu", *flag]), monkeypatch)
    assert not list(ws.glob("output/*-sno-*"))


def test_e2e_pose_loss_needs_the_coord_task(ws, monkeypatch):
    """--e2e_pose_loss --task depth: the JAX CLI's ValueError, word for word,
    before anything is written."""
    args = _args(ws, "no", ["--e2e_pose_loss", "--task", "depth"])
    with pytest.raises(ValueError) as ref:
        jcli.normalize_opt(jcli.config_parser().parse_args(args))
    with pytest.raises(ValueError) as port:
        _run(cli.main, ws, args + ["--device", "cpu"], monkeypatch)
    assert str(port.value) == str(ref.value) and "--task coord" in str(ref.value)
    assert not list(ws.glob("output/*-sno-*"))


def test_vanilla_net_scene_raises(ws, monkeypatch):
    """A scene outside urbanscape / naturescape has no nodata marker: both
    CLIs raise the JAX package's `get_nodata_value` error. The JAX CLI has
    made its output folder by then; the port refuses before it writes
    anything."""
    monkeypatch.setenv("CROSSLOC_COMPILATION_CACHE", "0")
    args = ["cambridge"] + _args(ws, "vanilla")[1:]
    with pytest.raises(NotImplementedError) as ref:
        _run(jcli.main, ws, args, monkeypatch)
    assert list(ws.glob("output/cambridge-*"))
    for d in [*ws.glob("output/cambridge-*"), *ws.glob("ckpts/cambridge-*")]:
        shutil.rmtree(d)
    with pytest.raises(NotImplementedError) as port:
        _run(cli.main, ws, args + ["--device", "cpu"], monkeypatch)
    assert str(port.value) == str(ref.value) == "unknown scene family: cambridge"
    assert not list(ws.glob("output/cambridge-*"))


def test_cuda_request_without_cuda_raises(ws, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the request is honoured")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        _run(cli.main, ws, _args(ws, "nocuda"), monkeypatch)
