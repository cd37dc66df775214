"""The decoder-finetune CLI under data parallelism: `--num_devices 2 --zero
--ckpt_backend orbax` over two CPU ranks (gloo) on the tiny MLR net of three
towers (the coord tower trains, depth and normal stay frozen). Only rank 0
writes the wired net; the frozen towers stay replicated and leave the run
bit-identical to their donors; the run continues from its DCP state; and it
ends where the one-process run of the same global batch ends, within Adam's
quantum.
"""
import os

import pytest
import torch

from crossloc_tpu_torch import compat, data, models
from crossloc_tpu_torch.cli import finetune_decoder_single_task as cli

H, W = 32, 48
NAME = ("urbanscape-coord-decoder_coord_free_depth_normal-unc-MLE-e{e}-lr0.0001-pairwise-ip"
        "-rc1.00-tiny")


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft_dp")
    for i, (t, s) in enumerate([("coord", "train_drone_real"), ("depth", "train_drone_sim"),
                                ("normal", "val_drone_real")]):
        data.write_fake_dataset(str(root / "datasets" / "urbanscape" / s), n=4, img_h=H,
                                img_w=W, focal=40.0, seed=i, scene="plane")
        (root / "weights" / t).mkdir(parents=True)
        compat.save_net(str(root / "weights" / t / "model.net"), models.init_weights(
            models.build_network(t, "MLE", tiny=True), torch.Generator().manual_seed(i)))
    return root


def _args(ws, epochs, extra=()):
    w = ws / "weights"
    return ["urbanscape", "--task", "coord", "--uncertainty", "MLE", "--tiny", "--batch_size",
            "4", "--epochs", str(epochs), "--learningrate", "1e-4", "--sim_data_chunk", "0.0",
            "--real_data_chunk", "1.0", "--encoders", "coord", "depth", "normal",
            "--coord_weight", str(w / "coord" / "model.net"), "--depth_weight",
            str(w / "depth" / "model.net"), "--normal_weight", str(w / "normal" / "model.net"),
            "--reuse_coord_encoder", "--unfreeze_coord_encoder", "--no_lr_scheduling",
            "--datasets_dir", str(ws / "datasets"), "--image_height", str(H), "--device", "cpu",
            *extra]


def test_finetune_under_zero_with_dcp(ws, monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        (ws / "dp").mkdir()
        monkeypatch.chdir(ws / "dp")
        extra = ["--num_devices", "2", "--zero", "--ckpt_backend", "orbax"]
        cli.main(_args(ws, 1, extra))
        cli.main(_args(ws, 2, extra + ["--epoch_plus"]))
        (ws / "one").mkdir()
        monkeypatch.chdir(ws / "one")
        cli.main(_args(ws, 2))
    finally:
        torch.set_num_threads(n)
    out1, out2 = ws / "dp" / "output" / NAME.format(e=1), ws / "dp" / "output" / NAME.format(e=2)
    log1, log2 = (out1 / "output.log").read_text(), (out2 / "output.log").read_text()
    assert "Data-parallel training over 2 devices with ZeRO parameter sharding" in log1
    assert "Saving the initialized MLR model weight" in log1
    assert log1.count("Iteration:") == 2  # rank 0's lines: 8 pairwise frames, global batch 4
    assert [d for d in os.listdir(out1) if d.isdigit()] == ["2"]
    assert "Restored full train state (step 2): exact optimizer resume from epoch 1." in log2

    got = compat.load_net(str(out2 / "model_epoch_plus_resume.net"))
    ref = compat.load_net(str(ws / "one" / "output" / NAME.format(e=2) / "model.net"))
    diffs = sorted(float((got[k].double() - ref[k].double()).abs().max()) for k in ref)
    assert diffs[len(diffs) // 2] < 1e-5 and diffs[-1] < 3.0 * 4 * 1e-4, diffs[-1]
    for i, task in ((2, "depth"), (3, "normal")):  # frozen towers: the donors' bits
        donor = compat.load_net(str(ws / "weights" / task / "model.net"))
        for k, v in donor.items():
            if k.startswith("encoder."):
                assert torch.equal(got[f"mlr_encoder_{i}." + k[len("encoder."):]], v), k
