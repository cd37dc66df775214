"""The port's measurement tools on the CPU: `tools.loader_bench` and
`tools.bench` (`--device cpu --tiny`) print their JSON line with its keys,
and `bench.conv_flops` equals a hand count of the tiny net's convs."""
import json

import pytest
import torch

from crossloc_tpu_torch import models
from crossloc_tpu_torch.tools import bench, loader_bench

torch.set_num_threads(2)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_loader_bench_json(capsys, tmp_path):
    out = loader_bench.main(["--frames", "6", "--size", "32", "48", "--image-height", "24",
                             "--threads", "1", "2", "--repeat", "1", "--batch", "2",
                             "--step-ms", "1", "3", "--workdir", str(tmp_path)])
    line = _last_json(capsys)
    assert line == json.loads(json.dumps(out))
    assert line["metric"] == "loader_bench" and line["usable_cores"] >= 1
    decoders = ["pil"] + (["native"] if line["native"] else [])
    for name in decoders:
        for n in (1, 2):
            assert line[f"{name}_t{n}"] > 0
    assert line["collate_decoder"] == ("native" if line["native"] else "PIL")
    assert line["collate_inline"] > 0 and line["wire_ms"] > 0
    for step in ("1.0", "3.0"):
        r = line["loader"][step]
        assert r["batches"] == 3 and r["first_ms"] >= 0 and r["stall_ms"] >= 0


def test_bench_json_on_the_cpu(capsys):
    out = bench.main(["2", "1", "--device", "cpu", "--tiny", "--size", "32", "48"])
    line = _last_json(capsys)
    assert line == json.loads(json.dumps(out))
    assert line["metric"] == "image_to_pose_throughput_32x48_b2"
    assert line["value"] > 0 and line["unit"] == "images/sec/card"
    assert line["device"] == "cpu" and line["mfu"] is None  # no device figure from a CPU run
    assert line["k1_launches_per_batch"] == 0  # the CPU takes the plain norm
    assert "vs_baseline" not in line


def test_conv_flops_hand_count():
    # the tiny net at 32x48: (C_in, C_out, k, H_out, W_out) of every conv
    stems = [(3, 32, 3, 32, 48), (32, 64, 3, 16, 24), (64, 128, 3, 8, 12), (128, 128, 3, 4, 6)]
    k3 = [(128, 128, 3, 4, 6)] * 12  # res1 2, res2 2, enc blocks 2 x 2, dec blocks 2 x 2
    # res1, res2, enc 2, dec 2, res3 3, fc1, fc2 (no res2_skip: mid == wide when tiny)
    k1 = [(128, 128, 1, 4, 6)] * 11
    fc3 = [(128, 4, 1, 4, 6)]  # 3 coordinates + 1 uncertainty
    hand = sum(2 * ci * co * k * k * h * w for ci, co, k, h, w in stems + k3 + k1 + fc3)
    net = models.build_network("coord", "MLE", tiny=True)
    assert bench.conv_flops(net, 32, 48) == hand


def test_bench_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.run(2, 1, device=None, tiny=True, size=(32, 48))
