"""The operation and byte counts against hand counts, and each
configuration's layer table against the port's built net, so that a drift
between them is caught rather than adopted."""
import copy
import math

import pytest
import torch

from perfbench.core import spec, weights, work

CONFIGS = [c["name"] for c in spec.benchmark()["configs"]]


def _layer(config, name):
    return next(l for l in config["layers"] if l["name"] == name)


def test_conv_counts_by_hand():
    cfg = spec.config("crossloc-coord-480x720")
    conv2 = _layer(cfg, "encoder.conv2")  # 32 -> 64, 3x3, stride 2, out 240 x 360
    (f, b), = work.conv_terms(conv2, 1, 480, 720, 4, backward=False)
    assert f == 2 * 32 * 64 * 9 * 240 * 360
    assert b == 4 * (480 * 720 * 32 + 64 * 32 * 9 + 240 * 360 * 64)
    (fw, bw), (fd, bd) = work.conv_terms(conv2, 1, 480, 720, 4, backward=True)
    assert fw == fd == f
    assert bw == 4 * (480 * 720 * 32 + 240 * 360 * 64 + 64 * 32 * 9)
    assert bd == 4 * (240 * 360 * 64 + 64 * 32 * 9 + 480 * 720 * 32)
    conv1 = _layer(cfg, "encoder.conv1")  # the image needs no gradient
    assert len(work.conv_terms(conv1, 1, 480, 720, 4, backward=True)) == 1


def test_norm_bytes_by_hand():
    cfg = spec.config("crossloc-mlr3-480x720")
    norm2 = _layer(cfg, "mlr_encoder_1.norm2")  # C = 64 at 240 x 360
    assert work.norm_bytes(norm2, 1, 480, 720, 4, False) == 2 * 240 * 360 * 64 * 4
    assert work.norm_bytes(norm2, 1, 480, 720, 4, True) == 240 * 360 * 4 * (2 * 64 + 64)
    frozen = _layer(cfg, "mlr_encoder_2.norm2")
    assert work.norm_bytes(frozen, 1, 480, 720, 4, True) == 0
    merge = _layer(cfg, "mlr_norm")  # dx only over the trainable tower's 512 channels
    assert work.norm_bytes(merge, 1, 480, 720, 4, True) == 60 * 90 * 4 * (2 * 1536 + 512)


def test_forward_flop_of_the_coord_net():
    cfg = spec.config("crossloc-coord-480x720")
    gflop = work.counts(cfg, 1, training=False)["conv"].flop / 1e9
    assert abs(gflop - 295.4133504) < 1e-6


@pytest.mark.parametrize("name", CONFIGS)
def test_layer_table_matches_the_port(name):
    from crossloc_tpu_torch import models
    from crossloc_tpu_torch.models.layers import Conv, GroupNorm

    cfg = spec.config(name)
    net = cfg["net"]
    model = models.build_network(cfg["task"], cfg["uncertainty"], num_mlr=net["num_mlr"],
                                 num_unfrozen_encoder=net["num_unfrozen_encoder"],
                                 mean=cfg["mean"])
    state = weights.state_dict(cfg, 0, torch.device("cpu"))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    seen = {}

    def hook(mod, args, kwargs, out):
        seen[names[mod]] = (mod, args[0], out, kwargs.get("relu", False))

    names = {m: n for n, m in model.named_modules() if isinstance(m, (Conv, GroupNorm))}
    for m in names:
        m.register_forward_hook(hook, with_kwargs=True)
    H, W = 32, 48
    model(torch.rand(1, H, W, 3))
    table = {l["name"]: l for l in cfg["layers"]}
    assert set(table) == set(seen)
    for n, (mod, x, y, relu) in seen.items():
        l = table[n]
        assert (y.shape[1], y.shape[2]) == (math.ceil(H / l["scale"]), math.ceil(W / l["scale"]))
        assert l["train"] == mod.weight.requires_grad
        if l["op"] == "conv":
            assert (mod.in_channels, mod.out_channels, mod.kernel_size[0], mod.stride[0]) == \
                (l["cin"], l["cout"], l["k"], l["stride"])
        else:
            assert (mod.weight.shape[0], mod.num_groups, relu, mod.eps) == \
                (l["c"], l["groups"], l["relu"], cfg["gn_eps"])
        assert (l["grad_in"] > 0) == (x.requires_grad and l["train"]), n


@pytest.mark.parametrize("key,value", [("gn_eps", 1e-6), ("groups", 16)])
def test_a_net_unlike_the_configuration_is_refused(key, value):
    cfg = copy.deepcopy(spec.config("crossloc-coord-480x720"))
    if key == "groups":
        _layer(cfg, "encoder.norm4")["groups"] = value
    else:
        cfg[key] = value
    with pytest.raises(ValueError):
        weights.port_model(cfg, 0, torch.device("cpu"))


@pytest.mark.parametrize("change", [{"dtype": "bfloat16"}, {"tf32": True}])
def test_a_precision_the_loops_do_not_run_is_refused(tiny, change):
    from perfbench.core import cell as cell_mod

    c = tiny("coord-pretrain-f32-b12")
    c.config.update(change)
    with pytest.raises(ValueError):
        cell_mod.measure(c, 1, 0.1, False, "/nonexistent", "cpu")


def test_seeded_affine_and_biases_are_drawn():
    cfg = spec.config("crossloc-coord-480x720")
    state = weights.state_dict(cfg, 7, torch.device("cpu"))
    for name in ("encoder.norm1.weight", "encoder.norm1.bias", "decoder.fc3.bias",
                 "encoder.conv1.bias"):
        t = state[name]
        base = 1.0 if name.endswith("norm1.weight") else 0.0
        assert (t - base).abs().min() > 0 and 0.05 < float((t - base).std()) < 0.2, name
    again = weights.state_dict(cfg, 7, torch.device("cpu"))
    assert all(torch.equal(state[n], again[n]) for n in state)
