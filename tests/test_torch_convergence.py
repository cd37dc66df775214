"""The convergence driver's mechanics on the CPU (`--smoke`): the plane
scene, phase 1 and both phase-2 arms through the unchanged
`encoder_pretrain.sh`, the sweeps through `validate_encoder_pretrain.sh`,
the parsed trajectory and one JSON line per arm; a rerun on the same work
directory skips every finished stage and reports the same numbers. The
first run passes the JAX tool's protocol flags at their smoke defaults."""
import json

import pytest

from crossloc_tpu_torch.tools import convergence

KEYS = {"loss_first", "loss_last", "t_first", "t_final", "t_best", "r_final", "pct_10m10deg",
        "pct_5m5deg", "steps", "step_ms", "wall_s", "device", "arm", "lr_phase2", "bars"}


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    ws = tmp_path_factory.mktemp("conv")
    # the JAX tool's protocol flags at the smoke run's own values; the rerun
    # below passes none and must find the same stages finished
    return ws, convergence.main(["--smoke", "--workdir", str(ws), "--frames", "4",
                                 "--val_frames", "2", "--epochs", "1", "--lr", "2e-3",
                                 "--const_lr", "--extend_epochs", "1"])


def test_smoke_runs_both_arms_through_the_harness(smoke, capsys):
    ws, results = smoke
    assert [r["arm"] for r in results] == ["ref", "jax"]
    for r in results:
        assert KEYS <= set(r) and r["device"] == "cpu" and r["mode"] == "smoke"
        # 4 frames, B=2: phase 1's 2 steps, then the extension re-runs the
        # log's last epoch (0) and runs epoch 1: 4 steps
        assert r["steps"] == 6 and r["checkpoints"] == 2
        assert r["loss_first"] > 0 and r["wall_s"] > 0 and r["step_ms"] > 0
        assert r["lr_phase2"] == 2e-3  # epoch 1 is before the first milestone
    assert (ws / "arm_ref" / "output").is_dir() and (ws / "arm_jax" / "output").is_dir()
    assert sorted(p.name for p in ws.glob("sweep_*.done")) == [
        "sweep_jax.done", "sweep_phase1.done", "sweep_ref.done"]
    # the trajectory: phase 1's first checkpoint, then the arm's
    rows = convergence._sweep(str(next((ws / "phase1" / "ckpts").iterdir())))
    assert [r[0] for r in rows] == [2] and results[0]["t_first"] == rows[0][1]


def test_rerun_skips_finished_stages(smoke, capsys):
    ws, results = smoke
    capsys.readouterr()
    again = convergence.main(["--smoke", "--workdir", str(ws)])
    out = capsys.readouterr().out
    assert "+ bash" not in out and "== 1." not in out
    assert again == results
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert lines == results
