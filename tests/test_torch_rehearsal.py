"""The port's dress rehearsal (`crossloc_tpu_torch/examples/dress_rehearsal.sh`)
on the CPU: the whole experiment matrix through the unchanged bash harness
(pretraining of four tasks, validation and selection, the encoder finetune,
the four-tower decoder finetune and its validation, then the e2e,
kill-and-resume and out-of-place arms) on the port's shims. Slow, as the JAX
package's rehearsal is."""
import os
import pathlib
import subprocess

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.slow
def test_dress_rehearsal_twin_passes_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run(["bash", str(REPO / "crossloc_tpu_torch" / "examples" /
                                      "dress_rehearsal.sh"), str(tmp_path / "ws"), "cpu"],
                         env=env, capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    assert "== dress rehearsal PASSED" in out.stdout
    ws = tmp_path / "ws"
    log = (ws / "output" / "urbanscape-coord-sresume_arm-no_unc-e40-lr0.0002-sim_only-sc1.00-tiny"
           / "output.log").read_text()
    assert "Restored full train state" in log
    assert list(ws.glob("ckpts/urbanscape-coord-decoder_*/FLAG_SELECTED_ITER_*.nodata"))
