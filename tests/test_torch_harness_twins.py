"""Twin workspaces for the unchanged bash harness: one runs the JAX package's
root shims, the other the port's `crossloc_tpu_torch/harness/` shims, on the
same frames and donors. The scripts run in subprocesses (the port with
`--device cpu` through EXTRA_ARGS); the two packages' runs go side by side.
Helpers compare what the two wrote: folder names, file sets, log and results
lines with the floats, timestamps and the workspace path masked, and `.net`
key sets. `tests/test_torch_harness_{encoder,decoder}_arms.py` use them; the
test below holds the masking itself."""
import os
import pathlib
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from crossloc_tpu_torch import compat, data, models

REPO = pathlib.Path(__file__).resolve().parent.parent
HARNESS = REPO / "crossloc_tpu_torch" / "harness"
TRAINING = REPO / "script_clean_training"
VALIDATION = REPO / "script_clean_validation"
SHIMS = ("train_single_task.py", "finetune_decoder_single_task.py", "test_single_task.py")
PACKAGES = ("jax", "port")
IMG_H, IMG_W = 32, 48


class Workspace:
    """One package's working directory: frames, shims, environment."""

    def __init__(self, root: pathlib.Path, package: str, sections):
        self.root, self.package = root, package
        for seed, section in enumerate(sections):
            data.write_fake_dataset(str(root / "datasets" / "urbanscape" / section), n=2,
                                    img_h=IMG_H, img_w=IMG_W, focal=40.0, seed=seed,
                                    scene="plane")
        for shim in SHIMS:
            os.symlink((REPO if package == "jax" else HARNESS) / shim, root / shim)
        device = "" if package == "jax" else " --device cpu"
        self.common = (f"--batch_size 2 --datasets_dir {root / 'datasets'} --image_height {IMG_H}"
                       + device)
        env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
        # two threads a process: the suite's other workers share the CPU
        env.update(CKPT_DIR=str(root / "ckpts"), OMP_NUM_THREADS="2",
                   EXTRA_ARGS=f"--epochs 1 {self.common}")
        if package == "jax":
            # the root shims import the JAX package from the repository; its
            # compilation cache stays in the workspace
            env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
                       CROSSLOC_COMPILATION_CACHE=str(root / "xla_cache"))
        self.env = env  # the port's shims find the repository themselves
        self.selector = (VALIDATION if package == "jax" else HARNESS) / "select_ckpt.py"

    def run(self, cmd, cwd=None, **extra_env) -> str:
        out = subprocess.run([str(c) for c in cmd], cwd=cwd or self.root,
                             env=dict(self.env, **extra_env), capture_output=True, text=True,
                             timeout=600)
        assert out.returncode == 0, (self.package, cmd, out.stdout[-3000:] + out.stderr[-3000:])
        return out.stdout

    def script(self, path, *args, **extra_env) -> str:
        return self.run(["bash", path, *args], **extra_env)

    def validate(self, script, folder: str) -> str:
        """`script` over the checkpoints of ckpts/<folder>, then the package's
        `select_ckpt.py --task coord` there; the two stdouts."""
        ckpts = self.root / "ckpts" / folder
        out = self.script(VALIDATION / script, "urbanscape", "coord", "TINY", "MLE", "0",
                          CKPT_DIR=str(ckpts), MIN_CKPT_ITER="0", EXTRA_ARGS=self.common)
        return out + self.run(["python3", self.selector, "--task", "coord"], cwd=ckpts)


def twins(tmp: pathlib.Path, sections) -> dict:
    """{"jax": Workspace, "port": Workspace} under `tmp`."""
    out = {}
    for pkg in PACKAGES:
        (tmp / pkg).mkdir()
        out[pkg] = Workspace(tmp / pkg, pkg, sections)
    return out


def seeded_donor(path: pathlib.Path, task: str, seed: int) -> str:
    """A tiny `task` net with seeded weights saved as a reference `.net`."""
    path.parent.mkdir(parents=True, exist_ok=True)
    net = models.init_weights(models.build_network(task, "MLE", tiny=True),
                              torch.Generator().manual_seed(seed))
    compat.save_net(str(path), net)
    return str(path)


def run_side_by_side(jobs: dict) -> dict:
    """{key: callable}: every job at once (each one chain of subprocesses);
    {key: its result}."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


_STAMP = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d", re.M)
_FLOAT = re.compile(r"-?\d+\.\d+(e[-+]?\d+)?")


def mask(text: str, ws: Workspace) -> list:
    """The lines of `text` with the workspace path, timestamps, floats, the
    git hash, the argument namespace (the port adds --device) and the
    device's name masked; integers (iterations, epochs, counts) stay."""
    text = text.replace(str(ws.root), "<ws>")
    text = _STAMP.sub("<time>", text)
    text = re.sub(r"git head hash code: \S+", "git head hash code: <sha>", text)
    text = re.sub(r"Namespace\(.*\)", "Namespace(<args>)", text)
    text = re.sub(r"Selected device \S+ via", "Selected device <dev> via", text)
    return _FLOAT.sub("<f>", text).splitlines()


def tree(ws: Workspace) -> dict:
    """{output/<name> or ckpts/<name>: sorted file names} of the workspace."""
    return {f"{sub}/{d.name}": sorted(p.name for p in d.iterdir())
            for sub in ("output", "ckpts") if (ws.root / sub).is_dir()
            for d in sorted((ws.root / sub).iterdir())}


def same_text_files(ws: dict, rel_dir: str, pattern: str) -> list:
    """The masked lines of each file matching `pattern` in `rel_dir`, the two
    packages' side by side; asserts they are equal and returns the names."""
    names = sorted(p.name for p in (ws["jax"].root / rel_dir).glob(pattern))
    assert names == sorted(p.name for p in (ws["port"].root / rel_dir).glob(pattern))
    for name in names:
        jax_lines, port_lines = (mask((ws[p].root / rel_dir / name).read_text(), ws[p])
                                 for p in PACKAGES)
        assert port_lines == jax_lines, f"{rel_dir}/{name}"
    return names


def same_net_keys(ws: dict, rel_dir: str) -> list:
    """Every `.net` in `rel_dir` holds the same keys and shapes in both
    packages' runs (each read through the port's `compat`)."""
    names = sorted(p.name for p in (ws["port"].root / rel_dir).glob("*.net"))
    for name in names:
        jax_net, port_net = (compat.load_net(str(ws[p].root / rel_dir / name)) for p in PACKAGES)
        assert {k: tuple(v.shape) for k, v in port_net.items()} == {
            k: tuple(v.shape) for k, v in jax_net.items()}, f"{rel_dir}/{name}"
    return names


def test_mask_hides_what_differs_between_runs_and_keeps_the_counts(tmp_path):
    """Floats, timestamps, the workspace path, the git hash, the argument
    namespace and the device's name are masked; iterations, epochs and
    other integers are compared as they are."""
    ws = Workspace.__new__(Workspace)
    ws.root = tmp_path
    text = (f"2026-01-02 03:04:05, INFO: Iteration:      12, Epoch:   0, Total loss: 35.17, "
            f"Avg Time: 0.094s\nSaving to {tmp_path}/output/x-lr0.0001\n"
            "Current git head hash code: abc123\nNamespace(a=1, device='cpu')\n"
            "Selected device TFRT_CPU_0 via CROSSLOC_DEVICE_ORDINAL\nMedian Error: 1.5e-3 deg")
    assert mask(text, ws) == [
        "<time>, INFO: Iteration:      12, Epoch:   0, Total loss: <f>, Avg Time: <f>s",
        "Saving to <ws>/output/x-lr<f>", "Current git head hash code: <sha>", "Namespace(<args>)",
        "Selected device <dev> via CROSSLOC_DEVICE_ORDINAL", "Median Error: <f> deg"]
