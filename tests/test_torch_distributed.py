"""The port's process-group scaffolding (`parallel/distributed.py`), the
dataset sharding of `data.Loader(shard=)` and the rank-0-only logging of
`utils.config_log`, against the JAX package where it has a counterpart.

Process groups in these tests use `file://` stores in `tmp_path`, so
parallel test workers never collide on ports; the env + TCP path has one
test of its own on a free localhost port.
"""
import os
import socket

import pytest
import torch
import torch.distributed as dist

from crossloc_tpu.data import pipeline as jpipeline
from crossloc_tpu.parallel import distributed as jdistributed
from crossloc_tpu_torch import parallel
from crossloc_tpu_torch.data import Loader
from crossloc_tpu_torch.tools.parallel_check import run_ranks
from crossloc_tpu_torch.utils import config_log

_ENV = ("CROSSLOC_COORDINATOR", "CROSSLOC_NUM_PROCESSES", "CROSSLOC_PROCESS_ID", "MASTER_ADDR",
        "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


def test_nothing_set_is_a_no_op():
    assert parallel.initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert parallel.topology() == (0, 1) == parallel.local_data_shard()
    assert parallel.rank_device("cpu") == torch.device("cpu")


def test_env_initialises_once(tmp_path, monkeypatch):
    """CROSSLOC_* (a file:// coordinator here) make a gloo group for CPU
    ranks; a second call is a no-op that returns True."""
    monkeypatch.setenv("CROSSLOC_COORDINATOR", "file://" + str(tmp_path / "store"))
    monkeypatch.setenv("CROSSLOC_NUM_PROCESSES", "1")
    monkeypatch.setenv("CROSSLOC_PROCESS_ID", "0")
    assert parallel.initialize_distributed(device="cpu") is True
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert parallel.initialize_distributed(device="cpu") is True
    assert parallel.topology() == (0, 1)


def test_explicit_arguments_win_over_the_env(tmp_path, monkeypatch):
    monkeypatch.setenv("CROSSLOC_COORDINATOR", "file://" + str(tmp_path / "unused"))
    monkeypatch.setenv("CROSSLOC_NUM_PROCESSES", "7")
    monkeypatch.setenv("CROSSLOC_PROCESS_ID", "3")
    assert parallel.initialize_distributed("file://" + str(tmp_path / "store"), 1, 0,
                                           device="cpu")
    assert dist.get_world_size() == 1 and dist.get_rank() == 0


@pytest.mark.parametrize("env", [
    {"CROSSLOC_COORDINATOR": "127.0.0.1:1234"},
    {"CROSSLOC_NUM_PROCESSES": "2", "CROSSLOC_PROCESS_ID": "0"},
    {"CROSSLOC_COORDINATOR": "127.0.0.1:1234", "CROSSLOC_PROCESS_ID": "1"},
], ids=["coordinator-only", "no-coordinator", "no-count"])
def test_partial_configuration_raises_jax_error(monkeypatch, env):
    """JAX's ValueError and words, torch's variable names in place of
    JAX_*; JAX raises before it initialises anything."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError) as ref:
        jdistributed.initialize_distributed()
    with pytest.raises(ValueError) as port:
        parallel.initialize_distributed(device="cpu")
    expect = (str(ref.value).replace("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR:MASTER_PORT")
              .replace("JAX_NUM_PROCESSES", "WORLD_SIZE").replace("JAX_PROCESS_ID", "RANK"))
    assert str(port.value) == expect
    assert "incomplete multi-host configuration" in expect
    assert not dist.is_initialized()


def test_backend_follows_the_topology():
    """nccl for cuda ranks with a card each, gloo for CPU ranks and for cuda
    ranks that outnumber the host's cards."""
    assert parallel.choose_backend("cpu", 2, 0) == "gloo"
    assert parallel.choose_backend("cpu", 1, 8) == "gloo"
    assert parallel.choose_backend("cuda", 1, 1) == "nccl"
    assert parallel.choose_backend("cuda", 4, 4) == "nccl"
    assert parallel.choose_backend("cuda", 2, 1) == "gloo"
    assert parallel.init_method_of("10.0.0.1:29500") == "tcp://10.0.0.1:29500"
    assert parallel.init_method_of("file:///tmp/s") == "file:///tmp/s"


def test_cuda_request_without_cuda_raises_before_init(tmp_path):
    """A cuda rank never moves to the CPU: without CUDA it raises."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        parallel.initialize_distributed("file://" + str(tmp_path / "s"), 1, 0, device="cuda")
    assert not dist.is_initialized()


def _sum_ranks(out_dir: str) -> None:
    rank, world = parallel.topology()
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write(f"{world} {dist.get_backend()} {t.item()}")


def _env_rank(rank: int, port: int, out_dir: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                      RANK=str(rank))
    torch.set_num_threads(1)
    assert parallel.initialize_distributed(device="cpu")
    try:
        _sum_ranks(out_dir)
    finally:
        dist.destroy_process_group()


def test_torch_env_over_tcp(tmp_path):
    """MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, as torchrun sets them:
    two processes meet over TCP on localhost and all-reduce."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    torch.multiprocessing.start_processes(_env_rank, args=(port, str(tmp_path)), nprocs=2,
                                          start_method="spawn")
    for r in range(2):
        assert (tmp_path / f"rank{r}.txt").read_text() == "2 gloo 3.0"


def test_file_store_ranks(tmp_path):
    run_ranks(_sum_ranks, 2, (str(tmp_path),), timeout=60, threads=1)
    assert (tmp_path / "rank1.txt").read_text() == "2 gloo 3.0"


class _DS:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n, world, bs, drop_last", [
    (10, 3, 2, False), (10, 3, 2, True), (16, 2, 8, True), (17, 4, 3, False), (5, 2, 4, True)])
def test_loader_shards_follow_jax_minimum_shard_rule(n, world, bs, drop_last):
    """Every rank reads idx[rank::world] cut to len // world: the same batch
    count and sizes on every rank, and the JAX loader's very indices."""
    counts = set()
    for rank in range(world):
        ours = Loader(_DS(n), bs, shuffle=True, drop_last=drop_last, shard=(rank, world))
        ref = jpipeline.Loader(_DS(n), bs, shuffle=True, drop_last=drop_last,
                               shard=(rank, world))
        for epoch in (0, 3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = ours.index_batches(), list(ref._index_batches())
            assert [list(b) for b in got] == [list(b) for b in want]
            counts.add(tuple(len(b) for b in got))
    assert len(counts) == 1


def test_config_log_of_other_ranks_writes_nothing(tmp_path, monkeypatch):
    """file_logging=False: stdout logging only; no output folder, no log."""
    from types import SimpleNamespace

    monkeypatch.chdir(tmp_path)
    opt = SimpleNamespace(ckpt_dir="", auto_resume=False, epoch_plus=False, network_in=None)
    out, ckpt = config_log(opt, str(tmp_path / "output" / "run"), file_logging=False)
    assert out == ckpt == str(tmp_path / "output" / "run")
    assert not (tmp_path / "output").exists()
    out, _ = config_log(opt, str(tmp_path / "output" / "run"))
    assert (tmp_path / "output" / "run" / "output.log").exists()
    import logging

    for h in list(logging.getLogger().handlers):
        logging.getLogger().removeHandler(h)
        h.close()
