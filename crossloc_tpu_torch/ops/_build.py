"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/lib<name>-<hash>.so` inside the package
(git-ignored), compiled for `sm_90a` at first use. The hash covers the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded. Nothing is compiled when a module is imported: the first call
of `library(name)` builds, later calls reuse the loaded library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
ptxas_report: Dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at first use on a "
                       "machine with the CUDA toolkit (set NVCC or put nvcc on PATH)")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    src, so = _target(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, so, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    build_seconds[name] = time.perf_counter() - t0
    ptxas_report[name] = out


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _loaded[name] = lib
    return lib


def all_sources() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
