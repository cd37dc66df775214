"""The port's native image decoder: `loader.cpp` behind a ctypes C ABI
(counterpart of `crossloc_tpu/native/__init__.py`, same functions and
signatures, `None` on any failure), and `load_image_bytes`, which hands out
the decoded uint8 bytes of a frame that needs no resize: the data layer's
batches (`CamLocDataset.collate`) take them as they are.

`loader.cpp` becomes `build/libclloader-<hash>.so` inside the package
(git-ignored), compiled with g++ at first use: nothing is compiled when the
module is imported. It decodes PNG on zlib alone; JPEG goes through libjpeg
when g++ finds `jpeglib.h` (`-DCL_WITH_JPEG -ljpeg`), else a JPEG file
returns None and the data layer decodes it with PIL (`jpeg()` says which).
The hash covers the source, the compiler flags and the libraries, so an
edited source is rebuilt and a stale library is never loaded. The flags
carry no `-march=native`: the name does not cover the host's CPU, so a
library must run on any x86-64 host that finds it. A failed build is
remembered (`build_error()`), never raised: `available()` is then False and
the data layer decodes with PIL.

`ctypes.CDLL` releases the interpreter lock for the length of each call, so
the Loader's decode threads run in parallel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "native" / "loader.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared")
JPEG_FLAGS = ("-DCL_WITH_JPEG",)
MAX_PIXELS = 1 << 28  # loader.cpp's kMaxPixels: a larger image or target gives None

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_jpeg: Optional[bool] = None
build_seconds: Optional[float] = None  # of this process's build; None if it found one


def jpeg() -> bool:
    """Whether the build takes libjpeg: g++ finds `jpeglib.h` (probed once)."""
    global _jpeg
    if _jpeg is None:
        cxx = shutil.which("g++")
        _jpeg = cxx is not None and subprocess.run(
            [cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
            input="#include <cstdio>\n#include <jpeglib.h>\n", capture_output=True,
            text=True).returncode == 0
    return _jpeg


def _flags() -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(compiler flags, libraries) of this host's build."""
    if jpeg():
        return CXX_FLAGS + JPEG_FLAGS, ("-ljpeg", "-lz")
    return CXX_FLAGS, ("-lz",)


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    flags, libs = _flags()
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags + libs).encode())
    return BUILD_DIR / f"libclloader-{h.hexdigest()[:16]}.so"


def _build(so: Path, quiet: bool) -> None:
    """Compile to a temp file, then move it in place: a concurrent process
    never loads a partial library. Raises with the compiler's output."""
    global build_seconds
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    flags, libs = _flags()
    cmd = [cxx, *flags, "-o", str(tmp), str(SOURCE), *libs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if not quiet:
        print(" ".join(cmd) + "\n" + proc.stdout, flush=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(proc.stdout.strip() or f"g++ exited with {proc.returncode}")
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0


def _load(quiet: bool = True) -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None after a failed build."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so, quiet)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError) as e:
            _error = str(e)
            return None
        lib.cl_image_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.cl_image_dims.restype = ctypes.c_int
        lib.cl_load_image.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_float)]
        lib.cl_load_image.restype = ctypes.c_int
        lib.cl_load_image_u8.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                         ctypes.POINTER(ctypes.c_uint8)]
        lib.cl_load_image_u8.restype = ctypes.c_int
        _lib = lib
    return _lib


def ensure_built(quiet: bool = True) -> bool:
    """Build the library if missing (`quiet=False` prints the compiler's
    command and output); returns availability."""
    return _load(quiet) is not None


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """The compiler's (or the loader's) message of a failed build, else None."""
    return _error


def image_dims(path: str) -> Optional[Tuple[int, int]]:
    """(h, w) of the stored image from its header, or None."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.cl_image_dims(os.fsencode(path), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def load_image(path: str, target_h: int, target_w: int) -> Optional[np.ndarray]:
    """Decode and resize to [target_h, target_w, 3] float32 in [0, 1], or None."""
    lib = _load()
    if lib is None or target_h <= 0 or target_w <= 0 or target_h * target_w > MAX_PIXELS:
        return None
    out = np.empty((target_h, target_w, 3), dtype=np.float32)
    rc = lib.cl_load_image(os.fsencode(path), target_h, target_w,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def load_image_bytes(path: str, h: int, w: int) -> Optional[np.ndarray]:
    """Decode to [h, w, 3] uint8, the decoded bytes as they are (the
    numerators of `load_image`'s byte / 255 without a resize), or None;
    None too where the stored size is not (h, w): this entry never
    resizes."""
    lib = _load()
    if lib is None or h <= 0 or w <= 0 or h * w > MAX_PIXELS:
        return None
    out = np.empty((h, w, 3), dtype=np.uint8)
    rc = lib.cl_load_image_u8(os.fsencode(path), h, w,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def load_image_std_height(path: str, image_height: int) -> Optional[np.ndarray]:
    """Decode and resize to `image_height` rows, keeping the aspect ratio
    (width round(w * image_height / h)), or None."""
    dims = image_dims(path)
    if dims is None:
        return None
    h, w = dims
    return load_image(path, image_height, int(round(w * image_height / h)))
