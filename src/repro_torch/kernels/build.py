"""Build and load the port's CUDA kernels.

Each kernel source (`kernels/<name>/csrc/*.cu`) is compiled with `nvcc`
into a shared library with a plain C interface and loaded with `ctypes`;
the headers they share (the key hash) live in `kernels/csrc/`. Builds
happen at first use, from the sources in the checkout only, into
`src/repro_torch/_build/` (git-ignored); a library's file name carries a
digest of its source and the shared headers, so an edited source or
header is rebuilt and a current one is loaded as it is. `build_all`
starts one `nvcc` per source, all at once, and waits for them together.

Importing this module builds nothing: a library is built and loaded
only when a wrapper launches its kernel on a CUDA tensor, or when
`build_all` is called.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

import torch

_PKG = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"
SOURCES: Dict[str, pathlib.Path] = {
    "bloom": _PKG / "kernels" / "bloom" / "csrc" / "bloom.cu",
    "semijoin": _PKG / "kernels" / "semijoin" / "csrc" / "semijoin.cu",
    "flashattn": _PKG / "kernels" / "flashattn" / "csrc" / "flashattn.cu",
}
#: headers every source may include (`#include "hash.cuh"`)
INCLUDE_DIR = _PKG / "kernels" / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per library: (build seconds, nvcc output incl. ptxas register counts);
#: seconds is 0.0 when a current build was found on disk (its log is read
#: from the `.log` file written beside it)
BUILD_INFO: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return nvcc


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha1(SOURCES[name].read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for `name` (None when a current build exists)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(INCLUDE_DIR), "-o", str(tmp),
           str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:           # the build's nvcc log lies beside it
        log = _target(name).with_suffix(".log")
        BUILD_INFO.setdefault(name, (0.0, log.read_text() if log.exists()
                                     else ""))
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)          # atomic: concurrent builds agree
    BUILD_INFO[name] = (time.perf_counter() - t0, log)


def build_all() -> Dict[str, Tuple[float, str]]:
    """Compile every kernel source in parallel; returns BUILD_INFO."""
    with _LOCK:
        started = {name: _start(name) for name in SOURCES}
        for name, st in started.items():
            _finish(name, st)
    return dict(BUILD_INFO)


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _LIBS[name] = lib
    return lib


class LaunchCounts(dict):
    """One kernel family's launch counts: kernel name -> launches. A
    wrapper calls `bump` where it launches its kernel. Server worker
    threads launch kernels at once, and `counts[k] += 1` is a read then
    a write with room for another thread between them, so `bump` and
    `reset` take a lock."""

    def __init__(self, *names: str):
        super().__init__((name, 0) for name in names)
        self._lock = threading.Lock()

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self[name] += n

    def reset(self) -> None:
        with self._lock:
            for name in self:
                self[name] = 0


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def check_i32(t: torch.Tensor, dev: torch.device, what: str,
              ndim: int = 1) -> None:
    """Raise unless `t` is a contiguous `ndim`-D int32 tensor on `dev`:
    what every kernel entry point takes (as uint32 or int32 words)."""
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, expected {dev}")
    if t.dtype != torch.int32 or t.dim() != ndim:
        raise ValueError(f"{what} must be a {ndim}-D int32 tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def check_bool(t: torch.Tensor, dev: torch.device, n: int,
               what: str) -> None:
    """Raise unless `t` is a contiguous 1-D bool tensor of `n` rows on
    `dev`: a per-row mask, which a kernel reads as one byte a row."""
    if (t.device != dev or t.dtype != torch.bool or t.dim() != 1
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous 1-D bool tensor "
                         f"on {dev}")
    if t.shape[0] != n:
        raise ValueError(f"{what} must cover every key row")
