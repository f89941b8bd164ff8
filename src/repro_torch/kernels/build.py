"""Build and load the port's CUDA kernels.

Each kernel source (`kernels/<name>/csrc/*.cu`) is compiled with `nvcc`
into a shared library with a plain C interface and loaded with `ctypes`.
Builds happen at first use, from the sources in the checkout only, into
`src/repro_torch/_build/` (git-ignored); a library's file name carries a
digest of its source, so an edited source is rebuilt and a current one
is loaded as it is. `build_all` starts one `nvcc` per source, all at
once, and waits for them together.

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

_PKG = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG / "_build"
SOURCES: Dict[str, pathlib.Path] = {
    "bloom": _PKG / "kernels" / "bloom" / "csrc" / "bloom.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per library: (build seconds, nvcc output incl. ptxas register counts);
#: seconds is 0.0 when a current build was found on disk
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
    digest = hashlib.sha1(SOURCES[name].read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for `name` (None when a current build exists)."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        BUILD_INFO.setdefault(name, (0.0, ""))
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
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


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
