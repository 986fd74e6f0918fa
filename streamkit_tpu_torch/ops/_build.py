# SPDX-License-Identifier: Apache-2.0
"""Build and load the port's native sources (``streamkit_tpu_torch/csrc``).

Every source compiles into its own shared library with a plain C interface,
named by a hash of the source and the flags, under ``_build/`` (git-ignored):
CUDA kernels with ``nvcc`` for ``sm_90a``, the host-side ingest shim with
``g++``. A library is built at its first use and loaded with ``ctypes``;
importing this module needs neither compiler. A failed build raises: there
is no fallback. :func:`build_all` starts one compiler per source at once, so
a cold start pays for the slowest file, not the sum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable

__all__ = ["Source", "build", "build_all", "load", "BUILD_DIR", "NVCC_FLAGS", "GXX_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]
GXX_LIBS = ["-lpthread", "-ldl"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compile seconds of the builds this process ran, by source file name
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _gxx() -> str:
    path = shutil.which(os.environ.get("CXX", "g++"))
    if path is None:
        raise RuntimeError("g++ not found: the ingest shim cannot be built")
    return path


@dataclass(frozen=True)
class Source:
    """One file under ``csrc/`` and the compiler that builds it."""

    file: str
    compiler: str  # "nvcc" | "g++"

    @property
    def path(self) -> str:
        return os.path.join(CSRC, self.file)

    def _flags(self):
        return NVCC_FLAGS if self.compiler == "nvcc" else GXX_FLAGS

    def library(self) -> str:
        with open(self.path, "rb") as f:
            digest = hashlib.sha1(f.read() + " ".join(self._flags()).encode()).hexdigest()[:12]
        stem = os.path.splitext(self.file)[0]
        return os.path.join(BUILD_DIR, f"libsk_{stem}_{digest}.so")

    def command(self, out: str):
        if self.compiler == "nvcc":
            return [_nvcc(), *NVCC_FLAGS, "-o", out, self.path]
        return [_gxx(), *GXX_FLAGS, "-o", out, self.path, *GXX_LIBS]


def _start(src: Source):
    """Start the compiler for ``src`` unless its library exists → (out, tmp,
    process, t0) or None."""
    out = src.library()
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.Popen(
        src.command(tmp), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )
    return out, tmp, proc, time.monotonic()


def _finish(src: Source, job) -> None:
    out, tmp, proc, t0 = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{src.compiler} failed on {src.file} ({proc.returncode}):\n{err}")
    os.replace(tmp, out)
    build_seconds[src.file] = time.monotonic() - t0


def build(src: Source) -> str:
    """Compile ``src`` once per revision and return the library path."""
    job = _start(src)
    if job is not None:
        _finish(src, job)
    return src.library()


def build_all(sources: Iterable[Source]) -> None:
    """Compile every missing library of ``sources`` in parallel; raise on the
    first failure after all compilers have ended."""
    jobs = [(src, _start(src)) for src in sources]
    errors = []
    for src, job in jobs:
        if job is None:
            continue
        try:
            _finish(src, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(src: Source, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """Build (if needed) and load ``src`` once per process; ``declare`` sets
    the ``argtypes``/``restype`` of its functions."""
    with _lock:
        lib = _loaded.get(src.file)
        if lib is None:
            lib = ctypes.CDLL(build(src))
            declare(lib)
            _loaded[src.file] = lib
        return lib
