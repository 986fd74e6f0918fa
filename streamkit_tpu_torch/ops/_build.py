# SPDX-License-Identifier: Apache-2.0
"""Build and load the port's native sources (``streamkit_tpu_torch/csrc``).

Every source compiles into its own shared library with a plain C interface,
named by a hash of the source, every local header it includes (``#include
"x.cuh"``, recursively) and the flags, under ``_build/`` (git-ignored):
CUDA kernels with ``nvcc`` for ``sm_90a``, the host-side shims (ingest,
libav decode) with ``g++``, linked against the system libraries
``pkg-config`` names. A library is built at its first use and loaded with ``ctypes``;
importing this module needs neither compiler. A failed build raises: there
is no fallback. :func:`build_all` starts one compiler per source at once, so
a cold start pays for the slowest file, not the sum.

``nvcc`` runs with ``-Xptxas -v``: its report (registers, shared memory,
spills per kernel) is kept beside the library as ``<library>.log``, so a
reused build still has it (:func:`report`, :func:`ptxas_summary`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Tuple

__all__ = ["Source", "build", "build_all", "load", "report", "ptxas_summary", "BUILD_DIR", "NVCC_FLAGS",
           "GXX_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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
        raise RuntimeError("g++ not found: the host shims cannot be built")
    return path


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


@dataclass(frozen=True)
class Source:
    """One file under ``csrc/`` and the compiler that builds it."""

    file: str
    compiler: str  # "nvcc" | "g++"
    # system libraries to compile and link against (``pkg-config`` names)
    pkg_config: Tuple[str, ...] = ()

    @property
    def path(self) -> str:
        return os.path.join(CSRC, self.file)

    def _flags(self) -> List[str]:
        return NVCC_FLAGS if self.compiler == "nvcc" else GXX_FLAGS

    def headers(self) -> List[str]:
        """The local headers this source includes, directly or through
        another local header, as paths under ``csrc/`` (sorted)."""
        seen, todo = set(), [self.path]
        while todo:
            with open(todo.pop(), encoding="utf-8") as f:
                text = f.read()
            for name in _INCLUDE.findall(text):
                path = os.path.join(CSRC, name)
                if path not in seen and os.path.exists(path):
                    seen.add(path)
                    todo.append(path)
        return sorted(seen)

    def library(self) -> str:
        h = hashlib.sha1()
        for path in [self.path, *self.headers()]:
            with open(path, "rb") as f:
                h.update(os.path.relpath(path, CSRC).encode() + b"\0" + f.read() + b"\0")
        h.update("\0".join(self._flags() + list(self.pkg_config)).encode())
        stem = os.path.splitext(self.file)[0]
        return os.path.join(BUILD_DIR, f"libsk_{stem}_{h.hexdigest()[:12]}.so")

    def command(self, out: str) -> List[str]:
        if self.compiler == "nvcc":
            return [_nvcc(), *self._flags(), "-o", out, self.path]
        return [_gxx(), *self._flags(), "-o", out, self.path, *GXX_LIBS, *_pkg_flags(self.pkg_config)]


def _pkg_flags(packages: Tuple[str, ...]) -> List[str]:
    """``pkg-config --cflags --libs`` of ``packages``; raises when
    ``pkg-config`` or one of them is missing."""
    if not packages:
        return []
    exe = shutil.which("pkg-config")
    if exe is None:
        raise RuntimeError(f"pkg-config not found: cannot link {', '.join(packages)}")
    proc = subprocess.run([exe, "--cflags", "--libs", *packages], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"pkg-config {' '.join(packages)} failed: {proc.stderr.strip()}")
    return proc.stdout.split()


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
    with open(f"{tmp}.log", "w", encoding="utf-8") as f:
        f.write(err)
    os.replace(f"{tmp}.log", f"{out}.log")
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


def report(src: Source) -> str:
    """The compiler's messages from building ``src``'s current library
    (for nvcc, the ``ptxas`` report); empty if it is not built."""
    path = f"{src.library()}.log"
    if not os.path.exists(path):
        return ""
    with open(path, encoding="utf-8") as f:
        return f.read()


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_summary(text: str) -> List[dict]:
    """Per kernel of a ``ptxas -v`` report: its (mangled) name, registers a
    thread, static shared memory, stack frame and spill bytes. Warnings
    (``ptxas warning``, e.g. wgmma serialisation) go to the kernel they
    follow."""
    out: List[dict] = []
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            out.append({"kernel": m.group(1), "registers": None, "smem": 0, "stack": 0, "spill_stores": 0,
                        "spill_loads": 0, "warnings": []})
            continue
        if not out:
            continue
        cur = out[-1]
        m = _PTXAS_FRAME.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (int(x) for x in m.groups())
        m = _PTXAS_USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = _PTXAS_SMEM.search(line)
            cur["smem"] = int(sm.group(1)) if sm else 0
        if "ptxas warning" in line or "Potential Performance Loss" in line:
            cur["warnings"].append(line.strip())
    return out
