# SPDX-License-Identifier: Apache-2.0
"""Test-side builds of the JAX package's native libraries, so that the port's
tests compare against the JAX package on a fresh checkout too.

The JAX package loads prebuilt libraries from ``native/build/`` (``make -C
native``): its libav shim (``nodes/codecs/av.py`` ``_SHIM_PATH``) and its
WASM runtime (``plugins/wasm.py``, which reads ``SK_WASM_RT`` first). Whether
``native/build/`` exists must not decide what a port test compares, so this
module compiles the same sources with the Makefile's own ``g++`` line into a
temporary directory, once per test process, and points the JAX modules at
those builds from the test side. The example native gain plugin
(``native/plugins/gain/gain_plugin.cpp``) is built the same way: a plugin is
the user's artifact, and both packages load the one ``.so``.
"""

from __future__ import annotations

import atexit
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "native")
# native/Makefile: CXXFLAGS, and the libraries each target links
CXXFLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra"]
AV_PACKAGES = ["libavformat", "libavcodec", "libavutil", "libswresample"]
SOURCES = {
    "libskit_av.so": "shims/av_decode.cpp",
    "libskit_wasm.so": "shims/wasm_rt.cpp",
    "gain_cpp.so": "plugins/gain/gain_plugin.cpp",
}

_lock = threading.Lock()
_dir: Optional[str] = None
_built: Dict[str, Optional[str]] = {}


def _workdir() -> str:
    global _dir
    if _dir is None:
        _dir = tempfile.mkdtemp(prefix="sk-native-")
        atexit.register(shutil.rmtree, _dir, True)
    return _dir


def libav_present() -> bool:
    """g++ and pkg-config present, and pkg-config finds every libav package
    (what the port's ``av_available()`` asks of the machine)."""
    if shutil.which("g++") is None or shutil.which("pkg-config") is None:
        return False
    return subprocess.run(["pkg-config", "--exists", *AV_PACKAGES]).returncode == 0


def build(name: str) -> Optional[str]:
    """``name`` (a key of :data:`SOURCES`) built from ``native/`` into this
    process's temporary directory → its path; None for ``libskit_av.so``
    where libav is absent. A failed compile raises."""
    with _lock:
        if name in _built:
            return _built[name]
        path = None
        if name != "libskit_av.so" or libav_present():
            if shutil.which("g++") is None:
                raise RuntimeError("g++ not found: the JAX package's native libraries cannot be built")
            path = os.path.join(_workdir(), name)
            libs = []
            if name == "libskit_av.so":
                libs = subprocess.run(["pkg-config", "--libs", *AV_PACKAGES], capture_output=True, text=True,
                                      check=True).stdout.split()
            subprocess.run(["g++", *CXXFLAGS, "-o", path, os.path.join(NATIVE, SOURCES[name]), *libs],
                           check=True, capture_output=True)
        _built[name] = path
        return path


def point_jax_av(monkeypatch) -> Optional[str]:
    """Point the JAX libav node at this process's build of the shim, or at no
    file where libav is absent (then neither package registers FLAC) → the
    path or None."""
    from streamkit_tpu.nodes.codecs import av

    path = build("libskit_av.so")
    monkeypatch.setattr(av, "_SHIM_PATH", path or os.path.join(_workdir(), "absent", "libskit_av.so"))
    return path


def point_jax_wasm() -> str:
    """Have the JAX WASM host load this process's build of its runtime: set
    ``SK_WASM_RT`` before its first load. (Where it was loaded already in
    this process, it keeps that library, a build of the same source.)"""
    path = build("libskit_wasm.so")
    os.environ["SK_WASM_RT"] = path
    return path
