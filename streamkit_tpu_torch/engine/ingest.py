# SPDX-License-Identifier: Apache-2.0
"""ctypes binding for the native session-ingestion shim.

Port of ``streamkit_tpu/engine/ingest.py``. :class:`IngestPool` keeps
per-session PCM accumulators and VAD-block assembly in C++
(``streamkit_tpu_torch/csrc/ingest.cpp``), so the serving loop does one
coalesced :meth:`~IngestPool.drain` per tick instead of per-packet asyncio
work per session. Transports push decoded PCM with :meth:`~IngestPool.push`;
load tests and benchmarks use :meth:`~IngestPool.start_replay`, which paces
a preloaded buffer from a C++ thread, or
:meth:`~IngestPool.start_replay_opus`, which decodes pre-encoded Opus
packets there (libopus through ``dlopen``). The same library holds the
Opus decoder node's batched decode (``skopus_batch_*``).

The shim is built from the port's own source with ``g++`` into ``_build/``
at first use (:mod:`..ops._build`); a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from typing import Optional, Tuple

import numpy as np

from ..ops import _build

__all__ = ["IngestPool", "SOURCE", "ingest_available"]

SOURCE = _build.Source("ingest.cpp", "g++")

_F32P = ctypes.POINTER(ctypes.c_float)


def _declare(lib) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sigs = {
        "skingest_create": (vp, [i, i, i]),
        "skingest_destroy": (None, [vp]),
        "skingest_open": (i, [vp]),
        "skingest_close": (None, [vp, i]),
        "skingest_push": (i, [vp, i, _F32P, ll]),
        "skingest_start_replay": (i, [vp, i, _F32P, ll, i, ll, ll, i]),
        "skingest_replay_start_ns": (ll, [vp, i]),
        "skingest_drain": (i, [vp, i, ll, ctypes.POINTER(i), ctypes.POINTER(ll), _F32P]),
        "skingest_pending": (i, [vp]),
        "skingest_active": (i, [vp]),
        "skingest_dropped": (ll, [vp]),
        "skingest_start_replay_opus": (i, [vp, i, ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int32),
                                           i, i, i, ll, ll, i]),
        "skopus_batch_create": (vp, [i, i]),
        "skopus_batch_destroy": (None, [vp]),
        "skopus_batch_decode": (i, [vp, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), i, _F32P, i,
                                    ctypes.POINTER(ctypes.c_int32)]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def ingest_available() -> bool:
    """Whether :class:`IngestPool` can load here: the shim is built for this
    revision of ``csrc/ingest.cpp``, or the compiler that builds it is on
    the path. (The reference checks for its prebuilt ``native/build``
    library; the port builds its own at first use.)"""
    return os.path.exists(SOURCE.library()) or shutil.which(os.environ.get("CXX", "g++")) is not None


class IngestPool:
    """Native multi-session PCM block assembler (see module docstring)."""

    def __init__(self, max_sessions: int, block_samples: int, queue_cap: int = 4096):
        self._lib = _build.load(SOURCE, _declare)
        self.block_samples = int(block_samples)
        self.max_sessions = int(max_sessions)
        self._pool = self._lib.skingest_create(max_sessions, block_samples, queue_cap)
        if not self._pool:
            raise RuntimeError("skingest_create failed")
        # reusable drain buffers (one drain in flight at a time)
        self._cap = max_sessions * 4
        self._ids = np.empty(self._cap, np.int32)
        self._arr = np.empty(self._cap, np.int64)
        self._blocks = np.empty((self._cap, block_samples), np.float32)

    def close(self) -> None:
        if self._pool:
            self._lib.skingest_destroy(self._pool)
            self._pool = None

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:
            pass

    # -- sessions -----------------------------------------------------------
    def open(self) -> int:
        sid = self._lib.skingest_open(self._pool)
        if sid < 0:
            raise RuntimeError("ingest pool full")
        return sid

    def close_session(self, sid: int) -> None:
        self._lib.skingest_close(self._pool, sid)

    def push(self, sid: int, pcm: np.ndarray) -> None:
        """Append PCM; raises when the session is closed or a paced replay
        is feeding it (mixing the two would reorder its audio)."""
        pcm = np.ascontiguousarray(pcm, np.float32)
        if self._lib.skingest_push(self._pool, sid, pcm.ctypes.data_as(_F32P), pcm.size) != 0:
            raise RuntimeError(f"push refused on session {sid}: closed or replaying")

    def start_replay(
        self,
        sid: int,
        audio: np.ndarray,
        frame_samples: int = 320,
        frame_us: int = 20_000,
        start_delay_us: int = 0,
        close_at_end: bool = True,
    ) -> None:
        """Pace ``audio`` into the session from a C++ thread: one
        ``frame_samples`` push every ``frame_us`` (20 ms @16 kHz default)."""
        audio = np.ascontiguousarray(audio, np.float32)
        rc = self._lib.skingest_start_replay(
            self._pool, sid, audio.ctypes.data_as(_F32P), audio.size,
            frame_samples, frame_us, start_delay_us, 1 if close_at_end else 0,
        )
        if rc != 0:
            raise RuntimeError(f"replay refused on session {sid}: closed or already replaying")

    def start_replay_opus(
        self,
        sid: int,
        packets: list,
        sample_rate: int = 16_000,
        channels: int = 1,
        frame_us: int = 20_000,
        start_delay_us: int = 0,
        close_at_end: bool = True,
    ) -> None:
        """Replay pre-encoded Opus ``packets`` (list of bytes): a C++ thread
        decodes each natively straight to ``sample_rate`` (libopus resamples
        internally — the compiler's fused native-rate decode) and pushes the
        PCM every ``frame_us`` (0 = full speed, for throughput benches). The
        entire ingress chain — pacing, entropy decode, block assembly — runs
        off the Python thread."""
        data = np.ascontiguousarray(np.frombuffer(b"".join(packets), np.uint8))
        offs = np.zeros(len(packets) + 1, np.int32)
        np.cumsum([len(p) for p in packets], out=offs[1:])
        rc = self._lib.skingest_start_replay_opus(
            self._pool, sid,
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(packets), sample_rate, channels,
            frame_us, start_delay_us, 1 if close_at_end else 0,
        )
        if rc == -2:
            raise RuntimeError("libopus unavailable for opus replay")
        if rc != 0:
            raise RuntimeError(f"replay refused on session {sid}: closed or already replaying")

    def replay_start_ns(self, sid: int) -> int:
        return int(self._lib.skingest_replay_start_ns(self._pool, sid))

    # -- draining -----------------------------------------------------------
    def drain(self, max_blocks: Optional[int] = None, timeout_us: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(session_ids [n], arrival_ns [n], blocks [n, block_samples])`` of
        every completed block, oldest first. ``timeout_us`` > 0 waits in C
        (the GIL released) for a block: call it from an executor thread."""
        cap = min(max_blocks or self._cap, self._cap)
        n = self._lib.skingest_drain(
            self._pool, cap, timeout_us,
            self._ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            self._arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            self._blocks.ctypes.data_as(_F32P),
        )
        return self._ids[:n].copy(), self._arr[:n].copy(), self._blocks[:n].copy()

    # -- stats --------------------------------------------------------------
    def pending(self) -> int:
        return self._lib.skingest_pending(self._pool)

    def active(self) -> int:
        return self._lib.skingest_active(self._pool)

    def dropped(self) -> int:
        return int(self._lib.skingest_dropped(self._pool))
