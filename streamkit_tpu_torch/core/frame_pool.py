# SPDX-License-Identifier: Apache-2.0
"""Bucketed sample-buffer pool amortizing hot-path allocations.

Parity with reference ``crates/core/src/frame_pool.rs`` (``FramePool<T>`` /
``PooledSamples``): decoders and resamplers acquire float32 buffers from
size-bucketed freelists instead of allocating per packet; AudioFrame.release()
returns them.
"""

from __future__ import annotations

import threading
from typing import Dict, List

import numpy as np

from .types import AudioFormat, AudioFrame

__all__ = ["AudioFramePool"]

# Default buckets cover common Opus/mixer frame sizes (mono..stereo, 20ms-60ms).
_DEFAULT_BUCKETS = (120, 240, 480, 960, 1920, 2880, 5760, 11520, 23040, 46080)


class AudioFramePool:
    """Thread-safe bucketed pool of float32 buffers."""

    def __init__(self, buckets=_DEFAULT_BUCKETS, max_per_bucket: int = 64) -> None:
        self._buckets = tuple(sorted(buckets))
        self._max_per_bucket = max_per_bucket
        self._free: Dict[int, List[np.ndarray]] = {b: [] for b in self._buckets}
        self._lock = threading.Lock()
        self.acquired = 0
        self.pooled_hits = 0

    def _bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return n  # oversized: exact allocation, not pooled on return

    def acquire(self, num_samples: int) -> np.ndarray:
        """Get a zeroed float32 buffer of exactly ``num_samples``.

        Buffers from a larger bucket are sliced; the backing array is returned
        to the pool on release.
        """
        self.acquired += 1
        bucket = self._bucket_for(num_samples)
        with self._lock:
            freelist = self._free.get(bucket)
            if freelist:
                buf = freelist.pop()
                self.pooled_hits += 1
                buf[:num_samples] = 0.0
                return buf[:num_samples]
        return np.zeros(bucket, dtype=np.float32)[:num_samples]

    def acquire_frame(self, num_samples: int, fmt: AudioFormat) -> AudioFrame:
        return AudioFrame(self.acquire(num_samples), fmt, _pool=self)

    def _return_buffer(self, buf: np.ndarray) -> None:
        base = buf.base if buf.base is not None else buf
        n = base.shape[0]
        if n not in self._free:
            return
        with self._lock:
            freelist = self._free[n]
            if len(freelist) < self._max_per_bucket:
                freelist.append(base)

    def stats(self) -> dict:
        with self._lock:
            return {
                "acquired": self.acquired,
                "pooled_hits": self.pooled_hits,
                "free": {b: len(v) for b, v in self._free.items() if v},
            }
