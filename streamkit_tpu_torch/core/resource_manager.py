# SPDX-License-Identifier: Apache-2.0
"""Content-addressed cache of shared heavy resources (ML weights, compiled fns).

Parity with reference ``crates/core/src/resource_manager.rs:73-300``:

* :class:`ResourceKey` — (kind, params_hash) content address,
* ``get_or_create`` with per-key single-flight (double-checked insert),
* policy ``{keep_loaded, max_memory_mb}`` with LRU eviction,
* ``stats()``, ``unload()``, ``clear()``.

The cached value is typically a model (its weights on the card) with its
config and tokenizer. Eviction deletes the host reference; PyTorch frees the
device memory when the last reference drops.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Dict, Optional

__all__ = ["ResourceKey", "ResourcePolicy", "ResourceManager"]


@dataclass(frozen=True)
class ResourceKey:
    kind: str
    params_hash: str

    @staticmethod
    def from_params(kind: str, params: Optional[dict]) -> "ResourceKey":
        blob = json.dumps(params or {}, sort_keys=True, default=str).encode()
        return ResourceKey(kind, hashlib.sha256(blob).hexdigest()[:16])


@dataclass
class ResourcePolicy:
    keep_loaded: bool = True
    max_memory_mb: int = 0  # 0 = unlimited


@dataclass
class _Entry:
    value: Any
    size_mb: float
    created_at: float
    last_used: float
    refcount: int = 0


class ResourceManager:
    """Async shared-resource cache with single-flight loading and LRU eviction."""

    def __init__(self, policy: ResourcePolicy = ResourcePolicy()) -> None:
        self.policy = policy
        self._entries: Dict[ResourceKey, _Entry] = {}
        self._inflight: Dict[ResourceKey, asyncio.Future] = {}
        self._lock = asyncio.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    async def get_or_create(
        self,
        key: ResourceKey,
        loader: Callable[[], Awaitable[Any]],
        size_mb: float = 0.0,
    ) -> Any:
        """Return the cached resource, loading it exactly once per key."""
        while True:
            async with self._lock:
                entry = self._entries.get(key)
                if entry is not None:
                    entry.last_used = time.monotonic()
                    entry.refcount += 1
                    self.hits += 1
                    return entry.value
                fut = self._inflight.get(key)
                if fut is None:
                    fut = asyncio.get_running_loop().create_future()
                    self._inflight[key] = fut
                    owner = True
                else:
                    owner = False
            if not owner:
                await asyncio.shield(asyncio.wait([fut]))
                continue  # re-check cache (loader may have failed)
            try:
                self.misses += 1
                value = await loader()
            except Exception as e:
                async with self._lock:
                    self._inflight.pop(key, None)
                if not fut.done():
                    fut.set_exception(e)
                    fut.exception()  # mark retrieved
                raise
            async with self._lock:
                now = time.monotonic()
                self._entries[key] = _Entry(value, size_mb, now, now, refcount=1)
                self._inflight.pop(key, None)
                await self._maybe_evict_locked()
            if not fut.done():
                fut.set_result(None)
            return value

    def release(self, key: ResourceKey) -> None:
        entry = self._entries.get(key)
        if entry is not None and entry.refcount > 0:
            entry.refcount -= 1

    async def _maybe_evict_locked(self) -> None:
        """4-phase LRU eviction mirroring reference ``resource_manager.rs:236-300``:
        evict unreferenced LRU entries until under the memory cap."""
        if self.policy.max_memory_mb <= 0:
            return
        total = sum(e.size_mb for e in self._entries.values())
        if total <= self.policy.max_memory_mb:
            return
        victims = sorted(
            (k for k, e in self._entries.items() if e.refcount == 0),
            key=lambda k: self._entries[k].last_used,
        )
        for k in victims:
            total -= self._entries[k].size_mb
            del self._entries[k]
            self.evictions += 1
            if total <= self.policy.max_memory_mb:
                break

    async def unload(self, key: ResourceKey) -> bool:
        async with self._lock:
            return self._entries.pop(key, None) is not None

    async def clear(self) -> int:
        async with self._lock:
            n = len(self._entries)
            self._entries.clear()
            return n

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "total_mb": sum(e.size_mb for e in self._entries.values()),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "keys": [
                {"kind": k.kind, "hash": k.params_hash, "size_mb": e.size_mb, "refs": e.refcount}
                for k, e in self._entries.items()
            ],
        }
