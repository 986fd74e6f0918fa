# SPDX-License-Identifier: Apache-2.0
"""Bounded, closable async channels — the host data-plane primitive.

The reference uses tokio bounded mpsc channels everywhere
(``crates/engine/src/constants.rs:31-130``). asyncio.Queue lacks close
semantics, which the engines rely on for EOF propagation (input closed →
flush → stop), so this module provides a small mpsc channel with:

* bounded capacity with awaitable ``send`` (backpressure) and ``try_send``,
* ``close()`` from either side; ``recv`` drains remaining items then raises
  :class:`ChannelClosed`,
* ``try_recv`` for greedy batch draining (reference
  ``core/src/helpers.rs:69-118``).
"""

from __future__ import annotations

import asyncio
import collections
from typing import Any, Deque, Optional

__all__ = ["Channel", "ChannelClosed", "ChannelFull", "channel"]


class ChannelClosed(Exception):
    """Raised on send to a closed channel, or recv from a closed+drained one."""


class ChannelFull(Exception):
    """Raised by try_send when the channel is at capacity."""


class Channel:
    """A bounded mpsc channel with close semantics."""

    __slots__ = ("capacity", "_items", "_closed", "_recv_waiters", "_send_waiters", "name")

    def __init__(self, capacity: int, name: str = "") -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.name = name
        self._items: Deque[Any] = collections.deque()
        self._closed = False
        self._recv_waiters: Deque[asyncio.Future] = collections.deque()
        self._send_waiters: Deque[asyncio.Future] = collections.deque()

    # -- state ----------------------------------------------------------------
    @property
    def is_closed(self) -> bool:
        return self._closed

    def qsize(self) -> int:
        return len(self._items)

    @property
    def is_empty(self) -> bool:
        return not self._items

    @property
    def is_full(self) -> bool:
        return len(self._items) >= self.capacity

    # -- send side --------------------------------------------------------------
    def try_send(self, item: Any) -> None:
        if self._closed:
            raise ChannelClosed(self.name)
        if len(self._items) >= self.capacity:
            raise ChannelFull(self.name)
        self._items.append(item)
        self._wake_one(self._recv_waiters)

    def put_nowait(self, item: Any) -> None:
        """Queue-compatible alias for try_send (used by lossy emitters)."""
        self.try_send(item)

    async def send(self, item: Any) -> None:
        """Await until there is room (Reliable backpressure), then enqueue."""
        while True:
            if self._closed:
                raise ChannelClosed(self.name)
            if len(self._items) < self.capacity:
                self._items.append(item)
                self._wake_one(self._recv_waiters)
                return
            fut = asyncio.get_running_loop().create_future()
            self._send_waiters.append(fut)
            try:
                await fut
            finally:
                if not fut.done():
                    fut.cancel()
                try:
                    self._send_waiters.remove(fut)
                except ValueError:
                    pass

    # -- receive side -------------------------------------------------------------
    def try_recv(self) -> Any:
        if self._items:
            item = self._items.popleft()
            self._wake_one(self._send_waiters)
            return item
        if self._closed:
            raise ChannelClosed(self.name)
        raise ChannelFull(self.name)  # empty; reuse as "would block"

    async def recv(self) -> Any:
        while True:
            if self._items:
                item = self._items.popleft()
                self._wake_one(self._send_waiters)
                return item
            if self._closed:
                raise ChannelClosed(self.name)
            fut = asyncio.get_running_loop().create_future()
            self._recv_waiters.append(fut)
            try:
                await fut
            finally:
                if not fut.done():
                    fut.cancel()
                try:
                    self._recv_waiters.remove(fut)
                except ValueError:
                    pass

    async def recv_optional(self) -> Optional[Any]:
        """recv() that returns None instead of raising on close (EOF)."""
        try:
            return await self.recv()
        except ChannelClosed:
            return None

    # -- close ------------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._wake_all(self._recv_waiters)
        self._wake_all(self._send_waiters)

    # -- internals -----------------------------------------------------------
    @staticmethod
    def _wake_one(waiters: Deque[asyncio.Future]) -> None:
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return

    @staticmethod
    def _wake_all(waiters: Deque[asyncio.Future]) -> None:
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(None)


def channel(capacity: int, name: str = "") -> Channel:
    return Channel(capacity, name)
