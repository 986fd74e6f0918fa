# SPDX-License-Identifier: Apache-2.0
"""Span-level tracing with OTLP export.

Parity target: the reference wraps every node task in
``info_span!("node_run", node.name, node.kind)`` (``crates/engine/src/
graph_builder.rs:421``, ``dynamic_actor.rs:485-490``) and every WS request
in a request span, exported via tracing-opentelemetry
(``apps/skit/src/telemetry.rs:43-63``, ``logging.rs:66-171``).

This is a dependency-free tracer: W3C-sized ids, contextvar parenting
(async-safe: each task sees its enclosing span), a bounded finished-span
buffer drained by the server's OTLP pusher (ported with the server) to ``{endpoint}/v1/traces`` in the OTLP/HTTP JSON encoding.

Usage::

    from streamkit_tpu_torch.utils.tracing import get_tracer
    with get_tracer().span("node_run", {"node.name": n, "node.kind": k}):
        ...                       # children started here parent automatically

**One clock.** Every span is stamped with :func:`now_ns`, the clock that
``torch.profiler``'s Kineto events are stamped with (nanoseconds since the
Unix epoch, ``time.time_ns``), so a span and the device operations of a
profiler trace can be laid side by side without conversion.

**Across threads.** Context variables do not cross
``loop.run_in_executor``: a span started in one thread is handed to another
with ``parent=``, or made current there with :meth:`Span.scope` (the batcher
does this for its device calls). A span whose start is known only
afterwards (a queue wait) is written whole with :meth:`Tracer.record`.

**Disabled is free.** Until :meth:`Tracer.enable` (the server enables it when
an OTLP endpoint is configured) every ``span()`` returns one shared no-op
and ``record()`` returns at once: no allocation, no clock read. Enabled, a
span costs one object and two clock reads; its ids are a per-process random
prefix and a counter, with no system call.
"""

from __future__ import annotations

import contextvars
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "encode_spans", "now_ns", "NOOP_SPAN"]

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "skit_current_span", default=None
)

#: the tracer's clock: Kineto's (``torch.profiler``) event clock
now_ns = time.time_ns


class _Ids:
    """W3C-sized ids without a system call per span: a random per-process
    prefix (drawn again in a forked child) and a counter."""

    def __init__(self) -> None:
        self._seed()
        if hasattr(os, "register_at_fork"):
            os.register_at_fork(after_in_child=self._seed)

    def _seed(self) -> None:
        self._trace_prefix = os.urandom(8).hex()
        self._span_base = int.from_bytes(os.urandom(8), "big")
        self._n = itertools.count(1)

    def trace_id(self) -> str:
        return f"{self._trace_prefix}{next(self._n):016x}"

    def span_id(self) -> str:
        # never all zeros (W3C): the counter starts at 1 and wraps past 0
        return f"{((self._span_base + next(self._n)) % 0xFFFFFFFFFFFFFFFF) + 1:016x}"


_IDS = _Ids()


class Span:
    """One span; use via :meth:`Tracer.span` (context manager, or
    :meth:`end` for a span that ends in another thread)."""

    __slots__ = (
        "tracer", "name", "trace_id", "span_id", "parent_span_id",
        "start_ns", "end_ns", "attributes", "status_ok", "status_message",
        "_token",
    )

    def __init__(self, tracer: "Tracer", name: str, attributes: Optional[dict],
                 parent: Optional["Span"], start_ns: Optional[int] = None) -> None:
        self.tracer = tracer
        self.name = name
        self.trace_id = parent.trace_id if parent is not None else _IDS.trace_id()
        self.span_id = _IDS.span_id()
        self.parent_span_id = parent.span_id if parent is not None else None
        self.start_ns = now_ns() if start_ns is None else start_ns
        self.end_ns = 0
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.status_ok = True
        self.status_message = ""
        self._token = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def fail(self, exc: BaseException) -> None:
        self.status_ok = False
        self.status_message = f"{type(exc).__name__}: {exc}"

    def end(self) -> None:
        """Close the span (once) without touching the current context."""
        if not self.end_ns:
            self.end_ns = now_ns()
            self.tracer._finish(self)

    def scope(self) -> "_Scope":
        """A context in which this span is current (children parent to it)
        and which leaves it open: for a span handed to another thread."""
        return _Scope(self)

    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        if exc is not None:
            self.fail(exc)
        self.end()


class _Scope:
    __slots__ = ("span", "_token")

    def __init__(self, span: Span) -> None:
        self.span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = _current_span.set(self.span)
        return self.span

    def __exit__(self, *a) -> None:
        _current_span.reset(self._token)


class _NoopSpan:
    __slots__ = ()

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def fail(self, exc: BaseException) -> None:
        pass

    def end(self) -> None:
        pass

    def scope(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> None:  # no *args: no tuple a span
        pass


#: what a disabled tracer hands out: every method does nothing
NOOP_SPAN = _NoopSpan()


class Tracer:
    """Process-wide tracer with a bounded finished-span buffer.

    Disabled (every ``span()`` returns a no-op) until :meth:`enable` — the
    server enables it when an OTLP endpoint is configured, so non-exporting
    processes pay nothing. Spans past ``max_buffered`` are counted in
    :attr:`dropped` and lost.
    """

    def __init__(self, max_buffered: int = 4096) -> None:
        self.enabled = False
        self.max_buffered = max_buffered
        self._finished: List[Span] = []
        self._lock = threading.Lock()
        self.dropped = 0

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def span(self, name: str, attributes: Optional[dict] = None, parent: Optional[Span] = None):
        """Start a span: a child of ``parent`` if that is a live span, else of
        the current task's span (or a new trace root)."""
        if not self.enabled:
            return NOOP_SPAN
        if not isinstance(parent, Span):
            parent = _current_span.get()
        return Span(self, name, attributes, parent)

    def record(self, name: str, start_ns: int, end_ns: int, attributes: Optional[dict] = None,
               parent: Optional[Span] = None) -> None:
        """Write a finished span whose times are known (both on
        :func:`now_ns`'s clock), parented as :meth:`span` parents."""
        if not self.enabled:
            return
        if not isinstance(parent, Span):
            parent = _current_span.get()
        sp = Span(self, name, attributes, parent, start_ns)
        sp.end_ns = end_ns
        self._finish(sp)

    def current(self) -> Optional[Span]:
        return _current_span.get()

    def _finish(self, span: Span) -> None:
        with self._lock:
            if len(self._finished) < self.max_buffered:
                self._finished.append(span)
            else:
                self.dropped += 1

    def drain(self) -> List[Span]:
        with self._lock:
            out, self._finished = self._finished, []
        return out


_TRACER = Tracer(max_buffered=int(os.environ.get("SK_TRACE_BUFFER", "4096")))


def get_tracer() -> Tracer:
    return _TRACER


def _attr_value(v: Any) -> dict:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def encode_spans(spans: List[Span], resource: Optional[dict] = None,
                 scope: Optional[dict] = None) -> dict:
    """Finished spans → ExportTraceServiceRequest (OTLP/HTTP JSON mapping)."""
    records = []
    for s in spans:
        rec = {
            "traceId": s.trace_id,
            "spanId": s.span_id,
            "name": s.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(s.start_ns),
            "endTimeUnixNano": str(s.end_ns),
            "attributes": [
                {"key": k, "value": _attr_value(v)} for k, v in s.attributes.items()
            ],
            "status": {"code": 1 if s.status_ok else 2},
        }
        if not s.status_ok and s.status_message:
            rec["status"]["message"] = s.status_message
        if s.parent_span_id:
            rec["parentSpanId"] = s.parent_span_id
        records.append(rec)
    return {
        "resourceSpans": [
            {
                "resource": resource
                or {
                    "attributes": [
                        {"key": "service.name",
                         "value": {"stringValue": "streamkit-tpu"}}
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": scope or {"name": "streamkit_tpu_torch", "version": "0.1"},
                        "spans": records,
                    }
                ],
            }
        ]
    }
