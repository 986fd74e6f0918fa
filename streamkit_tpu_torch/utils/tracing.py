# SPDX-License-Identifier: Apache-2.0
"""Span-level tracing with OTLP export.

Parity target: the reference wraps every node task in
``info_span!("node_run", node.name, node.kind)`` (``crates/engine/src/
graph_builder.rs:421``, ``dynamic_actor.rs:485-490``) and every WS request
in a request span, exported via tracing-opentelemetry
(``apps/skit/src/telemetry.rs:43-63``, ``logging.rs:66-171``).

This is a dependency-free tracer: W3C-style ids, contextvar parenting
(async-safe: each task sees its enclosing span), a bounded finished-span
buffer drained by the server's OTLP pusher (ported with the server) to ``{endpoint}/v1/traces`` in the OTLP/HTTP JSON encoding.

Usage::

    from streamkit_tpu_torch.utils.tracing import get_tracer
    with get_tracer().span("node_run", {"node.name": n, "node.kind": k}):
        ...                       # children started here parent automatically

Long-lived spans (a node's whole run) and sub-millisecond spans both cost
one dict on close; when no tracer sink is configured the context manager is
a few attribute reads — safe on hot paths.
"""

from __future__ import annotations

import contextvars
import os
import secrets
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "get_tracer", "encode_spans"]

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "skit_current_span", default=None
)


class Span:
    """One span; use via :meth:`Tracer.span` (context manager)."""

    __slots__ = (
        "tracer", "name", "trace_id", "span_id", "parent_span_id",
        "start_ns", "end_ns", "attributes", "status_ok", "status_message",
        "_token",
    )

    def __init__(self, tracer: "Tracer", name: str, attributes: Optional[dict],
                 parent: Optional["Span"]) -> None:
        self.tracer = tracer
        self.name = name
        self.trace_id = parent.trace_id if parent is not None else secrets.token_hex(16)
        self.span_id = secrets.token_hex(8)
        self.parent_span_id = parent.span_id if parent is not None else None
        self.start_ns = time.time_ns()
        self.end_ns = 0
        self.attributes: Dict[str, Any] = dict(attributes or {})
        self.status_ok = True
        self.status_message = ""
        self._token = None

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def __enter__(self) -> "Span":
        self._token = _current_span.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._token is not None:
            _current_span.reset(self._token)
            self._token = None
        if exc is not None:
            self.status_ok = False
            self.status_message = f"{type(exc).__name__}: {exc}"
        self.end_ns = time.time_ns()
        self.tracer._finish(self)


class _NoopSpan:
    __slots__ = ()

    def set_attribute(self, key: str, value: Any) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a) -> None:
        pass


_NOOP = _NoopSpan()


class Tracer:
    """Process-wide tracer with a bounded finished-span buffer.

    Disabled (every ``span()`` returns a no-op) until :meth:`enable` — the
    server enables it when an OTLP endpoint is configured, so non-exporting
    processes pay nothing.
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

    def span(self, name: str, attributes: Optional[dict] = None):
        """Start a child of the current task's span (or a new trace root)."""
        if not self.enabled:
            return _NOOP
        return Span(self, name, attributes, _current_span.get())

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
