# SPDX-License-Identifier: Apache-2.0
"""OTLP/HTTP push telemetry (metrics every 5 s + telemetry events as logs).

Port of the JAX package's ``server/otlp.py`` onto the port's own HTTP client
(:mod:`.http`; no aiohttp). The reference initializes an OTLP exporter with a
5 s periodic metric reader and routes tracing events through OTLP
(``apps/skit/src/telemetry.rs:22-110``; export call ``telemetry.rs:70-85``).

It speaks the OTLP/HTTP **JSON** encoding directly (opentelemetry-proto JSON
mapping: camelCase field names, 64-bit ints as strings), with no collector
SDK. Endpoints follow the OTLP convention: ``{base}/v1/metrics``,
``{base}/v1/logs`` and ``{base}/v1/traces``. Configure via ``[telemetry]
otlp_endpoint`` or the standard ``OTEL_EXPORTER_OTLP_ENDPOINT`` env var.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from . import http

__all__ = ["OtlpPusher", "encode_metrics", "encode_logs", "pusher_from_config"]

log = logging.getLogger(__name__)

# a request to the collector, from connect to its last body byte
EXPORT_TIMEOUT_S = 10.0

_RESOURCE = {
    "attributes": [
        {"key": "service.name", "value": {"stringValue": "streamkit-tpu"}},
    ]
}
_SCOPE = {"name": "streamkit_tpu", "version": "0.1"}


def _attrs(labels: Dict[str, str]) -> List[dict]:
    return [{"key": k, "value": {"stringValue": str(v)}} for k, v in labels.items()]


def encode_metrics(
    metrics: List[Tuple[str, str, float, Dict[str, str]]],
    now_ns: Optional[int] = None,
    start_ns: Optional[int] = None,
) -> dict:
    """``[(name, gauge|counter, value, labels)]`` → ExportMetricsServiceRequest
    in OTLP JSON encoding."""
    now_ns = now_ns or time.time_ns()
    start_ns = start_ns or now_ns
    by_name: Dict[str, dict] = {}
    for name, kind, value, labels in metrics:
        point = {
            "timeUnixNano": str(now_ns),
            "attributes": _attrs(labels),
        }
        if isinstance(value, float) and not value.is_integer():
            point["asDouble"] = value
        else:
            point["asInt"] = str(int(value))
        m = by_name.get(name)
        if m is None:
            if kind == "counter":
                m = {
                    "name": name,
                    "sum": {
                        "aggregationTemporality": 2,  # CUMULATIVE
                        "isMonotonic": True,
                        "dataPoints": [],
                    },
                }
            else:
                m = {"name": name, "gauge": {"dataPoints": []}}
            by_name[name] = m
        body = m.get("sum") or m["gauge"]
        if "sum" in m:
            point["startTimeUnixNano"] = str(start_ns)
        body["dataPoints"].append(point)
    return {
        "resourceMetrics": [
            {
                "resource": _RESOURCE,
                "scopeMetrics": [{"scope": _SCOPE, "metrics": list(by_name.values())}],
            }
        ]
    }


def encode_logs(events: List[dict], now_ns: Optional[int] = None) -> dict:
    """Telemetry events → ExportLogsServiceRequest (OTLP JSON).

    Each event dict carries at least ``event`` (type) plus arbitrary data;
    the event name maps to the log body, the rest to attributes."""
    now_ns = now_ns or time.time_ns()
    records = []
    for ev in events:
        attrs = {k: v for k, v in ev.items() if k != "event" and v is not None}
        records.append(
            {
                "timeUnixNano": str(now_ns),
                "severityNumber": 9,  # INFO
                "severityText": "INFO",
                "body": {"stringValue": str(ev.get("event", ""))},
                "attributes": _attrs(
                    {k: json.dumps(v) if isinstance(v, (dict, list)) else v
                     for k, v in attrs.items()}
                ),
            }
        )
    return {
        "resourceLogs": [
            {
                "resource": _RESOURCE,
                "scopeLogs": [{"scope": _SCOPE, "logRecords": records}],
            }
        ]
    }


class OtlpPusher:
    """Background exporter: metrics every ``interval`` seconds; telemetry
    events buffered and flushed alongside (reference pushes both streams)."""

    def __init__(
        self,
        endpoint: str,
        state,
        interval: float = 5.0,
        headers: Optional[Dict[str, str]] = None,
        max_buffered_events: int = 1000,
    ) -> None:
        self.endpoint = endpoint.rstrip("/")
        self.state = state
        self.interval = interval
        self.headers = {"Content-Type": "application/json", **(headers or {})}
        self._events: List[dict] = []
        self._max_events = max_buffered_events
        self._task: Optional[asyncio.Task] = None
        self._start_ns = time.time_ns()
        self.exports = 0
        self.failures = 0
        # host seconds spent in successful flushes (all posts of one export)
        self.export_seconds = 0.0

    # -- event feed (called from the server's telemetry broadcast) ---------
    def record_event(self, event: dict) -> None:
        if len(self._events) < self._max_events:
            self._events.append(event)

    def start(self) -> None:
        self._task = asyncio.ensure_future(self._run())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        async with http.ClientSession(timeout=EXPORT_TIMEOUT_S) as session:
            while True:
                await asyncio.sleep(self.interval)
                try:
                    await self.flush(session)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — export must not kill the server
                    self.failures += 1
                    log.warning("OTLP export failed: %s", e)

    async def _post(self, session: http.ClientSession, path: str, payload: dict) -> None:
        async with session.post(f"{self.endpoint}{path}", json=payload, headers=self.headers) as resp:
            await resp.read()
            if resp.status >= 400:
                raise http.ClientError(f"{path}: {resp.status} {resp.reason}")

    async def flush(self, session: http.ClientSession) -> None:
        from ..utils.tracing import encode_spans, get_tracer
        from .observability import collect_metrics

        t0 = time.perf_counter()
        await self._post(session, "/v1/metrics", encode_metrics(collect_metrics(self.state), start_ns=self._start_ns))
        if self._events:
            events, self._events = self._events, []
            await self._post(session, "/v1/logs", encode_logs(events))
        spans = get_tracer().drain()
        if spans:
            await self._post(session, "/v1/traces", encode_spans(spans))
        self.exports += 1
        self.export_seconds += time.perf_counter() - t0


def pusher_from_config(config, state) -> Optional[OtlpPusher]:
    """Build a pusher when configured: TOML ``[telemetry] otlp_endpoint`` or
    the standard ``OTEL_EXPORTER_OTLP_ENDPOINT`` env var."""
    endpoint = (
        getattr(config, "otlp_endpoint", None)
        or os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
    )
    if not endpoint:
        return None
    # traces are collected only while an exporter exists (node-run spans on
    # hot paths stay no-ops otherwise)
    from ..utils.tracing import get_tracer

    get_tracer().enable()
    headers = dict(getattr(config, "otlp_headers", None) or {})
    env_headers = os.environ.get("OTEL_EXPORTER_OTLP_HEADERS", "")
    for pair in env_headers.split(",") if env_headers else []:
        if "=" in pair:
            k, v = pair.split("=", 1)
            headers[k.strip()] = v.strip()
    return OtlpPusher(
        endpoint,
        state,
        interval=float(getattr(config, "otlp_interval_secs", 5.0)),
        headers=headers,
    )
