# SPDX-License-Identifier: Apache-2.0
"""OTLP/HTTP push in both packages: the port's ``server/otlp.py`` (on its own
HTTP client) against the JAX package's (aiohttp). Host code: the encodings
are compared as JSON, exactly, with the clocks fixed; the live pushes go to a
stub collector served by the port's HTTP layer."""

from __future__ import annotations

import asyncio
import json

import pytest
import torch

import streamkit_tpu.server as jax_server
import streamkit_tpu.server.otlp as jax_otlp
import streamkit_tpu.utils.tracing as jax_tracing
import streamkit_tpu_torch.server as torch_server
import streamkit_tpu_torch.server.otlp as torch_otlp
import streamkit_tpu_torch.utils.tracing as torch_tracing
from streamkit_tpu_torch.server import http as web

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others


@pytest.fixture(autouse=True)
def _tracers_off():
    yield
    jax_tracing.get_tracer().disable()
    torch_tracing.get_tracer().disable()


METRIC_SETS = [
    [("skit_sessions_active", "gauge", 3, {}), ("skit_node_packets_sent", "counter", 42, {"node": "gain"}),
     ("skit_node_packets_sent", "counter", 7, {"node": "mix"}), ("skit_uptime_seconds", "gauge", 1.5, {})],
    [("skit_process_rss_bytes", "gauge", 123456789.0, {}), ("skit_x", "counter", 0, {"a": 1, "b": "two"})],
    [],
]


@pytest.mark.parametrize("i", range(len(METRIC_SETS)))
def test_encode_metrics_equal(i):
    for now, start in ((1_000, 500), (1_700_000_000_123_456_789, None)):
        a = torch_otlp.encode_metrics(METRIC_SETS[i], now_ns=now, start_ns=start)
        b = jax_otlp.encode_metrics(METRIC_SETS[i], now_ns=now, start_ns=start)
        assert json.dumps(a) == json.dumps(b)
    metrics = {m["name"]: m for m in a["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
    if i == 0:
        assert metrics["skit_sessions_active"]["gauge"]["dataPoints"][0]["asInt"] == "3"
        assert len(metrics["skit_node_packets_sent"]["sum"]["dataPoints"]) == 2
        assert metrics["skit_uptime_seconds"]["gauge"]["dataPoints"][0]["asDouble"] == 1.5


def test_encode_logs_equal():
    events = [{"event": "script.error", "session_id": "abc", "data": {"x": 1}},
              {"event": "nodetelemetry", "node_id": "stt", "type_id": "stt.result", "data": {"text": "hi"},
               "timestamp_us": 12, "none": None},
              {"session_id": "no-event", "items": [1, 2]}]
    a, b = torch_otlp.encode_logs(events, now_ns=42), jax_otlp.encode_logs(events, now_ns=42)
    assert json.dumps(a) == json.dumps(b)
    rec = a["resourceLogs"][0]["scopeLogs"][0]["logRecords"][0]
    assert rec["body"]["stringValue"] == "script.error"
    assert json.loads({x["key"]: x["value"]["stringValue"] for x in rec["attributes"]}["data"]) == {"x": 1}


class _Collector:
    """A stub OTLP collector on the port's HTTP layer: keeps every posted
    document by path."""

    def __init__(self):
        self.posts = {"/v1/metrics": [], "/v1/logs": [], "/v1/traces": []}
        self.headers = []
        self.app = web.Application()
        for path in self.posts:
            self.app.router.add_post(path, self._handle)

    async def _handle(self, request):
        self.posts[request.path].append(await request.json())
        self.headers.append(dict(request.headers))
        return web.json_response({})

    async def __aenter__(self):
        self.runner = web.AppRunner(self.app)
        self.endpoint = f"http://127.0.0.1:{await self.runner.start('127.0.0.1', 0)}"
        return self

    async def __aexit__(self, *exc):
        await self.runner.cleanup()


async def _port_server(cfg):
    app = torch_server.create_app(cfg, device="cpu")
    runner = web.AppRunner(app)
    port = await runner.start("127.0.0.1", 0)
    return app, runner, f"http://127.0.0.1:{port}"


async def _jax_server(cfg):
    from aiohttp.test_utils import TestClient, TestServer

    app = jax_server.create_app(cfg)
    client = TestClient(TestServer(app))
    await client.start_server()
    return app, client


def _config(pkg, endpoint, interval):
    cfg = (torch_server if pkg == "torch" else jax_server).ServerConfig()
    cfg.moq_enabled = False
    cfg.otlp_endpoint = endpoint
    cfg.otlp_interval_secs = interval
    cfg.otlp_headers = {"X-Tenant": "t1"}
    return cfg


async def _wait(cond, timeout_s=30.0):
    for _ in range(int(timeout_s / 0.05)):
        if cond():
            return True
        await asyncio.sleep(0.05)
    return cond()


def test_push_to_live_collector_matches_jax(monkeypatch):
    """Both servers push metrics and the buffered events to one stub: the
    same metric names, the same log records, the configured headers (and
    those of ``OTEL_EXPORTER_OTLP_HEADERS``)."""
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_HEADERS", "X-Env=e1, X-Two = 2")
    event = {"type": "event", "payload": {"event": "sessioncreated", "session_id": "s1", "name": None}}
    seen = {}

    async def main():
        for pkg in ("jax", "torch"):
            async with _Collector() as col:
                cfg = _config(pkg, col.endpoint, 0.1)
                if pkg == "torch":
                    app, runner, _ = await _port_server(cfg)
                else:
                    app, client = await _jax_server(cfg)
                state = app["state"]
                try:
                    assert isinstance(state.otlp, (torch_otlp if pkg == "torch" else jax_otlp).OtlpPusher)
                    state.broadcast(event)
                    # a push counts once the collector's last response is read: wait for
                    # that too, not only for the collector to have the bodies
                    assert await _wait(lambda: col.posts["/v1/metrics"] and col.posts["/v1/logs"]
                                       and state.otlp.exports >= 1)
                    assert state.otlp.exports >= 1 and state.otlp.failures == 0
                finally:
                    await (runner.cleanup() if pkg == "torch" else client.close())
                assert state.otlp._task is None  # stopped with the app
                names = {m["name"] for m in col.posts["/v1/metrics"][0]["resourceMetrics"][0]["scopeMetrics"][0]
                         ["metrics"]}
                logs = col.posts["/v1/logs"][0]["resourceLogs"][0]["scopeLogs"][0]["logRecords"]
                for rec in logs:
                    rec.pop("timeUnixNano")
                hdr = {k.lower(): v for k, v in col.headers[0].items()}
                seen[pkg] = (names, logs, {k: hdr.get(k) for k in ("x-tenant", "x-env", "x-two", "content-type")})
        assert seen["torch"][0] >= {"skit_sessions_active", "skit_process_rss_bytes"}

    asyncio.run(main())
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][2] == {"x-tenant": "t1", "x-env": "e1", "x-two": "2", "content-type": "application/json"}
    assert [r["body"]["stringValue"] for r in seen["torch"][1]] == ["sessioncreated"]


def test_pusher_survives_unreachable_collector():
    """Failures count, the loop goes on, the server stays healthy (both)."""
    failures = {}

    async def main():
        cfg = _config("torch", "http://127.0.0.1:1", 0.05)
        app, runner, base = await _port_server(cfg)
        try:
            assert await _wait(lambda: app["state"].otlp.failures >= 2)
            async with web.ClientSession(timeout=30) as s:
                async with s.get(base + "/healthz") as r:
                    assert r.status == 200
        finally:
            await runner.cleanup()
        failures["torch"] = (app["state"].otlp.failures >= 2, app["state"].otlp.exports)
        app, client = await _jax_server(_config("jax", "http://127.0.0.1:1", 0.05))
        try:
            assert await _wait(lambda: app["state"].otlp.failures >= 2)
            assert (await client.get("/healthz")).status == 200
        finally:
            await client.close()
        failures["jax"] = (app["state"].otlp.failures >= 2, app["state"].otlp.exports)

    asyncio.run(main())
    assert failures["torch"] == failures["jax"] == (True, 0)


def test_a_collector_error_status_counts_as_a_failure():
    """A 4xx/5xx from the collector fails the export (the reference's
    ``raise_for_status``): nothing counts as exported."""

    async def main():
        app_c = web.Application()

        async def refuse(request):
            return web.json_response({"error": "no"}, status=503)

        app_c.router.add_post("/v1/metrics", refuse)
        runner_c = web.AppRunner(app_c)
        port = await runner_c.start("127.0.0.1", 0)
        app, runner, _ = await _port_server(_config("torch", f"http://127.0.0.1:{port}", 0.05))
        try:
            assert await _wait(lambda: app["state"].otlp.failures >= 2)
            return app["state"].otlp.exports
        finally:
            await runner.cleanup()
            await runner_c.cleanup()

    assert asyncio.run(main()) == 0


def test_spans_exported_and_session_flow_traced():
    """A session created, given a node and destroyed over the port's control
    plane appears as ``ws_request`` and ``node_run`` spans at ``/v1/traces``."""

    async def main():
        async with _Collector() as col:
            app, runner, base = await _port_server(_config("torch", col.endpoint, 0.1))
            try:
                assert torch_tracing.get_tracer().enabled
                async with web.ClientSession(timeout=30) as s:
                    ws = await s.ws_connect(base + "/api/v1/control")
                    await ws.send_json({"type": "request", "correlation_id": "1",
                                        "payload": {"action": "createsession", "name": "trace-me"}})
                    sid = None
                    while sid is None:
                        msg = json.loads((await ws.receive(timeout=10)).data)
                        if msg.get("payload", {}).get("action") == "sessioncreated":
                            sid = msg["payload"]["session_id"]
                    for i, payload in enumerate(({"action": "addnode", "session_id": sid, "node_id": "g",
                                                  "kind": "audio::gain"},
                                                 {"action": "destroysession", "session_id": sid}), 2):
                        await ws.send_json({"type": "request", "correlation_id": str(i), "payload": payload})

                    def names():
                        return {sp["name"] for doc in col.posts["/v1/traces"]
                                for sp in doc["resourceSpans"][0]["scopeSpans"][0]["spans"]}

                    assert await _wait(lambda: {"ws_request", "node_run"} <= names())
                    await ws.close()
            finally:
                await runner.cleanup()
            spans = [sp for doc in col.posts["/v1/traces"] for sp in doc["resourceSpans"][0]["scopeSpans"][0]["spans"]]
            node = next(sp for sp in spans if sp["name"] == "node_run")
            attrs = {a["key"]: a["value"]["stringValue"] for a in node["attributes"]}
            assert attrs["node.kind"] == "audio::gain" and attrs["session.id"] == sid
            actions = {a["value"]["stringValue"] for sp in spans if sp["name"] == "ws_request"
                       for a in sp["attributes"] if a["key"] == "request.action"}
            assert {"createsession", "addnode", "destroysession"} <= actions

    asyncio.run(main())


def test_no_endpoint_no_pusher(monkeypatch):
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    cfg = torch_server.ServerConfig()
    assert torch_otlp.pusher_from_config(cfg, None) is None
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", "http://127.0.0.1:9/")
    p = torch_otlp.pusher_from_config(cfg, None)
    q = jax_otlp.pusher_from_config(cfg, None)
    assert (p.endpoint, p.interval, p.headers) == (q.endpoint, q.interval, q.headers)
