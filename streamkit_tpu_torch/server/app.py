# SPDX-License-Identifier: Apache-2.0
"""The skit-equivalent server: HTTP routes + WS control plane.

Port of the JAX package's ``server/app.py`` onto the port's own HTTP/1.1 and
WebSocket layer (:mod:`.http`, standard library only). Routes and bodies are
the reference's (``apps/skit/src/server.rs:1859-1971`` route table):

* ``GET  /healthz``
* ``POST /api/v1/process`` — oneshot pipeline (multipart: config + media)
* ``GET  /api/v1/control`` — WebSocket control plane
* ``GET  /api/v1/permissions`` / ``config`` / ``schema/nodes`` / ``schema/packets``
* ``POST /api/v1/sessions`` (YAML create) / ``GET /api/v1/sessions`` /
  ``DELETE /api/v1/sessions/{id}`` / ``GET /api/v1/sessions/{id}/pipeline``
* ``GET /moq/{path}`` — MoQ media over WebSocket; MoQ over WebTransport on
  UDP ``moq_port`` (:mod:`.webtransport`) with ``GET /api/v1/moq/fingerprints``
  and ``GET /certificate.sha256`` when ``moq_enabled``
* ``GET/POST /api/v1/plugins``, ``DELETE /api/v1/plugins/{kind}`` — native
  and WASM plugins (:mod:`.plugins_api`); ``plugins_dir/{wasm,native}`` is
  loaded at start
* samples + assets, observability and UI routes

The device enters only through the nodes: :func:`create_app` takes
``device=`` (default ``cuda``; without a card it raises, ``device="cpu"``
runs on the CPU) and hands it to ``register_nodes`` and to the one
process-wide :class:`~..engine.batcher.DeviceBatcher`. OTLP push
(:mod:`.otlp`) starts with the app when ``otlp_endpoint`` is set; the script
node's fetch allowlist and secrets are installed from the config. Where
OpenSSL's libcrypto does not load, or the UDP bind fails, the server logs a
WARNING and serves MoQ over ``/moq/{path}`` only, as the reference does when
its bind fails.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Optional, Set

from ..api.messages import make_response, parse_message
from ..api.yaml_compiler import compile_yaml
from ..core import (
    ConfigurationError,
    NodeRegistry,
    ResourceManager,
    ResourcePolicy,
    StreamKitError,
    ValidationFailure,
)
from ..device import resolve_device
from ..engine.dynamic import DynamicEngineConfig
from ..engine.oneshot import run_oneshot_pipeline
from ..nodes import register_nodes
from ..nodes.core_nodes.file_io import set_security_paths
from ..nodes.core_nodes.script import ScriptSecret, set_global_script_config
from ..plugins.native import load_plugins_dir
from ..plugins.wasm import load_wasm_plugin

from . import http as web
from .config import ServerConfig
from .permissions import PermissionDenied, RoleStore
from .sessions import Session, SessionManager
from .websocket import MAX_WS_MESSAGE_BYTES, WsDispatcher

log = logging.getLogger(__name__)

__all__ = ["AppState", "SessionLimitReached", "create_app", "run_server"]


class SessionLimitReached(Exception):
    """Global ``max_concurrent_sessions`` admission limit hit
    (reference ``permissions.rs:316-321``): HTTP surfaces map this to 503,
    the WS control plane to an Error response payload."""


def _load_wasm_dir(registry, directory):
    """Load the .wasm plugins already on disk (as ``load_plugins_dir`` does
    for native ones); a bad plugin logs a WARNING and does not stop the start."""
    plugins = []
    if os.path.isdir(directory):
        for name in sorted(os.listdir(directory)):
            if name.endswith(".wasm"):
                try:
                    plugins.append(load_wasm_plugin(registry, os.path.join(directory, name)))
                except Exception as e:  # noqa: BLE001 — a bad plugin must not kill startup
                    log.warning("failed to load wasm plugin %s: %s", name, e)
    return plugins


class AppState:
    def __init__(self, config: ServerConfig, device=None) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.registry = NodeRegistry()
        register_nodes(self.registry, device=self.device)
        self.resources = ResourceManager(
            ResourcePolicy(
                keep_loaded=config.keep_models_loaded, max_memory_mb=config.max_model_memory_mb
            )
        )
        self.sessions = SessionManager()
        self.roles = RoleStore(config.roles, config.default_role, config.role_header)
        self._ws_clients: Set[web.WebSocketResponse] = set()
        # oneshot admission: permissions.max_concurrent_oneshots (reference
        # ConcurrencyLimitLayer, server.rs:1854-1856 — queues, not rejects);
        # engine.oneshot_concurrency_limit kept as the engine-profile alias.
        # When both are set the tighter bound wins.
        limits = [
            n
            for n in (
                config.oneshot_concurrency_limit or None,
                config.max_concurrent_oneshots,
            )
            if n
        ]
        self._oneshot_sem = asyncio.Semaphore(min(limits)) if limits else None
        # OTLP push telemetry (reference telemetry.rs 5 s periodic reader);
        # started on app startup when an endpoint is configured
        from .otlp import pusher_from_config

        self.otlp = pusher_from_config(config, self)
        set_security_paths(config.allowed_file_paths, config.allowed_write_paths)
        # script fetch() policy: allowlist from config, secret values from
        # env vars at startup (reference server.rs:1323-1360)
        secrets = {}
        for name, sc in (config.script_secrets or {}).items():
            value = os.environ.get(sc.get("env", ""))
            if value is None:
                log.warning("script secret %r: env var %r unset, skipped", name, sc.get("env"))
                continue
            secrets[name] = ScriptSecret(value, list(sc.get("allowed_fetch_urls", [])))
        set_global_script_config(config.script_fetch_allowlist, secrets)
        from ..core.moq_gateway import init_moq_gateway
        from ..engine.batcher import DeviceBatcher
        from ..moq.relay import init_moq_relay

        self.moq_gateway = init_moq_gateway()
        self.moq_relay = init_moq_relay()
        # WebTransport/QUIC acceptor (reference server.rs:1975-2085); the
        # UDP endpoint itself starts on app startup when moq_enabled
        self.webtransport = None
        if config.moq_enabled:
            from ..quic._libcrypto import LibcryptoUnavailable
            from .webtransport import WebTransportServer

            try:
                self.webtransport = WebTransportServer(
                    self.moq_relay, self.moq_gateway, config.moq_host, config.moq_port
                )
            except LibcryptoUnavailable as e:
                log.warning("WebTransport acceptor not started (%s); MoQ is served over /moq/{path} only", e)
        # one process-wide batcher: device work from ALL sessions is packed
        # into shared per-node-type batches
        self.batcher = DeviceBatcher(device=self.device)
        # plugins already on disk: plugins_dir/wasm, then plugins_dir/native
        self.wasm_plugins = _load_wasm_dir(self.registry, os.path.join(config.plugins_dir, "wasm"))
        self.native_plugins = load_plugins_dir(self.registry, os.path.join(config.plugins_dir, "native"))

    def broadcast(self, event: dict) -> None:
        """Fan an event out to every connected control client."""
        if self.otlp is not None:
            payload = event.get("payload", event)
            if isinstance(payload, dict):
                self.otlp.record_event(payload)
        data = json.dumps(event)
        for ws in list(self._ws_clients):
            if ws.closed:
                self._ws_clients.discard(ws)
                continue
            asyncio.ensure_future(self._safe_send(ws, data))

    @staticmethod
    async def _safe_send(ws: web.WebSocketResponse, data: str) -> None:
        try:
            await ws.send_str(data)
        except Exception:  # noqa: BLE001 — dead client
            pass

    async def create_session(self, name: Optional[str], created_by: str) -> Session:
        profile = self.config.profile
        cfg = DynamicEngineConfig(
            packet_batch_size=self.config.packet_batch_size,
            node_input_capacity=profile.node_input_capacity,
            pin_distributor_capacity=profile.pin_distributor_capacity,
        )
        # global admission limit (reference permissions.rs:381-386 +
        # websocket_handlers.rs:106-121): reject BEFORE spawning anything —
        # an allowed-but-unauthenticated role must not be able to exhaust
        # stream-table slots by opening unbounded sessions
        limit = self.config.max_concurrent_sessions
        if limit is not None and len(self.sessions.list()) >= limit:
            raise SessionLimitReached("Maximum concurrent sessions limit reached")
        # pre-check the name BEFORE spawning engine/forwarder tasks, and
        # tear the session down if registration still races to a duplicate
        if name is not None and any(s.name == name for s in self.sessions.list()):
            raise ValueError(f"session name {name!r} already in use")
        session = await Session.create(
            self.registry,
            name,
            created_by,
            self.broadcast,
            resources=self.resources,
            engine_config=cfg,
            batcher=self.batcher,
        )
        try:
            self.sessions.add(session)
        except ValueError:
            await session.destroy()
            raise
        return session


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------
async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def process_oneshot(request: web.Request) -> web.StreamResponse:
    """Oneshot pipeline execution (reference ``server.rs:1460-1584``)."""
    state: AppState = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("create_sessions")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)

    config_yaml: Optional[str] = None
    media_content_type: Optional[str] = None

    if request.content_type and request.content_type.startswith("multipart/"):
        reader = await request.multipart()
        parts = []
        async for part in reader:
            if part.name == "config":
                config_yaml = (await part.read()).decode()
            elif part.name == "media":
                media_content_type = part.headers.get("Content-Type")
                parts.append(await part.read())
        media = b"".join(parts) if parts else None
    else:
        config_yaml = request.query.get("config")
        media = await request.read()
        media_content_type = request.content_type

    if not config_yaml:
        return web.json_response({"error": "missing 'config' field (pipeline YAML)"}, status=422)

    try:
        pipeline = compile_yaml(config_yaml)
    except ConfigurationError as e:
        return web.json_response({"error": str(e)}, status=422)

    for node_id, node in pipeline.nodes.items():
        if not perms.node_allowed(node.kind):
            return web.json_response(
                {"error": f"node kind not allowed: {node.kind}"}, status=403
            )

    async def stream():
        if media:
            chunk_size = 64 * 1024
            for i in range(0, len(media), chunk_size):
                yield media[i : i + chunk_size]

    sem = state._oneshot_sem
    if sem is not None:
        await sem.acquire()
    from ..utils.tracing import get_tracer

    oneshot_span = get_tracer().span(
        "oneshot_request", {"pipeline.name": pipeline.name or ""}
    )
    oneshot_span.__enter__()
    try:
        try:
            result = await run_oneshot_pipeline(
                state.registry,
                pipeline,
                input_stream=stream(),
                input_content_type=media_content_type,
                configured_content_type=request.query.get("content_type"),
                resources=state.resources,
                batcher=state.batcher,
            )
        except (ValidationFailure, ConfigurationError) as e:
            return web.json_response({"error": str(e)}, status=422)

        response = web.StreamResponse(
            status=200, headers={"Content-Type": result.content_type}
        )
        # streamed as the pipeline produces it; every chunk awaits drain(),
        # so a slow client holds the pipeline back through the bounded
        # output channel
        try:
            await response.prepare(request)
            async for chunk in result.iter_chunks():
                await response.write(chunk)
            await response.write_eof()
        except StreamKitError as e:
            log.error("oneshot pipeline failed mid-stream: %s", e)
        except asyncio.CancelledError:
            result.cancel()
            raise
        except ConnectionError as e:
            # client went away mid-stream: abort the pipeline so node tasks
            # don't block forever on bounded channels and batcher slots free
            log.info("oneshot client disconnected: %s", type(e).__name__)
            result.cancel()
        except Exception:  # noqa: BLE001
            log.exception("oneshot streaming failed")
            result.cancel()
            raise
        return response
    finally:
        oneshot_span.__exit__(None, None, None)
        if sem is not None:
            sem.release()


async def ws_control(request: web.Request) -> web.WebSocketResponse:
    """WebSocket control plane (reference ``websocket.rs:139``)."""
    state: AppState = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    ws = web.WebSocketResponse(max_msg_size=MAX_WS_MESSAGE_BYTES)
    await ws.prepare(request)
    state._ws_clients.add(ws)
    dispatcher = WsDispatcher(state)
    try:
        async for msg in ws:
            if msg.type is not web.WSMsgType.TEXT:
                continue
            try:
                envelope = parse_message(msg.data)
            except (ValueError, json.JSONDecodeError) as e:
                await ws.send_json(
                    make_response("error", None, message=f"malformed message: {e}")
                )
                continue
            corr = envelope.get("correlation_id")
            payload = await dispatcher.handle(envelope.get("payload") or {}, role, perms)
            if payload is not None:
                await ws.send_json({"type": "response", "correlation_id": corr, "payload": payload})
    finally:
        state._ws_clients.discard(ws)
    return ws


async def moq_media_ws(request: web.Request) -> web.WebSocketResponse:
    """Media-plane WebSocket acceptor: ``/moq/{path}?direction=publish|subscribe``.

    Binding of the MoQ gateway over WS. Binary frames carry
    ``u8 flags | u64be timestamp_us | payload``.
    """
    from ..core.channel import ChannelClosed
    from ..core.moq_gateway import MoqConnection

    state: AppState = request.app["state"]
    path = "/" + request.match_info["path"]
    direction = request.query.get("direction", "publish")
    ws = web.WebSocketResponse()
    await ws.prepare(request)
    # resolve against gateway routes first (moq-peer sessions), then the
    # relay broadcast namespace (publisher nodes)
    bname = path.lstrip("/")
    use_relay = (
        not state.moq_gateway.has_route(path)
        and direction == "subscribe"
        and state.moq_relay.get(bname) is not None
    )
    if use_relay:
        from ..core.moq_gateway import encode_media_frame

        consumer = await state.moq_relay.subscribe(bname, wait=5.0)
        if consumer is None:
            await ws.close(code=4004, message=b"no such broadcast")
            return ws
        try:
            while True:
                frame = await consumer.recv()
                if frame is None:
                    break
                await ws.send_bytes(
                    encode_media_frame(frame.payload, frame.timestamp_us, frame.key)
                )
        except (ConnectionResetError, RuntimeError):
            pass
        finally:
            consumer.close()
        return ws

    conn = MoqConnection(path=path, direction=direction, remote=str(request.remote))
    accepted = await state.moq_gateway.accept_connection(conn)
    if not accepted:
        await ws.close(code=4004, message=b"no such media route")
        return ws

    async def pump_out() -> None:
        while True:
            frame = await conn.outgoing.recv_optional()
            if frame is None:
                return
            await ws.send_bytes(frame)

    out_task = asyncio.ensure_future(pump_out())
    try:
        async for msg in ws:
            if msg.type is web.WSMsgType.BINARY:
                try:
                    conn.incoming.try_send(msg.data)
                except ChannelClosed:
                    break
                except Exception:
                    pass  # backpressured publisher: drop (live media)
    finally:
        out_task.cancel()
        conn.close()
    return ws


async def get_permissions(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    return web.json_response({"role": role, "permissions": perms.to_json()})


async def get_config(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    return web.json_response(state.config.to_json())


async def validate_pipeline(request: web.Request) -> web.Response:
    """POST /api/v1/validate {yaml} → {valid, pipeline?|error?}.

    Compile-only check used by the Design view (no session is created)."""
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001
        return web.json_response({"error": "invalid JSON body"}, status=422)
    try:
        pipeline = compile_yaml(body.get("yaml", ""))
    except (ConfigurationError, Exception) as e:  # noqa: BLE001
        return web.json_response({"valid": False, "error": str(e)})
    state: AppState = request.app["state"]
    known = set(state.registry.kinds())
    unknown = sorted(
        {n.kind for n in pipeline.nodes.values() if n.kind not in known}
    )
    if unknown:
        return web.json_response(
            {"valid": False, "error": f"unknown node kind(s): {', '.join(unknown)}"}
        )
    return web.json_response({"valid": True, "pipeline": pipeline.to_json()})


async def schema_nodes(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    defs = [d.to_json() for d in state.registry.definitions() if perms.node_allowed(d.kind)]
    return web.json_response({"nodes": defs})


async def schema_packets(request: web.Request) -> web.Response:
    from ..core.packet_meta import packet_type_registry

    return web.json_response(
        {
            "packet_types": [
                {
                    "id": m.id,
                    "label": m.label,
                    "color": m.color,
                    "display_template": m.display_template,
                    "compatibility": m.compatibility,
                }
                for m in packet_type_registry()
            ]
        }
    )


async def create_session_http(request: web.Request) -> web.Response:
    """POST /api/v1/sessions {name?, yaml?} (reference ``server.rs:644-910``)."""
    state: AppState = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("create_sessions")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    try:
        body = await request.json()
    except json.JSONDecodeError:
        return web.json_response({"error": "invalid JSON body"}, status=422)
    try:
        session = await state.create_session(body.get("name"), created_by=role)
    except SessionLimitReached as e:
        return web.json_response({"error": str(e)}, status=503)
    except ValueError as e:
        return web.json_response({"error": str(e)}, status=409)

    yaml_text = body.get("yaml")
    if yaml_text:
        try:
            pipeline = compile_yaml(yaml_text)
            for node_id, node in pipeline.nodes.items():
                if not perms.node_allowed(node.kind):
                    raise PermissionDenied(f"node kind {node.kind}")
                await session.handle.add_node(node_id, node.kind, node.params)
            for c in pipeline.connections:
                await session.handle.connect(c.from_node, c.from_pin, c.to_node, c.to_pin, c.mode)
        except (StreamKitError, PermissionDenied, ValueError) as e:
            await state.sessions.remove(session.id)
            return web.json_response({"error": str(e)}, status=422)
    # lifecycle events broadcast regardless of entry point (reference
    # Session::create wires event forwarding to ALL WS clients —
    # session.rs:105-133; the UI's session lists depend on it)
    from ..api.messages import make_event

    state.broadcast(
        make_event(
            "sessioncreated",
            session_id=session.id,
            name=session.name,
            created_at=session.created_at,
        )
    )
    return web.json_response(
        {"session_id": session.id, "name": session.name, "created_at": session.created_at},
        status=201,
    )


async def list_sessions_http(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("list_sessions")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    creator = None if perms.access_all_sessions else role
    return web.json_response({"sessions": [s.info() for s in state.sessions.list(creator)]})


def _check_session_access(state, request, session) -> Optional[web.Response]:
    """Ownership gate mirroring the WS path (reference session ownership)."""
    role, perms = state.roles.extract(request.headers)
    if not perms.access_all_sessions and session.created_by != role:
        return web.json_response({"error": "permission denied: access_all_sessions"}, status=403)
    return None


async def destroy_session_http(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("destroy_sessions")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    session = state.sessions.get(request.match_info["id"])
    if session is None:
        return web.json_response({"error": "unknown session"}, status=404)
    denied = _check_session_access(state, request, session)
    if denied is not None:
        return denied
    await state.sessions.remove(session.id)
    from ..api.messages import make_event

    state.broadcast(make_event("sessiondestroyed", session_id=session.id))
    return web.json_response({"session_id": session.id})


async def get_session_pipeline(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("list_sessions")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    session = state.sessions.get(request.match_info["id"])
    if session is None:
        return web.json_response({"error": "unknown session"}, status=404)
    denied = _check_session_access(state, request, session)
    if denied is not None:
        return denied
    snapshot = await session.handle.get_pipeline()
    return web.json_response({"pipeline": snapshot})


# ---------------------------------------------------------------------------
@web.middleware
async def _security_middleware(request: web.Request, handler):
    """Origin guard + security headers (reference ``server.rs`` origin-guard
    middleware + security headers layer)."""
    state: AppState = request.app["state"]
    allowed = state.config.allowed_origins
    origin = request.headers.get("Origin")
    if allowed and origin is not None and origin not in allowed:
        return web.json_response({"error": "origin not allowed"}, status=403)
    resp = await handler(request)
    if isinstance(resp, web.StreamResponse):
        resp.headers.setdefault("X-Content-Type-Options", "nosniff")
        resp.headers.setdefault("X-Frame-Options", "DENY")
        resp.headers.setdefault("Referrer-Policy", "no-referrer")
    return resp


def create_app(config: Optional[ServerConfig] = None, *, device=None) -> web.Application:
    """The server's application on ``device`` (default ``cuda``)."""
    config = config or ServerConfig()
    app = web.Application(client_max_size=config.max_body_size, middlewares=[_security_middleware])
    app["state"] = AppState(config, device=device)

    prefix = config.base_path.rstrip("/")
    app.router.add_get(f"{prefix}/healthz", healthz)
    app.router.add_post(f"{prefix}/api/v1/process", process_oneshot)
    app.router.add_get(f"{prefix}/api/v1/control", ws_control)
    app.router.add_get(f"{prefix}/api/v1/permissions", get_permissions)
    app.router.add_get(f"{prefix}/api/v1/config", get_config)
    app.router.add_post(f"{prefix}/api/v1/validate", validate_pipeline)
    app.router.add_get(f"{prefix}/api/v1/schema/nodes", schema_nodes)
    app.router.add_get(f"{prefix}/api/v1/schema/packets", schema_packets)
    app.router.add_post(f"{prefix}/api/v1/sessions", create_session_http)
    app.router.add_get(f"{prefix}/api/v1/sessions", list_sessions_http)
    app.router.add_delete(f"{prefix}/api/v1/sessions/{{id}}", destroy_session_http)
    app.router.add_get(f"{prefix}/api/v1/sessions/{{id}}/pipeline", get_session_pipeline)
    app.router.add_get(f"{prefix}/moq/{{path:.*}}", moq_media_ws)

    from .observability import add_observability_routes
    from .plugins_api import add_plugin_routes
    from .samples import add_sample_routes
    from .ui import add_ui_routes

    add_sample_routes(app, prefix)
    add_observability_routes(app, prefix)
    add_plugin_routes(app, prefix)
    add_ui_routes(app, prefix)
    if app["state"].webtransport is not None:
        from .webtransport import add_fingerprint_routes

        add_fingerprint_routes(app, prefix)

    async def on_startup(app):
        state = app["state"]
        if state.otlp is not None:
            state.otlp.start()
            log.info("OTLP push telemetry → %s every %.0fs", state.otlp.endpoint, state.otlp.interval)
        if state.webtransport is not None:
            try:
                await state.webtransport.start()
            except OSError as e:
                log.warning("WebTransport acceptor failed to bind: %s", e)
                state.webtransport = None

    async def on_shutdown(app):
        state = app["state"]
        if state.otlp is not None:
            await state.otlp.stop()
        if state.webtransport is not None:
            await state.webtransport.stop()
        await state.sessions.destroy_all()
        state.batcher.stop()

    app.on_startup.append(on_startup)
    app.on_shutdown.append(on_shutdown)
    return app


def run_server(config: Optional[ServerConfig] = None, *, device=None) -> None:
    """Serve until SIGINT / SIGTERM. Port 0 binds an ephemeral port; the
    bound address is logged once the socket listens."""
    config = config or ServerConfig()
    # refuse to serve on a non-loopback address with the default-allow-all
    # admin role and no trusted role header (reference ``server.rs:2094-2117``)
    loopback = config.address in ("127.0.0.1", "::1", "localhost")
    if not loopback and config.default_role == "admin" and not config.role_header:
        raise SystemExit(
            "refusing to bind a non-loopback address with default role 'admin' and no "
            "role_header configured — set [permissions] default_role/role_header or "
            "bind 127.0.0.1"
        )
    ssl_context = None
    if config.tls_cert and config.tls_key:
        import ssl

        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(config.tls_cert, config.tls_key)
    app = create_app(config, device=device)
    device_name = str(app["state"].device)
    web.run_app(
        app, host=config.address, port=config.port, ssl_context=ssl_context,
        on_bound=lambda port: log.info("skit-tpu serving on %s:%s (tls=%s, device=%s)",
                                       config.address, port, bool(ssl_context), device_name),
    )
