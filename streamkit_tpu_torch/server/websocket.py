# SPDX-License-Identifier: Apache-2.0
"""WebSocket control plane: request dispatch + event broadcast.

Parity with reference ``apps/skit/src/websocket.rs`` +
``websocket_handlers.rs:36-1081``: JSON envelope
``{type, correlation_id, payload}``; payload actions are the lowercase
variants of the reference ``RequestPayload`` enum. Events broadcast to all
connected control clients. 1 MiB message cap.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Dict, Optional

from ..api.messages import make_event, make_response
from ..api.yaml_compiler import compile_pipeline_dict
from ..core import NodeControlMessage
from ..core.control import ConnectionMode
from .permissions import PermissionDenied, Permissions

log = logging.getLogger(__name__)

MAX_WS_MESSAGE_BYTES = 1024 * 1024  # reference websocket.rs:23-34


class WsDispatcher:
    """Handles one parsed request payload → response payload."""

    def __init__(self, app_state) -> None:
        self.state = app_state

    async def handle(self, payload: dict, role: str, perms: Permissions) -> Optional[dict]:
        action = payload.get("action", "").lower()
        handler = getattr(self, f"_h_{action}", None)
        if handler is None:
            return {"action": "error", "message": f"unknown action {action!r}"}
        from ..utils.tracing import get_tracer

        # per-request span (reference wraps each WS request; telemetry.rs)
        with get_tracer().span(
            "ws_request",
            {"request.action": action,
             "session.id": str(payload.get("session_id", "")), "role": role},
        ) as span:
            try:
                return await handler(payload, role, perms)
            except PermissionDenied as e:
                span.set_attribute("error", str(e))
                return {"action": "error", "message": str(e)}
            except Exception as e:  # noqa: BLE001 — errors become API responses
                span.set_attribute("error", str(e))
                return {"action": "error", "message": str(e)}

    # -- session management ------------------------------------------------
    async def _h_createsession(self, p, role, perms):
        perms.check("create_sessions")
        session = await self.state.create_session(p.get("name"), created_by=role)
        self.state.broadcast(
            make_event(
                "sessioncreated",
                session_id=session.id,
                name=session.name,
                created_at=session.created_at,
            )
        )
        return {
            "action": "sessioncreated",
            "session_id": session.id,
            "name": session.name,
            "created_at": session.created_at,
        }

    async def _h_destroysession(self, p, role, perms):
        perms.check("destroy_sessions")
        session = self._session(p, role, perms)
        await self.state.sessions.remove(session.id)
        self.state.broadcast(make_event("sessiondestroyed", session_id=session.id))
        return {"action": "sessiondestroyed", "session_id": session.id}

    async def _h_listsessions(self, p, role, perms):
        perms.check("list_sessions")
        creator = None if perms.access_all_sessions else role
        return {
            "action": "sessionslisted",
            "sessions": [s.info() for s in self.state.sessions.list(creator)],
        }

    async def _h_listnodes(self, p, role, perms):
        perms.check("list_nodes")
        defs = [
            d.to_json()
            for d in self.state.registry.definitions()
            if perms.node_allowed(d.kind)
        ]
        return {"action": "nodeslisted", "nodes": defs}

    async def _h_getpermissions(self, p, role, perms):
        return {"action": "permissions", "role": role, "permissions": perms.to_json()}

    # -- pipeline manipulation ----------------------------------------------
    def _session(self, p, role, perms):
        session = self.state.sessions.get(p.get("session_id", ""))
        if session is None:
            raise ValueError(f"unknown session {p.get('session_id')!r}")
        if not perms.access_all_sessions and session.created_by != role:
            raise PermissionDenied("access_all_sessions")
        return session

    async def _h_addnode(self, p, role, perms):
        perms.check("modify_sessions")
        kind = p["kind"]
        if not perms.node_allowed(kind):
            raise PermissionDenied(f"node kind {kind}")
        session = self._session(p, role, perms)
        await session.handle.add_node(p["node_id"], kind, p.get("params"))
        self.state.broadcast(
            make_event(
                "nodeadded",
                session_id=session.id,
                node_id=p["node_id"],
                kind=kind,
                params=p.get("params"),
            )
        )
        return {"action": "success"}

    async def _h_removenode(self, p, role, perms):
        perms.check("modify_sessions")
        session = self._session(p, role, perms)
        await session.handle.remove_node(p["node_id"])
        self.state.broadcast(
            make_event("noderemoved", session_id=session.id, node_id=p["node_id"])
        )
        return {"action": "success"}

    async def _h_connect(self, p, role, perms):
        perms.check("modify_sessions")
        session = self._session(p, role, perms)
        mode = ConnectionMode(p.get("mode", "reliable"))
        await session.handle.connect(
            p["from_node"], p["from_pin"], p["to_node"], p["to_pin"], mode
        )
        self.state.broadcast(
            make_event(
                "connectionadded",
                session_id=session.id,
                from_node=p["from_node"],
                from_pin=p["from_pin"],
                to_node=p["to_node"],
                to_pin=p["to_pin"],
            )
        )
        return {"action": "success"}

    async def _h_disconnect(self, p, role, perms):
        perms.check("modify_sessions")
        session = self._session(p, role, perms)
        await session.handle.disconnect(
            p["from_node"], p["from_pin"], p["to_node"], p["to_pin"]
        )
        self.state.broadcast(
            make_event(
                "connectionremoved",
                session_id=session.id,
                from_node=p["from_node"],
                from_pin=p["from_pin"],
                to_node=p["to_node"],
                to_pin=p["to_pin"],
            )
        )
        return {"action": "success"}

    async def _h_tunenode(self, p, role, perms):
        perms.check("tune_nodes")
        session = self._session(p, role, perms)
        msg = NodeControlMessage.from_json(p["message"])
        await session.handle.tune_node(p["node_id"], msg)
        if msg.op == "update_params":
            self.state.broadcast(
                make_event(
                    "nodeparamschanged",
                    session_id=session.id,
                    node_id=p["node_id"],
                    params=msg.params,
                )
            )
        return {"action": "success"}

    async def _h_tunenodeasync(self, p, role, perms):
        perms.check("tune_nodes")
        session = self._session(p, role, perms)
        msg = NodeControlMessage.from_json(p["message"])
        asyncio.ensure_future(session.handle.tune_node(p["node_id"], msg))
        return None  # fire-and-forget: no response

    async def _h_getpipeline(self, p, role, perms):
        # reference handle_get_pipeline (websocket_handlers.rs:959) requires
        # list_sessions before returning pipeline contents
        perms.check("list_sessions")
        session = self._session(p, role, perms)
        snapshot = await session.handle.get_pipeline()
        pipeline = {
            "name": session.name,
            "mode": "dynamic",
            "nodes": snapshot["nodes"],
            "connections": snapshot["connections"],
        }
        return {"action": "pipeline", "pipeline": pipeline}

    # -- batch operations -----------------------------------------------------
    async def _h_validatebatch(self, p, role, perms):
        perms.check("modify_sessions")
        session = self._session(p, role, perms)
        errors = await self._validate_ops(session, p.get("operations", []), perms)
        return {"action": "validationresult", "errors": errors}

    async def _h_applybatch(self, p, role, perms):
        perms.check("modify_sessions")
        session = self._session(p, role, perms)
        ops = p.get("operations", [])
        errors = await self._validate_ops(session, ops, perms)
        if errors:
            return {"action": "batchapplied", "success": False, "errors": [e["message"] for e in errors]}
        applied_errors = []
        for op in ops:
            try:
                await self._apply_op(session, op)
            except Exception as e:  # noqa: BLE001
                applied_errors.append(str(e))
                break
        return {
            "action": "batchapplied",
            "success": not applied_errors,
            "errors": applied_errors,
        }

    async def _validate_ops(self, session, ops, perms):
        errors = []
        snapshot = await session.handle.get_pipeline()
        known = set(snapshot["nodes"])
        for op in ops:
            action = op.get("action", "").lower()
            if action == "addnode":
                if not perms.node_allowed(op.get("kind", "")):
                    errors.append(
                        {"error_type": "error", "message": f"node kind not allowed: {op.get('kind')}",
                         "node_id": op.get("node_id"), "connection_id": None}
                    )
                if not self.state.registry.contains(op.get("kind", "")):
                    errors.append(
                        {"error_type": "error", "message": f"unknown node kind: {op.get('kind')}",
                         "node_id": op.get("node_id"), "connection_id": None}
                    )
                known.add(op.get("node_id"))
            elif action in ("connect", "disconnect"):
                for endpoint in (op.get("from_node"), op.get("to_node")):
                    if endpoint not in known:
                        errors.append(
                            {"error_type": "error", "message": f"unknown node: {endpoint}",
                             "node_id": endpoint, "connection_id": None}
                        )
            elif action == "removenode":
                if op.get("node_id") not in known:
                    errors.append(
                        {"error_type": "error", "message": f"unknown node: {op.get('node_id')}",
                         "node_id": op.get("node_id"), "connection_id": None}
                    )
                known.discard(op.get("node_id"))
        return errors

    async def _apply_op(self, session, op):
        action = op.get("action", "").lower()
        if action == "addnode":
            await session.handle.add_node(op["node_id"], op["kind"], op.get("params"))
        elif action == "removenode":
            await session.handle.remove_node(op["node_id"])
        elif action == "connect":
            await session.handle.connect(
                op["from_node"], op["from_pin"], op["to_node"], op["to_pin"],
                ConnectionMode(op.get("mode", "reliable")),
            )
        elif action == "disconnect":
            await session.handle.disconnect(
                op["from_node"], op["from_pin"], op["to_node"], op["to_pin"]
            )
        else:
            raise ValueError(f"unknown batch action {action!r}")
