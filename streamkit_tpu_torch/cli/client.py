# SPDX-License-Identifier: Apache-2.0
"""HTTP + WS client library for the server API.

Parity target: ``apps/skit-cli/src/client.rs`` (1,293 LoC): typed wrappers
over the oneshot endpoint, sessions REST, and the WS control plane, on the
port's own HTTP / WebSocket client (:mod:`..server.http`).
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import Any, AsyncIterator, Dict, List, Optional

from ..server.http import ClientSession, ClientWebSocket, FormData, WSMsgType

__all__ = ["SkitClient"]


class SkitClient:
    def __init__(self, base_url: str = "http://127.0.0.1:8080") -> None:
        self.base_url = base_url.rstrip("/")
        self._session: Optional[ClientSession] = None
        self._ws: Optional[ClientWebSocket] = None
        self._pending: Dict[str, asyncio.Future] = {}
        self._events: asyncio.Queue = asyncio.Queue()
        self._ws_reader: Optional[asyncio.Task] = None

    async def __aenter__(self) -> "SkitClient":
        self._session = ClientSession()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        if self._ws_reader:
            # the reader must be gone before close() reads the peer's close
            # frame itself, or close() waits out its timeout
            self._ws_reader.cancel()
            await asyncio.gather(self._ws_reader, return_exceptions=True)
        if self._ws is not None:
            await self._ws.close()
        if self._session is not None:
            await self._session.close()

    # -- HTTP ------------------------------------------------------------------
    async def healthz(self) -> dict:
        async with self._session.get(f"{self.base_url}/healthz") as r:
            return await r.json()

    async def process_oneshot(
        self, config_yaml: str, media: bytes, media_content_type: str = "application/octet-stream"
    ) -> tuple:
        form = FormData()
        form.add_field("config", config_yaml)
        form.add_field("media", media, filename="media", content_type=media_content_type)
        async with self._session.post(f"{self.base_url}/api/v1/process", data=form) as r:
            body = await r.read()
            if r.status != 200:
                raise RuntimeError(f"oneshot failed ({r.status}): {body[:500]!r}")
            return body, r.headers.get("Content-Type")

    async def create_session_http(self, name: Optional[str] = None, yaml_text: Optional[str] = None) -> dict:
        async with self._session.post(
            f"{self.base_url}/api/v1/sessions", json={"name": name, "yaml": yaml_text}
        ) as r:
            body = await r.json()
            if r.status not in (200, 201):
                raise RuntimeError(f"create session failed: {body}")
            return body

    async def list_sessions(self) -> List[dict]:
        async with self._session.get(f"{self.base_url}/api/v1/sessions") as r:
            return (await r.json())["sessions"]

    async def destroy_session_http(self, session_id: str) -> None:
        async with self._session.delete(f"{self.base_url}/api/v1/sessions/{session_id}") as r:
            await r.read()

    async def get_pipeline(self, session_id: str) -> dict:
        async with self._session.get(f"{self.base_url}/api/v1/sessions/{session_id}/pipeline") as r:
            return (await r.json())["pipeline"]

    async def schema_nodes(self) -> List[dict]:
        async with self._session.get(f"{self.base_url}/api/v1/schema/nodes") as r:
            return (await r.json())["nodes"]

    async def permissions(self) -> dict:
        async with self._session.get(f"{self.base_url}/api/v1/permissions") as r:
            return await r.json()

    async def get_config(self) -> dict:
        async with self._session.get(f"{self.base_url}/api/v1/config") as r:
            return await r.json()

    async def moq_fingerprints(self) -> dict:
        """The WebTransport acceptor's ``{"fingerprints", "port"}``."""
        async with self._session.get(f"{self.base_url}/api/v1/moq/fingerprints") as r:
            if r.status != 200:
                raise RuntimeError(f"the server runs no WebTransport acceptor ({r.status})")
            return await r.json()

    async def list_plugins(self) -> dict:
        async with self._session.get(f"{self.base_url}/api/v1/plugins") as r:
            return await r.json()

    async def upload_plugin(self, path: str) -> dict:
        """Upload a ``.so`` or ``.wasm`` as the multipart ``file`` part the
        server reads; raises on a status of 400 or above."""
        form = FormData()
        with open(path, "rb") as f:
            form.add_field("file", f.read(), filename=path.rsplit("/", 1)[-1])
        async with self._session.post(f"{self.base_url}/api/v1/plugins", data=form) as r:
            doc = await r.json()
            if r.status >= 400:
                raise RuntimeError(doc.get("error", f"HTTP {r.status}"))
            return doc

    async def delete_plugin(self, kind: str) -> None:
        async with self._session.delete(f"{self.base_url}/api/v1/plugins/{kind}") as r:
            if r.status >= 400:
                raise RuntimeError(f"HTTP {r.status}")

    async def list_assets(self) -> dict:
        async with self._session.get(f"{self.base_url}/api/v1/assets") as r:
            return await r.json()

    async def upload_asset(self, path: str) -> dict:
        form = FormData()
        with open(path, "rb") as f:
            form.add_field("file", f.read(), filename=path.rsplit("/", 1)[-1])
        async with self._session.post(f"{self.base_url}/api/v1/assets", data=form) as r:
            doc = await r.json()
            if r.status >= 400:
                raise RuntimeError(doc.get("error", f"HTTP {r.status}"))
            return doc

    async def delete_asset(self, asset_id: str) -> None:
        async with self._session.delete(f"{self.base_url}/api/v1/assets/{asset_id}") as r:
            if r.status >= 400:
                raise RuntimeError(f"HTTP {r.status}")

    async def samples(self) -> List[dict]:
        async with self._session.get(f"{self.base_url}/api/v1/samples") as r:
            return (await r.json())["samples"]

    # -- WS control plane ---------------------------------------------------------
    async def connect_ws(self) -> None:
        ws_url = self.base_url.replace("http", "ws", 1) + "/api/v1/control"
        self._ws = await self._session.ws_connect(ws_url)
        self._ws_reader = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        async for msg in self._ws:
            if msg.type is not WSMsgType.TEXT:
                continue
            data = json.loads(msg.data)
            if data.get("type") == "response":
                fut = self._pending.pop(data.get("correlation_id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(data["payload"])
            elif data.get("type") == "event":
                await self._events.put(data["payload"])

    async def request(self, action: str, **fields) -> dict:
        if self._ws is None:
            await self.connect_ws()
        corr = str(uuid.uuid4())
        fut = asyncio.get_running_loop().create_future()
        self._pending[corr] = fut
        await self._ws.send_json(
            {"type": "request", "correlation_id": corr, "payload": {"action": action, **fields}}
        )
        payload = await asyncio.wait_for(fut, timeout=30)
        if payload.get("action") == "error":
            raise RuntimeError(payload.get("message"))
        return payload

    async def events(self) -> AsyncIterator[dict]:
        if self._ws is None:
            await self.connect_ws()
        while True:
            yield await self._events.get()

    # convenience wrappers
    async def create_session(self, name: Optional[str] = None) -> str:
        return (await self.request("createsession", name=name))["session_id"]

    async def add_node(self, session_id, node_id, kind, params=None):
        await self.request("addnode", session_id=session_id, node_id=node_id, kind=kind, params=params)

    async def connect_nodes(self, session_id, from_node, to_node, from_pin="out", to_pin="in"):
        await self.request(
            "connect", session_id=session_id, from_node=from_node, from_pin=from_pin,
            to_node=to_node, to_pin=to_pin,
        )

    async def tune(self, session_id, node_id, params):
        await self.request(
            "tunenode", session_id=session_id, node_id=node_id,
            message={"type": "update_params", "params": params},
        )

    async def destroy_session(self, session_id) -> None:
        await self.request("destroysession", session_id=session_id)
