# SPDX-License-Identifier: Apache-2.0
"""Plugin management endpoints.

Port of the JAX package's ``server/plugins_api.py`` onto the port's HTTP
layer (:mod:`.http`). Parity target: reference
``apps/skit/src/plugins.rs:121-649`` (UnifiedPluginManager): list loaded
plugins, upload by HTTP multipart, delete/unload.

* ``GET /api/v1/plugins`` — the native plugins, then the WASM ones
* ``POST /api/v1/plugins`` — a multipart ``file`` part named ``*.so`` or
  ``*.wasm`` (``load_plugins``), streamed to ``plugins_dir/{native,wasm}``
  under the server's body limit, then loaded and registered
* ``DELETE /api/v1/plugins/{kind}`` (``delete_plugins``) — as in the JAX
  package, a WASM plugin is unregistered and its file kept
  (``{"removed": kind}``; it loads again at the next start), a native one is
  unregistered and its file removed (``{"deleted": kind}``)
"""

from __future__ import annotations

import os

from ..core.errors import PluginError
from ..plugins.native import load_native_plugin
from ..plugins.wasm import load_wasm_plugin
from . import http as web
from .permissions import PermissionDenied

__all__ = ["add_plugin_routes"]


def _denied(request: web.Request, capability: str):
    role, perms = request.app["state"].roles.extract(request.headers)
    try:
        perms.check(capability)
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    return None


async def list_plugins(request: web.Request) -> web.Response:
    state = request.app["state"]
    plugins = [
        {
            "kind": p.kind,
            "description": p.description,
            "path": p.path,
            "abi_version": int(p.api.abi_version),
            "runtime": "native",
        }
        for p in state.native_plugins
    ] + [
        {
            "kind": p.kind,
            "description": f"WASM plugin {p.name}",
            "path": p.path,
            "abi_version": 1,
            "runtime": "wasm",
        }
        for p in state.wasm_plugins
    ]
    return web.json_response({"plugins": plugins})


async def upload_plugin(request: web.Request) -> web.Response:
    state = request.app["state"]
    denied = _denied(request, "load_plugins")
    if denied is not None:
        return denied
    reader = await request.multipart()
    saved_path = None
    runtime = None
    async for part in reader:
        if part.name == "file" and part.filename and part.filename.endswith((".so", ".wasm")):
            runtime = "wasm" if part.filename.endswith(".wasm") else "native"
            plugins_dir = os.path.join(state.config.plugins_dir, runtime)
            os.makedirs(plugins_dir, exist_ok=True)
            saved_path = os.path.join(plugins_dir, os.path.basename(part.filename))
            with open(saved_path, "wb") as f:
                while True:
                    chunk = await part.read_chunk()
                    if not chunk:
                        break
                    f.write(chunk)
    if saved_path is None:
        return web.json_response({"error": "no .so or .wasm file part"}, status=422)
    if runtime == "wasm":
        try:
            plugin = load_wasm_plugin(state.registry, saved_path)
        except (ValueError, RuntimeError) as e:
            os.remove(saved_path)
            return web.json_response({"error": str(e)}, status=422)
        state.wasm_plugins.append(plugin)
        return web.json_response({"kind": plugin.kind, "description": f"WASM plugin {plugin.name}"}, status=201)
    try:
        plugin = load_native_plugin(state.registry, saved_path)
    except PluginError as e:
        os.remove(saved_path)
        return web.json_response({"error": str(e)}, status=422)
    state.native_plugins.append(plugin)
    return web.json_response({"kind": plugin.kind, "description": plugin.description}, status=201)


async def delete_plugin(request: web.Request) -> web.Response:
    state = request.app["state"]
    denied = _denied(request, "delete_plugins")
    if denied is not None:
        return denied
    kind = request.match_info["kind"]
    for p in list(state.wasm_plugins):
        if p.kind == kind:
            state.registry.unregister(kind)
            state.wasm_plugins.remove(p)
            return web.json_response({"removed": kind})
    for p in list(state.native_plugins):
        if p.kind == kind:
            state.registry.unregister(kind)
            state.native_plugins.remove(p)
            try:
                os.remove(p.path)
            except OSError:
                pass
            return web.json_response({"deleted": kind})
    return web.json_response({"error": f"unknown plugin {kind!r}"}, status=404)


def add_plugin_routes(app: web.Application, prefix: str) -> None:
    app.router.add_get(f"{prefix}/api/v1/plugins", list_plugins)
    app.router.add_post(f"{prefix}/api/v1/plugins", upload_plugin)
    app.router.add_delete(f"{prefix}/api/v1/plugins/{{kind:.+}}", delete_plugin)
