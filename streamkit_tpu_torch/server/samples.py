# SPDX-License-Identifier: Apache-2.0
"""Sample-pipeline and audio-asset CRUD.

Parity with reference ``apps/skit/src/samples.rs`` (653 LoC) + ``assets.rs``
(524 LoC): sample YAML pipelines under ``{samples_dir}/{system,user}``, audio
assets with ``.license`` sidecars, glob-based read/write permissions, path
traversal guards (``file_security.rs``).
"""

from __future__ import annotations

import os
import re
from typing import Optional

from . import http as web

from .permissions import PermissionDenied

_SAFE_ID = re.compile(r"^[A-Za-z0-9._\-]+$")


def _safe_join(root: str, *parts: str) -> str:
    """Path traversal guard (reference ``file_security.rs``)."""
    for p in parts:
        if not _SAFE_ID.match(p):
            raise web.HTTPUnprocessableEntity(text=f"invalid path component: {p!r}")
    path = os.path.realpath(os.path.join(root, *parts))
    rootr = os.path.realpath(root)
    if not (path == rootr or path.startswith(rootr + os.sep)):
        raise web.HTTPForbidden(text="path escapes storage root")
    return path


def _sample_info(path: str, is_system: bool) -> dict:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    name = os.path.splitext(os.path.basename(path))[0]
    mode = "dynamic"
    description = ""
    for line in text.splitlines():
        if line.startswith("mode:"):
            mode = line.split(":", 1)[1].strip()
        elif line.startswith("description:"):
            description = line.split(":", 1)[1].strip()
    return {
        "id": os.path.basename(path),
        "name": name,
        "description": description,
        "yaml": text,
        "is_system": is_system,
        "mode": mode,
        "is_fragment": False,
    }


async def list_samples(request: web.Request) -> web.Response:
    state = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("list_samples")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    out = []
    for sub, is_system in (("system", True), ("user", False)):
        d = os.path.join(state.config.samples_dir, "pipelines", sub)
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if fn.endswith((".yml", ".yaml")) and perms.sample_allowed(fn):
                out.append(_sample_info(os.path.join(d, fn), is_system))
    return web.json_response({"samples": out})


async def get_sample(request: web.Request) -> web.Response:
    state = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("read_samples")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    sample_id = request.match_info["id"]
    if not perms.sample_allowed(sample_id):
        return web.json_response({"error": "sample not allowed"}, status=403)
    for sub, is_system in (("system", True), ("user", False)):
        root = os.path.join(state.config.samples_dir, "pipelines", sub)
        try:
            path = _safe_join(root, sample_id)
        except web.HTTPError as e:
            return web.json_response({"error": e.text}, status=e.status)
        if os.path.isfile(path):
            return web.json_response(_sample_info(path, is_system))
    return web.json_response({"error": "not found"}, status=404)


async def save_sample(request: web.Request) -> web.Response:
    state = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("write_samples")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    body = await request.json()
    name = body.get("name", "")
    if not _SAFE_ID.match(name or ""):
        return web.json_response({"error": "invalid sample name"}, status=422)
    root = os.path.join(state.config.samples_dir, "pipelines", "user")
    os.makedirs(root, exist_ok=True)
    path = _safe_join(root, f"{name}.yml" if not name.endswith((".yml", ".yaml")) else name)
    if os.path.exists(path) and not body.get("overwrite"):
        return web.json_response({"error": "sample exists (set overwrite)"}, status=409)
    # validate before writing
    from ..api.yaml_compiler import compile_yaml
    from ..core import ConfigurationError

    try:
        compile_yaml(body.get("yaml", ""))
    except ConfigurationError as e:
        return web.json_response({"error": f"invalid pipeline: {e}"}, status=422)
    with open(path, "w", encoding="utf-8") as f:
        f.write(body.get("yaml", ""))
    return web.json_response({"id": os.path.basename(path)}, status=201)


async def delete_sample(request: web.Request) -> web.Response:
    state = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("delete_samples")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    root = os.path.join(state.config.samples_dir, "pipelines", "user")
    try:
        path = _safe_join(root, request.match_info["id"])
    except web.HTTPError as e:
        return web.json_response({"error": e.text}, status=e.status)
    if not os.path.isfile(path):
        return web.json_response({"error": "not found"}, status=404)
    os.remove(path)
    return web.json_response({"deleted": request.match_info["id"]})


async def list_assets(request: web.Request) -> web.Response:
    state = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("list_samples")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    out = []
    for sub, is_system in (("system", True), ("user", False)):
        d = os.path.join(state.config.assets_dir, sub)
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".license"):
                continue
            ext = os.path.splitext(fn)[1].lstrip(".")
            if ext not in ("opus", "ogg", "flac", "mp3", "wav", "m4a"):
                continue
            full = os.path.join(d, fn)
            license_path = full + ".license"
            lic = None
            if os.path.exists(license_path):
                with open(license_path, encoding="utf-8") as f:
                    lic = f.read().strip()
            out.append(
                {
                    "id": fn,
                    "name": os.path.splitext(fn)[0],
                    "path": full,
                    "format": ext,
                    "size_bytes": os.path.getsize(full),
                    "license": lic,
                    "is_system": is_system,
                }
            )
    return web.json_response({"assets": out})


async def upload_asset(request: web.Request) -> web.Response:
    state = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("upload_assets")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    reader = await request.multipart()
    saved = None
    async for part in reader:
        if part.name == "file" and part.filename:
            root = os.path.join(state.config.assets_dir, "user")
            os.makedirs(root, exist_ok=True)
            path = _safe_join(root, os.path.basename(part.filename))
            with open(path, "wb") as f:
                while True:
                    chunk = await part.read_chunk()
                    if not chunk:
                        break
                    f.write(chunk)
            saved = os.path.basename(path)
    if saved is None:
        return web.json_response({"error": "no file part"}, status=422)
    return web.json_response({"id": saved}, status=201)


async def delete_asset(request: web.Request) -> web.Response:
    state = request.app["state"]
    role, perms = state.roles.extract(request.headers)
    try:
        perms.check("delete_assets")
    except PermissionDenied as e:
        return web.json_response({"error": str(e)}, status=403)
    root = os.path.join(state.config.assets_dir, "user")
    try:
        path = _safe_join(root, request.match_info["id"])
    except web.HTTPError as e:
        return web.json_response({"error": e.text}, status=e.status)
    if not os.path.isfile(path):
        return web.json_response({"error": "not found"}, status=404)
    os.remove(path)
    if os.path.exists(path + ".license"):
        os.remove(path + ".license")
    return web.json_response({"deleted": request.match_info["id"]})


def add_sample_routes(app: web.Application, prefix: str) -> None:
    app.router.add_get(f"{prefix}/api/v1/samples", list_samples)
    app.router.add_get(f"{prefix}/api/v1/samples/{{id}}", get_sample)
    app.router.add_post(f"{prefix}/api/v1/samples", save_sample)
    app.router.add_delete(f"{prefix}/api/v1/samples/{{id}}", delete_sample)
    app.router.add_get(f"{prefix}/api/v1/assets", list_assets)
    app.router.add_post(f"{prefix}/api/v1/assets", upload_asset)
    app.router.add_delete(f"{prefix}/api/v1/assets/{{id}}", delete_asset)
