# SPDX-License-Identifier: Apache-2.0
"""The port's server against the JAX package's: both run on 127.0.0.1 in one
test (the JAX server through aiohttp's ``TestServer``, the port's through
``create_app(device="cpu")`` on its own HTTP layer), and the same requests,
sent by aiohttp's client to each, get the same status codes and bodies.

Case for case the mirror of ``tests/test_server.py`` (its plugin-route case
is in ``tests/test_torch_plugins.py``), plus a oneshot STT request
through a small f32 Whisper whose Transcription lines equal the JAX
server's. Bodies that carry a session id or a time are compared with those
fields normalised."""

import asyncio
import contextlib
import json
import re

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestServer
import torch

import streamkit_tpu.server as jax_server
import streamkit_tpu_torch.server as torch_server
from streamkit_tpu_torch.server.http import AppRunner
from _torch_native import point_jax_av
from test_server import DOUBLE_VOLUME_YAML, make_wav
from test_torch_whisper_node import _json_key, hf_dir, speech_wav, stt_doc  # noqa: F401  (module fixture)

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

PACKAGES = ("jax", "torch")


def configs(**fields):
    """The same ``ServerConfig`` for both packages, each without its
    WebTransport acceptor (whose default UDP port 4443 one test process
    cannot bind twice; ``tests/test_torch_webtransport.py`` binds port 0)."""
    out = {}
    for pkg, mod in (("jax", jax_server), ("torch", torch_server)):
        cfg = mod.ServerConfig()
        cfg.moq_enabled = False
        for k, v in fields.items():
            setattr(cfg, k, v)
        out[pkg] = cfg
    return out


@contextlib.asynccontextmanager
async def serve(pkg: str, cfg=None):
    """One server on 127.0.0.1 → (app, base URL)."""
    cfg = cfg or configs()[pkg]
    if pkg == "jax":
        app = jax_server.create_app(cfg)
        server = TestServer(app, host="127.0.0.1")
        await server.start_server()
        try:
            yield app, str(server.make_url("")).rstrip("/")
        finally:
            await server.close()
    else:
        app = torch_server.create_app(cfg, device="cpu")
        runner = AppRunner(app)
        port = await runner.start("127.0.0.1", 0)
        try:
            yield app, f"http://127.0.0.1:{port}"
        finally:
            await runner.cleanup()


def on_both(scenario, **cfg_fields):
    """Run ``scenario(session, base, app)`` against each server; → {pkg: result}."""

    async def main():
        out = {}
        cfgs = configs(**cfg_fields)
        for pkg in PACKAGES:
            async with serve(pkg, cfgs[pkg]) as (app, base):
                async with aiohttp.ClientSession() as session:
                    out[pkg] = await scenario(session, base, app)
        return out

    return asyncio.run(main())


async def fetch(session, method, url, **kw):
    """→ (status, media type, body bytes)."""
    async with session.request(method, url, **kw) as r:
        return r.status, r.content_type, await r.read()


_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
_TIME = re.compile(r"\d{4}-\d\d-\d\dT\d\d:\d\d:\d\d(\.\d+)?Z?")


def norm(obj):
    """A JSON value with session ids and times replaced by placeholders."""
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    if isinstance(obj, str):
        return _TIME.sub("<time>", _UUID.sub("<id>", obj))
    return obj


def same(got):
    assert got["torch"] == got["jax"], (got["torch"], got["jax"])
    return got["torch"]


def wav_form(yaml_text, wav, name="in.wav"):
    form = aiohttp.FormData()
    form.add_field("config", yaml_text)
    form.add_field("media", wav, filename=name, content_type="audio/wav")
    return form


# -- the mirror of tests/test_server.py ----------------------------------------
def test_healthz():
    got = on_both(lambda s, base, app: fetch(s, "GET", base + "/healthz"))
    status, ctype, body = same(got)
    assert status == 200 and ctype == "application/json" and json.loads(body) == {"status": "ok"}


def test_oneshot_process_multipart():
    x = (np.ones(9600) * 0.25).astype(np.float32)

    async def scenario(s, base, app):
        async with s.post(base + "/api/v1/process", data=wav_form(DOUBLE_VOLUME_YAML, make_wav(x))) as r:
            return r.status, r.headers["Content-Type"], await r.read()

    status, ctype, body = same(on_both(scenario))
    assert status == 200 and ctype == "audio/wav"
    y = np.frombuffer(body[44:], dtype="<i2").astype(np.float32) / 32768.0
    np.testing.assert_allclose(y[:9600], 0.5, atol=2e-3)


def test_oneshot_bad_yaml_422():
    async def scenario(s, base, app):
        form = aiohttp.FormData()
        form.add_field("config", "nodes:\n  a: {kind: x, needs: a}")
        form.add_field("media", b"x")
        return await fetch(s, "POST", base + "/api/v1/process", data=form)

    status, _, body = same(on_both(scenario))
    assert status == 422 and "Circular" in json.loads(body)["error"]


@pytest.mark.parametrize("path", ["/api/v1/schema/packets", "/api/v1/permissions", "/api/v1/config",
                                  "/nope", "/api/v1/sessions/x/nope"])
def test_schema_permissions_config_and_unknown_routes(path):
    status, _, body = same(on_both(lambda s, base, app: fetch(s, "GET", base + path)))
    if path.endswith("nope"):
        assert status == 404 and body == b"404: Not Found"
    else:
        assert status == 200 and json.loads(body)


def test_schema_nodes_agree_on_every_ported_kind(monkeypatch):
    """The port lists the kinds it registers; each is listed as the JAX
    server lists it (the MoQ publisher's input also takes Binary). The JAX
    libav node loads a shim built here from ``native/shims`` where libav is
    present and none where it is absent, as the port builds its own: both
    list ``audio::flac::decoder`` or neither does, whether or not
    ``native/build/`` exists."""
    from streamkit_tpu_torch.nodes.codecs import flac_available

    assert (point_jax_av(monkeypatch) is not None) == flac_available()
    got = on_both(lambda s, base, app: fetch(s, "GET", base + "/api/v1/schema/nodes"))
    defs = {pkg: {d["kind"]: d for d in json.loads(got[pkg][2])["nodes"]} for pkg in PACKAGES}
    assert got["jax"][0] == got["torch"][0] == 200
    assert {"audio::gain", "core::passthrough", "transport::moq::peer", "transport::http::fetcher"} <= set(defs["torch"])
    assert set(defs["torch"]) <= set(defs["jax"])
    for kind, d in defs["torch"].items():
        want = json.loads(json.dumps(defs["jax"][kind]))
        if kind == "transport::moq::publisher":
            (pin,) = want["input_pins"]
            pin["accepts_types"] = pin["accepts_types"] + [{"type": "binary"}]
        assert d == want, kind


def test_session_rest_lifecycle(tmp_path):
    wav_path = tmp_path / "in.wav"
    wav_path.write_bytes(make_wav(np.zeros(4800, np.float32)))
    yaml_text = f"""
mode: dynamic
nodes:
  reader:
    kind: core::file_reader
    params: {{path: "{wav_path}"}}
  sink: {{kind: core::sink, needs: reader}}
"""

    async def scenario(s, base, app):
        out = [await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "it-sess", "yaml": yaml_text})]
        sid = json.loads(out[0][2])["session_id"]
        out.append(await fetch(s, "GET", base + "/api/v1/sessions"))
        status, ctype, body = await fetch(s, "GET", base + f"/api/v1/sessions/{sid}/pipeline")
        pipe = json.loads(body)["pipeline"]
        out.append((status, sorted((n, v["kind"]) for n, v in pipe["nodes"].items()), pipe["connections"]))
        out.append(await fetch(s, "DELETE", base + f"/api/v1/sessions/{sid}"))
        out.append(await fetch(s, "GET", base + "/api/v1/sessions"))
        return [(o[0], norm(json.loads(o[2]))) if isinstance(o[2], bytes) else o for o in out]

    out = same(on_both(scenario))
    assert [o[0] for o in out] == [201, 200, 200, 200, 200]
    assert out[2][1] == [("reader", "core::file_reader"), ("sink", "core::sink")]
    assert out[4][1] == {"sessions": []}


async def _ws_request(ws, action, **fields):
    corr = f"c-{action}"
    await ws.send_json({"type": "request", "correlation_id": corr, "payload": {"action": action, **fields}})
    while True:  # skip events until the correlated response arrives
        msg = json.loads((await ws.receive()).data)
        if msg["type"] == "response" and msg.get("correlation_id") == corr:
            return msg["payload"]


def test_ws_control_plane_full_flow(tmp_path):
    wav_path = tmp_path / "in.wav"
    wav_path.write_bytes(make_wav(np.ones(48000, np.float32) * 0.25))

    async def scenario(s, base, app):
        out_path = tmp_path / f"out-{id(app)}.wav"
        ws = await s.ws_connect(base + "/api/v1/control")
        replies = []
        p = await _ws_request(ws, "createsession", name="ws-sess")
        sid = p["session_id"]
        replies.append(p)
        p = await _ws_request(ws, "listnodes")
        replies.append((p["action"], len(p["nodes"]) > 10))
        for node_id, kind, params in [
            ("reader", "core::file_reader", {"path": str(wav_path)}),
            ("demux", "containers::wav::demuxer", None),
            ("gain", "audio::gain", {"gain": 2.0}),
            ("mux", "containers::wav::muxer", None),
            ("writer", "core::file_writer", {"path": str(out_path)}),
        ]:
            replies.append(await _ws_request(ws, "addnode", session_id=sid, node_id=node_id, kind=kind,
                                             params=params))
        for a, b in [("reader", "demux"), ("demux", "gain"), ("gain", "mux"), ("mux", "writer")]:
            replies.append(await _ws_request(ws, "connect", session_id=sid, from_node=a, from_pin="out",
                                             to_node=b, to_pin="in"))
        replies.append(await _ws_request(ws, "tunenode", session_id=sid, node_id="gain",
                                         message={"type": "update_params", "params": {"gain": 1.0}}))
        for _ in range(200):
            await asyncio.sleep(0.05)
            p = await _ws_request(ws, "getpipeline", session_id=sid)
            states = [n.get("state") for n in p["pipeline"]["nodes"].values()]
            if all(isinstance(st, dict) and "stopped" in st for st in states):
                break
        replies.append(sorted(p["pipeline"]["nodes"]))
        replies.append(await _ws_request(ws, "destroysession", session_id=sid))
        await ws.close()
        return norm(replies), out_path.read_bytes()

    replies, data = same(on_both(scenario))
    assert replies[0]["action"] == "sessioncreated" and replies[-1]["action"] == "sessiondestroyed"
    assert all(r == {"action": "success"} for r in replies[2:12])
    assert data[:4] == b"RIFF"


def test_ws_error_paths():
    async def scenario(s, base, app):
        ws = await s.ws_connect(base + "/api/v1/control")
        out = []
        await ws.send_str("not json")
        out.append(json.loads((await ws.receive()).data))
        for corr, payload in (("x", {"action": "nonexistent"}), ("y", {"action": "getpipeline", "session_id": "ghost"})):
            await ws.send_json({"type": "request", "correlation_id": corr, "payload": payload})
            out.append(json.loads((await ws.receive()).data))
        await ws.close()
        return out

    out = same(on_both(scenario))
    assert out[0]["payload"]["action"] == "error"
    assert "unknown action" in out[1]["payload"]["message"]
    assert "unknown session" in out[2]["payload"]["message"]


def test_rbac_viewer_role_denied():
    async def scenario(s, base, app):
        status, _, body = await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "x"})
        ws = await s.ws_connect(base + "/api/v1/control")
        await ws.send_json({"type": "request", "correlation_id": "c", "payload": {"action": "createsession"}})
        msg = json.loads((await ws.receive()).data)
        await ws.close()
        return status, json.loads(body), msg

    status, body, msg = same(on_both(scenario, default_role="viewer",
                                     roles={"viewer": {"list_sessions": True, "list_nodes": True}}))
    assert status == 403 and "permission denied" in msg["payload"]["message"]


def test_samples_crud(tmp_path):
    async def scenario(s, base, app):
        app["state"].config.samples_dir = str(tmp_path / str(id(app)))
        out = [await fetch(s, "POST", base + "/api/v1/samples",
                           json={"name": "mytest", "yaml": "mode: dynamic\nnodes:\n  a: {kind: core::sink}\n"})]
        out.append(await fetch(s, "GET", base + "/api/v1/samples"))
        out.append(await fetch(s, "GET", base + "/api/v1/samples/mytest.yml"))
        out.append(await fetch(s, "POST", base + "/api/v1/samples",
                               json={"name": "bad", "yaml": "nodes:\n  a: {kind: x, needs: a}"}))
        out.append(await fetch(s, "GET", base + "/api/v1/samples/..%2Fsecret"))
        out.append(await fetch(s, "DELETE", base + "/api/v1/samples/mytest.yml"))
        return [(st, ct, body) for st, ct, body in out]

    out = same(on_both(scenario))
    assert [o[0] for o in out][:4] == [201, 200, 200, 422] and out[4][0] in (403, 404, 422) and out[5][0] == 200
    assert json.loads(out[2][2])["mode"] == "dynamic"


@pytest.mark.parametrize("path", ["/monitor", "/", "/ui"])
def test_web_ui_served(path):
    status, ctype, body = same(on_both(lambda s, base, app: fetch(s, "GET", base + path)))
    assert status == 200 and ctype == "text/html"
    text = body.decode()
    assert "monitor" in text if path == "/monitor" else ("Design" in text and "Convert" in text)


def test_origin_guard():
    async def scenario(s, base, app):
        out = []
        for headers in ({"Origin": "https://evil.example"}, {"Origin": "https://good.example"}, {}):
            async with s.get(base + "/healthz", headers=headers) as r:
                out.append((r.status, await r.read(), r.headers.get("X-Content-Type-Options")))
        return out

    out = same(on_both(scenario, allowed_origins=["https://good.example"]))
    assert [o[0] for o in out] == [403, 200, 200] and out[2][2] == "nosniff"


def test_nonloopback_admin_refusal():
    got = {}
    for pkg, mod in (("jax", jax_server), ("torch", torch_server)):
        cfg = configs(address="0.0.0.0")[pkg]
        with pytest.raises(SystemExit, match="refusing") as e:
            mod.run_server(cfg)
        got[pkg] = str(e.value)
    same(got)


def test_duplicate_session_name_409_no_leak():
    async def scenario(s, base, app):
        r1 = await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "dup"})
        r2 = await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "dup"})
        return r1[0], r2[0], json.loads(r2[2]), len(app["state"].sessions.list())

    assert same(on_both(scenario)) == (201, 409, {"error": "session name 'dup' already in use"}, 1)


def test_session_ownership_on_http_routes():
    roles = {"alice": {"create_sessions": True, "list_sessions": True, "destroy_sessions": True},
             "bob": {"create_sessions": True, "list_sessions": True, "destroy_sessions": True}}

    async def scenario(s, base, app):
        st, _, body = await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "a1"}, headers={"X-Role": "alice"})
        sid = json.loads(body)["session_id"]
        out = [st]
        for method, path, role in (("GET", "/pipeline", "bob"), ("DELETE", "", "bob"), ("GET", "/pipeline", "alice"),
                                   ("DELETE", "", "alice")):
            r = await fetch(s, method, base + f"/api/v1/sessions/{sid}{path}", headers={"X-Role": role})
            out.append((r[0], norm(json.loads(r[2])) if r[0] == 403 or method == "DELETE" else None))
        return out

    out = same(on_both(scenario, role_header="X-Role", roles=roles, default_role="alice"))
    assert out[0] == 201 and [o[0] for o in out[1:]] == [403, 403, 200, 200]


def test_validate_endpoint():
    async def scenario(s, base, app):
        out = []
        for body in ({"yaml": DOUBLE_VOLUME_YAML}, {"yaml": "mode: oneshot\nsteps:\n  - kind: no::such::node\n"},
                     {"yaml": "steps: [}"}):
            out.append(await fetch(s, "POST", base + "/api/v1/validate", json=body))
        out.append(await fetch(s, "POST", base + "/api/v1/validate", data=b"not json",
                               headers={"Content-Type": "application/json"}))
        return out

    out = same(on_both(scenario))
    first = json.loads(out[0][2])
    assert first["valid"] is True and len(first["pipeline"]["nodes"]) == 5
    assert json.loads(out[1][2])["valid"] is False and json.loads(out[2][2])["valid"] is False
    assert out[3][0] == 422


def test_max_concurrent_sessions_limit():
    async def scenario(s, base, app):
        out, ids = [], []
        for i in range(3):
            r = await fetch(s, "POST", base + "/api/v1/sessions", json={"name": f"s{i}"})
            out.append((r[0], norm(json.loads(r[2]))))
            if r[0] == 201:
                ids.append(json.loads(r[2])["session_id"])
        ws = await s.ws_connect(base + "/api/v1/control")
        await ws.send_json({"type": "request", "correlation_id": "c1", "payload": {"action": "createsession"}})
        out.append(json.loads((await ws.receive()).data))
        out.append((await fetch(s, "DELETE", base + f"/api/v1/sessions/{ids[0]}"))[0])
        out.append((await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "s3"}))[0])
        await ws.close()
        return out

    out = same(on_both(scenario, max_concurrent_sessions=2))
    assert [o[0] for o in out[:3]] == [201, 201, 503]
    assert "Maximum concurrent sessions limit reached" in out[3]["payload"]["message"]
    assert out[4:] == [200, 201]


def test_max_concurrent_oneshots_queues():
    wav = make_wav(np.full(4800, 0.25, np.float32))

    async def scenario(s, base, app):
        async def one():
            return await fetch(s, "POST", base + "/api/v1/process", data=wav_form(DOUBLE_VOLUME_YAML, wav))

        return await asyncio.gather(*(one() for _ in range(3)))

    out = same(on_both(scenario, max_concurrent_oneshots=1))
    assert [o[0] for o in out] == [200, 200, 200] and out[0][2] == out[1][2] == out[2][2]


def test_metrics_endpoint():
    """The mirror of ``tests/test_moq.py::test_metrics_endpoint``."""

    async def scenario(s, base, app):
        await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "m"})
        status, ctype, body = await fetch(s, "GET", base + "/api/v1/metrics")
        names = sorted({line.split("{")[0].split(" ")[0] for line in body.decode().splitlines()
                        if line and not line.startswith("#")})
        return status, ctype, "skit_sessions_active 1" in body.decode(), names

    status, ctype, active, names = same(on_both(scenario))
    assert status == 200 and ctype == "text/plain" and active and "skit_uptime_seconds" in names


# -- beyond the mirror ---------------------------------------------------------
def test_oneshot_stt_lines_equal_jax(hf_dir):  # noqa: F811
    """A small f32 Whisper (the shared HF checkpoint) behind both servers:
    the same multipart request gives the same Transcription lines."""
    import yaml

    params = dict(model_path=hf_dir, dtype="float32", max_tokens=8, language="en")
    doc = stt_doc(params)
    body = speech_wav()

    async def scenario(s, base, app):
        status, ctype, out = await fetch(s, "POST", base + "/api/v1/process", data=wav_form(yaml.safe_dump(doc), body))
        return status, ctype, [_json_key(json.loads(line)) for line in out.decode().splitlines() if line.strip()]

    status, ctype, lines = same(on_both(scenario))
    assert status == 200 and ctype == "application/json" and lines
    assert all(text and "<" not in text for text, _, _ in lines)


def test_raw_body_with_config_in_query():
    """A non-multipart oneshot: the body is the media, the YAML rides in
    ``?config=`` (``app.py``'s second branch), sent chunked by the client."""
    wav = make_wav(np.full(4800, 0.25, np.float32))

    async def scenario(s, base, app):
        async def gen():
            for i in range(0, len(wav), 1000):
                yield wav[i : i + 1000]

        return await fetch(s, "POST", base + "/api/v1/process", params={"config": DOUBLE_VOLUME_YAML}, data=gen(),
                           headers={"Content-Type": "audio/wav"})

    status, ctype, body = same(on_both(scenario))
    assert status == 200 and ctype == "audio/wav" and len(body) > 44


def test_body_above_max_body_size_is_413():
    """``max_body_size`` refuses a body that reaches it, as aiohttp's
    ``client_max_size`` does (the JAX server's limit)."""
    wav = make_wav(np.zeros(4096, np.float32))

    async def scenario(s, base, app):
        return await fetch(s, "POST", base + "/api/v1/process", params={"config": DOUBLE_VOLUME_YAML}, data=wav,
                           headers={"Content-Type": "audio/wav"})

    got = on_both(scenario, max_body_size=4096)
    assert got["jax"][0] == got["torch"][0] == 413
    for status, ctype, body in got.values():
        assert body.startswith(b"Maximum request body size 4096 exceeded, actual body size ")
