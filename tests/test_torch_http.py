# SPDX-License-Identifier: Apache-2.0
"""The port's HTTP/1.1 and WebSocket layer (``server/http.py``), held
against independent implementations: raw frames and requests written here
byte by byte, aiohttp's client against the port's server, the port's client
against an aiohttp server, and the JAX server (aiohttp) where both servers
must answer alike.

Covers keep-alive, chunked request bodies (with extensions and trailers),
streamed responses that reach the client before the pipeline ends, a client
that leaves mid-stream (its pipeline is cancelled), WebSocket fragmentation
with a ping between fragments, ping / pong, 1009 on an oversized message, an
unmasked client frame refused, the fetcher node against the server's asset
files, and ``serve --port 0`` as a subprocess."""

import asyncio
import base64
import json
import os
import re
import signal
import struct
import subprocess
import sys
import time

import aiohttp
import numpy as np
from aiohttp import web as aioweb
import torch

import streamkit_tpu_torch.server.app as torch_app
from streamkit_tpu_torch.server import http
from test_server import DOUBLE_VOLUME_YAML, make_wav
from test_torch_server import configs, fetch, same, serve

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(coro):
    return asyncio.run(coro)


async def raw_exchange(port: int, data: bytes, *, until: bytes = None, timeout: float = 10.0) -> bytes:
    """Write ``data`` on one connection; read until ``until`` appears (or EOF)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    out = b""
    try:
        async with asyncio.timeout(timeout):
            while until is None or until not in out:
                chunk = await reader.read(65536)
                if not chunk:
                    break
                out += chunk
    finally:
        writer.close()
    return out


def _port(base: str) -> int:
    return int(base.rsplit(":", 1)[1])


# -- HTTP/1.1 ------------------------------------------------------------------
def test_two_requests_on_one_keep_alive_connection():
    async def two():
        async with serve("torch") as (app, base):
            reader, writer = await asyncio.open_connection("127.0.0.1", _port(base))
            answers = []
            for _ in range(2):
                writer.write(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
                await writer.drain()
                head = await reader.readuntil(b"\r\n\r\n")
                n = int(re.search(rb"Content-Length: (\d+)", head).group(1))
                answers.append((head.split(b"\r\n")[0], await reader.readexactly(n)))
            writer.close()
            return answers

    answers = run(two())
    assert answers == [(b"HTTP/1.1 200 OK", b'{"status": "ok"}')] * 2


def test_connection_close_is_honoured():
    async def main():
        async with serve("torch") as (app, base):
            return await raw_exchange(_port(base), b"GET /healthz HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")

    out = run(main())  # read to EOF: the server closed after one answer
    assert out.startswith(b"HTTP/1.1 200 OK") and b"Connection: close" in out and out.endswith(b'{"status": "ok"}')


def test_chunked_request_body_with_extensions_and_trailers():
    """A chunked body written by hand (a chunk extension, a trailer) reaches
    the pipeline as its bytes; the JAX server gives the same response."""
    wav = make_wav(np.full(4800, 0.25, np.float32))
    pieces = [wav[i : i + 777] for i in range(0, len(wav), 777)]
    body = b"".join(b"%x;ext=1\r\n%b\r\n" % (len(p), p) for p in pieces) + b"0\r\nX-Trailer: 1\r\n\r\n"

    async def scenario(s, base, app):
        import urllib.parse

        target = "/api/v1/process?" + urllib.parse.urlencode({"config": DOUBLE_VOLUME_YAML})
        head = (f"POST {target} HTTP/1.1\r\nHost: x\r\nContent-Type: audio/wav\r\nTransfer-Encoding: chunked\r\n"
                "Connection: close\r\n\r\n").encode()
        out = await raw_exchange(_port(base), head + body)
        status = out.split(b"\r\n", 1)[0].split(b" ")[1]
        # de-chunk the response (both servers stream it chunked)
        rest, data = out.split(b"\r\n\r\n", 1)[1], b""
        while True:
            size, rest = rest.split(b"\r\n", 1)
            n = int(size, 16)
            if n == 0:
                break
            data, rest = data + rest[:n], rest[n + 2 :]
        return status, data

    status, data = same(on_both_raw(scenario))
    assert status == b"200" and data[:4] == b"RIFF" and len(data) == len(wav)


def on_both_raw(scenario, **cfg):
    async def main():
        out = {}
        cfgs = configs(**cfg)
        for pkg in ("jax", "torch"):
            async with serve(pkg, cfgs[pkg]) as (app, base):
                out[pkg] = await scenario(None, base, app)
        return out

    return run(main())


def test_multipart_body_above_max_body_size():
    """A multipart oneshot body past ``max_body_size``: the port refuses it
    with 413, as it refuses every body read past the limit; the JAX server
    reads it (aiohttp's ``client_max_size`` does not bound
    ``request.multipart()``) and answers 200."""
    wav = make_wav(np.zeros(9600, np.float32))

    async def scenario(s, base, app):
        form = aiohttp.FormData()
        form.add_field("config", DOUBLE_VOLUME_YAML)
        form.add_field("media", wav, filename="in.wav", content_type="audio/wav")
        return await fetch(s, "POST", base + "/api/v1/process", data=form)

    got = on_both(scenario, max_body_size=4096)
    assert got["jax"][0] == 200 and got["jax"][2][:4] == b"RIFF"
    assert got["torch"][0] == 413 and got["torch"][2].startswith(b"Maximum request body size 4096 exceeded")


PACED_YAML = """
mode: oneshot
steps:
  - kind: streamkit::http_input
  - kind: containers::wav::demuxer
  - kind: core::pacer
  - kind: containers::wav::muxer
  - kind: streamkit::http_output
"""


def test_response_chunks_arrive_before_the_pipeline_ends():
    """A paced pipeline (real time) over 2 s of audio: the first chunks
    reach the client while the pipeline still runs, seconds before its end."""
    wav = make_wav(np.full(32000, 0.25, np.float32), rate=16000)

    async def main():
        async with serve("torch") as (app, base):
            async with aiohttp.ClientSession() as s:
                form = aiohttp.FormData()
                form.add_field("config", PACED_YAML)
                form.add_field("media", wav, filename="in.wav", content_type="audio/wav")
                t0 = time.monotonic()
                arrivals, data = [], b""
                async with s.post(base + "/api/v1/process", data=form) as r:
                    assert r.status == 200 and r.headers["Transfer-Encoding"] == "chunked"
                    async for chunk in r.content.iter_any():
                        arrivals.append(time.monotonic() - t0)
                        data += chunk
                return arrivals, data

    arrivals, data = run(main())
    assert data[:4] == b"RIFF" and len(data) == len(wav)
    assert len(arrivals) > 3 and arrivals[-1] > 1.5 and arrivals[0] < arrivals[-1] - 1.0, arrivals


def test_client_leaving_mid_stream_cancels_the_pipeline(monkeypatch):
    """The client reads the first chunk of a 20 s paced response and closes
    the socket: the server cancels the pipeline (every node task ends) and
    stays up."""
    results = []
    real = torch_app.run_oneshot_pipeline

    async def recording(*a, **kw):
        results.append(await real(*a, **kw))
        return results[-1]

    monkeypatch.setattr(torch_app, "run_oneshot_pipeline", recording)
    wav = make_wav(np.full(16000 * 20, 0.25, np.float32), rate=16000)

    async def main():
        async with serve("torch") as (app, base):
            form = http.FormData()
            form.add_field("config", PACED_YAML)
            form.add_field("media", wav, filename="in.wav", content_type="audio/wav")
            resp = await http.ClientSession().post(base + "/api/v1/process", data=form)
            assert resp.status == 200
            async for _ in resp.iter_chunked(1024):
                break  # leave after the first chunk: the connection closes
            (result,) = results
            t0 = time.monotonic()
            while not all(t.done() for t in result.graph.tasks.values()):
                assert time.monotonic() - t0 < 10, "the pipeline was not cancelled"
                await asyncio.sleep(0.05)
            elapsed = time.monotonic() - t0
            async with aiohttp.ClientSession() as s:
                status = (await fetch(s, "GET", base + "/healthz"))[0]
            return elapsed, status, any(t.cancelled() for t in result.graph.tasks.values())

    elapsed, status, cancelled = run(main())
    assert elapsed < 10 and status == 200 and cancelled


def test_port_client_reads_an_aiohttp_server():
    """The port's client against aiohttp's server: JSON, a streamed chunked
    body, a multipart upload, and a WebSocket echo with a ping."""

    async def handler_stream(request):
        resp = aioweb.StreamResponse()
        await resp.prepare(request)
        for i in range(4):
            await resp.write(f"part{i};".encode())
            await asyncio.sleep(0.01)
        await resp.write_eof()
        return resp

    async def handler_form(request):
        fields = {}
        async for part in await request.multipart():
            fields[part.name] = [part.filename, (await part.read()).decode()]
        return aioweb.json_response(fields)

    async def handler_ws(request):
        ws = aioweb.WebSocketResponse()
        await ws.prepare(request)
        async for msg in ws:
            await ws.send_str("echo " + msg.data)
        return ws

    async def main():
        app = aioweb.Application()
        app.router.add_get("/s", handler_stream)
        app.router.add_post("/f", handler_form)
        app.router.add_get("/ws", handler_ws)
        runner = aioweb.AppRunner(app)
        await runner.setup()
        site = aioweb.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        base = f"http://127.0.0.1:{port}"
        try:
            s = http.ClientSession(timeout=10)
            async with s.get(base + "/s") as r:
                chunks = [c async for c in r.iter_chunked(64)]
            form = http.FormData()
            form.add_field("config", "a: 1")
            form.add_field("media", b"xyz", filename="m.bin", content_type="application/octet-stream")
            r = await s.post(base + "/f", data=form)
            fields = await r.json()
            ws = await s.ws_connect(base + "/ws")
            await ws.ping(b"p")
            await ws.send_str("hi")
            msg = await ws.receive(timeout=5)
            await ws.close()
            return b"".join(chunks), fields, msg.data
        finally:
            await runner.cleanup()

    body, fields, echo = run(main())
    assert body == b"part0;part1;part2;part3;"
    assert fields == {"config": [None, "a: 1"], "media": ["m.bin", "xyz"]}
    assert echo == "echo hi"


# -- WebSocket framing ---------------------------------------------------------
def client_frame(opcode: int, payload: bytes, fin: bool = True, mask: bool = True) -> bytes:
    """One RFC 6455 frame written here, independently of the port's framing."""
    b0 = (0x80 if fin else 0) | opcode
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", b0, (0x80 if mask else 0) | n)
    elif n < 65536:
        head = struct.pack("!BBH", b0, (0x80 if mask else 0) | 126, n)
    else:
        head = struct.pack("!BBQ", b0, (0x80 if mask else 0) | 127, n)
    if not mask:
        return head + payload
    key = os.urandom(4)
    return head + key + bytes(b ^ key[i % 4] for i, b in enumerate(payload))


async def read_server_frame(reader):
    b0, b1 = await reader.readexactly(2)
    assert not b1 & 0x80, "the server masked a frame"
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack("!H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack("!Q", await reader.readexactly(8))
    return b0 & 0x0F, await reader.readexactly(n)


async def raw_ws(port: int, path: str = "/api/v1/control"):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET {path} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n").encode())
    head = await reader.readuntil(b"\r\n\r\n")
    import hashlib

    accept = base64.b64encode(hashlib.sha1((key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode()).digest())
    assert head.startswith(b"HTTP/1.1 101") and b"Sec-WebSocket-Accept: " + accept in head, head
    return reader, writer


def test_ws_fragmented_request_with_a_ping_between_fragments():
    """A control-plane request in three fragments, a ping between the first
    two: the pong comes first, then the answer to the whole message; a close
    is answered with a close. Both servers alike."""
    request = json.dumps({"type": "request", "correlation_id": "f1", "payload": {"action": "listsessions"}}).encode()
    a, b, c = request[:10], request[10:30], request[30:]

    async def scenario(_, base, app):
        reader, writer = await raw_ws(_port(base))
        writer.write(client_frame(0x1, a, fin=False) + client_frame(0x9, b"hello")
                     + client_frame(0x0, b, fin=False) + client_frame(0x0, c, fin=True))
        got = [await read_server_frame(reader), await read_server_frame(reader)]
        writer.write(client_frame(0x8, struct.pack("!H", 1000)))
        op, payload = await read_server_frame(reader)
        writer.close()
        return got[0], (got[1][0], json.loads(got[1][1])), (op, struct.unpack("!H", payload[:2])[0])

    pong, answer, close = same(on_both_raw(scenario))
    assert pong == (0xA, b"hello")
    assert answer == (0x1, {"type": "response", "correlation_id": "f1",
                            "payload": {"action": "sessionslisted", "sessions": []}})
    assert close == (0x8, 1000)


def test_ws_ping_gets_a_pong():
    """aiohttp's client (its automatic pong handling off) pings the port's
    control plane and receives the pong with the same payload."""

    async def scenario(s, base, app):
        ws = await s.ws_connect(base + "/api/v1/control", autoping=False)
        await ws.ping(b"are you there")
        msg = await ws.receive(timeout=5)
        await ws.close()
        return msg.type.name, msg.data

    assert same(on_both(scenario)) == ("PONG", b"are you there")


def on_both(scenario, **cfg):
    async def main():
        out = {}
        cfgs = configs(**cfg)
        for pkg in ("jax", "torch"):
            async with serve(pkg, cfgs[pkg]) as (app, base):
                async with aiohttp.ClientSession() as s:
                    out[pkg] = await scenario(s, base, app)
        return out

    return run(main())


def test_ws_oversized_message_closes_1009():
    """A text message past the control plane's 1 MiB cap: close code 1009
    from both servers."""

    async def scenario(s, base, app):
        ws = await s.ws_connect(base + "/api/v1/control")
        await ws.send_str("x" * (1024 * 1024 + 10))
        msg = await ws.receive(timeout=10)
        await ws.close()
        return msg.type.name, ws.close_code

    assert same(on_both(scenario)) == ("CLOSE", 1009)


def test_ws_unmasked_client_frame_is_refused():
    """A client frame without a mask: the port's server closes with 1002
    (protocol error) and answers nothing else, as RFC 6455 §5.1 asks.
    (aiohttp's server, under the JAX package, reads such a frame.)"""

    async def main():
        async with serve("torch") as (app, base):
            reader, writer = await raw_ws(_port(base))
            msg = json.dumps({"type": "request", "correlation_id": "u", "payload": {"action": "listsessions"}})
            writer.write(client_frame(0x1, msg.encode(), mask=False))
            op, payload = await asyncio.wait_for(read_server_frame(reader), 5)
            rest = await asyncio.wait_for(reader.read(), 5)  # then the server closes the socket
            writer.close()
            return op, struct.unpack("!H", payload[:2])[0], rest

    assert run(main()) == (0x8, 1002, b"")


def test_port_ws_client_masks_and_the_server_answers():
    """The port's own client on the port's control plane: a request and its
    response, then a clean close (code 1000)."""

    async def main():
        async with serve("torch") as (app, base):
            ws = await http.ClientSession().ws_connect(base.replace("http", "ws") + "/api/v1/control")
            await ws.send_json({"type": "request", "correlation_id": "p", "payload": {"action": "getpermissions"}})
            msg = await ws.receive(timeout=5)
            closed = await ws.close()
            return msg.json(), closed, ws.close_code

    doc, closed, code = run(main())
    assert doc["payload"]["role"] == "admin" and closed and code == 1000


# -- the fetcher node ------------------------------------------------------------
def asset_file_app(root: str) -> http.Application:
    """Serves the files under ``root`` at ``/assets/{id}``: the JAX server has
    no route that returns an asset's bytes (``samples.py`` lists, uploads
    and deletes), so the fetcher reads the uploaded file from here."""

    async def get(request):
        path = os.path.join(root, os.path.basename(request.match_info["id"]))
        if not os.path.isfile(path):
            raise http.HTTPNotFound()
        return http.FileResponse(path)

    app = http.Application()
    app.router.add_get("/assets/{id}", get)
    return app


def test_fetcher_session_reads_an_uploaded_asset(tmp_path):
    """A WAV uploaded through ``POST /api/v1/assets`` and served back over
    HTTP; a dynamic session ``transport::http::fetcher → wav demuxer → gain
    → wav muxer → file_writer`` created through ``POST /api/v1/sessions``
    writes the same bytes on both servers (the JAX fetcher on aiohttp, the
    port's on its own client)."""
    wav = make_wav(np.full(9600, 0.25, np.float32))

    async def scenario(s, base, app):
        assets = tmp_path / f"assets-{id(app)}"
        app["state"].config.assets_dir = str(assets)
        form = aiohttp.FormData()
        form.add_field("file", wav, filename="tone.wav", content_type="audio/wav")
        up = await fetch(s, "POST", base + "/api/v1/assets", data=form)
        files = http.AppRunner(asset_file_app(str(assets / "user")))
        fport = await files.start("127.0.0.1", 0)
        out_path = tmp_path / f"out-{id(app)}.wav"
        yaml_text = f"""
mode: dynamic
nodes:
  fetch:
    kind: transport::http::fetcher
    params: {{url: "http://127.0.0.1:{fport}/assets/tone.wav", chunk_size: 4096}}
  demux: {{kind: containers::wav::demuxer, needs: fetch}}
  gain: {{kind: audio::gain, params: {{gain: 2.0}}, needs: demux}}
  mux: {{kind: containers::wav::muxer, needs: gain}}
  writer: {{kind: core::file_writer, params: {{path: "{out_path}"}}, needs: mux}}
"""
        try:
            created = await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "fetch", "yaml": yaml_text})
            sid = json.loads(created[2])["session_id"]
            for _ in range(200):
                await asyncio.sleep(0.05)
                pipe = json.loads((await fetch(s, "GET", base + f"/api/v1/sessions/{sid}/pipeline"))[2])
                states = [n.get("state") for n in pipe["pipeline"]["nodes"].values()]
                if all(isinstance(st, dict) and "stopped" in st for st in states):
                    break
            await fetch(s, "DELETE", base + f"/api/v1/sessions/{sid}")
        finally:
            await files.cleanup()
        return up[0], json.loads(up[2]), created[0], out_path.read_bytes()

    up_status, up_body, created, data = same(on_both(scenario))
    assert up_status == 201 and up_body == {"id": "tone.wav"} and created == 201
    y = np.frombuffer(data[44:], dtype="<i2").astype(np.float32) / 32768.0
    assert data[:4] == b"RIFF" and len(y) == 9600
    np.testing.assert_allclose(y, 0.5, atol=2e-3)


def test_oneshot_refuses_a_fetcher_source_in_both():
    """A oneshot pipeline whose only source is the fetcher is refused by both
    engines (only ``http_input`` and ``file_reader`` start a oneshot; the
    fetcher waits for a Start that only the dynamic engine sends)."""
    yaml_text = """
mode: oneshot
steps:
  - kind: transport::http::fetcher
    params: {url: "http://127.0.0.1:9/x.wav"}
  - kind: containers::wav::demuxer
  - kind: streamkit::http_output
"""

    async def scenario(s, base, app):
        return await fetch(s, "POST", base + "/api/v1/process", params={"config": yaml_text}, data=b"")

    status, _, body = same(on_both(scenario))
    assert status == 422 and b"requires an input" in body


# -- the entry point -------------------------------------------------------------
def test_serve_port_0_subprocess_on_cpu(tmp_path):
    """``python -m streamkit_tpu_torch.server serve --port 0 --device cpu``
    binds an ephemeral port, logs it, answers, and exits 0 on SIGINT; its
    WebTransport acceptor (``[moq] port = 0`` in the config) binds an
    ephemeral UDP port, logs it and reports it on the fingerprint route."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    config = tmp_path / "skit.toml"
    config.write_text("[moq]\nport = 0\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "streamkit_tpu_torch.server", "serve", "--address", "127.0.0.1", "--port", "0",
         "--device", "cpu", "--config", str(config)], cwd=str(tmp_path), env=env, stderr=subprocess.PIPE,
        text=True)
    try:
        port, lines = None, []
        deadline = time.monotonic() + 120
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"serving on 127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "".join(lines)

        async def ask():
            async with aiohttp.ClientSession() as s:
                health = await fetch(s, "GET", f"http://127.0.0.1:{port}/healthz")
                nodes = await fetch(s, "GET", f"http://127.0.0.1:{port}/api/v1/schema/nodes")
                fps = await fetch(s, "GET", f"http://127.0.0.1:{port}/api/v1/moq/fingerprints")
                return health, {n["kind"] for n in json.loads(nodes[2])["nodes"]}, json.loads(fps[2])

        (status, _, body), kinds, fps = run(ask())
        assert status == 200 and json.loads(body) == {"status": "ok"}
        assert "transport::moq::publisher" in kinds and "plugin::native::whisper" in kinds
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    log = "".join(lines)
    udp = re.search(r"WebTransport MoQ acceptor on udp/(\d+)", log)
    assert "device=cpu" in log and udp and int(udp.group(1)) == fps["port"] > 0, log
    assert len(fps["fingerprints"]) == 1


def test_cli_commands_against_the_port_server(tmp_path, capsys):
    """The CLI's ``oneshot``, ``create``, ``list``, ``destroy``, ``nodes``,
    ``plugins list`` and ``moq subscribe`` against a port server on the CPU:
    ``moq subscribe --frames 3`` takes three frames of a relay broadcast over
    WebTransport, writes their payloads to stdout and exits 0."""
    from streamkit_tpu_torch.cli.main import main as cli_main

    pipeline = tmp_path / "p.yml"
    pipeline.write_text(DOUBLE_VOLUME_YAML)
    media = tmp_path / "in.wav"
    media.write_bytes(make_wav(np.full(4800, 0.25, np.float32)))
    out = tmp_path / "out.wav"

    cfg = configs(moq_enabled=True, moq_port=0)["torch"]

    async def main():
        async with serve("torch", cfg) as (app, base):
            loop = asyncio.get_running_loop()

            def cli(*args):
                return cli_main(list(args))

            async def publish():
                b = app["state"].moq_relay.announce("captions")
                for i in range(200):  # until the subscriber has its frames
                    b.publish(b"line%d;" % i, i * 20_000, key=(i % 5 == 0))
                    await asyncio.sleep(0.02)
                b.end()

            rcs = [await loop.run_in_executor(None, cli, "oneshot", "-s", base, str(pipeline), str(media), "-o",
                                              str(out))]
            rcs.append(await loop.run_in_executor(None, cli, "create", "-s", base, "--name", "cli-sess"))
            sessions = [s.info() for s in app["state"].sessions.list()]
            rcs.append(await loop.run_in_executor(None, cli, "list", "-s", base))
            rcs.append(await loop.run_in_executor(None, cli, "destroy", "-s", base, sessions[0]["id"]))
            rcs.append(await loop.run_in_executor(None, cli, "nodes", "-s", base))
            rcs.append(await loop.run_in_executor(None, cli, "plugins", "list", "-s", base))
            pub = asyncio.ensure_future(publish())
            rcs.append(await loop.run_in_executor(None, cli, "moq", "subscribe", "captions", "-s", base,
                                                  "--moq-port", str(app["state"].webtransport.port),
                                                  "--frames", "3"))
            pub.cancel()
            return rcs, sessions, len(app["state"].sessions.list())

    rcs, sessions, left = run(main())
    assert rcs == [0, 0, 0, 0, 0, 0, 0]
    err = capsys.readouterr()
    assert "received 3 frames" in err.err and re.search(rb"(line\d+;){3}", err.out.encode()), err
    assert [s["name"] for s in sessions] == ["cli-sess"] and left == 0
    assert out.read_bytes()[:4] == b"RIFF"
