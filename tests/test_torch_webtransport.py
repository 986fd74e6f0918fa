# SPDX-License-Identifier: Apache-2.0
"""The port's HTTP/3 + WebTransport layer, MoQ wire protocols and MoQ
sessions (``streamkit_tpu_torch/{quic/h3,quic/qpack,moq,server/webtransport}``)
against the JAX package's.

* counterparts of ``tests/test_h3_webtransport.py``,
  ``tests/test_webtransport_moq.py``, ``tests/test_moq_lite.py``,
  ``tests/test_moq_wire.py`` (its MoQ cases) and
  ``tests/test_moq_wire_golden.py``, every encoder's bytes equal to the JAX
  encoder's and to the golden vectors;
* across packages: JAX MoQ clients (native and moq-lite) publish through the
  port's ``WebTransportServer`` to the port's clients, and the port's
  clients through the JAX acceptor to the JAX clients;
* the port's server: fingerprint routes, relay and peer-pipeline loops over
  UDP, and ``skit moq publish --protocol lite`` → native subscribe through
  the port's CLI.

Every acceptor binds UDP port 0.
"""

import asyncio
import json
import os
import tempfile
import wave

import numpy as np
import pytest
import torch

import streamkit_tpu.moq.lite as jax_lite
import streamkit_tpu.moq.lite_session as jax_lite_session
import streamkit_tpu.moq.relay as jax_relay
import streamkit_tpu.moq.session as jax_session
import streamkit_tpu.moq.wire as jax_wire
import streamkit_tpu.quic.qpack as jax_qpack
import streamkit_tpu.server.webtransport as jax_webtransport
import streamkit_tpu_torch.moq.lite as lite
import streamkit_tpu_torch.moq.lite_session as torch_lite_session
import streamkit_tpu_torch.moq.relay as torch_relay
import streamkit_tpu_torch.moq.session as torch_session
import streamkit_tpu_torch.moq.wire as wire
import streamkit_tpu_torch.server.webtransport as torch_webtransport
from streamkit_tpu_torch.nodes.codecs import opus_available
from streamkit_tpu_torch.quic.endpoint import connect, serve
from streamkit_tpu_torch.quic.h3 import H3Connection, SessionRequest, WtDatagram, WtStreamData
from streamkit_tpu_torch.quic.packet import decode_varint, encode_varint
from streamkit_tpu_torch.quic.qpack import decode_field_section, encode_field_section, huffman_decode
from streamkit_tpu_torch.quic.tls import generate_self_signed
from streamkit_tpu_torch.server import ServerConfig, create_app
from streamkit_tpu_torch.server.http import AppRunner, ClientSession
from test_webtransport_moq import PEER_YAML

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

needs_opus = pytest.mark.skipif(not opus_available(), reason="libopus does not load here")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "moq_vectors.json")
with open(GOLDEN) as f:
    VEC = {k: bytes.fromhex(v) for k, v in json.load(f).items()}


# ---------------------------------------------------------------------------
# HTTP/3 + QPACK
def test_qpack_roundtrip_connect_headers():
    hs = [
        (":method", "CONNECT"),
        (":protocol", "webtransport"),
        (":scheme", "https"),
        (":authority", "localhost:4443"),
        (":path", "/moq"),
        ("origin", "https://localhost"),
    ]
    enc = encode_field_section(hs)
    assert enc == jax_qpack.encode_field_section(hs)
    assert decode_field_section(enc) == hs
    assert len(encode_field_section([(":method", "CONNECT"), (":scheme", "https")])) == 4


def test_hpack_huffman_rfc7541_vectors():
    assert huffman_decode(bytes.fromhex("f1e3c2e5f23a6ba0ab90f4ff")) == b"www.example.com"
    assert huffman_decode(bytes.fromhex("6402")) == b"302"
    assert huffman_decode(bytes.fromhex("aec3771a4b")) == b"private"
    assert huffman_decode(bytes.fromhex("d07abe941054d444a8200595040b8166e082a62d1bff")) == (
        b"Mon, 21 Oct 2013 20:13:21 GMT"
    )


def test_webtransport_session_streams_datagrams():
    async def main():
        cert, key = generate_self_signed()
        import hashlib

        fp = hashlib.sha256(cert).digest()

        async def on_conn(proto):
            await proto.handshake_done
            h3 = H3Connection(proto, True)
            h3.start()
            while True:
                ev = await h3.events.get()
                if isinstance(ev, SessionRequest):
                    assert ev.path == "/moq"
                    h3.accept_session(ev.session_id)
                elif isinstance(ev, WtStreamData):
                    if ev.bidi and ev.data:
                        h3.send_stream(ev.stream_id, b"reply:" + ev.data, fin=ev.fin)
                    elif not ev.bidi and ev.data:
                        out = h3.open_wt_uni(ev.session_id)
                        h3.send_stream(out, b"uni-reply:" + ev.data, fin=True)
                elif isinstance(ev, WtDatagram):
                    h3.send_wt_datagram(ev.session_id, b"dg-reply:" + ev.data)

        server, tr = await serve("127.0.0.1", 0, cert, key, on_conn)
        port = tr.get_extra_info("sockname")[1]
        client, proto = await connect("127.0.0.1", port, [fp])
        h3 = H3Connection(proto, False)
        h3.start()
        session = await h3.connect_session("/moq", "localhost")
        bidi = h3.open_wt_bidi(session)
        h3.send_stream(bidi, b"hello-bidi")
        uni = h3.open_wt_uni(session)
        h3.send_stream(uni, b"hello-uni", fin=True)
        h3.send_wt_datagram(session, b"hello-dg")
        got = {}
        while len(got) < 3:
            ev = await asyncio.wait_for(h3.events.get(), timeout=5)
            if isinstance(ev, WtStreamData) and ev.bidi and ev.data:
                got["bidi"] = ev.data
            elif isinstance(ev, WtStreamData) and not ev.bidi and ev.data:
                got["uni"] = ev.data
            elif isinstance(ev, WtDatagram):
                got["dg"] = ev.data
        client.close()
        server.close()
        return got

    got = asyncio.run(main())
    assert got == {"bidi": b"reply:hello-bidi", "uni": b"uni-reply:hello-uni", "dg": b"dg-reply:hello-dg"}


# ---------------------------------------------------------------------------
# native wire protocol (moq/wire.py)
def test_control_roundtrip_fragmented():
    blob = (
        wire.encode_msg(wire.MSG_SETUP, wire.MOQ_VERSION)
        + wire.encode_msg(wire.MSG_PUBLISH, 7, "/transcoder/input")
        + wire.encode_msg(wire.MSG_SUBSCRIBE, 8, "lt-live")
        + wire.encode_msg(wire.MSG_SUBSCRIBE_ERROR, 8, "broadcast not announced")
    )
    assert blob == (
        jax_wire.encode_msg(jax_wire.MSG_SETUP, jax_wire.MOQ_VERSION)
        + jax_wire.encode_msg(jax_wire.MSG_PUBLISH, 7, "/transcoder/input")
        + jax_wire.encode_msg(jax_wire.MSG_SUBSCRIBE, 8, "lt-live")
        + jax_wire.encode_msg(jax_wire.MSG_SUBSCRIBE_ERROR, 8, "broadcast not announced")
    )
    p = wire.ControlParser()
    msgs = []
    for i in range(len(blob)):
        msgs += p.feed(blob[i : i + 1])
    assert msgs == [
        (wire.MSG_SETUP, (wire.MOQ_VERSION,)),
        (wire.MSG_PUBLISH, (7, "/transcoder/input")),
        (wire.MSG_SUBSCRIBE, (8, "lt-live")),
        (wire.MSG_SUBSCRIBE_ERROR, (8, "broadcast not announced")),
    ]
    assert not p.buf


def test_control_unknown_message_raises():
    with pytest.raises(ValueError, match="unknown MoQ control message"):
        wire.ControlParser().feed(bytes([0x3F]) + b"xx")


@pytest.mark.parametrize("chunk", [7, 10**6])
def test_group_parser_frames(chunk):
    stream = wire.encode_group_header(alias=5, group_seq=9)
    payloads = [(b"frame-one", 1000, True), (b"x" * 300, 2000, False), (b"", 3000, False)]
    for data, ts, key in payloads:
        stream += wire.encode_frame(data, ts, key)
    jstream = jax_wire.encode_group_header(alias=5, group_seq=9) + b"".join(
        jax_wire.encode_frame(d, t, k) for d, t, k in payloads)
    assert stream == jstream
    gp = wire.GroupParser()
    out = []
    for i in range(0, len(stream), chunk):
        out += gp.feed(stream[i : i + chunk])
    assert gp.alias == 5 and gp.group_seq == 9
    assert out == payloads


# ---------------------------------------------------------------------------
# moq-lite (moq/lite.py)
def test_version_constant_bytes():
    enc = encode_varint(lite.VERSION_DRAFT_02)
    v, off = decode_varint(enc, 0)
    assert v == 0xFF0BBB02 and off == len(enc) == 8


def test_hang_frame_vector():
    payload = b"\x01\x02\x03opus"
    frame = lite.encode_hang_frame(payload, 1_234_000)
    assert frame == jax_lite.encode_hang_frame(payload, 1_234_000)
    ln, off = decode_varint(frame, 0)
    inner = frame[off:]
    assert len(inner) == ln
    assert lite.decode_hang_frame(inner) == (payload, 1_234_000)
    tsv, toff = decode_varint(inner, 0)
    assert tsv == 1_234_000 and inner[toff:] == payload


def test_catalog_shape():
    cat = lite.build_catalog()
    assert cat == jax_lite.build_catalog()
    tracks = lite.parse_catalog(cat)
    assert tracks and tracks[0][0] == "audio/data"
    cfg = tracks[0][1]
    assert cfg["codec"] == "opus" and cfg["sampleRate"] == 48000 and cfg["channelCount"] == 1
    assert json.loads(cat)["audio"]["priority"] == 80


def test_session_handshake_roundtrip():
    msg = lite.encode_session_client([lite.VERSION_DRAFT_02], {0x5: b"ext"})
    assert msg == jax_lite.encode_session_client([jax_lite.VERSION_DRAFT_02], {0x5: b"ext"})
    versions, ext, off = lite.decode_session_client(msg)
    assert versions == [lite.VERSION_DRAFT_02] and ext == {5: b"ext"} and off == len(msg)
    srv = lite.encode_session_server()
    v, _, off2 = lite.decode_session_server(srv)
    assert v == lite.VERSION_DRAFT_02 and off2 == len(srv)


def test_subscribe_roundtrip():
    msg = lite.encode_subscribe(7, "room/alice", "audio/data", priority=80)
    assert msg == jax_lite.encode_subscribe(7, "room/alice", "audio/data", priority=80)
    assert lite.decode_subscribe(msg) == (7, "room/alice", "audio/data", 80, len(msg))


def test_announce_parser_incremental():
    p = lite.AnnounceParser()
    data = (
        lite.encode_announce(lite.ANNOUNCE_ACTIVE, "a/b")
        + lite.encode_announce(lite.ANNOUNCE_ENDED, "a/b")
        + lite.encode_announce(lite.ANNOUNCE_LIVE)
    )
    out = []
    for i in range(0, len(data), 3):
        out.extend(p.feed(data[i : i + 3]))
    assert out == [(lite.ANNOUNCE_ACTIVE, "a/b"), (lite.ANNOUNCE_ENDED, "a/b"), (lite.ANNOUNCE_LIVE, "")]


def test_group_parser_split_frames():
    gp = lite.LiteGroupParser()
    wire_bytes = (
        lite.encode_group_header(3, 9)
        + lite.encode_hang_frame(b"xx", 20_000)
        + lite.encode_hang_frame(b"yyyy", 40_000)
    )
    frames = []
    for i in range(0, len(wire_bytes), 5):
        frames.extend(gp.feed(wire_bytes[i : i + 5]))
    assert gp.sub_id == 3 and gp.sequence == 9
    assert [lite.decode_hang_frame(f) for f in frames] == [(b"xx", 20_000), (b"yyyy", 40_000)]


# ---------------------------------------------------------------------------
# golden vectors (tests/golden/moq_vectors.json)
ENCODE_CASES = [
    ("lite_session_client", lambda L, W: L.encode_session_client()),
    ("lite_session_server", lambda L, W: L.encode_session_server()),
    ("lite_announce_please", lambda L, W: L.encode_announce_please("demo/")),
    ("lite_announce_active", lambda L, W: L.encode_announce(L.ANNOUNCE_ACTIVE, "room1")),
    ("lite_announce_live", lambda L, W: L.encode_announce(L.ANNOUNCE_LIVE)),
    ("lite_subscribe", lambda L, W: L.encode_subscribe(7, "demo/room1", "audio/data", priority=80)),
    ("lite_subscribe_ok", lambda L, W: L.encode_subscribe_ok(80)),
    ("lite_group_header", lambda L, W: L.encode_group_header(7, 64)),
    ("lite_hang_frame", lambda L, W: L.encode_hang_frame(b"opus-pkt", 300_000)),
    ("lite_catalog", lambda L, W: L.build_catalog()),
    ("native_setup", lambda L, W: W.encode_msg(W.MSG_SETUP, W.MOQ_VERSION)),
    ("native_subscribe", lambda L, W: W.encode_msg(W.MSG_SUBSCRIBE, 3, b"demo/room1/audio/data")),
    ("native_group_header", lambda L, W: W.encode_group_header(3, 17)),
    ("native_frame", lambda L, W: W.encode_frame(b"opus-pkt", 300_000, key=True)),
]


@pytest.mark.parametrize("name,enc", ENCODE_CASES, ids=[c[0] for c in ENCODE_CASES])
def test_encoder_matches_golden(name, enc):
    ours = enc(lite, wire)
    assert ours.hex() == VEC[name].hex() == enc(jax_lite, jax_wire).hex()


def test_hand_derived_layouts():
    assert lite.encode_session_client() == bytes.fromhex("01c0000000ff0bbb0200")
    assert lite.encode_group_header(7, 64) == bytes.fromhex("074040")
    frame = lite.encode_hang_frame(b"opus-pkt", 300_000)
    assert frame[:1] == b"\x0c" and frame[1:5] == bytes.fromhex("800493e0")


def test_decode_golden_streams():
    """Each decoder parses the frozen bytes back, byte at a time."""
    versions, exts, off = lite.decode_session_client(VEC["lite_session_client"])
    assert versions == [lite.VERSION_DRAFT_02] and exts == {} and off == len(VEC["lite_session_client"])
    version, exts, off = lite.decode_session_server(VEC["lite_session_server"])
    assert version == lite.VERSION_DRAFT_02 and exts == {} and off == len(VEC["lite_session_server"])
    assert lite.decode_announce_please(VEC["lite_announce_please"]) == ("demo/", len(VEC["lite_announce_please"]))
    p = lite.AnnounceParser()
    msgs = []
    for stream in (VEC["lite_announce_active"], VEC["lite_announce_live"]):
        for i in range(len(stream)):
            msgs.extend(p.feed(stream[i : i + 1]))
    assert msgs == [(lite.ANNOUNCE_ACTIVE, "room1"), (lite.ANNOUNCE_LIVE, "")]
    assert lite.decode_subscribe(VEC["lite_subscribe"]) == (7, "demo/room1", "audio/data", 80,
                                                            len(VEC["lite_subscribe"]))
    assert lite.decode_subscribe_ok(VEC["lite_subscribe_ok"]) == (80, 1)
    gp = lite.LiteGroupParser()
    frames = []
    stream = VEC["lite_group_header"] + VEC["lite_hang_frame"]
    for i in range(len(stream)):
        frames.extend(gp.feed(stream[i : i + 1]))
    assert gp.sub_id == 7 and gp.sequence == 64
    assert [lite.decode_hang_frame(f) for f in frames] == [(b"opus-pkt", 300_000)]
    assert any(t == "audio/data" for t, _ in lite.parse_catalog(VEC["lite_catalog"]))
    cp = wire.ControlParser()
    stream = VEC["native_setup"] + VEC["native_subscribe"]
    msgs = []
    for i in range(len(stream)):
        msgs.extend(cp.feed(stream[i : i + 1]))
    assert msgs == [(wire.MSG_SETUP, (wire.MOQ_VERSION,)), (wire.MSG_SUBSCRIBE, (3, "demo/room1/audio/data"))]
    ng = wire.GroupParser()
    frames = []
    stream = VEC["native_group_header"] + VEC["native_frame"]
    for i in range(len(stream)):
        frames.extend(ng.feed(stream[i : i + 1]))
    assert ng.alias == 3 and ng.group_seq == 17 and frames == [(b"opus-pkt", 300_000, True)]


# ---------------------------------------------------------------------------
# sessions over a bare acceptor
PKGS = {
    "torch": (torch_relay, torch_webtransport, torch_session.MoqClient, torch_lite_session.MoqLiteClient),
    "jax": (jax_relay, jax_webtransport, jax_session.MoqClient, jax_lite_session.MoqLiteClient),
}


async def _start_wt(pkg):
    relay_mod, wt_mod, _, _ = PKGS[pkg]
    wt = wt_mod.WebTransportServer(relay_mod.MoqRelay(), None, host="127.0.0.1", port=0)
    port = await wt.start()
    return wt, port, [bytes.fromhex(wt.fingerprint)]


def _client(pkg, protocol):
    return PKGS[pkg][2 if protocol == "native" else 3]()


async def _relay_round(server_pkg, pub_pkg, pub_proto, sub_pkg, sub_proto, name, n=10):
    """``pub`` publishes ``n`` frames to ``name`` through ``server_pkg``'s
    acceptor; ``sub`` receives them → the frames."""
    wt, port, fp = await _start_wt(server_pkg)
    pub_c, sub_c = _client(pub_pkg, pub_proto), _client(sub_pkg, sub_proto)
    try:
        await pub_c.connect("127.0.0.1", port, fp)
        pub = await pub_c.publish(name)
        await asyncio.sleep(0.3)  # lite: server announce/subscribe handshake
        await sub_c.connect("127.0.0.1", port, fp)
        sub = await sub_c.subscribe(name, timeout=10)
        await asyncio.sleep(0.2)
        for i in range(n):
            pub.send(b"frame%d" % i, i * 20_000, key=(i % 5 == 0))
        got = []
        for _ in range(n):
            f = await sub.recv(timeout=5)
            assert f is not None
            got.append(f)
        pub.end()
        return got
    finally:
        pub_c.close()
        sub_c.close()
        await wt.stop()


@pytest.mark.parametrize(
    "server_pkg,pub_pkg,pub_proto,sub_pkg,sub_proto",
    [
        ("torch", "torch", "lite", "torch", "lite"),  # moq-lite loopback
        ("torch", "torch", "lite", "torch", "native"),  # both protocols on one acceptor
        ("torch", "jax", "native", "torch", "native"),  # JAX clients into the port's acceptor
        ("torch", "jax", "lite", "torch", "lite"),
        ("jax", "torch", "native", "jax", "native"),  # the port's clients into the JAX acceptor
        ("jax", "torch", "lite", "jax", "lite"),
    ],
)
def test_relay_publish_subscribe(server_pkg, pub_pkg, pub_proto, sub_pkg, sub_proto):
    got = asyncio.run(_relay_round(server_pkg, pub_pkg, pub_proto, sub_pkg, sub_proto, "interop/audio"))
    assert [g[0] for g in got] == [b"frame%d" % i for i in range(10)]
    assert [g[1] for g in got] == [i * 20_000 for i in range(10)]
    assert [g[2] for g in got] == [i % 5 == 0 for i in range(10)]


# ---------------------------------------------------------------------------
# the port's server
async def _start_app(**fields):
    cfg = ServerConfig()
    cfg.moq_port = 0  # ephemeral
    cfg.plugins_dir = tempfile.mkdtemp()
    for k, v in fields.items():
        setattr(cfg, k, v)
    app = create_app(cfg, device="cpu")
    runner = AppRunner(app)
    port = await runner.start("127.0.0.1", 0)
    return app, runner, f"http://127.0.0.1:{port}"


async def _get(url):
    s = ClientSession(timeout=30)
    async with s.get(url) as r:
        return r.status, await r.read()


def test_fingerprint_endpoints():
    async def main():
        app, runner, base = await _start_app()
        try:
            wt = app["state"].webtransport
            doc = await _get(base + "/api/v1/moq/fingerprints")
            txt = await _get(base + "/certificate.sha256")
            return doc, txt, wt.fingerprint, wt.port
        finally:
            await runner.cleanup()

    (s1, doc), (s2, text), fp, port = asyncio.run(main())
    assert (s1, s2) == (200, 200)
    assert json.loads(doc) == {"fingerprints": [fp], "port": port} and port > 0
    assert text.decode() == fp and len(bytes.fromhex(fp)) == 32


def test_acceptor_absent_serves_websocket_moq_only(monkeypatch, caplog):
    """Without libcrypto, or with ``moq_enabled`` off, the server starts no
    acceptor, logs why, and answers 404 on both fingerprint routes."""
    from streamkit_tpu_torch.quic import _libcrypto as lc

    def unavailable():
        raise lc.LibcryptoUnavailable("OpenSSL libcrypto (1.1.1 or 3.x) not found")

    async def main(**fields):
        app, runner, base = await _start_app(**fields)
        try:
            return (app["state"].webtransport, (await _get(base + "/api/v1/moq/fingerprints"))[0],
                    (await _get(base + "/certificate.sha256"))[0])
        finally:
            await runner.cleanup()

    assert asyncio.run(main(moq_enabled=False)) == (None, 404, 404)
    monkeypatch.setattr(lc, "lib", unavailable)
    with caplog.at_level("WARNING"):
        assert asyncio.run(main()) == (None, 404, 404)
    assert "WebTransport acceptor not started" in caplog.text and "libcrypto" in caplog.text


def test_wt_relay_publish_subscribe():
    """Two WebTransport clients meet at a relay broadcast of the port's server."""

    async def main():
        app, runner, base = await _start_app()
        wt = app["state"].webtransport
        fp = [bytes.fromhex(wt.fingerprint)]
        sub_client, pub_client = torch_session.MoqClient(), torch_session.MoqClient()
        try:
            await sub_client.connect("127.0.0.1", wt.port, fp)
            await pub_client.connect("127.0.0.1", wt.port, fp)
            pub = await pub_client.publish("wt-room")
            sub_task = asyncio.ensure_future(sub_client.subscribe("wt-room"))
            await asyncio.sleep(0.3)
            sub = await sub_task
            await asyncio.sleep(0.2)
            for i in range(30):
                pub.send(f"frame-{i}".encode(), timestamp_us=i * 20_000, key=(i % 10 == 0))
            frames = []
            while len(frames) < 25:
                f = await sub.recv(timeout=10)
                assert f is not None
                frames.append(f)
            pub.end()
            return frames
        finally:
            sub_client.close()
            pub_client.close()
            await runner.cleanup()

    frames = asyncio.run(main())
    payloads = [f[0].decode() for f in frames]
    first = int(payloads[0].split("-")[1])
    assert payloads == [f"frame-{i}" for i in range(first, first + len(payloads))]
    assert frames[0][2] is True
    ts = [f[1] for f in frames]
    assert ts == sorted(ts)


@needs_opus
def test_wt_publisher_peer_subscriber_loop():
    """The reference moq.yml loop over real QUIC on the port's server: Opus
    frames in over WebTransport, the pipeline transcodes with 2x gain, the
    re-encoded audio comes back over WebTransport."""
    from streamkit_tpu_torch.nodes.codecs.opus import OpusDecoder, OpusEncoder

    async def main():
        app, runner, base = await _start_app()
        wt = app["state"].webtransport
        fp = [bytes.fromhex(wt.fingerprint)]
        s = ClientSession(timeout=60)
        async with s.post(base + "/api/v1/sessions", json={"name": "wt", "yaml": PEER_YAML}) as r:
            assert r.status == 201, await r.text()
        sub_client, pub_client = torch_session.MoqClient(), torch_session.MoqClient()
        try:
            await sub_client.connect("127.0.0.1", wt.port, fp)
            sub = await sub_client.subscribe("/wt-transcoder/output")
            await pub_client.connect("127.0.0.1", wt.port, fp)
            pub = await pub_client.publish("/wt-transcoder/input")
            await asyncio.sleep(0.2)
            enc = OpusEncoder(48000, 1, 64000)
            t = np.arange(48000) / 48000
            tone = (0.25 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
            for i in range(40):
                pub.send(enc.encode(tone[i * 960 : (i + 1) * 960]), timestamp_us=i * 20_000, key=(i % 5 == 0))
            frames = []
            while len(frames) < 20:
                f = await sub.recv(timeout=15)
                assert f is not None
                frames.append(f)
            pub.end()
            return frames
        finally:
            sub_client.close()
            pub_client.close()
            await runner.cleanup()

    frames = asyncio.run(main())
    dec = OpusDecoder(48000, 1)
    pcm = None
    for payload, _ts, _key in frames[5:12]:
        pcm = dec.decode(payload)
    peak = float(np.abs(pcm).max())
    assert 0.35 < peak < 0.75, f"expected ~0.5 after 2x gain through the WT loop, got {peak}"


@needs_opus
def test_cli_moq_publish_lite_subscribe_native(tmp_path):
    """``skit-tpu-cli moq publish --protocol lite`` (fingerprints fetched
    over HTTP, Opus encoded by the port's encoder) → a native-protocol
    subscriber on the port's server."""
    from streamkit_tpu_torch.cli import main as torch_cli

    wav_path = tmp_path / "tone.wav"
    sr = 48_000
    t = np.arange(sr) / sr
    tone = (0.25 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int16)
    with wave.open(str(wav_path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(tone.tobytes())

    async def main():
        app, runner, base = await _start_app()
        wt = app["state"].webtransport
        sub_c = torch_session.MoqClient()
        try:
            await sub_c.connect("127.0.0.1", wt.port, [bytes.fromhex(wt.fingerprint)])
            args = torch_cli.build_parser().parse_args(
                ["moq", "publish", "cli/audio", str(wav_path), "--protocol", "lite",
                 "--moq-port", str(wt.port), "-s", base])
            pub_task = asyncio.ensure_future(torch_cli._run(args))
            await asyncio.sleep(0.6)  # publisher connected + announced
            sub = await sub_c.subscribe("cli/audio")
            frames = []
            while len(frames) < 10:
                f = await sub.recv(timeout=10)
                assert f is not None, "no frames over the CLI's moq-lite publish"
                frames.append(f)
            rc = await asyncio.wait_for(pub_task, 10)  # one second of audio
            return frames, rc
        finally:
            sub_c.close()
            await runner.cleanup()

    frames, rc = asyncio.run(main())
    assert rc == 0
    assert all(len(p[0]) > 0 for p in frames)
    ts = [p[1] for p in frames]
    assert ts == sorted(ts) and all(b - a == 20_000 for a, b in zip(ts, ts[1:]))
