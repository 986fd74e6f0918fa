# SPDX-License-Identifier: Apache-2.0
"""The port's MoQ layer against the JAX package's: the gateway
(``core/moq_gateway.py``), the in-process relay (``moq/relay.py``), the
transport nodes and the ``/moq/{path}`` WebSocket route. Case for case the
mirror of the gateway, relay and WS-loopback cases of ``tests/test_moq.py``
and ``tests/test_moq_relay.py``, each scenario run on both packages with the
same results; the Opus cases run where libopus loads, as the port's Opus
tests do. Then the port's own: the publisher node takes Binary (so
``live_captions.yml`` publishes its JSON lines, which the JAX engine
refuses), and 4004 on a path nobody serves."""

import asyncio
import json

import aiohttp
import numpy as np
import pytest
import torch

import streamkit_tpu.core.moq_gateway as jax_gateway
import streamkit_tpu.moq as jax_moq
import streamkit_tpu_torch.core.moq_gateway as torch_gateway
import streamkit_tpu_torch.moq as torch_moq
from streamkit_tpu_torch.nodes.codecs import opus_available
from test_moq import MOQ_YAML
from test_torch_server import configs, fetch, same, serve

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

GATEWAYS = {"jax": jax_gateway, "torch": torch_gateway}
RELAYS = {"jax": jax_moq, "torch": torch_moq}
needs_opus = pytest.mark.skipif(not opus_available(), reason="libopus does not load here")


def both(fn):
    """``fn(pkg)`` on each package → the shared result (they must agree)."""
    return same({pkg: fn(pkg) for pkg in ("jax", "torch")})


# -- gateway ---------------------------------------------------------------------
@pytest.mark.parametrize("payload,ts,key", [(b"opusdata", 123456, True), (b"", 0, False), (b"\x00" * 300, -5, False)])
def test_media_frame_roundtrip(payload, ts, key):
    def go(pkg):
        frame = GATEWAYS[pkg].encode_media_frame(payload, ts, key=key)
        return frame, GATEWAYS[pkg].decode_media_frame(frame)

    frame, (p, t, k) = both(go)
    assert p == payload and t == max(0, ts) and k == key and len(frame) == 9 + len(payload)


def test_gateway_route_registration_and_wait(monkeypatch):
    def go(pkg):
        mg = GATEWAYS[pkg]
        monkeypatch.setattr(mg, "ROUTE_WAIT_SECS", 0.2)

        async def main():
            gw = mg.MoqGateway()
            route = await gw.register_route("/x/input")
            try:
                await gw.register_route("/x/input")
                dup = "accepted"
            except ValueError as e:
                dup = str(e)
            conn = mg.MoqConnection("/x/input", "publish")
            ok = await gw.accept_connection(conn)
            got = await route.recv()
            routes = gw.routes()
            await gw.unregister_route("/x/input")
            late = await gw.accept_connection(mg.MoqConnection("/nope", "publish"))
            return dup, ok, got is conn, routes, gw.has_route("/x/input"), late

        return asyncio.run(main())

    assert both(go) == ("route already registered: /x/input", True, True, ["/x/input"], False, False)


# -- relay (tests/test_moq_relay.py) --------------------------------------------------
def test_publish_subscribe_ordering():
    def go(pkg):
        async def main():
            relay = RELAYS[pkg].MoqRelay()
            b = relay.announce("room")
            sub = await relay.subscribe("room", wait=0.1)
            for i in range(10):
                b.publish(bytes([i]), timestamp_us=i * 1000, key=(i % 5 == 0))
            got = [await sub.recv() for _ in range(10)]
            b.end()
            return [(f.payload[0], f.timestamp_us, f.key) for f in got], await sub.recv()

        return asyncio.run(main())

    frames, end = both(go)
    assert [f[0] for f in frames] == list(range(10)) and frames[0][2] and frames[5][2] and end is None


def test_slow_subscriber_drops_whole_groups():
    def go(pkg):
        async def main():
            relay = RELAYS[pkg].MoqRelay()
            b = relay.announce("room")
            sub = await relay.subscribe("room", wait=0.1)
            for g in range(20):
                for i in range(4):
                    b.publish(f"{g}:{i}".encode(), key=(i == 0))
            first = await sub.recv()
            g0 = int(first.payload.split(b":")[0])
            seen = [first.payload.decode()]
            for _ in range(4 * (20 - g0) - 1):
                seen.append((await sub.recv()).payload.decode())
            return g0, first.key, sub.dropped_groups, seen

        return asyncio.run(main())

    g0, key, dropped, seen = both(go)
    assert g0 >= 12 and key and dropped >= 12
    assert seen == [f"{g}:{i}" for g in range(g0, 20) for i in range(4)]


def test_subscribe_waits_for_announce():
    def go(pkg):
        async def main():
            relay = RELAYS[pkg].MoqRelay()

            async def announce_later():
                await asyncio.sleep(0.05)
                b = relay.announce("later")
                while b.subscriber_count == 0:
                    await asyncio.sleep(0.01)
                b.publish(b"hi", key=True)

            task = asyncio.ensure_future(announce_later())
            sub = await relay.subscribe("later", wait=2.0)
            f = await sub.recv()
            await task
            return sub is not None, f.payload, await relay.subscribe("never", wait=0.05)

        return asyncio.run(main())

    assert both(go) == (True, b"hi", None)


def test_announce_replace_semantics():
    def go(pkg):
        async def main():
            relay = RELAYS[pkg].MoqRelay()
            relay.announce("room")
            sub = await relay.subscribe("room", wait=0.1)
            b2 = relay.announce("room")
            ended = await sub.recv()
            try:
                relay.announce("room", replace=False)
                refused = None
            except ValueError as e:
                refused = str(e)
            listed = relay.announced()
            b2.end()
            return ended, refused, listed, relay.announced()

        return asyncio.run(main())

    ended, refused, listed, after = both(go)
    assert ended is None and "already announced" in refused
    assert listed == [{"name": "room", "subscribers": 0, "frames": 0}] and after == []


def _registry(pkg):
    if pkg == "jax":
        from streamkit_tpu.core import NodeRegistry
        from streamkit_tpu.nodes import register_nodes

        reg = NodeRegistry()
        register_nodes(reg)
    else:
        from streamkit_tpu_torch.core import NodeRegistry
        from streamkit_tpu_torch.nodes import register_nodes

        reg = NodeRegistry()
        register_nodes(reg, device="cpu")
    return reg


@needs_opus
def test_selfcontained_pub_sub_pipeline():
    """file audio → opus → publisher ⇒ relay ⇒ subscriber → decoder → gain →
    encoder → publisher, in one dynamic session of each package."""
    yaml_doc = {"mode": "dynamic", "nodes": {
        "sub": {"kind": "transport::moq::subscriber", "params": {"broadcast": "lt-input"}},
        "decode": {"kind": "audio::opus::decoder", "needs": "sub"},
        "gain": {"kind": "audio::gain", "params": {"gain": 1.0}, "needs": "decode"},
        "encode": {"kind": "audio::opus::encoder", "needs": "gain"},
        "pub_out": {"kind": "transport::moq::publisher",
                    "params": {"broadcast": "lt-output", "group_duration_ms": 40}, "needs": "encode"}}}

    def go(pkg):
        if pkg == "jax":
            from streamkit_tpu.api import compile_pipeline_dict
            from streamkit_tpu.engine.dynamic import DynamicEngineConfig, start_dynamic_engine
            from streamkit_tpu.nodes.codecs.opus import OpusEncoder
        else:
            from streamkit_tpu_torch.api import compile_pipeline_dict
            from streamkit_tpu_torch.engine.dynamic import DynamicEngineConfig, start_dynamic_engine
            from streamkit_tpu_torch.nodes.codecs.opus import OpusEncoder

        async def main():
            relay = RELAYS[pkg].init_moq_relay()
            handle = start_dynamic_engine(_registry(pkg), DynamicEngineConfig(session_id="lt"))
            pipeline = compile_pipeline_dict(yaml_doc)
            for node_id, n in pipeline.nodes.items():
                await handle.add_node(node_id, n.kind, n.params)
            for c in pipeline.connections:
                await handle.connect(c.from_node, c.from_pin, c.to_node, c.to_pin)
            out_sub = asyncio.ensure_future(relay.subscribe("lt-output", wait=10.0))
            await asyncio.sleep(0.1)
            b = relay.announce("lt-input")
            for _ in range(500):
                if b.subscriber_count > 0:
                    break
                await asyncio.sleep(0.01)
            attached = b.subscriber_count > 0
            enc = OpusEncoder(48000, 1, 64000)
            tone = (0.25 * np.sin(2 * np.pi * 330 * np.arange(48000) / 48000)).astype(np.float32)
            for i in range(25):
                b.publish(enc.encode(tone[i * 960 : (i + 1) * 960]), i * 20000, key=(i % 2 == 0))
            consumer = await out_sub
            frames = [await asyncio.wait_for(consumer.recv(), timeout=10) for _ in range(10)]
            b.end()
            await handle.shutdown_and_wait()
            return attached, [(f.timestamp_us, f.key, len(f.payload) > 0) for f in frames]

        return asyncio.run(main())

    attached, frames = both(go)
    assert attached and len(frames) == 10 and all(f[2] for f in frames)


# -- the WS media route ------------------------------------------------------------
@needs_opus
def test_moq_loopback_transcoder_over_ws():
    """The reference's moq.yml over ``/moq/{path}`` on both servers: a client
    publishes Opus, the session transcodes (gain 2×), a subscriber receives
    the re-encoded stream at about twice the amplitude."""
    from streamkit_tpu_torch.nodes.codecs.opus import OpusDecoder, OpusEncoder

    async def scenario(s, base, app):
        created = await fetch(s, "POST", base + "/api/v1/sessions", json={"name": "moq", "yaml": MOQ_YAML})
        sub_ws = await s.ws_connect(base + "/moq/transcoder/output?direction=subscribe")
        pub_ws = await s.ws_connect(base + "/moq/transcoder/input?direction=publish")
        enc = OpusEncoder(48000, 1, 64000)
        tone = (0.25 * np.sin(2 * np.pi * 440 * np.arange(48000) / 48000)).astype(np.float32)
        for i in range(25):
            await pub_ws.send_bytes(torch_gateway.encode_media_frame(enc.encode(tone[i * 960 : (i + 1) * 960]),
                                                                     i * 20000))
        frames = []
        try:
            while len(frames) < 15:
                msg = await asyncio.wait_for(sub_ws.receive(), timeout=10)
                if msg.type.name != "BINARY":
                    break
                frames.append(msg.data)
        finally:
            await pub_ws.close()
            await sub_ws.close()
        dec = OpusDecoder(48000, 1)
        pcm = None
        for f in frames[10:14]:
            pcm = dec.decode(torch_gateway.decode_media_frame(f)[0])
        return created[0], len(frames) >= 15, bool(pcm is not None and 0.35 < np.abs(pcm).max() < 0.75)

    assert same(on_both_servers(scenario)) == (201, True, True)


def on_both_servers(scenario, **cfg):
    async def main():
        out = {}
        cfgs = configs(**cfg)
        for pkg in ("jax", "torch"):
            async with serve(pkg, cfgs[pkg]) as (app, base):
                async with aiohttp.ClientSession() as s:
                    out[pkg] = await scenario(s, base, app)
        return out

    return asyncio.run(main())


def test_unserved_media_path_closes_4004(monkeypatch):
    """A subscriber on a path that no route and no broadcast serves: after
    the gateway's route wait, both servers close with 4004."""
    monkeypatch.setattr(jax_gateway, "ROUTE_WAIT_SECS", 0.3)
    monkeypatch.setattr(torch_gateway, "ROUTE_WAIT_SECS", 0.3)

    async def scenario(s, base, app):
        ws = await s.ws_connect(base + "/moq/nobody/here?direction=subscribe")
        msg = await ws.receive(timeout=10)
        return msg.type.name, ws.close_code, msg.extra

    assert same(on_both_servers(scenario)) == ("CLOSE", 4004, "no such media route")


def test_publisher_takes_binary_so_captions_reach_a_ws_subscriber(tmp_path):
    """``live_captions.yml`` ends ``core::json_serialize → transport::moq::
    publisher {broadcast: captions}``. The JAX engine refuses that edge (its
    publisher takes Opus only); the port's publisher takes Binary, and a
    WebSocket subscriber on ``/moq/captions`` receives the bytes, framed."""
    text = b"".join(json.dumps({"line": i}).encode() + b"\n" for i in range(200))
    src = tmp_path / "lines.jsonl"
    src.write_bytes(text)
    nodes = [("pub", "transport::moq::publisher", {"broadcast": "captions"}),
             ("reader", "core::file_reader", {"path": str(src), "chunk_size": 512})]

    async def scenario(s, base, app):
        ws = await s.ws_connect(base + "/api/v1/control")

        async def req(action, **fields):
            await ws.send_json({"type": "request", "correlation_id": action, "payload": {"action": action, **fields}})
            while True:
                msg = json.loads((await ws.receive()).data)
                if msg["type"] == "response" and msg["correlation_id"] == action:
                    return msg["payload"]

        sid = (await req("createsession", name="captions"))["session_id"]
        for node_id, kind, params in nodes:
            assert (await req("addnode", session_id=sid, node_id=node_id, kind=kind, params=params))["action"] == "success"
        for _ in range(100):  # the publisher announces its broadcast when it starts
            if app["state"].moq_relay.get("captions") is not None:
                break
            await asyncio.sleep(0.02)
        sub = await s.ws_connect(base + "/moq/captions?direction=subscribe")
        await asyncio.sleep(0.2)  # the subscriber attaches before the reader starts
        reply = await req("connect", session_id=sid, from_node="reader", from_pin="out", to_node="pub", to_pin="in")
        frames = []
        if reply["action"] == "success":
            while True:
                msg = await sub.receive(timeout=10)
                if msg.type.name != "BINARY":
                    break
                frames.append(torch_gateway.decode_media_frame(msg.data))
        await sub.close()
        await req("destroysession", session_id=sid)
        await ws.close()
        return reply, frames

    got = on_both_servers(scenario)
    jax_reply, jax_frames = got["jax"]
    assert jax_reply["action"] == "error" and "type mismatch" in jax_reply["message"] and not jax_frames
    reply, frames = got["torch"]
    assert reply == {"action": "success"}
    assert b"".join(p for p, _, _ in frames) == text and frames[0][2]  # the first frame opens a group
