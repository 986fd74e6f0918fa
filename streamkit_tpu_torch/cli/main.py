# SPDX-License-Identifier: Apache-2.0
"""skit-cli equivalent: client commands against a running server.

Parity target: ``apps/skit-cli/src/main.rs:15-320`` commands:
oneshot, create, destroy, list, tune, pipeline, nodes, permissions,
samples, watch (WS event stream), config, plugins (list / load / delete),
assets, control, shell (:mod:`.shell`), loadtest (``lt``,
:mod:`.loadtest`) and moq (publish / subscribe over WebTransport, native or
moq-lite), on the port's own HTTP / WebSocket / QUIC clients. ``moq`` takes
``--server`` like every other command (the JAX CLI's ``moq`` has none and
fails on ``args.server``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import Optional

from ..server.http import ClientError
from .client import SkitClient
from .loadtest import LoadTestConfig, run_load_test

# commands whose modules are not ported yet → the ROADMAP item that holds them
NOT_PORTED: dict = {}


def _add_server_arg(p):
    p.add_argument("--server", "-s", default="http://127.0.0.1:8080")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="skit-tpu-cli", description="StreamKit-TPU client")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("oneshot", help="run a oneshot pipeline")
    _add_server_arg(p)
    p.add_argument("pipeline", help="pipeline YAML file")
    p.add_argument("input", nargs="?", help="media input file")
    p.add_argument("--output", "-o", help="output file (default stdout)")

    p = sub.add_parser("create", help="create a dynamic session")
    _add_server_arg(p)
    p.add_argument("--name")
    p.add_argument("--yaml", help="pipeline YAML file to populate the session")

    p = sub.add_parser("destroy", help="destroy a session")
    _add_server_arg(p)
    p.add_argument("session_id")

    p = sub.add_parser("list", help="list sessions")
    _add_server_arg(p)

    p = sub.add_parser("pipeline", help="show a session's live pipeline")
    _add_server_arg(p)
    p.add_argument("session_id")

    p = sub.add_parser("tune", help="update a node's params")
    _add_server_arg(p)
    p.add_argument("session_id")
    p.add_argument("node_id")
    p.add_argument("params", help="JSON params, e.g. '{\"gain\": 2.0}'")

    p = sub.add_parser("nodes", help="list available node kinds")
    _add_server_arg(p)

    p = sub.add_parser("permissions", help="show current role + permissions")
    _add_server_arg(p)

    p = sub.add_parser("samples", help="list sample pipelines")
    _add_server_arg(p)

    p = sub.add_parser("watch", help="stream server events")
    _add_server_arg(p)

    p = sub.add_parser("shell", help="interactive session shell")
    _add_server_arg(p)

    p = sub.add_parser("config", help="show effective/default config or schema")
    _add_server_arg(p)
    p.add_argument(
        "what", nargs="?", default="effective",
        choices=["effective", "default", "schema"],
        help="effective = fetch from the server; default = print the default "
        "TOML; schema = print the config JSON schema (reference cli.rs:117-150)",
    )

    p = sub.add_parser("plugins", help="manage plugins")
    _add_server_arg(p)
    p.add_argument("action", choices=["list", "load", "delete"])
    p.add_argument("target", nargs="?", help="plugin file (.so/.wasm) or kind")

    p = sub.add_parser("assets", help="manage audio assets")
    _add_server_arg(p)
    p.add_argument("action", choices=["list", "upload", "delete"])
    p.add_argument("target", nargs="?", help="file to upload or asset id")

    p = sub.add_parser("control", help="raw control-plane operations")
    _add_server_arg(p)
    csub = p.add_subparsers(dest="cop", required=True)
    c = csub.add_parser("add-node"); c.add_argument("session_id"); c.add_argument("node_id"); c.add_argument("kind"); c.add_argument("params", nargs="?")
    c = csub.add_parser("remove-node"); c.add_argument("session_id"); c.add_argument("node_id")
    c = csub.add_parser("connect"); c.add_argument("session_id"); c.add_argument("from_node"); c.add_argument("to_node"); c.add_argument("--from-pin", default="out"); c.add_argument("--to-pin", default="in")
    c = csub.add_parser("disconnect"); c.add_argument("session_id"); c.add_argument("from_node"); c.add_argument("to_node"); c.add_argument("--from-pin", default="out"); c.add_argument("--to-pin", default="in")
    c = csub.add_parser("validate-batch"); c.add_argument("session_id"); c.add_argument("ops_file", help="JSON list of ops")
    c = csub.add_parser("apply-batch"); c.add_argument("session_id"); c.add_argument("ops_file")

    p = sub.add_parser("loadtest", aliases=["lt"], help="run a load test")
    p.add_argument("config", help="load-test TOML config")

    p = sub.add_parser("moq", help="publish/subscribe media over MoQ WebTransport")
    msub = p.add_subparsers(dest="moq_cmd", required=True)
    for name in ("publish", "subscribe"):
        m = msub.add_parser(name)
        _add_server_arg(m)
        m.add_argument("broadcast", help="broadcast name (relay) or gateway path")
        if name == "publish":
            m.add_argument("wav", help="16-bit PCM WAV file to publish as 20 ms frames")
        else:
            m.add_argument("--frames", type=int, default=0, help="stop after N frames (0 = forever)")
        m.add_argument(
            "--protocol",
            choices=["native", "lite"],
            default="native",
            help="wire protocol: the compact native protocol or moq-lite draft-02 + hang",
        )
        m.add_argument("--moq-port", type=int, default=4443, help="server UDP MoQ port")

    return parser


async def _run(args) -> int:
    cmd = args.command
    if cmd in NOT_PORTED:
        print(f"error: '{cmd}' is not ported to streamkit_tpu_torch yet: ROADMAP {NOT_PORTED[cmd]}",
              file=sys.stderr)
        return 2
    if cmd == "shell":
        from .shell import run_shell

        return await run_shell(args.server)
    if cmd in ("loadtest", "lt"):
        cfg = LoadTestConfig.from_toml(args.config)
        results = await run_load_test(cfg)
        print(json.dumps(results, indent=2))
        return 0

    if cmd == "moq":
        return await _run_moq(args)

    async with SkitClient(args.server) as client:
        if cmd == "oneshot":
            media = open(args.input, "rb").read() if args.input else b""
            body, ctype = await client.process_oneshot(open(args.pipeline).read(), media)
            if args.output:
                with open(args.output, "wb") as f:
                    f.write(body)
                print(f"wrote {len(body)} bytes ({ctype}) to {args.output}", file=sys.stderr)
            else:
                sys.stdout.buffer.write(body)
        elif cmd == "create":
            yaml_text = open(args.yaml).read() if args.yaml else None
            info = await client.create_session_http(args.name, yaml_text)
            print(json.dumps(info, indent=2))
        elif cmd == "destroy":
            await client.destroy_session_http(args.session_id)
            print("destroyed", args.session_id)
        elif cmd == "list":
            print(json.dumps(await client.list_sessions(), indent=2))
        elif cmd == "pipeline":
            print(json.dumps(await client.get_pipeline(args.session_id), indent=2))
        elif cmd == "tune":
            await client.tune(args.session_id, args.node_id, json.loads(args.params))
            print("tuned", args.node_id)
        elif cmd == "nodes":
            for n in await client.schema_nodes():
                print(f"{n['kind']:40s} {n['description']}")
        elif cmd == "permissions":
            print(json.dumps(await client.permissions(), indent=2))
        elif cmd == "samples":
            for s in await client.samples():
                print(f"{s['id']:40s} [{s['mode']}] {s['description']}")
        elif cmd == "watch":
            print("watching events (ctrl-c to stop)...", file=sys.stderr)
            async for ev in client.events():
                print(json.dumps(ev))
        elif cmd == "config":
            if args.what == "default":
                from ..server.__main__ import _default_toml

                print(_default_toml())
            elif args.what == "schema":
                from ..server.__main__ import _config_schema

                print(json.dumps(_config_schema(), indent=2))
            else:
                print(json.dumps(await client.get_config(), indent=2))
        elif cmd == "plugins":
            if args.action == "list":
                print(json.dumps(await client.list_plugins(), indent=2))
            elif args.action == "load":
                print(json.dumps(await client.upload_plugin(args.target), indent=2))
            else:
                await client.delete_plugin(args.target)
                print("deleted", args.target)
        elif cmd == "assets":
            if args.action == "list":
                print(json.dumps(await client.list_assets(), indent=2))
            elif args.action == "upload":
                print(json.dumps(await client.upload_asset(args.target), indent=2))
            else:
                await client.delete_asset(args.target)
                print("deleted", args.target)
        elif cmd == "control":
            # raw WS control ops (reference ControlCommands, main.rs:509-562)
            op = args.cop
            if op == "add-node":
                params = json.loads(args.params) if args.params else None
                await client.request(
                    "addnode", session_id=args.session_id, node_id=args.node_id,
                    kind=args.kind, params=params,
                )
            elif op == "remove-node":
                await client.request(
                    "removenode", session_id=args.session_id, node_id=args.node_id
                )
            elif op in ("connect", "disconnect"):
                await client.request(
                    op, session_id=args.session_id,
                    from_node=args.from_node, from_pin=args.from_pin,
                    to_node=args.to_node, to_pin=args.to_pin,
                )
            elif op in ("validate-batch", "apply-batch"):
                ops = json.loads(open(args.ops_file).read())
                resp = await client.request(
                    "validatebatch" if op == "validate-batch" else "applybatch",
                    session_id=args.session_id, operations=ops,
                )
                print(json.dumps(resp, indent=2))
                return 0
            print("ok")
    return 0


async def _run_moq(args) -> int:
    """MoQ media client: publish a WAV as 20 ms Opus frames, or subscribe a
    broadcast and dump raw Opus packets to stdout. ``--protocol lite``
    speaks moq-lite draft-02 + hang (the reference's wire protocol,
    peer.rs:459-880); ``native`` is the compact in-house protocol."""
    import urllib.parse
    import wave

    import numpy as np

    if args.moq_cmd == "publish":
        from ..nodes.codecs import opus_available

        if not opus_available():
            print("error: moq publish encodes Opus and libopus does not load here", file=sys.stderr)
            return 1
    host = urllib.parse.urlparse(args.server).hostname or "127.0.0.1"
    async with SkitClient(args.server) as http:
        fps = [bytes.fromhex(f) for f in (await http.moq_fingerprints())["fingerprints"]]

    if args.protocol == "lite":
        from ..moq.lite_session import MoqLiteClient as Client
    else:
        from ..moq.session import MoqClient as Client

    client = Client()
    await client.connect(host, args.moq_port, fps)
    try:
        if args.moq_cmd == "publish":
            from ..nodes.codecs.opus import OpusEncoder

            with wave.open(args.wav) as w:
                sr, ch = w.getframerate(), w.getnchannels()
                pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
            audio = pcm.astype(np.float32) / 32768.0
            if ch > 1:
                audio = audio.reshape(-1, ch).mean(axis=1)
            if sr != 48_000:
                print(f"warning: resampling {sr} -> 48000 not applied; frames sent as-is", file=sys.stderr)
            enc = OpusEncoder(48_000, 1, 64_000)
            pub = await client.publish(args.broadcast)
            await asyncio.sleep(0.3)  # lite: server announce/subscribe handshake
            frame = 960  # 20 ms @48k
            n = len(audio) // frame
            start = asyncio.get_running_loop().time()
            for i in range(n):
                delay = start + i * 0.02 - asyncio.get_running_loop().time()
                if delay > 0:
                    await asyncio.sleep(delay)
                pkt = enc.encode(audio[i * frame : (i + 1) * frame])
                pub.send(pkt, i * 20_000, key=(i % 50 == 0))
            pub.end()
            print(f"published {n} frames", file=sys.stderr)
        else:
            sub = await client.subscribe(args.broadcast)
            count = 0
            while args.frames == 0 or count < args.frames:
                f = await sub.recv(timeout=30)
                if f is None:
                    break
                payload, ts, key = f
                sys.stdout.buffer.write(payload)
                sys.stdout.buffer.flush()
                count += 1
            print(f"received {count} frames", file=sys.stderr)
    finally:
        client.close()
    return 0


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return asyncio.run(_run(args))
    except KeyboardInterrupt:
        return 130
    except BrokenPipeError:
        return 0  # downstream pager/head closed the pipe
    except (RuntimeError, ClientError, ConnectionError, TimeoutError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
