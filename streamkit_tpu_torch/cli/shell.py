# SPDX-License-Identifier: Apache-2.0
"""Interactive shell for live session control.

Port of the JAX package's ``cli/shell.py`` on the port's own client
(:class:`.client.SkitClient` over :mod:`..server.http`). Parity target:
``apps/skit-cli/src/shell.rs`` (741 LoC): a REPL over the WS control plane —
create/use sessions, add/connect/tune nodes, watch events —
with the rustyline affordances mapped onto CPython ``readline``: persistent
history (``~/.skit_history``, ``shell.rs:273-276``), tab completion for
commands / session ids / node kinds / file paths (``SkitCompleter``,
``shell.rs:87-190``), per-command inline help, and the reference's
``oneshot`` and ``loadtest``/``lt`` commands (``shell.rs:353-361``).
"""

from __future__ import annotations

import asyncio
import glob as _glob
import json
import os
import shlex
from typing import Dict, List, Optional

from .client import SkitClient

HISTORY_FILE = os.path.expanduser("~/.skit_history")

# command -> (usage, description); drives `help`, `help <cmd>`, and completion
COMMANDS: Dict[str, tuple] = {
    "sessions": ("sessions", "list sessions (aliases: list, ls)"),
    "create": (
        "create [name | pipeline.yaml [--name <name>]]",
        "create a session and select it; a .yaml/.yml arg creates from config",
    ),
    "use": ("use <session-id>", "select a session (id prefix ok)"),
    "destroy": ("destroy [session-id]", "destroy selected/named session (id prefix ok)"),
    "nodes": ("nodes [filter]", "list available node kinds"),
    "add": ("add <node-id> <kind> [json]", "add a node to the selected session"),
    "rm": ("rm <node-id>", "remove a node from the selected session"),
    "connect": ("connect <from> <to> [fpin tpin]", "connect nodes (default out->in)"),
    "disconnect": ("disconnect <from> <to> [f t]", "disconnect nodes"),
    "tune": (
        "tune <node-id> <json | param value>",
        "update node params (JSON object, or one param/value pair)",
    ),
    "pipeline": ("pipeline", "show the selected session's live pipeline"),
    "watch": ("watch [n]", "print the next n events (default 5)"),
    "oneshot": (
        "oneshot <pipeline.yaml> <input> <output>",
        "process a file through a pipeline (POST /api/v1/process)",
    ),
    "loadtest": (
        "loadtest <config.toml> [--duration <s>] [--cleanup] (alias: lt)",
        "run a load test with live per-tick output",
    ),
    "help": ("help [command]", "this text, or one command's usage (alias: h)"),
    "quit": ("quit", "exit the shell (aliases: exit, q)"),
}
ALIASES = {"list": "sessions", "ls": "sessions", "lt": "loadtest",
           "h": "help", "exit": "quit", "q": "quit"}
_FILE_ARG_COMMANDS = {"create", "oneshot", "loadtest"}


class ShellCompleter:
    """readline completer: commands at word 0, then per-command operands —
    session ids, node kinds, or filenames (reference SkitCompleter)."""

    def __init__(self, shell: "Shell") -> None:
        self.shell = shell
        self._matches: List[str] = []

    def _candidates(self, line: str, text: str) -> List[str]:
        try:
            before = line[: line.rfind(text)] if text else line
            words = before.split()
        except Exception:
            words = []
        if not words:  # completing the command itself
            return sorted(list(COMMANDS) + list(ALIASES))
        cmd = ALIASES.get(words[0], words[0])
        argn = len(words)  # 1 => first operand
        if cmd in ("use", "destroy") and argn == 1:
            return self.shell.known_sessions
        if cmd == "add" and argn == 2:
            return self.shell.known_kinds
        if cmd == "nodes" and argn == 1:
            return self.shell.known_kinds
        if cmd in ("tune", "rm") and argn == 1:
            return self.shell.known_nodes
        if cmd in _FILE_ARG_COMMANDS:
            hits = _glob.glob(text + "*")
            return [h + ("/" if os.path.isdir(h) else "") for h in hits]
        return []

    def __call__(self, text: str, state: int):  # readline protocol
        if state == 0:
            try:
                import readline

                line = readline.get_line_buffer()
            except Exception:
                line = text
            self._matches = [c for c in self._candidates(line, text) if c.startswith(text)]
        return self._matches[state] if state < len(self._matches) else None


class Shell:
    def __init__(self, client: SkitClient) -> None:
        self.client = client
        self.session: Optional[str] = None
        # completion caches — refreshed opportunistically, never blocking a key
        self.known_sessions: List[str] = []
        self.known_kinds: List[str] = []
        self.known_nodes: List[str] = []

    def _sid(self, args) -> str:
        sid = self._match_session(args[0]) if args else self.session
        if not sid:
            raise RuntimeError("no session selected (use `create` or `use <id>`)")
        return sid

    def _match_session(self, prefix: str) -> str:
        """Exact id, else unique known-id prefix (rustyline completes full
        ids; prefix matching is the no-readline equivalent)."""
        hits = [s for s in self.known_sessions if s.startswith(prefix)]
        if len(hits) == 1:
            return hits[0]
        return prefix

    async def _refresh_sessions(self) -> List[dict]:
        sessions = await self.client.list_sessions()
        self.known_sessions = [s["id"] for s in sessions]
        return sessions

    def _print_help(self, args: List[str]) -> None:
        if args:
            cmd = ALIASES.get(args[0], args[0])
            if cmd in COMMANDS:
                usage, desc = COMMANDS[cmd]
                print(f"  {usage}\n      {desc}")
            else:
                print(f"unknown command {args[0]!r}")
            return
        print("commands:")
        for usage, desc in COMMANDS.values():
            print(f"  {usage:44s} {desc}")
        print("\ntab completes commands, session ids, node kinds, and file paths.")

    async def dispatch(self, line: str) -> bool:
        try:
            parts = shlex.split(line)
        except ValueError as e:
            print(f"parse error: {e}")
            return True
        if not parts:
            return True
        cmd, args = ALIASES.get(parts[0], parts[0]), parts[1:]
        try:
            if cmd == "quit":
                return False
            elif cmd == "help":
                self._print_help(args)
            elif cmd == "sessions":
                for s in await self._refresh_sessions():
                    marker = "*" if s["id"] == self.session else " "
                    print(f"{marker} {s['id']}  {s.get('name') or ''}")
            elif cmd == "create":
                await self._create(args)
            elif cmd == "use":
                await self._refresh_sessions()
                self.session = self._match_session(args[0])
                print(f"selected {self.session}")
            elif cmd == "destroy":
                await self._refresh_sessions()
                sid = self._sid(args)
                await self.client.request("destroysession", session_id=sid)
                if sid == self.session:
                    self.session = None
                print(f"destroyed {sid}")
            elif cmd == "nodes":
                kinds = await self.client.schema_nodes()
                self.known_kinds = [n["kind"] for n in kinds]
                pat = args[0] if args else ""
                for n in kinds:
                    if pat in n["kind"]:
                        print(f"{n['kind']:42s} {n['description']}")
            elif cmd == "add":
                params = json.loads(args[2]) if len(args) > 2 else None
                await self.client.request(
                    "addnode", session_id=self._sid([]), node_id=args[0], kind=args[1], params=params
                )
                self.known_nodes.append(args[0])
                print("ok")
            elif cmd == "rm":
                await self.client.request("removenode", session_id=self._sid([]), node_id=args[0])
                if args[0] in self.known_nodes:
                    self.known_nodes.remove(args[0])
                print("ok")
            elif cmd in ("connect", "disconnect"):
                fpin = args[2] if len(args) > 2 else "out"
                tpin = args[3] if len(args) > 3 else "in"
                await self.client.request(
                    cmd, session_id=self._sid([]), from_node=args[0], from_pin=fpin,
                    to_node=args[1], to_pin=tpin,
                )
                print("ok")
            elif cmd == "tune":
                await self._tune(args)
            elif cmd == "pipeline":
                p = await self.client.request("getpipeline", session_id=self._sid([]))
                pipe = p["pipeline"]
                self.known_nodes = list(pipe["nodes"])
                for name, node in pipe["nodes"].items():
                    print(f"  {name:20s} {node['kind']:32s} {node.get('state')}")
                for c in pipe["connections"]:
                    print(f"  {c['from_node']}:{c['from_pin']} -> {c['to_node']}:{c['to_pin']}")
            elif cmd == "watch":
                n = int(args[0]) if args else 5
                count = 0
                async for ev in self.client.events():
                    print(json.dumps(ev))
                    count += 1
                    if count >= n:
                        break
            elif cmd == "oneshot":
                await self._oneshot(args)
            elif cmd == "loadtest":
                await self._loadtest(args)
            else:
                print(f"unknown command {cmd!r} (try `help`)")
        except (RuntimeError, IndexError, json.JSONDecodeError, OSError) as e:
            print(f"error: {e}")
        return True

    async def _create(self, args: List[str]) -> None:
        """``create [name]`` or reference-style ``create <pipeline.yaml>
        [--name <name>]`` (shell.rs:375) — a config path starts the session
        with that pipeline."""
        name = None
        config = None
        rest = list(args)
        if "--name" in rest:
            i = rest.index("--name")
            name = rest[i + 1]
            del rest[i : i + 2]
        if rest and rest[0].endswith((".yaml", ".yml", ".json")):
            with open(rest[0]) as f:
                config = f.read()
        elif rest:
            name = rest[0]
        if config is not None:
            p = await self.client.create_session_http(name=name, yaml_text=config)
            sid = p.get("session_id") or p.get("id")
        else:
            p = await self.client.request("createsession", name=name)
            sid = p["session_id"]
        self.session = sid
        self.known_sessions.append(sid)
        print(f"created + selected {sid} ({p.get('name')})")

    async def _tune(self, args: List[str]) -> None:
        """JSON form (`tune gain {"gain": 2}`) or the reference's
        param/value form (`tune gain gain 2`, shell.rs:358)."""
        node_id = args[0]
        if len(args) == 3 and not args[1].lstrip().startswith("{"):
            val: object = args[2]
            for cast in (int, float):
                try:
                    val = cast(args[2])
                    break
                except ValueError:
                    continue
            params = {args[1]: val}
        else:
            params = json.loads(args[1])
        await self.client.request(
            "tunenode", session_id=self._sid([]), node_id=node_id,
            message={"type": "update_params", "params": params},
        )
        print("ok")

    async def _oneshot(self, args: List[str]) -> None:
        if len(args) != 3:
            raise RuntimeError("usage: oneshot <pipeline.yaml> <input> <output>")
        with open(args[0]) as f:
            yaml_text = f.read()
        with open(args[1], "rb") as f:
            media = f.read()
        out, ctype = await self.client.process_oneshot(yaml_text, media)
        with open(args[2], "wb") as f:
            f.write(out)
        print(f"wrote {len(out)} bytes ({ctype}) -> {args[2]}")

    async def _loadtest(self, args: List[str]) -> None:
        from .loadtest import LoadTestConfig, run_load_test

        if not args:
            raise RuntimeError("usage: loadtest <config.toml> [--duration <s>] [--cleanup]")
        cfg = LoadTestConfig.from_toml(args[0])
        cfg.server = self.client.base_url
        rest = args[1:]
        if "--duration" in rest:
            cfg.duration_secs = float(rest[rest.index("--duration") + 1])
        print(f"loadtest {cfg.scenario!r} for {cfg.duration_secs:.0f}s against {cfg.server}")
        pre = {s["id"] for s in await self._refresh_sessions()}
        summary = await run_load_test(cfg, realtime=True)
        for name, s in summary.items():
            print(
                f"  {name}: {s['requests']} reqs, {s['success_rate'] * 100:.1f}% ok, "
                f"p50 {s['p50_ms']:.0f}ms p90 {s['p90_ms']:.0f}ms p99 {s['p99_ms']:.0f}ms"
            )
        if "--cleanup" in rest:  # reference --cleanup (shell.rs:388): only
            # sessions the test left behind, never pre-existing ones
            leftovers = [s for s in await self._refresh_sessions() if s["id"] not in pre]
            for s in leftovers:
                try:
                    await self.client.request("destroysession", session_id=s["id"])
                except Exception:
                    pass
            print(f"cleaned up {len(leftovers)} session(s)")

    async def _prime_completion(self) -> None:
        """Best-effort caches so the first TAB already completes."""
        try:
            await self._refresh_sessions()
            self.known_kinds = [n["kind"] for n in await self.client.schema_nodes()]
        except Exception:
            pass

    def _setup_readline(self):
        try:
            import readline
        except ImportError:
            return None
        try:
            readline.read_history_file(HISTORY_FILE)
        except OSError:
            pass
        readline.set_history_length(1000)
        readline.set_completer(ShellCompleter(self))
        readline.set_completer_delims(" \t")
        readline.parse_and_bind("tab: complete")
        return readline

    async def repl(self) -> None:
        print("streamkit-tpu shell — `help` for commands, TAB completes")
        rl = self._setup_readline()
        await self._prime_completion()
        loop = asyncio.get_running_loop()
        while True:
            prompt = f"skit[{(self.session or '-')[:8]}]> "
            try:
                line = await loop.run_in_executor(None, lambda: input(prompt))
            except (EOFError, KeyboardInterrupt):
                break
            if not await self.dispatch(line):
                break
        if rl is not None:
            try:
                rl.write_history_file(HISTORY_FILE)
            except OSError:
                pass


async def run_shell(server: str) -> int:
    async with SkitClient(server) as client:
        await client.connect_ws()
        await Shell(client).repl()
    return 0
