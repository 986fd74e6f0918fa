# SPDX-License-Identifier: Apache-2.0
"""Sandboxed per-packet scripting node.

Parity target: ``core::script`` (``nodes/src/core/script.rs``, 2,482 LoC):
the reference embeds QuickJS with a per-packet ``process(packet)`` function,
100 ms timeout, 64 MB memory cap, and an allowlisted ``fetch()``.

Host-side equivalent (a copy of the JAX package's ``nodes/core_nodes/script.py``;
no device work): a **restricted-Python** expression VM — scripts are
parsed to an AST and only a whitelisted node set is allowed (no imports, no
attribute access except on the packet proxy, no dunder names). This keeps
per-packet transforms (routing, filtering, field rewriting, simple math)
without embedding a JS engine; per-packet wall-clock budget enforced.

Script contract (mirrors the reference's):
    a ``process(packet)`` function defined in the script body, returning
    ``packet`` (possibly modified), a new packet dict, or ``None`` to drop.
Packet proxy fields: ``kind``, ``text``, ``data`` (custom payload),
``metadata`` (dict), ``content_type``; helpers ``emit(event, data)``,
``text_packet(s)``, ``custom_packet(type_id, data)``.
"""

from __future__ import annotations

import ast
import asyncio
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ...core import (
    ChannelClosed,
    ConfigurationError,
    CustomPacketData,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    ProcessorNode,
    RuntimeNodeError,
    TelemetryEmitter,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason

_ALLOWED_NODES = (
    ast.Try, ast.ExceptHandler, ast.Raise,  # so scripts can handle fetch() failures
    ast.Module, ast.FunctionDef, ast.arguments, ast.arg, ast.Return, ast.Pass,
    ast.Expr, ast.Assign, ast.AugAssign, ast.AnnAssign, ast.If, ast.For, ast.While,
    ast.Break, ast.Continue, ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.Lambda,
    ast.IfExp, ast.Dict, ast.Set, ast.ListComp, ast.SetComp, ast.DictComp,
    # NOTE: ast.GeneratorExp is deliberately NOT allowed — a live generator
    # object exposes gi_frame/send() which walk out of the sandbox.
    ast.Compare, ast.Call, ast.Constant, ast.Attribute,
    ast.Subscript, ast.Starred, ast.Name, ast.List, ast.Tuple, ast.Slice,
    ast.comprehension, ast.keyword, ast.JoinedStr, ast.FormattedValue,
    ast.Load, ast.Store, ast.Del,
    ast.And, ast.Or, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv,
    ast.Mod, ast.Pow, ast.LShift, ast.RShift, ast.BitOr, ast.BitXor,
    ast.BitAnd, ast.Not, ast.Invert, ast.UAdd, ast.USub, ast.Eq, ast.NotEq,
    ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.Is, ast.IsNot, ast.In, ast.NotIn,
)

# Attribute access is allowlist-only: the packet-proxy fields plus known-safe
# methods of str/dict/list/set/tuple. Anything else (frame/generator/function
# introspection like gi_frame, f_back, f_globals, send, throw, __class__…) is
# rejected at parse time. str.format/format_map are excluded because format
# strings can traverse attributes ("{0.__class__}").
_ALLOWED_ATTRS = frozenset(
    # packet proxy fields
    ["kind", "text", "data", "type_id", "metadata", "content_type"]
    # str
    + ["upper", "lower", "strip", "lstrip", "rstrip", "split", "rsplit",
       "splitlines", "join", "replace", "startswith", "endswith", "find",
       "rfind", "count", "title", "capitalize", "casefold", "center",
       "ljust", "rjust", "zfill", "isdigit", "isalpha", "isalnum",
       "isspace", "isupper", "islower", "encode", "decode"]
    # dict
    + ["get", "keys", "values", "items", "update", "pop", "popitem",
       "setdefault", "clear", "copy"]
    # list
    + ["append", "extend", "insert", "remove", "sort", "reverse", "index"]
    # set
    + ["add", "discard", "union", "intersection", "difference",
       "symmetric_difference", "issubset", "issuperset"]
)

# Parse-time resource caps (reference MAX_SCRIPT_BYTES = 256 KiB,
# script.rs; the depth cap guards ast.parse/compile recursion).
_MAX_SCRIPT_BYTES = 256 * 1024
_MAX_NESTING_DEPTH = 100

_SAFE_BUILTINS = {
    "len": len, "min": min, "max": max, "abs": abs, "sum": sum, "round": round,
    "int": int, "float": float, "str": str, "bool": bool, "list": list,
    "dict": dict, "set": set, "tuple": tuple, "sorted": sorted, "reversed": reversed,
    "enumerate": enumerate, "zip": zip, "range": range, "any": any, "all": all,
    "isinstance": isinstance, "repr": repr, "None": None, "True": True, "False": False,
    "Exception": Exception, "ValueError": ValueError, "RuntimeError": RuntimeError,
    "TypeError": TypeError, "KeyError": KeyError,
}


# ---------------------------------------------------------------------------
# fetch(): allowlisted outbound HTTP (reference script.rs:83-141 AllowlistRule,
# 168-268 pattern matching + semaphore, 869-1060 fetch registration).
# Secure by default: empty global allowlist blocks every call.
# ---------------------------------------------------------------------------

_FETCH_TIMEOUT_SECS = 5.0  # reference: 5s connect + 5s send + 5s body read
_FETCH_MAX_BODY = 8 * 1024 * 1024  # defensive cap (reference reads unbounded)
_FETCH_SEMAPHORE = threading.BoundedSemaphore(
    max(1, int(os.environ.get("SK_SCRIPT_FETCH_MAX_INFLIGHT", "16")))
)


class _NoRedirectHandler(urllib.request.HTTPRedirectHandler):
    """Never follow redirects: an allowlisted endpoint that 302s to an
    attacker host would otherwise leak injected secret headers and bypass
    the allowlist (reference sets redirect Policy::none, script.rs:176).
    Returning None makes urllib raise HTTPError for the 3xx, which the
    caller returns as-is."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):  # noqa: D102
        return None


_FETCH_OPENER = urllib.request.build_opener(_NoRedirectHandler)


@dataclass
class ScriptSecret:
    """Server-loaded secret, injectable into fetch() headers only
    (reference ``script.rs:106-121``)."""

    value: str
    allowed_fetch_urls: List[str] = field(default_factory=list)


@dataclass
class GlobalScriptConfig:
    """Server-wide script policy (reference ``script.rs:95-104``): there is
    deliberately no per-pipeline allowlist override."""

    fetch_allowlist: List[dict] = field(default_factory=list)  # {"url","methods"}
    secrets: Dict[str, ScriptSecret] = field(default_factory=dict)


_GLOBAL_SCRIPT_CONFIG = GlobalScriptConfig()


def set_global_script_config(
    fetch_allowlist: Optional[List[dict]] = None,
    secrets: Optional[Dict[str, ScriptSecret]] = None,
) -> None:
    """Install server-level fetch policy (called once at server startup)."""
    global _GLOBAL_SCRIPT_CONFIG
    _GLOBAL_SCRIPT_CONFIG = GlobalScriptConfig(
        list(fetch_allowlist or []), dict(secrets or {})
    )


def _wildmatch(pattern: str, s: str) -> bool:
    """``*``/``?`` wildcard match (reference uses the wildmatch crate)."""
    rx = "".join(
        ".*" if c == "*" else "." if c == "?" else re.escape(c) for c in pattern
    )
    return re.fullmatch(rx, s) is not None


def parse_allowlist_pattern(pattern: str) -> Optional[Tuple[str, str, str]]:
    """``https://host[:port]/path*`` → (scheme, host_pattern, path_pattern);
    missing path defaults to ``/*`` (reference ``script.rs:198-220``)."""
    if "://" not in pattern:
        return None
    scheme, _, rest = pattern.partition("://")
    scheme, rest = scheme.strip().lower(), rest.strip()
    if not scheme or not rest:
        return None
    host, sep, path = rest.partition("/")
    if not host.strip():
        return None
    return scheme, host, ("/" + path) if sep else "/*"


def _url_matches(url: str, scheme_pat: str, host_pat: str, path_pat: str) -> bool:
    try:
        parsed = urllib.parse.urlsplit(url)
    except ValueError:
        return False
    if not parsed.hostname:
        return False
    if parsed.scheme.lower() != scheme_pat:
        return False
    # rule with an explicit port pattern matches host:port, else host only
    candidate = parsed.hostname
    if ":" in host_pat:
        candidate = f"{parsed.hostname}:{parsed.port}" if parsed.port else parsed.hostname
    if not _wildmatch(host_pat, candidate):
        return False
    return _wildmatch(path_pat, parsed.path or "/")


def _url_allowed_by_patterns(url: str, patterns: List[str]) -> bool:
    for pat in patterns:
        parts = parse_allowlist_pattern(pat)
        if parts and _url_matches(url, *parts):
            return True
    return False


def is_url_allowed(url: str, method: str, allowlist: List[dict]) -> bool:
    """Fail-safe allowlist check (reference ``script.rs:775-831``)."""
    if not allowlist:
        return False  # empty allowlist = block all
    for rule in allowlist:
        methods = rule.get("methods") or []
        if not any(m.upper() == method.upper() for m in methods):
            continue
        parts = parse_allowlist_pattern(rule.get("url", ""))
        if parts and _url_matches(url, *parts):
            return True
    return False


# fetch time is credited back to the script's line-trace deadline: the 5s
# network budget is fetch's own, not the per-packet compute budget's.
_DEADLINE_CREDIT = threading.local()


def _do_fetch(
    url: str,
    options: Optional[dict],
    header_mappings: List[dict],
) -> str:
    """Blocking allowlisted HTTP call; returns the response body text.

    Mirrors reference semantics: method from options (default GET), secret
    headers injected host-side (URL-scoped), script headers additive, JSON
    body only for POST/PUT/PATCH, 5s timeout, bounded concurrency.
    """
    cfg = _GLOBAL_SCRIPT_CONFIG
    options = options or {}
    method = str(options.get("method", "GET")).upper()
    if not is_url_allowed(url, method, cfg.fetch_allowlist):
        reason = (
            "global allowlist is empty"
            if not cfg.fetch_allowlist
            else "URL not in global allowlist"
        )
        raise RuntimeError(f"fetch blocked: {reason}")
    headers: Dict[str, str] = {}
    for mapping in header_mappings:
        secret = cfg.secrets.get(mapping.get("secret", ""))
        if secret is None:
            continue  # unknown secret: header silently not added (reference)
        if secret.allowed_fetch_urls and not _url_allowed_by_patterns(
            url, secret.allowed_fetch_urls
        ):
            continue  # secret is URL-scoped and this URL isn't in scope
        template = mapping.get("template", "{}")
        headers[mapping["header"]] = template.replace("{}", secret.value)
    for k, v in (options.get("headers") or {}).items():
        headers[str(k)] = str(v)
    data = None
    if method in ("POST", "PUT", "PATCH") and options.get("body") is not None:
        data = str(options["body"]).encode()
        headers.setdefault("Content-Type", "application/json")

    if not _FETCH_SEMAPHORE.acquire(timeout=_FETCH_TIMEOUT_SECS):
        raise RuntimeError("fetch blocked: too many concurrent fetch() calls")
    t0 = time.monotonic()
    try:
        req = urllib.request.Request(url, data=data, headers=headers, method=method)
        with _FETCH_OPENER.open(req, timeout=_FETCH_TIMEOUT_SECS) as resp:
            body = resp.read(_FETCH_MAX_BODY + 1)
            if len(body) > _FETCH_MAX_BODY:
                raise RuntimeError("fetch failed: response exceeds 8 MiB cap")
            charset = resp.headers.get_content_charset() or "utf-8"
            return body.decode(charset, errors="replace")
    except urllib.error.HTTPError as e:
        # non-2xx still has a readable body (reference returns response.text())
        body = e.read(_FETCH_MAX_BODY)
        return body.decode("utf-8", errors="replace")
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise RuntimeError(f"fetch failed: {e}") from e
    finally:
        _FETCH_SEMAPHORE.release()
        holder = getattr(_DEADLINE_CREDIT, "holder", None)
        if holder is not None:
            holder[0] += time.monotonic() - t0


def _check_source_limits(src: str) -> None:
    """Pre-parse resource caps: size and bracket-nesting depth (a deeply
    nested literal can exhaust the parser/compiler stack in-process)."""
    if len(src.encode("utf-8", errors="replace")) > _MAX_SCRIPT_BYTES:
        raise ConfigurationError(
            f"script exceeds {_MAX_SCRIPT_BYTES // 1024} KiB limit"
        )
    depth = 0
    for ch in src:
        if ch in "([{":
            depth += 1
            if depth > _MAX_NESTING_DEPTH:
                raise ConfigurationError(
                    f"script nesting exceeds depth {_MAX_NESTING_DEPTH}"
                )
        elif ch in ")]}":
            depth = max(0, depth - 1)


def _validate_script(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ConfigurationError(
                f"script uses disallowed syntax: {type(node).__name__}"
            )
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise ConfigurationError(f"dunder name not allowed: {node.id}")
        if isinstance(node, ast.Attribute) and node.attr not in _ALLOWED_ATTRS:
            raise ConfigurationError(f"attribute not allowed: {node.attr}")
        if isinstance(node, ast.ExceptHandler):
            # a bare/BaseException handler could swallow the deadline signal
            if node.type is None:
                raise ConfigurationError("bare 'except:' not allowed (catch Exception)")
            for sub in ast.walk(node.type):
                if isinstance(sub, ast.Name) and sub.id == "BaseException":
                    raise ConfigurationError("catching BaseException not allowed")


class _PacketProxy:
    """Safe, mutable view of a packet for scripts."""

    __slots__ = ("kind", "text", "data", "type_id", "metadata", "content_type", "_drop")

    def __init__(self, pkt: Packet) -> None:
        self.kind = pkt.kind.value
        self.text = pkt.text if pkt.text is not None else (
            pkt.transcription.text if pkt.transcription else None
        )
        self.data = pkt.custom.data if pkt.custom else None
        self.type_id = pkt.custom.type_id if pkt.custom else None
        self.metadata = pkt.metadata.to_json() if pkt.metadata else {}
        self.content_type = pkt.content_type


class ScriptNode(ProcessorNode):
    """Per-packet restricted-Python transform (``core::script``)."""

    KIND = "core::script"

    def __init__(self, params: Optional[dict]) -> None:
        cfg = parse_config_optional(
            params,
            {
                "script": None,
                "script_path": None,  # reference param (script.rs config)
                # auto: .js path or JS-looking source → the mjs JavaScript
                # engine (reference QuickJS dialect, utils/mjs.py);
                # otherwise the sandboxed-Python dialect
                "language": "auto",
                "timeout_ms": 100.0,
                "memory_limit_mb": 64.0,  # accepted (mjs bounds via op budget)
                "pass_audio_through": True,
                "max_events_per_sec": 100.0,
                # fetch() secret→header injection (reference HeaderMapping,
                # script.rs:24-44): [{"secret", "header", "template"}]
                "headers": [],
            },
        )
        source = cfg["script"]
        self.script_path = cfg["script_path"]
        if source is None and self.script_path:
            try:
                with open(self.script_path, encoding="utf-8") as f:
                    source = f.read()
            except OSError as e:
                raise ConfigurationError(f"cannot read script_path: {e}") from e
        if not source:
            raise ConfigurationError("script node requires a 'script' or 'script_path' parameter")
        self.timeout = float(cfg["timeout_ms"]) / 1000.0
        self.pass_audio = bool(cfg["pass_audio_through"])
        self.max_events_per_sec = float(cfg["max_events_per_sec"])
        self.header_mappings = list(cfg["headers"] or [])
        for m in self.header_mappings:
            if not isinstance(m, dict) or "secret" not in m or "header" not in m:
                raise ConfigurationError(
                    "headers entries must be {secret, header[, template]} mappings"
                )
        _check_source_limits(source)
        lang = str(cfg["language"])
        if lang not in ("auto", "python", "javascript"):
            raise ConfigurationError("language must be auto|python|javascript")
        if lang == "auto":
            stripped = source.lstrip()
            if (self.script_path or "").endswith(".js") or stripped.startswith(
                ("function ", "const ", "let ", "var ", "async function", "//", "/*")
            ):
                lang = "javascript"
            else:
                lang = "python"
        self.language = lang
        self._code = None
        self._js_source = None
        if lang == "javascript":
            from ...utils.mjs import JSError, _Parser, _tokenize

            try:  # parse eagerly so config errors surface at node creation
                _Parser(_tokenize(source)).parse_program()
            except JSError as e:
                raise ConfigurationError(f"javascript syntax error: {e}") from e
            self._js_source = source
            return
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            raise ConfigurationError(f"script syntax error: {e}") from e
        _validate_script(tree)
        self._code = compile(tree, "<script-node>", "exec")

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.any()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.passthrough())]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx, self.max_events_per_sec)
        if self._js_source is not None:
            await self._run_js(ctx, stats, telemetry)
            return

        emitted: List[dict] = []
        env: Dict[str, Any] = {
            "__builtins__": _SAFE_BUILTINS,
            "emit": lambda event, data=None: emitted.append({"event": event, "data": data or {}}),
            "text_packet": lambda s: {"__packet__": "text", "text": str(s)},
            "custom_packet": lambda tid, data: {"__packet__": "custom", "type_id": tid, "data": data},
            "state": {},  # persistent per-node scratch dict
            # allowlisted blocking HTTP (reference fetch(), script.rs:869+)
            "fetch": lambda url, options=None: _do_fetch(
                url, options, self.header_mappings
            ),
        }
        exec(self._code, env)  # define process() — validated AST, safe builtins
        process = env.get("process")
        if not callable(process):
            raise ConfigurationError("script must define a process(packet) function")

        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.audio is not None and self.pass_audio:
                    await ctx.output.send("out", pkt)
                    stats.packet_sent()
                    continue
                proxy = _PacketProxy(pkt)
                emitted.clear()
                loop = asyncio.get_running_loop()
                try:
                    # run on an executor thread with a tracing deadline: a
                    # runaway script neither blocks the event loop nor runs
                    # past its wall-clock budget
                    result = await loop.run_in_executor(
                        None, _run_with_deadline, process, proxy, self.timeout
                    )
                except _ScriptTimeout as e:
                    stats.packet_errored()
                    telemetry.emit("script.timeout", {"ms": e.elapsed_ms})
                    # reference passes the packet through on timeout
                    # (script.rs:760-770)
                    await ctx.output.send("out", pkt)
                    stats.packet_sent()
                    continue
                except Exception as e:  # noqa: BLE001 — script errors don't kill the node
                    stats.packet_errored()
                    telemetry.emit("script.error", {"error": f"{type(e).__name__}: {e}"})
                    continue
                for ev in emitted:
                    telemetry.emit(ev["event"], ev["data"])
                out_pkt = self._materialize(result, proxy, pkt)
                if out_pkt is None:
                    stats.packet_discarded()
                    continue
                await ctx.output.send("out", out_pkt)
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))

    # ------------------------------------------------------------------ JS
    async def _run_js(self, ctx: NodeContext, stats, telemetry) -> None:
        """QuickJS-dialect execution via :mod:`...utils.mjs`: per-packet
        ``process(packet)`` with the reference's packet shape
        (``script.rs:453-693``), fetch() allowlist + secret headers, and the
        telemetry span API (``script.rs:1071-1097``)."""
        from ...utils.mjs import (
            JSError,
            JSInterpreter,
            JSObject,
            from_python,
            js_to_string,
            to_python,
        )

        interp = JSInterpreter(op_budget=50_000_000)
        interp.set_global(
            "fetch",
            lambda url, options=None: _do_fetch(
                js_to_string(url), to_python(options), self.header_mappings
            ),
        )
        spans: Dict[str, tuple] = {}
        span_seq = [0]

        def start_span(event_type, data=None):
            span_seq[0] += 1
            sid = f"span-{span_seq[0]}"
            spans[sid] = (js_to_string(event_type), time.monotonic(), to_python(data) or {})
            return sid

        def end_span(sid, data=None):
            info = spans.pop(js_to_string(sid), None)
            if info is None:
                return
            event_type, t0, d0 = info
            payload = dict(d0)
            payload.update(to_python(data) or {})
            payload["duration_ms"] = round((time.monotonic() - t0) * 1000, 1)
            telemetry.emit(event_type, payload)

        tel = JSObject()
        tel["emit"] = lambda ev, data=None: telemetry.emit(js_to_string(ev), to_python(data) or {})
        tel["startSpan"] = start_span
        tel["endSpan"] = end_span
        interp.set_global("telemetry", tel)
        console = JSObject()
        console["log"] = lambda *a: telemetry.emit(
            "script.log", {"message": " ".join(js_to_string(x) for x in a)[:500]}
        )
        console["warn"] = console["log"]
        console["error"] = console["log"]
        interp.set_global("console", console)

        loop = asyncio.get_running_loop()
        try:
            # top-level runs once (module state persists across packets,
            # like the reference's long-lived QuickJS context)
            await loop.run_in_executor(
                None, _run_with_deadline, lambda _: interp.run(self._js_source), None,
                max(self.timeout, 1.0),
            )
        except (JSError, _ScriptTimeout) as e:
            raise RuntimeNodeError(f"script top-level failed: {e}") from e
        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.audio is not None and self.pass_audio:
                    await ctx.output.send("out", pkt)
                    stats.packet_sent()
                    continue
                js_pkt = _packet_to_js(pkt)
                try:
                    result = await loop.run_in_executor(
                        None, _run_with_deadline,
                        lambda p: interp.call("process", p), js_pkt, self.timeout,
                    )
                except _ScriptTimeout as e:
                    stats.packet_errored()
                    telemetry.emit("script.timeout", {"ms": e.elapsed_ms})
                    await ctx.output.send("out", pkt)  # reference passthrough
                    stats.packet_sent()
                    continue
                except JSError as e:
                    stats.packet_errored()
                    telemetry.emit("script.error", {"error": str(e)[:500]})
                    continue
                out_pkt = _js_to_packet(result, pkt)
                if out_pkt is None:
                    stats.packet_discarded()
                    continue
                await ctx.output.send("out", out_pkt)
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))

    @staticmethod
    def _materialize(result, proxy: _PacketProxy, original: Packet) -> Optional[Packet]:
        if result is None:
            return None
        if isinstance(result, dict) and result.get("__packet__") == "text":
            return Packet.new_text(result["text"], original.metadata)
        if isinstance(result, dict) and result.get("__packet__") == "custom":
            return Packet.new_custom(
                CustomPacketData(result["type_id"], result["data"]), original.metadata
            )
        if isinstance(result, _PacketProxy):
            # write back mutations of text/data
            if original.text is not None and result.text != original.text:
                return Packet.new_text(result.text, original.metadata)
            if original.custom is not None and result.data != original.custom.data:
                return Packet.new_custom(
                    CustomPacketData(original.custom.type_id, result.data), original.metadata
                )
            return original
        if isinstance(result, str):
            return Packet.new_text(result, original.metadata)
        return original


def _packet_to_js(pkt: Packet):
    """Packet → the reference's JS packet shape (script.rs:453-628):
    {type, data, ...}; audio carries metadata only."""
    from ...utils.mjs import JSObject, from_python

    obj = JSObject()
    if pkt.text is not None:
        obj["type"] = "Text"
        obj["data"] = pkt.text
    elif pkt.transcription is not None:
        tr = pkt.transcription
        obj["type"] = "Transcription"
        data = JSObject()
        data["text"] = tr.text
        if tr.language:
            data["language"] = tr.language
        data["segments"] = from_python(
            [
                {
                    "text": s.text,
                    "start_time_ms": s.start_time_ms,
                    "end_time_ms": s.end_time_ms,
                }
                for s in tr.segments
            ]
        )
        obj["data"] = data
    elif pkt.custom is not None:
        obj["type"] = "Custom"
        obj["type_id"] = pkt.custom.type_id
        obj["data"] = from_python(pkt.custom.data)
    elif pkt.audio is not None:
        obj["type"] = "Audio"
        meta = JSObject()
        meta["sample_rate"] = float(pkt.audio.format.sample_rate)
        meta["channels"] = float(pkt.audio.format.channels)
        frames = len(pkt.audio.samples) // max(1, pkt.audio.format.channels)
        meta["frames"] = float(frames)
        meta["duration_ms"] = float(frames * 1000 // max(1, pkt.audio.format.sample_rate))
        obj["metadata"] = meta
    elif pkt.binary is not None:
        obj["type"] = "Binary"
        obj["content_type"] = pkt.content_type or ""
        obj["size"] = float(len(pkt.binary))
    return obj


def _js_to_packet(result, original: Packet) -> Optional[Packet]:
    """JS return value → Packet (script.rs:629-693): null drops; {type:
    'Text'|'Custom', ...} builds a new packet; the input object (or any
    other value) passes the original through."""
    from ...utils.mjs import UNDEFINED, JSObject, js_to_string, to_python

    if result is None or result is UNDEFINED:
        return None
    if isinstance(result, JSObject):
        ptype = result.get("type")
        if ptype == "Text":
            return Packet.new_text(js_to_string(result.get("data", "")), original.metadata)
        if ptype == "Custom":
            return Packet.new_custom(
                CustomPacketData(
                    js_to_string(result.get("type_id", "script/custom@1")),
                    to_python(result.get("data")),
                ),
                original.metadata,
            )
        return original
    if isinstance(result, str):
        return Packet.new_text(result, original.metadata)
    return original


class _ScriptTimeout(BaseException):
    """BaseException so sandbox scripts (which may only catch Exception)
    cannot swallow the deadline signal."""

    def __init__(self, elapsed_ms: float) -> None:
        super().__init__(f"script exceeded budget ({elapsed_ms:.0f} ms)")
        self.elapsed_ms = elapsed_ms


def _run_with_deadline(fn, arg, timeout_secs: float):
    """Execute fn(arg) on this thread, aborting via a line-trace deadline.

    sys.settrace fires per line of *Python* script code, so loops written in
    the sandbox abort at the deadline (C-level builtins can still overrun —
    the sandbox whitelist keeps those bounded). Time spent inside fetch()
    is credited back: network waits have their own 5s budget and must not
    consume the per-packet compute budget.
    """
    credit = [0.0]
    _DEADLINE_CREDIT.holder = credit
    t0 = time.monotonic()

    def tracer(frame, event, _arg):
        if time.monotonic() > t0 + timeout_secs + credit[0]:
            raise _ScriptTimeout((time.monotonic() - t0) * 1000)
        return tracer

    sys.settrace(tracer)
    try:
        return fn(arg)
    finally:
        sys.settrace(None)
        _DEADLINE_CREDIT.holder = None
