# SPDX-License-Identifier: Apache-2.0
"""The script node and its JavaScript interpreter in both packages: the
port's ``utils/mjs.py`` and ``nodes/core_nodes/script.py`` against the JAX
package's, on the same scripts and packets (host code: equal exactly).

* every case of ``tests/test_mjs.py`` runs once on each interpreter (the same
  test function with its names bound to the port's module), and a corpus of
  programs gives equal values in both;
* the JavaScript node cases of ``tests/test_script_js.py`` and the Python
  dialect's transforms and refusals give equal packets, telemetry and errors;
* ``fetch()``: the allowlist matrix, secret scoping, a refused method, a
  redirect that is not followed, against a stub served by the port's own
  HTTP layer; the server config installs the same policy in both.

Budgets are deterministic: a script that must finish gets 10 s for
microseconds of work, a script that must time out never ends.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import types

import pytest
import torch

import streamkit_tpu.core as jax_core
import streamkit_tpu.nodes.core_nodes.script as jax_script
import streamkit_tpu.utils.mjs as jax_mjs
import streamkit_tpu_torch.core as torch_core
import streamkit_tpu_torch.nodes.core_nodes.script as torch_script
import streamkit_tpu_torch.utils.mjs as torch_mjs
from streamkit_tpu_torch.server import http as web

import test_mjs as ref_mjs

torch.set_num_threads(2)  # pytest runs files in parallel workers: leave cores to the others

PACKAGES = {"jax": (jax_core, jax_script), "torch": (torch_core, torch_script)}
BUDGET_MS = 10_000  # a finishing script's per-packet budget


@pytest.fixture(autouse=True)
def _reset_policy():
    yield
    for _, script in PACKAGES.values():
        script.set_global_script_config([], {})


# -- the interpreter ------------------------------------------------------------
def _on_port(fn):
    """``fn`` (a function of ``tests/test_mjs.py``) with every name the module
    imported from the JAX package's ``mjs`` bound to the port's, and the
    module's own helpers rebound the same way."""
    env = dict(vars(ref_mjs))
    for name, value in vars(ref_mjs).items():
        if getattr(value, "__module__", None) == jax_mjs.__name__ or value is jax_mjs.UNDEFINED:
            env[name] = getattr(torch_mjs, name)
    for name, value in vars(ref_mjs).items():
        if isinstance(value, types.FunctionType) and value.__module__ == ref_mjs.__name__:
            env[name] = types.FunctionType(value.__code__, env, name, value.__defaults__, value.__closure__)
    return env[fn.__name__]


MJS_CASES = sorted(n for n, v in vars(ref_mjs).items() if n.startswith("test_") and callable(v))


def test_the_port_has_its_own_interpreter():
    assert torch_mjs is not jax_mjs and torch_mjs.JSInterpreter is not jax_mjs.JSInterpreter
    fn = _on_port(ref_mjs.test_arithmetic_and_coercion)
    assert fn.__globals__["JSInterpreter"] is torch_mjs.JSInterpreter
    assert fn.__globals__["run"].__globals__ is fn.__globals__


@pytest.mark.parametrize("case", MJS_CASES)
def test_mjs_case_holds_in_both_interpreters(case):
    fn = getattr(ref_mjs, case)
    assert not inspect.signature(fn).parameters, case
    fn()
    _on_port(fn)()


PROGRAMS = [
    "1 + 2 * 3 - 4 / 8",
    "'a' + 1 + 2",
    "[1, '2', 3].map(x => x * 2)",
    "({a: 1, b: [1, 2, {c: 'x'}]})",
    "JSON.stringify({k: [1, 2.5, null, true], s: 'q\"'})",
    "JSON.parse('{\"a\": [1, 2, {\"b\": null}]}')",
    "'Hello World'.split(' ').reverse().join('-').toLowerCase()",
    "[5, 1, 4, 10].sort((a, b) => a - b)",
    "[5, 1, 4, 10].sort()",
    "Math.max(3, 7, 2) + Math.floor(2.7) + Math.round(2.5)",
    "(0.1 + 0.2).toFixed(2)",
    "parseInt('42px') + parseFloat('3.5e1')",
    "typeof null + typeof undefined + typeof (() => 1)",
    "'abc'.padStart(6, '*') + 'x'.repeat(3)",
    "'a-b_c d'.replace(/[-_ ]/g, '+')",
    "Object.keys({z: 1, a: 2}).concat(Object.values({z: 1, a: 2}))",
    "let s = 0; for (let i = 0; i < 10; i++) { if (i % 3 === 0) continue; s += i; } s",
    "const {a, b: [x, ...rest]} = {a: 1, b: [2, 3, 4]}; [a, x, rest]",
    "`${1 + 1} and ${'x'.toUpperCase()}`",
    "null ?? 'dflt'",
    "[1, 2, 3].includes(2) && 'yes'",
    "String(undefined) + String(null) + String(1/0) + String(-0)",
    "new Map([['a', 1]]).get('a') + new Set([1, 1, 2]).size",
    "try { throw new Error('boom'); } catch (e) { e.message + '!' }",
    "class P { constructor(x) { this.x = x; } get d() { return this.x * 2; } } new P(21).d",
    "'2024-01-02'.match(/(\\d+)-(\\d+)-(\\d+)/).slice(1).map(Number)",
    "[...'héllo'].length",
    "1 / 3",
    "2 ** 53 + 1",
    "-7 % 3",
]


def _value(interp_mod, src):
    it = interp_mod.JSInterpreter(op_budget=1_000_000)
    try:
        return ("ok", interp_mod.to_python(it.run(src)))
    except interp_mod.JSError as e:
        return ("error", str(e))


@pytest.mark.parametrize("src", PROGRAMS)
def test_program_gives_equal_values(src):
    assert _value(torch_mjs, src) == _value(jax_mjs, src)


def test_op_budget_stops_both_at_the_same_count():
    for mod in (jax_mjs, torch_mjs):
        with pytest.raises(mod.JSTimeout):
            mod.JSInterpreter(op_budget=10_000).run("while (true) {}")


# -- the node -----------------------------------------------------------------
async def _drive(pkg, params, packets):
    """Run one script node of ``pkg`` over ``packets`` → (outputs, telemetry)."""
    core, script = PACKAGES[pkg]
    node = script.ScriptNode(params)
    in_ch, out_ch, tel_ch = core.Channel(64), core.Channel(256), core.Channel(256)
    ctx = core.NodeContext(node_name="script", inputs={"in": in_ch},
                           output=core.OutputSender("script", direct={"out": out_ch}), telemetry_tx=tel_ch)
    for p in packets(core):
        in_ch.try_send(p)
    in_ch.close()
    await node.run(ctx)
    ctx.output.close()
    out = []
    while (item := await out_ch.recv_optional()) is not None:
        out.append(item)
    tel = []
    while tel_ch.qsize() > 0:
        tel.append(tel_ch.try_recv())
    return node, out, tel


def _summary(out, tel):
    """Packets and telemetry as plain data; span durations (wall time) dropped."""
    pkts = []
    for p in out:
        pkts.append((p.kind.value, p.text, p.transcription.text if p.transcription else None,
                     (p.custom.type_id, p.custom.data) if p.custom else None))
    events = [(t.event_type, {k: v for k, v in t.data.items() if k not in ("duration_ms", "ms")}) for t in tel]
    return pkts, events


def _both(params, packets):
    got = {}
    for pkg in PACKAGES:
        node, out, tel = asyncio.run(_drive(pkg, dict(params), packets))
        got[pkg] = (node.language, _summary(out, tel))
    assert got["torch"] == got["jax"]
    return got["torch"]


def _texts(*texts):
    return lambda core: [core.Packet.new_text(t) for t in texts]


def _transcription(core):
    return [core.Packet.new_text("dropme"), core.Packet.new_transcription(core.TranscriptionData(
        text="hi there", segments=(core.TranscriptionSegment("hi there", 100, 900),), language="en",
        is_final=True))]


NODE_CASES = {
    "js_autodetected_text": ({"script": """
        function process(packet) {
          if (packet.type !== 'Text') return packet;
          return { type: 'Text', data: packet.data.toUpperCase() + '!' };
        }"""}, _texts("hello")),
    "js_transcription_shape_and_drop": ({"language": "javascript", "script": """
        function process(packet) {
          if (packet.type !== 'Transcription') return null;
          const seg = packet.data.segments[0];
          return { type: 'Text', data: `${packet.data.text} [${seg.start_time_ms}-${seg.end_time_ms}]` };
        }"""}, _transcription),
    "js_state_persists": ({"language": "javascript", "script": """
        let count = 0;
        function process(packet) { count++; return { type: 'Text', data: 'n=' + count }; }"""},
                          _texts("a", "b", "c")),
    "js_telemetry_spans": ({"language": "javascript", "script": """
        function process(packet) {
          const sid = telemetry.startSpan('llm.request', { model: 'x' });
          telemetry.emit('custom.event', { k: 1 });
          console.log('seen', packet.data);
          telemetry.endSpan(sid, { status: 'ok' });
          return packet;
        }"""}, _texts("x")),
    "js_error_keeps_the_node": ({"language": "javascript", "script": """
        function process(packet) {
          if (packet.data === 'boom') throw new Error('kaput');
          return packet;
        }"""}, _texts("ok1", "boom", "ok2")),
    "js_custom_packet": ({"language": "javascript", "script": """
        function process(packet) {
          return { type: 'Custom', type_id: 'demo/words@1', data: { words: packet.data.split(' ') } };
        }"""}, _texts("one two three")),
    "js_timeout_passes_through": ({"language": "javascript", "script": "function process(p) { while (true) {} }",
                                   "timeout_ms": 100}, _texts("x")),
    "python_text_rewrite": ({"language": "python", "script": (
        "def process(p):\n"
        "    if p.text is None:\n"
        "        return p\n"
        "    emit('seen', {'n': len(p.text)})\n"
        "    return text_packet(p.text.upper() + ' [' + str(len(state)) + ']')\n")},
                            _texts("alpha", "beta")),
    "python_transcription_and_state": ({"script": (
        "def process(p):\n"
        "    state['n'] = state.get('n', 0) + 1\n"
        "    if p.kind != 'Transcription':\n"
        "        return None\n"
        "    return custom_packet('demo/t@1', {'text': p.text, 'n': state['n']})\n")}, _transcription),
    "python_error_keeps_the_node": ({"script": (
        "def process(p):\n"
        "    if p.text == 'boom':\n"
        "        raise ValueError('kaput')\n"
        "    return p\n")}, _texts("ok1", "boom", "ok2")),
    "python_timeout_cannot_be_caught": ({"script": (
        "def process(p):\n"
        "    while True:\n"
        "        try:\n"
        "            x = 1\n"
        "        except Exception:\n"
        "            pass\n"), "timeout_ms": 100}, _texts("survive")),
}


@pytest.mark.parametrize("case", sorted(NODE_CASES))
def test_script_node_matches_jax(case):
    params, packets = NODE_CASES[case]
    params = {"timeout_ms": BUDGET_MS, **params}
    language, (pkts, events) = _both(params, packets)
    expect = {
        "js_autodetected_text": [("text", "HELLO!", None, None)],
        "js_transcription_shape_and_drop": [("text", "hi there [100-900]", None, None)],
        "js_state_persists": [("text", f"n={i}", None, None) for i in (1, 2, 3)],
        "js_error_keeps_the_node": [("text", t, None, None) for t in ("ok1", "ok2")],
        "js_timeout_passes_through": [("text", "x", None, None)],
        "python_timeout_cannot_be_caught": [("text", "survive", None, None)],
        "python_error_keeps_the_node": [("text", t, None, None) for t in ("ok1", "ok2")],
    }.get(case)
    if expect is not None:
        assert pkts == expect
    assert language == ("python" if case.startswith("python") else "javascript")
    if case == "js_telemetry_spans":
        assert [e[0] for e in events] == ["custom.event", "script.log", "llm.request"]
    if case.endswith("timeout_passes_through") or case.endswith("cannot_be_caught"):
        assert [e[0] for e in events] == ["script.timeout"]


REFUSED = {
    "bare_except": ("def process(p):\n    try:\n        pass\n    except:\n        pass\n", "bare"),
    "base_exception": ("def process(p):\n    try:\n        pass\n    except BaseException:\n        pass\n",
                       "BaseException"),
    "import": ("import os\ndef process(p):\n    return p\n", "disallowed syntax"),
    "dunder": ("def process(p):\n    return __builtins__\n", "dunder"),
    "attribute": ("def process(p):\n    return p.__class__\n", "attribute not allowed"),
    "generator": ("def process(p):\n    return sum(x for x in range(3))\n", "disallowed syntax"),
    "format": ("def process(p):\n    return '{0}'.format(p)\n", "attribute not allowed"),
    "nesting": ("x = " + "[" * 101 + "]" * 101 + "\n", "nesting"),
    "too_large": ("# " + "x" * (256 * 1024) + "\n", "KiB"),
    "no_process": ("y = 1\n", None),
    "js_syntax": ("function process( {", "javascript syntax"),
    "bad_language": (None, "language must be"),
    "empty": ("", "requires a 'script'"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_script_raises_the_same_error(case):
    src, match = REFUSED[case]
    params = {"script": src, "language": "cobol" if case == "bad_language" else "auto"}
    if case == "bad_language":
        params["script"] = "def process(p):\n    return p\n"
    if case == "js_syntax":
        params["language"] = "javascript"
    errors = {}
    for pkg, (core, script) in PACKAGES.items():
        try:
            node = script.ScriptNode(dict(params))
        except core.ConfigurationError as e:
            errors[pkg] = str(e)
            continue
        # a script without process() is refused when the node starts
        with pytest.raises(core.ConfigurationError) as info:
            asyncio.run(_drive(pkg, dict(params), _texts("x")))
        errors[pkg] = str(info.value)
        assert node.language == "python"
    assert errors["torch"] == errors["jax"]
    if match:
        assert match in errors["torch"]


# -- fetch() ------------------------------------------------------------------
ALLOWLIST_PATTERNS = ["https://api.example.com/*", "https://example.com", "http://*:8080/v1/*", "no-scheme",
                      "https://", "  HTTPS://Host.example/p?q ", "http://a.b:*/x/*"]
URL_MATRIX = [
    ("https://api.example.com/v1/data", "GET"), ("https://api.example.com/v1/data", "post"),
    ("https://api.example.com/v1/data", "DELETE"), ("https://api.example.com/v2/data", "GET"),
    ("http://api.example.com/v1/data", "GET"), ("https://evil.com/v1/data", "GET"),
    ("http://127.0.0.1:9131/hook", "GET"), ("http://127.0.0.1:9131/other", "GET"),
    ("http://127.0.0.1/hook", "GET"), ("not a url", "GET"), ("https://api.example.com", "GET"),
]
RULE_SETS = [
    [], [{"url": "https://api.example.com/v1/*", "methods": ["GET", "POST"]}],
    [{"url": "http://127.0.0.1:*/hook", "methods": ["GET"]}], [{"url": "https://*", "methods": []}],
    [{"url": "https://*.example.com/*", "methods": ["get"]}, {"url": "http://127.0.0.1/*", "methods": ["GET"]}],
]


def test_allowlist_patterns_and_matrix_match_jax():
    for pat in ALLOWLIST_PATTERNS:
        assert torch_script.parse_allowlist_pattern(pat) == jax_script.parse_allowlist_pattern(pat), pat
    allowed = 0
    for rules in RULE_SETS:
        for url, method in URL_MATRIX:
            got = torch_script.is_url_allowed(url, method, rules)
            assert got == jax_script.is_url_allowed(url, method, rules), (url, method, rules)
            allowed += got
    assert allowed > 0


class _Stub:
    """A loopback HTTP stub on the port's own server: records the last
    request; ``/redirect`` answers 302 to ``/stolen``."""

    def __init__(self):
        self.last = {}
        self.app = web.Application()
        for method in ("GET", "POST"):
            self.app.router.add_route(method, "/{path:.*}", self._handle)

    async def _handle(self, request):
        self.last = {"method": request.method, "path": request.path, "headers": dict(request.headers),
                     "body": (await request.read()).decode()}
        if request.path.startswith("/redirect"):
            return web.json_response({"redirected": True}, status=302, headers={"Location": "/stolen"})
        return web.json_response({"ok": True, "path": request.path, "echo": self.last["body"]})


def _fetch_both(rules_of, secrets_of, params, text="go"):
    """The same fetch script through both nodes against one stub → the
    output texts and the stub's last request, per package."""
    got = {}

    async def run(pkg):
        stub = _Stub()
        runner = web.AppRunner(stub.app)
        port = await runner.start("127.0.0.1", 0)
        base = f"http://127.0.0.1:{port}"
        _, script = PACKAGES[pkg]
        script.set_global_script_config(rules_of(base), {k: script.ScriptSecret(v, scope(base))
                                                          for k, (v, scope) in secrets_of.items()})
        p = {"timeout_ms": BUDGET_MS, **params}
        p["script"] = p["script"].replace("BASE", base)
        try:
            _, out, _ = await _drive(pkg, p, _texts(text))
        finally:
            await runner.cleanup()
        last = dict(stub.last)
        if last:
            last["headers"] = {k.lower(): v for k, v in last["headers"].items() if k.lower() not in ("host", "user-agent")}
        return [o.text for o in out], last

    for pkg in PACKAGES:
        got[pkg] = asyncio.run(run(pkg))
    assert got["torch"] == got["jax"]
    return got["torch"]


def test_fetch_blocked_by_default():
    texts, last = _fetch_both(lambda b: [], {}, {"script": (
        "def process(p):\n    try:\n        return fetch('BASE/x')\n"
        "    except Exception as e:\n        return 'blocked:' + str(e)\n")})
    assert texts[0].startswith("blocked:") and "allowlist is empty" in texts[0] and not last


def test_fetch_get_allowed_in_both_dialects():
    for src in ("def process(p):\n    return fetch('BASE/api/data')\n",
                "function process(p) { return { type: 'Text', data: fetch('BASE/api/data') }; }"):
        texts, last = _fetch_both(lambda b: [{"url": f"{b}/api/*", "methods": ["GET"]}], {}, {"script": src})
        assert json.loads(texts[0]) == {"ok": True, "path": "/api/data", "echo": ""}
        assert last["method"] == "GET"


def test_fetch_post_body_and_scoped_secret_header():
    texts, last = _fetch_both(
        lambda b: [{"url": f"{b}/*", "methods": ["POST"]}], {"api_key": ("s3cret", lambda b: [f"{b}/*"])},
        {"script": ("def process(p):\n    return fetch('BASE/hook', {'method': 'POST', 'body': '{\"k\": 1}', "
                    "'headers': {'X-Extra': 'yes'}})\n"),
         "headers": [{"secret": "api_key", "header": "Authorization", "template": "Bearer {}"}]})
    assert json.loads(texts[0])["ok"] is True
    assert last["method"] == "POST" and last["body"] == '{"k": 1}'
    assert last["headers"]["authorization"] == "Bearer s3cret"
    assert last["headers"]["x-extra"] == "yes" and last["headers"]["content-type"] == "application/json"


def test_secret_not_injected_outside_its_scope():
    texts, last = _fetch_both(
        lambda b: [{"url": f"{b}/*", "methods": ["GET"]}],
        {"api_key": ("s3cret", lambda b: ["https://other.example.com/*"])},
        {"script": "def process(p):\n    return fetch('BASE/leak')\n",
         "headers": [{"secret": "api_key", "header": "Authorization"}]})
    assert json.loads(texts[0])["ok"] is True and "authorization" not in last["headers"]


def test_fetch_method_not_in_allowlist():
    texts, last = _fetch_both(lambda b: [{"url": f"{b}/*", "methods": ["GET"]}], {}, {"script": (
        "def process(p):\n    try:\n        return fetch('BASE/x', {'method': 'POST'})\n"
        "    except Exception as e:\n        return 'blocked'\n")})
    assert texts == ["blocked"] and not last


def test_fetch_redirect_not_followed():
    texts, last = _fetch_both(
        lambda b: [{"url": f"{b}/*", "methods": ["GET"]}], {"api_key": ("s3cret", lambda b: [f"{b}/*"])},
        {"script": "def process(p):\n    return fetch('BASE/redirect')\n",
         "headers": [{"secret": "api_key", "header": "Authorization"}]})
    assert json.loads(texts[0]) == {"redirected": True}
    assert last["path"] == "/redirect"  # /stolen was never requested


def test_server_config_installs_the_same_script_policy(monkeypatch):
    """``[script]`` settings reach ``set_global_script_config`` in both
    servers: the allowlist as given, each secret's value from its env var,
    a secret whose env var is unset skipped."""
    import streamkit_tpu.server as jax_server
    import streamkit_tpu_torch.server as torch_server

    monkeypatch.setenv("SK_TEST_SCRIPT_SECRET", "v4lue")
    monkeypatch.delenv("SK_TEST_SCRIPT_UNSET", raising=False)
    policies = {}
    for pkg, server in (("jax", jax_server), ("torch", torch_server)):
        cfg = server.ServerConfig()
        cfg.moq_enabled = False
        cfg.script_fetch_allowlist = [{"url": "https://api.example.com/*", "methods": ["GET"]}]
        cfg.script_secrets = {"key": {"env": "SK_TEST_SCRIPT_SECRET", "allowed_fetch_urls": ["https://api.example.com/*"]},
                              "gone": {"env": "SK_TEST_SCRIPT_UNSET"}}
        kw = {"device": "cpu"} if pkg == "torch" else {}
        server.create_app(cfg, **kw)
        policy = PACKAGES[pkg][1]._GLOBAL_SCRIPT_CONFIG
        policies[pkg] = (policy.fetch_allowlist, {k: (s.value, s.allowed_fetch_urls) for k, s in policy.secrets.items()})
    assert policies["torch"] == policies["jax"]
    assert policies["torch"][1] == {"key": ("v4lue", ["https://api.example.com/*"])}


def test_the_schema_lists_no_script_node_in_either():
    """``core::script`` cannot be built without a script, so the registry's
    definitions (``/api/v1/schema/nodes``) skip it in both packages
    (followed: the reference's registry probes every kind with no params)."""
    import streamkit_tpu.nodes as jax_nodes
    import streamkit_tpu_torch.nodes as torch_nodes

    for core, nodes, kw in ((jax_core, jax_nodes, {}), (torch_core, torch_nodes, {"device": "cpu"})):
        reg = core.NodeRegistry()
        nodes.register_nodes(reg, **kw)
        kinds = {d.kind for d in reg.definitions()}
        assert reg.contains("core::script") and "core::script" not in kinds and "containers::webm::muxer" in kinds
