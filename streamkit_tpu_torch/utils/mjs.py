# SPDX-License-Identifier: Apache-2.0
"""mjs — a small JavaScript interpreter for the script node.

The port's own copy of the JAX package's ``utils/mjs.py`` (host code; it
touches no device). Parity target: the reference embeds QuickJS for ``core::script``
(``crates/nodes/src/core/script.rs``, per-packet ``process(packet)``,
fetch allowlist, timeouts). No JS engine ships in this image, so this is a
from-scratch tree-walking interpreter covering the language subset the
reference's shipped scripts use (``samples/pipelines/dynamic/
voice-weather-open-meteo.js`` and the oneshot samples):

* ``var``/``let``/``const``, functions (decls, expressions, arrows,
  closures, default params, rest args), ``if``/``for``/``for-of``/
  ``for-in``/``while``/``do``/``switch``/``break``/``continue``,
  ``try``/``catch``/``finally``/``throw``,
* full expression grammar: ternary, ``&&``/``||``/``??``, equality
  (loose + strict), arithmetic with JS coercions, template literals,
  spread in array literals and calls, optional chaining ``?.``,
  ``typeof``/``delete``/``in``/``instanceof``, ``++``/``--``,
* regex literals (translated to Python ``re``; flags ``gimsu``),
* the standard library surface those scripts touch: JSON, Math, Number,
  String/Array/Object methods, ``parseInt``/``parseFloat``,
  ``console.log``, ``Date.now``,
* host hooks: the embedder injects globals (``fetch``, ``emit`` …);
  execution is budgeted by an operation counter (the QuickJS-style
  interrupt handler) so hostile scripts cannot spin.

Deliberately out of scope (not used by the shipped scripts): classes,
generators, async/await, getters/setters, Proxy/Reflect, labels, ``with``.
"""

from __future__ import annotations

import json as _json
import math as _math
import re as _re
import time as _time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["JSInterpreter", "JSError", "JSTimeout", "UNDEFINED", "js_repr", "to_python", "from_python"]


class JSError(Exception):
    """A JS-level throw or SyntaxError surfaced to the embedder."""

    def __init__(self, value):
        self.value = value
        super().__init__(js_to_string(value))


class JSTimeout(JSError):
    def __init__(self, msg="script operation budget exhausted"):
        super().__init__(msg)


class _Undefined:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "undefined"

    def __bool__(self):
        return False


UNDEFINED = _Undefined()


class JSObject(dict):
    """A JS object; insertion-ordered string keys."""


class JSArray(list):
    """A JS array."""


class JSRegExp:
    def __init__(self, source: str, flags: str):
        self.source = source
        self.flags = flags
        py_flags = 0
        if "i" in flags:
            py_flags |= _re.IGNORECASE
        if "s" in flags:
            py_flags |= _re.DOTALL
        if "m" in flags:
            py_flags |= _re.MULTILINE
        self.global_ = "g" in flags
        self.re = _re.compile(_js_regex_to_py(source), py_flags)
        self.last_index = 0

    def __repr__(self):
        return f"/{self.source}/{self.flags}"


def _js_regex_to_py(src: str) -> str:
    """Translate JS regex syntax to Python's (the constructs in scope:
    ``\\d \\w \\s`` classes, groups, alternation, quantifiers, lookahead,
    non-capturing groups, named groups ``(?<name>``)."""
    return src.replace("(?<", "(?P<").replace("(?P<=", "(?<=").replace("(?P<!", "(?<!")


class JSFunction:
    def __init__(self, name, params, defaults, rest, body, closure, interp,
                 is_arrow=False, this=None, is_async=False):
        self.name = name or ""
        self.params = params
        self.defaults = defaults
        self.rest = rest
        self.body = body
        self.closure = closure
        self.interp = interp
        self.is_arrow = is_arrow
        self.this = this
        self.is_async = is_async
        self.home_class = None  # set for class methods (super resolution)
        self.properties = JSObject()

    def __repr__(self):
        return f"function {self.name}() {{ ... }}"


class JSPromise:
    """Synchronous-microtask promise. ``then`` callbacks on a settled promise
    run immediately; awaiting a *pending* promise drives the embedder's
    ``pending_pump`` (the headless event loop) until it settles."""

    __slots__ = ("state", "value", "callbacks")

    def __init__(self):
        self.state = "pending"  # pending | fulfilled | rejected
        self.value = UNDEFINED
        self.callbacks = []  # (on_fulfil|None, on_reject|None, chained JSPromise)

    def __repr__(self):
        return f"Promise {{ <{self.state}> }}"


class JSClass:
    """A `class` declaration/expression: constructor + method tables.

    Pragmatic QuickJS-subset semantics: methods/getters/setters live on the
    class (prototype-chain lookup through ``parent``); instance fields are
    initialized base-first before the constructor body runs."""

    def __init__(self, name, parent):
        self.name = name or ""
        self.parent = parent  # JSClass | None
        self.ctor = None  # JSFunction | None
        self.methods: Dict[str, Any] = {}
        self.getters: Dict[str, Any] = {}
        self.setters: Dict[str, Any] = {}
        self.fields: List[Tuple[str, Any]] = []  # (name, init-expr AST)
        self.statics = JSObject()

    def __repr__(self):
        return f"class {self.name} {{ ... }}"


class JSMap:
    """JS Map: insertion-ordered; object keys by identity."""

    def __init__(self):
        self._items: Dict[Any, Any] = {}  # hashable-key fast path
        self._obj_items: List[Tuple[Any, Any]] = []  # identity-keyed

    def _find_obj(self, key):
        for i, (k, _) in enumerate(self._obj_items):
            if k is key:
                return i
        return -1

    def get(self, key):
        try:
            return self._items.get(key, UNDEFINED)
        except TypeError:
            i = self._find_obj(key)
            return self._obj_items[i][1] if i >= 0 else UNDEFINED

    def set(self, key, value):
        try:
            self._items[key] = value
        except TypeError:
            i = self._find_obj(key)
            if i >= 0:
                self._obj_items[i] = (key, value)
            else:
                self._obj_items.append((key, value))
        return self

    def has(self, key):
        try:
            return key in self._items
        except TypeError:
            return self._find_obj(key) >= 0

    def delete(self, key):
        try:
            return self._items.pop(key, _SENTINEL) is not _SENTINEL
        except TypeError:
            i = self._find_obj(key)
            if i >= 0:
                self._obj_items.pop(i)
                return True
            return False

    def clear(self):
        self._items.clear()
        self._obj_items.clear()

    def entries(self):
        out = [(k, v) for k, v in self._items.items()]
        out.extend(self._obj_items)
        return out

    @property
    def size(self):
        return len(self._items) + len(self._obj_items)


class JSSet:
    """JS Set: insertion-ordered; object members by identity."""

    def __init__(self):
        self._items: Dict[Any, bool] = {}
        self._obj_items: List[Any] = []

    def has(self, v):
        try:
            return v in self._items
        except TypeError:
            return any(x is v for x in self._obj_items)

    def add(self, v):
        try:
            self._items[v] = True
        except TypeError:
            if not any(x is v for x in self._obj_items):
                self._obj_items.append(v)
        return self

    def delete(self, v):
        try:
            return self._items.pop(v, _SENTINEL) is not _SENTINEL
        except TypeError:
            for i, x in enumerate(self._obj_items):
                if x is v:
                    self._obj_items.pop(i)
                    return True
            return False

    def clear(self):
        self._items.clear()
        self._obj_items.clear()

    def values(self):
        return list(self._items.keys()) + list(self._obj_items)

    @property
    def size(self):
        return len(self._items) + len(self._obj_items)


class _Sentinel:
    pass


_SENTINEL = _Sentinel()


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------
_KEYWORDS = {
    "var", "let", "const", "function", "return", "if", "else", "for", "while",
    "do", "break", "continue", "try", "catch", "finally", "throw", "switch",
    "case", "default", "new", "delete", "typeof", "instanceof", "in", "of",
    "true", "false", "null", "undefined", "this", "void",
}

_PUNCT = [
    "...", "=>", "===", "!==", "**=", "<<=", ">>=", ">>>", "&&=", "||=", "??=",
    "==", "!=", "<=", ">=", "&&", "||", "??", "?.", "++", "--", "+=", "-=",
    "*=", "/=", "%=", "&=", "|=", "^=", "**", "<<", ">>",
    "{", "}", "(", ")", "[", "]", ";", ",", "<", ">", "+", "-", "*", "/", "%",
    "&", "|", "^", "!", "~", "?", ":", "=", ".",
]


class _Tok:
    __slots__ = ("kind", "value", "pos", "nl_before")

    def __init__(self, kind, value, pos, nl_before):
        self.kind = kind  # num str tmpl regex name keyword punct eof
        self.value = value
        self.pos = pos
        self.nl_before = nl_before

    def __repr__(self):
        return f"{self.kind}:{self.value!r}"


def _tokenize(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    i = 0
    n = len(src)
    nl = False

    def prev_significant():
        return toks[-1] if toks else None

    while i < n:
        c = src[i]
        if c in " \t\r":
            i += 1
            continue
        if c == "\n":
            nl = True
            i += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            i = n if j < 0 else j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i + 2)
            if j < 0:
                raise JSError("SyntaxError: unterminated comment")
            if "\n" in src[i:j]:
                nl = True
            i = j + 2
            continue
        start = i
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF":
                    j += 1
                toks.append(_Tok("num", float(int(src[i:j], 16)), start, nl))
            else:
                while j < n and (src[j].isdigit() or src[j] in ".eE" or (src[j] in "+-" and src[j - 1] in "eE")):
                    j += 1
                toks.append(_Tok("num", float(src[i:j]), start, nl))
            i = j
            nl = False
            continue
        # strings
        if c in "'\"":
            j = i + 1
            buf = []
            while j < n and src[j] != c:
                if src[j] == "\\":
                    buf.append(_unescape(src, j))
                    j += 2
                    if buf[-1] is None:  # \uXXXX consumed more
                        pass
                else:
                    buf.append(src[j])
                    j += 1
            out, j = _scan_string(src, i + 1, c)
            toks.append(_Tok("str", out, start, nl))
            i = j + 1
            nl = False
            continue
        # template literal
        if c == "`":
            parts, j = _scan_template(src, i + 1)
            toks.append(_Tok("tmpl", parts, start, nl))
            i = j
            nl = False
            continue
        # identifier / keyword
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (src[j].isalnum() or src[j] in "_$"):
                j += 1
            word = src[i:j]
            toks.append(_Tok("keyword" if word in _KEYWORDS else "name", word, start, nl))
            i = j
            nl = False
            continue
        # regex or division
        if c == "/":
            prev = prev_significant()
            regex_ok = prev is None or (
                prev.kind == "punct" and prev.value not in (")", "]", "}")
            ) or (prev.kind == "keyword" and prev.value not in ("this", "true", "false", "null", "undefined"))
            if regex_ok:
                body, flags, j = _scan_regex(src, i + 1)
                toks.append(_Tok("regex", (body, flags), start, nl))
                i = j
                nl = False
                continue
        for p in _PUNCT:
            if src.startswith(p, i):
                toks.append(_Tok("punct", p, start, nl))
                i += len(p)
                break
        else:
            raise JSError(f"SyntaxError: unexpected character {c!r} at {i}")
        nl = False
    toks.append(_Tok("eof", None, n, True))
    return toks


def _scan_string(src: str, i: int, quote: str) -> Tuple[str, int]:
    buf = []
    n = len(src)
    while i < n and src[i] != quote:
        if src[i] == "\\":
            ch, i = _read_escape(src, i + 1)
            buf.append(ch)
        else:
            buf.append(src[i])
            i += 1
    if i >= n:
        raise JSError("SyntaxError: unterminated string")
    return "".join(buf), i


def _read_escape(src: str, i: int) -> Tuple[str, int]:
    c = src[i]
    simple = {"n": "\n", "t": "\t", "r": "\r", "b": "\b", "f": "\f", "v": "\v", "0": "\0"}
    if c in simple:
        return simple[c], i + 1
    if c == "u":
        if src[i + 1] == "{":
            j = src.index("}", i)
            return chr(int(src[i + 2 : j], 16)), j + 1
        return chr(int(src[i + 1 : i + 5], 16)), i + 5
    if c == "x":
        return chr(int(src[i + 1 : i + 3], 16)), i + 3
    if c == "\n":
        return "", i + 1
    return c, i + 1


def _unescape(src, j):
    return src[j + 1] if j + 1 < len(src) else ""


def _scan_template(src: str, i: int):
    """Returns ([("str", s) | ("expr", tokens)], next_index_after_backtick)."""
    parts = []
    buf = []
    n = len(src)
    while i < n:
        c = src[i]
        if c == "`":
            if buf:
                parts.append(("str", "".join(buf)))
            return parts, i + 1
        if c == "\\":
            ch, i = _read_escape(src, i + 1)
            buf.append(ch)
            continue
        if src.startswith("${", i):
            if buf:
                parts.append(("str", "".join(buf)))
                buf = []
            depth = 1
            j = i + 2
            while j < n and depth:
                if src[j] == "{":
                    depth += 1
                elif src[j] == "}":
                    depth -= 1
                elif src[j] == "`":
                    # nested template: skip it wholesale
                    _, j = _scan_template(src, j + 1)
                    continue
                j += 1
            parts.append(("expr", src[i + 2 : j - 1]))
            i = j
            continue
        buf.append(c)
        i += 1
    raise JSError("SyntaxError: unterminated template literal")


def _scan_regex(src: str, i: int) -> Tuple[str, str, int]:
    n = len(src)
    buf = []
    in_class = False
    while i < n:
        c = src[i]
        if c == "\\":
            buf.append(src[i : i + 2])
            i += 2
            continue
        if c == "[":
            in_class = True
        elif c == "]":
            in_class = False
        elif c == "/" and not in_class:
            break
        elif c == "\n":
            raise JSError("SyntaxError: unterminated regex")
        buf.append(c)
        i += 1
    i += 1  # closing /
    j = i
    while j < n and src[j] in "gimsuy":
        j += 1
    return "".join(buf), src[i:j], j


# ---------------------------------------------------------------------------
# parser — produces tuple-based AST nodes ("kind", ...)
# ---------------------------------------------------------------------------
class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    # -- token helpers ------------------------------------------------------
    def peek(self, k=0) -> _Tok:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at(self, kind, value=None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def eat(self, kind, value=None) -> Optional[_Tok]:
        if self.at(kind, value):
            return self.next()
        return None

    def expect(self, kind, value=None) -> _Tok:
        if not self.at(kind, value):
            t = self.peek()
            raise JSError(f"SyntaxError: expected {value or kind}, got {t.kind}:{t.value!r}")
        return self.next()

    def semi(self):
        # ASI: accept ';', '}', eof, or a newline before the next token
        if self.eat("punct", ";"):
            return
        t = self.peek()
        if t.kind == "eof" or (t.kind == "punct" and t.value == "}") or t.nl_before:
            return
        raise JSError(f"SyntaxError: expected ; before {t.value!r}")

    # -- program ------------------------------------------------------------
    def parse_program(self):
        body = []
        while not self.at("eof"):
            body.append(self.statement())
        return ("block", body)

    # -- statements ---------------------------------------------------------
    def statement(self):
        t = self.peek()
        # `async function f() {}` — executed synchronously: the embedder's
        # fetch() blocks (matching the reference scripts' await-immediately
        # usage), so async/await degenerate to direct calls/values here.
        if t.kind == "name" and t.value == "async" and self.peek(1).kind == "keyword" and self.peek(1).value == "function":
            self.next()
            return self.function_decl(is_async=True)
        if t.kind == "name" and t.value == "class" and self.peek(1).kind == "name":
            node = self.class_expr()
            return ("classdecl", node[1], node)
        if t.kind == "punct" and t.value == "{":
            return self.block()
        if t.kind == "punct" and t.value == ";":
            self.next()
            return ("empty",)
        if t.kind == "keyword":
            v = t.value
            if v in ("var", "let", "const"):
                s = self.var_decl()
                self.semi()
                return s
            if v == "function":
                return self.function_decl()
            if v == "if":
                return self.if_stmt()
            if v == "for":
                return self.for_stmt()
            if v == "while":
                self.next()
                self.expect("punct", "(")
                cond = self.expression()
                self.expect("punct", ")")
                return ("while", cond, self.statement())
            if v == "do":
                self.next()
                body = self.statement()
                self.expect("keyword", "while")
                self.expect("punct", "(")
                cond = self.expression()
                self.expect("punct", ")")
                self.semi()
                return ("dowhile", cond, body)
            if v == "return":
                self.next()
                t2 = self.peek()
                if (t2.kind == "punct" and t2.value in (";", "}")) or t2.kind == "eof" or t2.nl_before:
                    self.semi()
                    return ("return", None)
                e = self.expression()
                self.semi()
                return ("return", e)
            if v == "break":
                self.next()
                self.semi()
                return ("break",)
            if v == "continue":
                self.next()
                self.semi()
                return ("continue",)
            if v == "throw":
                self.next()
                e = self.expression()
                self.semi()
                return ("throw", e)
            if v == "try":
                return self.try_stmt()
            if v == "switch":
                return self.switch_stmt()
        e = self.expression()
        self.semi()
        return ("expr", e)

    def block(self):
        self.expect("punct", "{")
        body = []
        while not self.eat("punct", "}"):
            body.append(self.statement())
        return ("block", body)

    def binding_target(self):
        """A declaration/parameter binding: plain name, object pattern, or
        array pattern. AST: ``("pid", name)`` | ``("pobj", props, rest)``
        (props = [(key, sub-target, default-expr|None)]) |
        ``("parr", elems, rest)`` (elems = [(sub-target|None, default)])."""
        t = self.peek()
        if t.kind == "name":
            return ("pid", self.next().value)
        if t.kind == "punct" and t.value == "{":
            self.next()
            props, rest = [], None
            while not self.eat("punct", "}"):
                if self.eat("punct", "..."):
                    rest = self.expect("name").value
                    self.expect("punct", "}")
                    break
                kt = self.next()
                if kt.kind not in ("name", "keyword", "str"):
                    raise JSError(f"SyntaxError: bad destructuring key {kt.value!r}")
                key = kt.value
                sub = ("pid", key)
                if self.eat("punct", ":"):
                    sub = self.binding_target()
                default = None
                if self.eat("punct", "="):
                    default = self.assignment()
                props.append((key, sub, default))
                if not self.eat("punct", ","):
                    self.expect("punct", "}")
                    break
            return ("pobj", props, rest)
        if t.kind == "punct" and t.value == "[":
            self.next()
            elems, rest = [], None
            while not self.eat("punct", "]"):
                if self.at("punct", ","):  # elision hole
                    self.next()
                    elems.append((None, None))
                    continue
                if self.eat("punct", "..."):
                    rest = self.expect("name").value
                    self.expect("punct", "]")
                    break
                sub = self.binding_target()
                default = None
                if self.eat("punct", "="):
                    default = self.assignment()
                elems.append((sub, default))
                if not self.eat("punct", ","):
                    self.expect("punct", "]")
                    break
            return ("parr", elems, rest)
        raise JSError(f"SyntaxError: expected binding target, got {t.value!r}")

    def var_decl(self):
        kind = self.next().value
        decls = []
        while True:
            target = self.binding_target()
            init = None
            if self.eat("punct", "="):
                init = self.assignment()
            decls.append((target, init))
            if not self.eat("punct", ","):
                break
        return ("decl", kind, decls)

    def function_decl(self, is_async=False):
        self.expect("keyword", "function")
        name = self.expect("name").value
        params, defaults, rest = self.param_list()
        body = self.block()
        return ("funcdecl", name, params, defaults, rest, body, is_async)

    def param_list(self):
        self.expect("punct", "(")
        params, defaults, rest = [], [], None
        while not self.eat("punct", ")"):
            if self.eat("punct", "..."):
                rest = self.expect("name").value
                self.expect("punct", ")")
                break
            p = self.binding_target()
            d = None
            if self.eat("punct", "="):
                d = self.assignment()
            params.append(p)
            defaults.append(d)
            if not self.eat("punct", ","):
                self.expect("punct", ")")
                break
        return params, defaults, rest

    def if_stmt(self):
        self.expect("keyword", "if")
        self.expect("punct", "(")
        cond = self.expression()
        self.expect("punct", ")")
        then = self.statement()
        other = None
        if self.eat("keyword", "else"):
            other = self.statement()
        return ("if", cond, then, other)

    def for_stmt(self):
        self.expect("keyword", "for")
        self.expect("punct", "(")
        init = None
        if not self.at("punct", ";"):
            if self.peek().kind == "keyword" and self.peek().value in ("var", "let", "const"):
                init = self.var_decl()
                # for-of / for-in
                if self.at("keyword", "of") or self.at("keyword", "in"):
                    kind = self.next().value
                    iterable = self.expression()
                    self.expect("punct", ")")
                    body = self.statement()
                    target = init[2][0][0]  # binding pattern
                    return ("forof" if kind == "of" else "forin", target, iterable, body)
            else:
                init = ("expr", self.expression())
        self.expect("punct", ";")
        cond = None if self.at("punct", ";") else self.expression()
        self.expect("punct", ";")
        update = None if self.at("punct", ")") else self.expression()
        self.expect("punct", ")")
        body = self.statement()
        return ("for", init, cond, update, body)

    def try_stmt(self):
        self.expect("keyword", "try")
        block = self.block()
        catch_name, catch_block, finally_block = None, None, None
        if self.eat("keyword", "catch"):
            if self.eat("punct", "("):
                catch_name = self.expect("name").value
                self.expect("punct", ")")
            catch_block = self.block()
        if self.eat("keyword", "finally"):
            finally_block = self.block()
        return ("try", block, catch_name, catch_block, finally_block)

    def switch_stmt(self):
        self.expect("keyword", "switch")
        self.expect("punct", "(")
        disc = self.expression()
        self.expect("punct", ")")
        self.expect("punct", "{")
        cases = []  # (test|None, [stmts])
        while not self.eat("punct", "}"):
            if self.eat("keyword", "case"):
                test = self.expression()
                self.expect("punct", ":")
            else:
                self.expect("keyword", "default")
                self.expect("punct", ":")
                test = None
            stmts = []
            while not (
                self.at("keyword", "case") or self.at("keyword", "default") or self.at("punct", "}")
            ):
                stmts.append(self.statement())
            cases.append((test, stmts))
        return ("switch", disc, cases)

    def class_expr(self):
        """``class [Name] [extends Expr] { members }`` — members are
        methods / ``constructor`` / ``get``/``set`` accessors / ``static``
        members / instance fields (``x = expr``)."""
        self.next()  # 'class' (tokenized as a name)
        name = None
        if self.at("name") and self.peek().value != "extends":
            name = self.next().value
        sup = None
        if self.at("name", "extends"):
            self.next()
            sup = self.call_member()
        self.expect("punct", "{")
        members = []  # (is_static, kind: ctor|method|get|set|field, key, value)
        while not self.eat("punct", "}"):
            if self.eat("punct", ";"):
                continue
            is_static = False
            if self.at("name", "static") and not (
                self.peek(1).kind == "punct" and self.peek(1).value in ("(", "=")
            ):
                self.next()
                is_static = True
            is_async = False
            if self.at("name", "async") and not (
                self.peek(1).kind == "punct" and self.peek(1).value in ("(", "=")
            ):
                self.next()
                is_async = True
            mkind = "method"
            t = self.peek()
            if (
                t.kind == "name"
                and t.value in ("get", "set")
                and not (self.peek(1).kind == "punct" and self.peek(1).value in ("(", "="))
            ):
                mkind = self.next().value
            kt = self.next()
            if kt.kind not in ("name", "keyword", "str"):
                raise JSError(f"SyntaxError: bad class member {kt.value!r}")
            key = kt.value
            if self.at("punct", "="):  # instance/static field
                self.next()
                value = self.assignment()
                self.semi()
                members.append((is_static, "field", key, value))
                continue
            if not self.at("punct", "("):  # bare field `x;`
                self.semi()
                members.append((is_static, "field", key, ("lit", UNDEFINED)))
                continue
            params, defaults, rest = self.param_list()
            body = self.block()
            fn = ("func", key, params, defaults, rest, body, is_async)
            if key == "constructor" and mkind == "method" and not is_static:
                mkind = "ctor"
            members.append((is_static, mkind, key, fn))
        return ("class", name, sup, members)

    # -- expressions --------------------------------------------------------
    def expression(self):
        e = self.assignment()
        while self.eat("punct", ","):
            e = ("seq", e, self.assignment())
        return e

    def assignment(self):
        # arrow functions: name => ..., (a, b) => ...
        arrow = self.try_arrow()
        if arrow is not None:
            return arrow
        left = self.conditional()
        t = self.peek()
        if t.kind == "punct" and t.value in ("=", "+=", "-=", "*=", "/=", "%=", "**=", "&&=", "||=", "??=", "&=", "|=", "^=", "<<=", ">>="):
            self.next()
            right = self.assignment()
            return ("assign", t.value, left, right)
        return left

    def try_arrow(self):
        start = self.i
        t = self.peek()
        is_async = False
        if t.kind == "name" and t.value == "async":
            nxt = self.peek(1)
            if (nxt.kind == "keyword" and nxt.value == "function") or (
                nxt.kind == "name" and self.peek(2).kind == "punct" and self.peek(2).value == "=>"
            ) or (nxt.kind == "punct" and nxt.value == "("):
                self.next()  # consume `async`
                is_async = True
                t = self.peek()
                if t.kind == "keyword" and t.value == "function":
                    self.next()
                    name = self.eat("name")
                    params, defaults, rest = self.param_list()
                    body = self.block()
                    return ("func", name.value if name else None, params, defaults, rest, body, True)
        if t.kind == "name" and self.peek(1).kind == "punct" and self.peek(1).value == "=>":
            name = self.next().value
            self.next()
            body = self.arrow_body()
            return ("arrow", [("pid", name)], [None], None, body, is_async)
        if t.kind == "punct" and t.value == "(":
            # look ahead for ') =>'
            depth = 0
            j = self.i
            while j < len(self.toks):
                tk = self.toks[j]
                if tk.kind == "punct" and tk.value == "(":
                    depth += 1
                elif tk.kind == "punct" and tk.value == ")":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            nxt = self.toks[j + 1] if j + 1 < len(self.toks) else None
            if nxt is not None and nxt.kind == "punct" and nxt.value == "=>":
                params, defaults, rest = self.param_list()
                self.expect("punct", "=>")
                body = self.arrow_body()
                return ("arrow", params, defaults, rest, body, is_async)
        self.i = start
        return None

    def arrow_body(self):
        if self.at("punct", "{"):
            return self.block()
        return ("return", self.assignment())

    def conditional(self):
        cond = self.nullish()
        if self.eat("punct", "?"):
            a = self.assignment()
            self.expect("punct", ":")
            b = self.assignment()
            return ("cond", cond, a, b)
        return cond

    def nullish(self):
        e = self.logical_or()
        while self.eat("punct", "??"):
            e = ("nullish", e, self.logical_or())
        return e

    def logical_or(self):
        e = self.logical_and()
        while self.eat("punct", "||"):
            e = ("or", e, self.logical_and())
        return e

    def logical_and(self):
        e = self.bit_or()
        while self.eat("punct", "&&"):
            e = ("and", e, self.bit_or())
        return e

    def bit_or(self):
        e = self.bit_xor()
        while self.at("punct", "|") and not self.at("punct", "||"):
            self.next()
            e = ("bin", "|", e, self.bit_xor())
        return e

    def bit_xor(self):
        e = self.bit_and()
        while self.at("punct", "^"):
            self.next()
            e = ("bin", "^", e, self.bit_and())
        return e

    def bit_and(self):
        e = self.equality()
        while self.at("punct", "&") and not self.at("punct", "&&"):
            self.next()
            e = ("bin", "&", e, self.equality())
        return e

    def equality(self):
        e = self.relational()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ("===", "!==", "==", "!="):
                self.next()
                e = ("bin", t.value, e, self.relational())
            else:
                return e

    def relational(self):
        e = self.shift()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ("<", ">", "<=", ">="):
                self.next()
                e = ("bin", t.value, e, self.shift())
            elif t.kind == "keyword" and t.value == "instanceof":
                self.next()
                e = ("bin", "instanceof", e, self.shift())
            elif t.kind == "keyword" and t.value == "in":
                self.next()
                e = ("bin", "in", e, self.shift())
            else:
                return e

    def shift(self):
        e = self.additive()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ("<<", ">>", ">>>"):
                self.next()
                e = ("bin", t.value, e, self.additive())
            else:
                return e

    def additive(self):
        e = self.multiplicative()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ("+", "-"):
                self.next()
                e = ("bin", t.value, e, self.multiplicative())
            else:
                return e

    def multiplicative(self):
        e = self.exponent()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ("*", "/", "%"):
                self.next()
                e = ("bin", t.value, e, self.exponent())
            else:
                return e

    def exponent(self):
        e = self.unary()
        if self.at("punct", "**"):
            self.next()
            return ("bin", "**", e, self.exponent())
        return e

    def unary(self):
        t = self.peek()
        if t.kind == "name" and t.value == "await":
            nxt = self.peek(1)
            if not (nxt.kind == "punct" and nxt.value in (";", ")", "]", "}", ",", "=", "=>")) and nxt.kind != "eof":
                self.next()
                # sync runtime: unwraps promises, pumping the embedder's
                # event loop while the promise is pending
                return ("await", self.unary())
        if t.kind == "punct" and t.value in ("!", "-", "+", "~"):
            self.next()
            return ("unary", t.value, self.unary())
        if t.kind == "punct" and t.value in ("++", "--"):
            self.next()
            return ("preincr", t.value, self.unary())
        if t.kind == "keyword" and t.value in ("typeof", "void", "delete"):
            self.next()
            return ("unary", t.value, self.unary())
        return self.postfix()

    def postfix(self):
        e = self.call_member()
        t = self.peek()
        if t.kind == "punct" and t.value in ("++", "--") and not t.nl_before:
            self.next()
            return ("postincr", t.value, e)
        return e

    def call_member(self):
        if self.eat("keyword", "new"):
            # `new Ctor(args)` binds tighter than trailing member/call chains:
            # parse the constructor (member accesses only), then its args,
            # then let the normal postfix loop continue on the instance.
            callee = self.primary()
            while True:
                if self.eat("punct", "."):
                    name = self.next()
                    if name.kind not in ("name", "keyword"):
                        raise JSError("SyntaxError: bad property access")
                    callee = ("member", callee, ("lit", name.value), False)
                elif self.at("punct", "["):
                    self.next()
                    idx = self.expression()
                    self.expect("punct", "]")
                    callee = ("member", callee, idx, False)
                else:
                    break
            args = self.arguments() if self.at("punct", "(") else []
            e = ("new", callee, args)
        else:
            e = self.primary()
        while True:
            if self.eat("punct", "."):
                name = self.next()
                if name.kind not in ("name", "keyword"):
                    raise JSError("SyntaxError: bad property access")
                e = ("member", e, ("lit", name.value), False)
            elif self.eat("punct", "?."):
                if self.at("punct", "("):
                    args = self.arguments()
                    e = ("call", e, args, True)
                elif self.at("punct", "["):
                    self.next()
                    idx = self.expression()
                    self.expect("punct", "]")
                    e = ("member", e, idx, True)
                else:
                    name = self.next()
                    e = ("member", e, ("lit", name.value), True)
            elif self.at("punct", "("):
                args = self.arguments()
                e = ("call", e, args, False)
            elif self.eat("punct", "["):
                idx = self.expression()
                self.expect("punct", "]")
                e = ("member", e, idx, False)
            else:
                return e

    def arguments(self):
        self.expect("punct", "(")
        args = []
        while not self.eat("punct", ")"):
            if self.eat("punct", "..."):
                args.append(("spread", self.assignment()))
            else:
                args.append(self.assignment())
            if not self.eat("punct", ","):
                self.expect("punct", ")")
                break
        return args

    def primary(self):
        t = self.next()
        if t.kind == "num":
            return ("lit", t.value)
        if t.kind == "str":
            return ("lit", t.value)
        if t.kind == "regex":
            return ("regex", t.value[0], t.value[1])
        if t.kind == "tmpl":
            parts = []
            for kind, val in t.value:
                if kind == "str":
                    parts.append(("str", val))
                else:
                    sub = _Parser(_tokenize(val))
                    parts.append(("expr", sub.expression()))
            return ("template", parts)
        if t.kind == "name":
            if t.value == "class" and (self.at("punct", "{") or self.peek().kind == "name"):
                self.i -= 1
                return self.class_expr()
            if t.value == "super":
                return ("super",)
            return ("name", t.value)
        if t.kind == "keyword":
            if t.value == "true":
                return ("lit", True)
            if t.value == "false":
                return ("lit", False)
            if t.value == "null":
                return ("lit", None)
            if t.value == "undefined":
                return ("lit", UNDEFINED)
            if t.value == "this":
                return ("this",)
            if t.value == "function":
                name = self.eat("name")
                params, defaults, rest = self.param_list()
                body = self.block()
                return ("func", name.value if name else None, params, defaults, rest, body, False)
            if t.value == "new":
                self.i -= 1
                return self.call_member()
        if t.kind == "punct":
            if t.value == "(":
                e = self.expression()
                self.expect("punct", ")")
                return e
            if t.value == "[":
                items = []
                while not self.eat("punct", "]"):
                    if self.eat("punct", "..."):
                        items.append(("spread", self.assignment()))
                    else:
                        items.append(self.assignment())
                    if not self.eat("punct", ","):
                        self.expect("punct", "]")
                        break
                return ("array", items)
            if t.value == "{":
                props = []
                while not self.eat("punct", "}"):
                    kt = self.next()
                    if kt.kind in ("name", "keyword", "str"):
                        key = kt.value
                    elif kt.kind == "num":
                        key = js_to_string(kt.value)
                    elif kt.kind == "punct" and kt.value == "[":
                        keyexpr = self.expression()
                        self.expect("punct", "]")
                        self.expect("punct", ":")
                        props.append(("computed", keyexpr, self.assignment()))
                        if not self.eat("punct", ","):
                            self.expect("punct", "}")
                            break
                        continue
                    elif kt.kind == "punct" and kt.value == "...":
                        props.append(("spread", self.assignment()))
                        if not self.eat("punct", ","):
                            self.expect("punct", "}")
                            break
                        continue
                    else:
                        raise JSError(f"SyntaxError: bad object key {kt.value!r}")
                    if key == "async" and (
                        self.peek().kind in ("name", "keyword", "str")
                        and self.peek(1).kind == "punct"
                        and self.peek(1).value == "("
                    ):
                        # async shorthand method: `async m(args) {…}`
                        mkey = self.next().value
                        params, defaults, rest = self.param_list()
                        body = self.block()
                        props.append(("kv", mkey, ("func", mkey, params, defaults, rest, body, True)))
                        if not self.eat("punct", ","):
                            self.expect("punct", "}")
                            break
                        continue
                    if key in ("get", "set") and (
                        self.peek().kind in ("name", "keyword", "str", "num")
                        and not (self.peek(1).kind == "punct" and self.peek(1).value in (":", ",", "}"))
                    ):
                        # accessor: `get x() {…}` / `set x(v) {…}`
                        akind = key
                        akt = self.next()
                        akey = js_to_string(akt.value) if akt.kind == "num" else akt.value
                        params, defaults, rest = self.param_list()
                        body = self.block()
                        props.append((akind, akey, ("func", akey, params, defaults, rest, body, False)))
                        if not self.eat("punct", ","):
                            self.expect("punct", "}")
                            break
                        continue
                    if self.at("punct", "("):
                        params, defaults, rest = self.param_list()
                        body = self.block()
                        props.append(("kv", key, ("func", key, params, defaults, rest, body, False)))
                    elif self.eat("punct", ":"):
                        props.append(("kv", key, self.assignment()))
                    else:
                        props.append(("kv", key, ("name", key)))  # shorthand
                    if not self.eat("punct", ","):
                        self.expect("punct", "}")
                        break
                return ("object", props)
        raise JSError(f"SyntaxError: unexpected token {t.value!r}")


# ---------------------------------------------------------------------------
# runtime helpers (JS semantics)
# ---------------------------------------------------------------------------

def _spread_seq(v):
    """Iterable coercion for spread sites (arrays, strings, Map/Set)."""
    if isinstance(v, (JSArray, str)):
        return list(v)
    if isinstance(v, JSSet):
        return v.values()
    if isinstance(v, JSMap):
        return [JSArray([k, x]) for k, x in v.entries()]
    try:
        return list(v)
    except TypeError:
        raise JSError("TypeError: value is not iterable (spread)")


def js_truthy(v) -> bool:
    if v is UNDEFINED or v is None or v is False:
        return False
    if isinstance(v, float):
        return not (v == 0 or _math.isnan(v))
    if isinstance(v, str):
        return len(v) > 0
    if v is True:
        return True
    return True


def js_typeof(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "object"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, JSFunction) or callable(v):
        return "function"
    return "object"


def js_to_number(v) -> float:
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, float):
        return v
    if v is UNDEFINED:
        return float("nan")
    if v is None:
        return 0.0
    if isinstance(v, str):
        s = v.strip()
        if not s:
            return 0.0
        try:
            if s.startswith(("0x", "0X")):
                return float(int(s, 16))
            return float(s)
        except ValueError:
            return float("nan")
    if isinstance(v, JSArray):
        if len(v) == 0:
            return 0.0
        if len(v) == 1:
            return js_to_number(v[0])
    return float("nan")


def _fmt_number(x: float) -> str:
    if _math.isnan(x):
        return "NaN"
    if x == _math.inf:
        return "Infinity"
    if x == -_math.inf:
        return "-Infinity"
    if x == int(x) and abs(x) < 1e21:
        return str(int(x))
    return repr(x)


def js_to_string(v) -> str:
    if v is UNDEFINED:
        return "undefined"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return _fmt_number(v)
    if isinstance(v, str):
        return v
    if isinstance(v, JSArray):
        return ",".join("" if x is UNDEFINED or x is None else js_to_string(x) for x in v)
    if isinstance(v, JSObject):
        return "[object Object]"
    if isinstance(v, JSRegExp):
        return repr(v)
    if isinstance(v, JSFunction):
        return repr(v)
    return str(v)


def js_repr(v) -> str:
    """console.log-style rendering."""
    if isinstance(v, str):
        return v
    return _json_stringify(v, None, 0) if isinstance(v, (JSObject, JSArray)) else js_to_string(v)


def js_loose_eq(a, b) -> bool:
    if (a is UNDEFINED or a is None) and (b is UNDEFINED or b is None):
        return True
    if a is UNDEFINED or a is None or b is UNDEFINED or b is None:
        return False
    if type(a) == type(b) or (isinstance(a, (float, bool)) and isinstance(b, (float, bool))):
        return js_strict_eq(a, b)
    if isinstance(a, str) and isinstance(b, (float, bool)):
        return js_to_number(a) == js_to_number(b)
    if isinstance(b, str) and isinstance(a, (float, bool)):
        return js_to_number(a) == js_to_number(b)
    if isinstance(a, (JSObject, JSArray)):
        return js_loose_eq(js_to_string(a), b)
    if isinstance(b, (JSObject, JSArray)):
        return js_loose_eq(a, js_to_string(b))
    return False


def js_strict_eq(a, b) -> bool:
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, float) and isinstance(b, float):
        return a == b
    if isinstance(a, str) and isinstance(b, str):
        return a == b
    return a is b


def to_python(v):
    """JS value → plain Python (for the embedder)."""
    if v is UNDEFINED:
        return None
    if isinstance(v, JSArray):
        return [to_python(x) for x in v]
    if isinstance(v, JSObject):
        return {k: to_python(x) for k, x in v.items()}
    if isinstance(v, JSMap):
        return {to_python(k): to_python(x) for k, x in v.entries()}
    if isinstance(v, JSSet):
        return [to_python(x) for x in v.values()]
    if isinstance(v, JSPromise):
        return to_python(v.value) if v.state == "fulfilled" else None
    if isinstance(v, float) and v == int(v) and abs(v) < 2**53:
        return int(v)
    return v


def from_python(v):
    """Plain Python → JS value."""
    if v is None:
        return None
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return float(v)
    if isinstance(v, str):
        return v
    if isinstance(v, (list, tuple)):
        return JSArray(from_python(x) for x in v)
    if isinstance(v, dict):
        o = JSObject()
        for k, x in v.items():
            o[str(k)] = from_python(x)
        return o
    return v


def _json_stringify(v, indent, depth) -> str:
    try:
        return _json.dumps(to_python(v), separators=(",", ":") if not indent else None, indent=indent)
    except (TypeError, ValueError):
        return "null"


# control-flow signals
class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Scope:
    __slots__ = ("vars", "parent", "consts")

    def __init__(self, parent=None):
        self.vars: Dict[str, Any] = {}
        self.consts: set = set()
        self.parent = parent

    def lookup(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s
            s = s.parent
        return None

    def get(self, name):
        s = self.lookup(name)
        if s is None:
            raise JSError(f"ReferenceError: {name} is not defined")
        return s.vars[name]

    def set(self, name, value):
        s = self.lookup(name)
        if s is None:
            # implicit global (sloppy mode)
            g = self
            while g.parent is not None:
                g = g.parent
            g.vars[name] = value
            return
        if name in s.consts:
            raise JSError(f"TypeError: assignment to constant variable {name}")
        s.vars[name] = value

    def declare(self, name, value, const=False):
        self.vars[name] = value
        if const:
            self.consts.add(name)


# ---------------------------------------------------------------------------
# interpreter
# ---------------------------------------------------------------------------
class JSInterpreter:
    """One isolated JS realm. ``run(src)`` executes top-level code;
    ``call(name, *args)`` invokes a declared function; ``op_budget`` bounds
    total interpreter operations per call (the sandbox timeout analog)."""

    def __init__(self, op_budget: int = 5_000_000):
        self.globals = _Scope()
        self.op_budget = op_budget
        self.ops = 0
        # embedder event-loop hook: called while awaiting a pending promise;
        # returns True if it made progress (ran a timer / delivered an event)
        self.pending_pump: Optional[Callable[[], bool]] = None
        self._install_stdlib()

    # -- embedder API -------------------------------------------------------
    def set_global(self, name: str, value) -> None:
        self.globals.declare(name, value)

    def run(self, src: str):
        ast = _Parser(_tokenize(src)).parse_program()
        self.ops = 0
        return self.exec_block(ast[1], self.globals)

    def call(self, name: str, *args):
        fn = self.globals.get(name)
        self.ops = 0
        out = self.call_function(fn, list(args), UNDEFINED)
        # async entry points return a promise — unwrap it for the embedder
        # (pending promises pump the embedder loop; rejections re-throw)
        return self._await_value(out)

    # -- execution ----------------------------------------------------------
    def _tick(self):
        self.ops += 1
        if self.ops > self.op_budget:
            raise JSTimeout()

    def exec_block(self, stmts, scope):
        # hoist function declarations
        for s in stmts:
            if s[0] == "funcdecl":
                _, name, params, defaults, rest, body, is_async = s
                scope.declare(
                    name, JSFunction(name, params, defaults, rest, body, scope, self, is_async=is_async)
                )
        last = UNDEFINED
        for s in stmts:
            last = self.exec_stmt(s, scope)
        return last

    def exec_stmt(self, s, scope):
        self._tick()
        kind = s[0]
        if kind == "expr":
            return self.eval(s[1], scope)
        if kind == "decl":
            _, dkind, decls = s
            for target, init in decls:
                val = UNDEFINED if init is None else self.eval(init, scope)
                self._bind_pattern(target, val, scope, const=(dkind == "const"))
            return UNDEFINED
        if kind == "classdecl":
            _, name, node = s
            scope.declare(name, self.eval(node, scope))
            return UNDEFINED
        if kind == "funcdecl":
            return UNDEFINED  # hoisted
        if kind == "block":
            return self.exec_block(s[1], _Scope(scope))
        if kind == "if":
            if js_truthy(self.eval(s[1], scope)):
                return self.exec_stmt(s[2], scope)
            if s[3] is not None:
                return self.exec_stmt(s[3], scope)
            return UNDEFINED
        if kind == "while":
            while js_truthy(self.eval(s[1], scope)):
                self._tick()
                try:
                    self.exec_stmt(s[2], scope)
                except _Break:
                    break
                except _Continue:
                    continue
            return UNDEFINED
        if kind == "dowhile":
            while True:
                self._tick()
                try:
                    self.exec_stmt(s[2], scope)
                except _Break:
                    break
                except _Continue:
                    pass
                if not js_truthy(self.eval(s[1], scope)):
                    break
            return UNDEFINED
        if kind == "for":
            _, init, cond, update, body = s
            fscope = _Scope(scope)
            if init is not None:
                self.exec_stmt(init, fscope)
            while cond is None or js_truthy(self.eval(cond, fscope)):
                self._tick()
                try:
                    self.exec_stmt(body, fscope)
                except _Break:
                    break
                except _Continue:
                    pass
                if update is not None:
                    self.eval(update, fscope)
            return UNDEFINED
        if kind == "forof":
            _, target, iterable, body = s
            it = self.eval(iterable, scope)
            if isinstance(it, str):
                seq = list(it)
            elif isinstance(it, JSArray):
                seq = list(it)
            elif isinstance(it, JSMap):
                seq = [JSArray([k, v]) for k, v in it.entries()]
            elif isinstance(it, JSSet):
                seq = it.values()
            elif isinstance(it, JSObject):
                raise JSError("TypeError: object is not iterable (use for-in)")
            else:
                seq = list(it) if it else []
            for item in seq:
                self._tick()
                fscope = _Scope(scope)
                self._bind_pattern(target, item, fscope)
                try:
                    self.exec_stmt(body, fscope)
                except _Break:
                    break
                except _Continue:
                    continue
            return UNDEFINED
        if kind == "forin":
            _, target, iterable, body = s
            it = self.eval(iterable, scope)
            if isinstance(it, JSObject):
                keys = list(it.keys())
            elif isinstance(it, JSArray):
                keys = [js_to_string(float(i)) for i in range(len(it))]
            else:
                keys = []
            for k in keys:
                self._tick()
                fscope = _Scope(scope)
                self._bind_pattern(target, k, fscope)
                try:
                    self.exec_stmt(body, fscope)
                except _Break:
                    break
                except _Continue:
                    continue
            return UNDEFINED
        if kind == "return":
            raise _Return(UNDEFINED if s[1] is None else self.eval(s[1], scope))
        if kind == "break":
            raise _Break()
        if kind == "continue":
            raise _Continue()
        if kind == "throw":
            raise JSError(self.eval(s[1], scope))
        if kind == "try":
            _, block, cname, cblock, fblock = s
            try:
                self.exec_stmt(block, scope)
            except JSError as e:
                if isinstance(e, JSTimeout):
                    raise
                if cblock is not None:
                    cscope = _Scope(scope)
                    if cname:
                        cscope.declare(cname, self._error_value(e))
                    self.exec_stmt(cblock, cscope)
            finally:
                if fblock is not None:
                    self.exec_stmt(fblock, scope)
            return UNDEFINED
        if kind == "switch":
            _, disc, cases = s
            dval = self.eval(disc, scope)
            matched = False
            try:
                for test, stmts in cases:
                    if not matched and test is not None and js_strict_eq(self.eval(test, scope), dval):
                        matched = True
                    if matched:
                        for st in stmts:
                            self.exec_stmt(st, scope)
                if not matched:
                    hit_default = False
                    for test, stmts in cases:
                        if test is None:
                            hit_default = True
                        if hit_default:
                            for st in stmts:
                                self.exec_stmt(st, scope)
            except _Break:
                pass
            return UNDEFINED
        if kind == "empty":
            return UNDEFINED
        raise JSError(f"InternalError: unknown statement {kind}")

    def _error_value(self, e: JSError):
        v = e.value
        if isinstance(v, (JSObject, JSArray, str, float, bool)) or v is None or v is UNDEFINED:
            if isinstance(v, str):
                o = JSObject()
                o["message"] = v
                o["name"] = "Error"
                return o
            return v
        o = JSObject()
        o["message"] = str(v)
        o["name"] = "Error"
        return o

    # -- expressions --------------------------------------------------------
    def eval(self, e, scope):
        self._tick()
        kind = e[0]
        if kind == "lit":
            return e[1]
        if kind == "name":
            return scope.get(e[1])
        if kind == "this":
            s = scope.lookup("this")
            return s.vars["this"] if s is not None else UNDEFINED
        if kind == "template":
            out = []
            for pk, pv in e[1]:
                if pk == "str":
                    out.append(pv)
                else:
                    out.append(js_to_string(self.eval(pv, scope)))
            return "".join(out)
        if kind == "regex":
            return JSRegExp(e[1], e[2])
        if kind == "array":
            arr = JSArray()
            for item in e[1]:
                if item[0] == "spread":
                    arr.extend(_spread_seq(self.eval(item[1], scope)))
                else:
                    arr.append(self.eval(item, scope))
            return arr
        if kind == "object":
            obj = JSObject()
            for prop in e[1]:
                if prop[0] == "kv":
                    obj[prop[1]] = self.eval(prop[2], scope)
                elif prop[0] == "computed":
                    obj[js_to_string(self.eval(prop[1], scope))] = self.eval(prop[2], scope)
                elif prop[0] in ("get", "set"):
                    _, akey, fnode = prop
                    fn = self.eval(fnode, scope)
                    acc = getattr(obj, "accessors", None)
                    if acc is None:
                        acc = obj.accessors = {}
                    g, s_ = acc.get(akey, (None, None))
                    acc[akey] = (fn, s_) if prop[0] == "get" else (g, fn)
                else:  # spread
                    v = self.eval(prop[1], scope)
                    if isinstance(v, JSObject):
                        obj.update(v)
            return obj
        if kind in ("func", "arrow"):
            if kind == "func":
                _, name, params, defaults, rest, body, is_async = e
                return JSFunction(name, params, defaults, rest, body, scope, self, is_async=is_async)
            _, params, defaults, rest, body, is_async = e
            return JSFunction(None, params, defaults, rest, body, scope, self, is_arrow=True, is_async=is_async)
        if kind == "await":
            v = self.eval(e[1], scope)
            return self._await_value(v)
        if kind == "class":
            return self._build_class(e, scope)
        if kind == "super":
            s = scope.lookup("__superclass__")
            return s.vars["__superclass__"] if s is not None else UNDEFINED
        if kind == "seq":
            self.eval(e[1], scope)
            return self.eval(e[2], scope)
        if kind == "cond":
            return self.eval(e[2] if js_truthy(self.eval(e[1], scope)) else e[3], scope)
        if kind == "and":
            left = self.eval(e[1], scope)
            return self.eval(e[2], scope) if js_truthy(left) else left
        if kind == "or":
            left = self.eval(e[1], scope)
            return left if js_truthy(left) else self.eval(e[2], scope)
        if kind == "nullish":
            left = self.eval(e[1], scope)
            return self.eval(e[2], scope) if left is None or left is UNDEFINED else left
        if kind == "bin":
            return self._binop(e[1], e[2], e[3], scope)
        if kind == "unary":
            op = e[1]
            if op == "typeof":
                try:
                    return js_typeof(self.eval(e[2], scope))
                except JSError:
                    return "undefined"
            v = self.eval(e[2], scope)
            if op == "!":
                return not js_truthy(v)
            if op == "-":
                return -js_to_number(v)
            if op == "+":
                return js_to_number(v)
            if op == "~":
                return float(~_to_int32(v))
            if op == "void":
                return UNDEFINED
            if op == "delete":
                if e[2][0] == "member":
                    obj = self.eval(e[2][1], scope)
                    key = self._member_key(e[2][2], scope)
                    if isinstance(obj, JSObject):
                        obj.pop(key, None)
                        return True
                return True
            raise JSError(f"InternalError: unary {op}")
        if kind in ("preincr", "postincr"):
            _, op, target = e
            old = js_to_number(self._eval_ref(target, scope))
            new = old + (1.0 if op == "++" else -1.0)
            self._assign_to(target, new, scope)
            return new if kind == "preincr" else old
        if kind == "assign":
            _, op, target, rhs = e
            if op == "=":
                val = self.eval(rhs, scope)
            elif op in ("&&=", "||=", "??="):
                cur = self._eval_ref(target, scope)
                if op == "&&=" and not js_truthy(cur):
                    return cur
                if op == "||=" and js_truthy(cur):
                    return cur
                if op == "??=" and not (cur is None or cur is UNDEFINED):
                    return cur
                val = self.eval(rhs, scope)
            else:
                cur = self._eval_ref(target, scope)
                val = self._apply_binop(op[:-1], cur, self.eval(rhs, scope))
            self._assign_to(target, val, scope)
            return val
        if kind == "member":
            obj = self.eval(e[1], scope)
            if e[3] and (obj is None or obj is UNDEFINED):
                return UNDEFINED
            return self.get_member(obj, self._member_key(e[2], scope))
        if kind == "call":
            return self._eval_call(e, scope)
        if kind == "new":
            return self._eval_new(e, scope)
        if kind == "spread":
            return self.eval(e[1], scope)
        raise JSError(f"InternalError: unknown expression {kind}")

    def _member_key(self, keyexpr, scope) -> str:
        if keyexpr[0] == "lit":
            v = keyexpr[1]
        else:
            v = self.eval(keyexpr, scope)
        if isinstance(v, float):
            return _fmt_number(v)
        return js_to_string(v)

    def _eval_ref(self, target, scope):
        try:
            return self.eval(target, scope)
        except JSError:
            return UNDEFINED

    def _assign_to(self, target, val, scope):
        if target[0] == "name":
            scope.set(target[1], val)
        elif target[0] == "member":
            obj = self.eval(target[1], scope)
            key = self._member_key(target[2], scope)
            self.set_member(obj, key, val)
        else:
            raise JSError("SyntaxError: invalid assignment target")

    def _binop(self, op, le, re_, scope):
        a = self.eval(le, scope)
        if op == "instanceof":
            b = self.eval(re_, scope)
            if isinstance(b, JSClass):
                c = getattr(a, "jsclass", None)
                while c is not None:
                    if c is b:
                        return True
                    c = c.parent
                return False
            check = getattr(b, "instance_check", None)
            if check is not None:
                return bool(check(a))
            name = getattr(b, "name", None) or getattr(b, "__name__", "")
            if name == "Array":
                return isinstance(a, JSArray)
            return isinstance(a, JSObject)
        if op == "in":
            b = self.eval(re_, scope)
            key = _fmt_number(a) if isinstance(a, float) else js_to_string(a)
            if isinstance(b, JSObject):
                return key in b
            if isinstance(b, JSArray):
                try:
                    return 0 <= int(float(key)) < len(b)
                except ValueError:
                    return False
            return False
        b = self.eval(re_, scope)
        return self._apply_binop(op, a, b)

    def _apply_binop(self, op, a, b):
        if op == "+":
            if isinstance(a, str) or isinstance(b, str) or isinstance(a, (JSObject, JSArray)) or isinstance(b, (JSObject, JSArray)):
                return js_to_string(a) + js_to_string(b)
            return js_to_number(a) + js_to_number(b)
        if op == "-":
            return js_to_number(a) - js_to_number(b)
        if op == "*":
            return js_to_number(a) * js_to_number(b)
        if op == "/":
            bn = js_to_number(b)
            an = js_to_number(a)
            if bn == 0:
                if an == 0 or _math.isnan(an):
                    return float("nan")
                return _math.inf if (an > 0) == (not _math.copysign(1, bn) < 0) else -_math.inf
            return an / bn
        if op == "%":
            an, bn = js_to_number(a), js_to_number(b)
            if bn == 0 or _math.isnan(an) or _math.isnan(bn) or _math.isinf(an):
                return float("nan")
            return _math.fmod(an, bn)
        if op == "**":
            return js_to_number(a) ** js_to_number(b)
        if op == "==":
            return js_loose_eq(a, b)
        if op == "!=":
            return not js_loose_eq(a, b)
        if op == "===":
            return js_strict_eq(a, b)
        if op == "!==":
            return not js_strict_eq(a, b)
        if op in ("<", ">", "<=", ">="):
            if isinstance(a, str) and isinstance(b, str):
                return {"<": a < b, ">": a > b, "<=": a <= b, ">=": a >= b}[op]
            an, bn = js_to_number(a), js_to_number(b)
            if _math.isnan(an) or _math.isnan(bn):
                return False
            return {"<": an < bn, ">": an > bn, "<=": an <= bn, ">=": an >= bn}[op]
        if op == "&":
            return float(_to_int32(a) & _to_int32(b))
        if op == "|":
            return float(_to_int32(a) | _to_int32(b))
        if op == "^":
            return float(_to_int32(a) ^ _to_int32(b))
        if op == "<<":
            return float(_to_int32(_to_int32(a) << (_to_uint32(b) & 31)))
        if op == ">>":
            return float(_to_int32(a) >> (_to_uint32(b) & 31))
        if op == ">>>":
            return float(_to_uint32(a) >> (_to_uint32(b) & 31))
        raise JSError(f"InternalError: binop {op}")

    def _eval_call(self, e, scope):
        _, callee, args, optional = e
        this = UNDEFINED
        if callee[0] == "super":
            # super(...) — run the parent constructor chain on current `this`
            s = scope.lookup("__superclass__")
            sup = s.vars["__superclass__"] if s is not None else None
            ts = scope.lookup("this")
            this_val = ts.vars["this"] if ts is not None else UNDEFINED
            if not isinstance(sup, JSClass):
                raise JSError("SyntaxError: 'super' outside a derived-class method")
            argv = []
            for a in args:
                if a[0] == "spread":
                    argv.extend(_spread_seq(self.eval(a[1], scope)))
                else:
                    argv.append(self.eval(a, scope))
            # parent fields already initialized in _construct
            self._run_ctor(sup, this_val, argv)
            return UNDEFINED
        if callee[0] == "member" and callee[1][0] == "super":
            # super.m(...) — parent-chain method with the current `this`
            s = scope.lookup("__superclass__")
            sup = s.vars["__superclass__"] if s is not None else None
            ts = scope.lookup("this")
            this_val = ts.vars["this"] if ts is not None else UNDEFINED
            if not isinstance(sup, JSClass):
                raise JSError("SyntaxError: 'super' outside a derived-class method")
            key = self._member_key(callee[2], scope)
            hit = self._class_lookup(sup, key)
            if hit is None:
                raise JSError(f"TypeError: super.{key} is not a function")
            fn = hit[1] if hit[0] == "method" else self.call_function(hit[1], [], this_val)
            argv = []
            for a in args:
                if a[0] == "spread":
                    argv.extend(_spread_seq(self.eval(a[1], scope)))
                else:
                    argv.append(self.eval(a, scope))
            return self.call_function(fn, argv, this_val)
        if callee[0] == "member":
            obj = self.eval(callee[1], scope)
            if callee[3] and (obj is None or obj is UNDEFINED):
                return UNDEFINED
            key = self._member_key(callee[2], scope)
            fn = self.get_member(obj, key)
            this = obj
        else:
            fn = self.eval(callee, scope)
        if optional and (fn is None or fn is UNDEFINED):
            return UNDEFINED
        argv = []
        for a in args:
            if a[0] == "spread":
                v = self.eval(a[1], scope)
                argv.extend(_spread_seq(v))
            else:
                argv.append(self.eval(a, scope))
        return self.call_function(fn, argv, this)

    def _eval_new(self, e, scope):
        _, callee, args = e
        name = callee[1] if callee[0] == "name" else None
        argv = []
        for a in args:
            if a[0] == "spread":
                argv.extend(_spread_seq(self.eval(a[1], scope)))
            else:
                argv.append(self.eval(a, scope))
        if name in ("Error", "TypeError", "RangeError", "SyntaxError"):
            o = JSObject()
            o["name"] = name
            o["message"] = js_to_string(argv[0]) if argv else ""
            return o
        if name == "RegExp":
            return JSRegExp(js_to_string(argv[0]), js_to_string(argv[1]) if len(argv) > 1 else "")
        if name == "Array":
            if len(argv) == 1 and isinstance(argv[0], float):
                return JSArray([UNDEFINED] * int(argv[0]))
            return JSArray(argv)
        fn = self.eval(callee, scope)
        if isinstance(fn, JSClass):
            return self._construct(fn, argv)
        if isinstance(fn, JSFunction):
            this = JSObject()
            out = self.call_function(fn, argv, this)
            return out if isinstance(out, JSObject) else this
        if callable(fn):
            # host constructor (Promise, Map, Set, embedder DOM classes):
            # calling it returns the instance
            return self.call_function(fn, argv, UNDEFINED)
        raise JSError("TypeError: not a constructor")

    def call_function(self, fn, argv, this):
        if isinstance(fn, JSFunction):
            if fn.is_async:
                # async fn: run synchronously (awaits pump the embedder
                # loop), return a settled promise — so `.then()` chains and
                # `await` both observe proper JS semantics
                p = JSPromise()
                try:
                    self._promise_settle(p, "fulfilled", self._invoke_js(fn, argv, this))
                except JSTimeout:
                    raise
                except JSError as e:
                    self._promise_settle(p, "rejected", self._error_value(e))
                return p
            return self._invoke_js(fn, argv, this)
        if callable(fn):
            try:
                out = fn(*argv)
            except JSError:
                raise
            except Exception as ex:  # host exceptions become JS throws so
                # scripts' try/catch works (QuickJS host-function semantics)
                raise JSError(f"{type(ex).__name__}: {ex}")
            return out if out is not None else UNDEFINED
        raise JSError(f"TypeError: {js_to_string(fn)} is not a function")

    def _invoke_js(self, fn: JSFunction, argv, this):
        scope = _Scope(fn.closure)
        if not fn.is_arrow:
            scope.declare("this", this)
            if fn.home_class is not None:
                scope.declare("__superclass__", fn.home_class.parent)
        for i, p in enumerate(fn.params):
            val = argv[i] if i < len(argv) else UNDEFINED
            if val is UNDEFINED and fn.defaults[i] is not None:
                val = self.eval(fn.defaults[i], scope)
            self._bind_pattern(p, val, scope)
        if fn.rest is not None:
            scope.declare(fn.rest, JSArray(argv[len(fn.params):]))
        scope.declare("arguments", JSArray(argv))
        try:
            self.exec_stmt(fn.body, scope)
        except _Return as r:
            return r.value
        return UNDEFINED

    def _bind_pattern(self, target, value, scope, const=False):
        """Bind a ``binding_target`` pattern to ``value`` in ``scope``."""
        k = target[0]
        if k == "pid":
            scope.declare(target[1], value, const=const)
            return
        if k == "pobj":
            _, props, rest = target
            if value is None or value is UNDEFINED:
                raise JSError(f"TypeError: cannot destructure {js_to_string(value)}")
            taken = set()
            for key, sub, default in props:
                v = self.get_member(value, key)
                if v is UNDEFINED and default is not None:
                    v = self.eval(default, scope)
                self._bind_pattern(sub, v, scope, const)
                taken.add(key)
            if rest is not None:
                o = JSObject()
                if isinstance(value, JSObject):
                    for kk, vv in value.items():
                        if kk not in taken:
                            o[kk] = vv
                scope.declare(rest, o, const=const)
            return
        if k == "parr":
            _, elems, rest = target
            if isinstance(value, (JSArray, str)):
                seq = list(value)
            elif isinstance(value, JSSet):
                seq = value.values()
            elif isinstance(value, JSMap):
                seq = [JSArray([kk, vv]) for kk, vv in value.entries()]
            elif value is None or value is UNDEFINED:
                raise JSError(f"TypeError: {js_to_string(value)} is not iterable")
            else:
                try:
                    seq = list(value)
                except TypeError:
                    raise JSError("TypeError: value is not iterable")
            for i, (sub, default) in enumerate(elems):
                if sub is None:
                    continue
                v = seq[i] if i < len(seq) else UNDEFINED
                if v is UNDEFINED and default is not None:
                    v = self.eval(default, scope)
                self._bind_pattern(sub, v, scope, const)
            if rest is not None:
                scope.declare(rest, JSArray(seq[len(elems):]), const=const)
            return
        raise JSError("InternalError: bad binding pattern")

    # -- promises -------------------------------------------------------------
    def _promise_settle(self, p: JSPromise, state: str, value):
        if p.state != "pending":
            return
        # `resolve(anotherPromise)` adopts its state
        if state == "fulfilled" and isinstance(value, JSPromise):
            inner = value
            if inner.state == "pending":
                inner.callbacks.append(
                    (
                        lambda v: self._promise_settle(p, "fulfilled", v),
                        lambda r: self._promise_settle(p, "rejected", r),
                        None,
                    )
                )
                return
            state, value = inner.state, inner.value
        p.state = state
        p.value = value
        cbs, p.callbacks = p.callbacks, []
        for on_ful, on_rej, chained in cbs:
            handler = on_ful if state == "fulfilled" else on_rej
            if handler is None:
                if chained is not None:
                    self._promise_settle(chained, state, value)
                continue
            if chained is None:
                handler(value)
                continue
            try:
                out = (
                    self.call_function(handler, [value], UNDEFINED)
                    if isinstance(handler, JSFunction) or callable(handler)
                    else UNDEFINED
                )
                self._promise_settle(chained, "fulfilled", out)
            except JSTimeout:
                raise
            except JSError as e:
                self._promise_settle(chained, "rejected", self._error_value(e))

    def _promise_then(self, p: JSPromise, on_ful=None, on_rej=None) -> JSPromise:
        chained = JSPromise()
        if p.state == "pending":
            p.callbacks.append((on_ful, on_rej, chained))
        else:
            handler = on_ful if p.state == "fulfilled" else on_rej
            if handler is None:
                self._promise_settle(chained, p.state, p.value)
            else:
                try:
                    out = self.call_function(handler, [p.value], UNDEFINED)
                    self._promise_settle(chained, "fulfilled", out)
                except JSTimeout:
                    raise
                except JSError as e:
                    self._promise_settle(chained, "rejected", self._error_value(e))
        return chained

    def _await_value(self, v):
        if not isinstance(v, JSPromise):
            return v
        guard = 0
        while v.state == "pending":
            self._tick()
            if self.pending_pump is None:
                raise JSError("TypeError: await on a pending promise with no event loop")
            progressed = self.pending_pump()
            if not progressed:
                guard += 1
                if guard > 10_000:
                    raise JSError("Error: await: promise never settles (event loop starved)")
            else:
                guard = 0
        if v.state == "fulfilled":
            return v.value
        raise JSError(v.value)

    # -- classes --------------------------------------------------------------
    def _build_class(self, e, scope) -> JSClass:
        _, name, supexpr, members = e
        parent = None
        if supexpr is not None:
            parent = self.eval(supexpr, scope)
            if not isinstance(parent, JSClass):
                raise JSError("TypeError: class extends a non-class value")
        cls = JSClass(name, parent)
        for is_static, mkind, key, value in members:
            if mkind == "field":
                if is_static:
                    cls.statics[key] = self.eval(value, scope)
                else:
                    cls.fields.append((key, value))
                continue
            fn = self.eval(value, scope)
            fn.home_class = cls
            if is_static:
                cls.statics[key] = fn
            elif mkind == "ctor":
                cls.ctor = fn
            elif mkind == "get":
                cls.getters[key] = fn
            elif mkind == "set":
                cls.setters[key] = fn
            else:
                cls.methods[key] = fn
        return cls

    def _construct(self, cls: JSClass, argv):
        inst = JSObject()
        inst.jsclass = cls
        # instance fields, base-first (simplification: before ctor bodies)
        chain = []
        c = cls
        while c is not None:
            chain.append(c)
            c = c.parent
        for c in reversed(chain):
            for fkey, fexpr in c.fields:
                fscope = _Scope(self.globals)
                fscope.declare("this", inst)
                inst[fkey] = self.eval(fexpr, fscope)
        self._run_ctor(cls, inst, argv)
        return inst

    def _run_ctor(self, cls: JSClass, inst, argv):
        c = cls
        while c is not None and c.ctor is None:
            c = c.parent  # default-constructor chain: forward args upward
        if c is not None:
            self._invoke_js(c.ctor, argv, inst)

    def _class_lookup(self, cls, key):
        c = cls
        while c is not None:
            if key in c.getters:
                return ("get", c.getters[key])
            if key in c.methods:
                return ("method", c.methods[key])
            c = c.parent
        return None

    def _class_lookup_setter(self, cls, key):
        c = cls
        while c is not None:
            if key in c.setters:
                return c.setters[key]
            c = c.parent
        return None

    # -- member access ------------------------------------------------------
    def get_member(self, obj, key: str):
        if obj is None or obj is UNDEFINED:
            raise JSError(f"TypeError: cannot read property {key!r} of {js_to_string(obj)}")
        if isinstance(obj, JSObject):
            acc = getattr(obj, "accessors", None)
            if acc is not None and key in acc and acc[key][0] is not None:
                return self.call_function(acc[key][0], [], obj)
            if key in obj:
                return obj[key]
            cls = getattr(obj, "jsclass", None)
            if cls is not None:
                hit = self._class_lookup(cls, key)
                if hit is not None:
                    return self.call_function(hit[1], [], obj) if hit[0] == "get" else hit[1]
                if key == "constructor":
                    return cls
            return _object_method(self, obj, key)
        if isinstance(obj, JSPromise):
            if key == "then":
                return lambda on_ful=None, on_rej=None: self._promise_then(
                    obj,
                    on_ful if on_ful not in (None, UNDEFINED) else None,
                    on_rej if on_rej not in (None, UNDEFINED) else None,
                )
            if key == "catch":
                return lambda on_rej=None: self._promise_then(
                    obj, None, on_rej if on_rej not in (None, UNDEFINED) else None
                )
            if key == "finally":
                def _finally(cb=None):
                    def run(v):
                        if cb not in (None, UNDEFINED):
                            self.call_function(cb, [], UNDEFINED)
                        return v
                    def run_rej(r):
                        if cb not in (None, UNDEFINED):
                            self.call_function(cb, [], UNDEFINED)
                        raise JSError(r)
                    return self._promise_then(obj, run, run_rej)
                return _finally
            return UNDEFINED
        if isinstance(obj, JSMap):
            if key == "size":
                return float(obj.size)
            if key == "get":
                return lambda k=UNDEFINED: obj.get(k)
            if key == "set":
                return lambda k=UNDEFINED, v=UNDEFINED: obj.set(k, v)
            if key == "has":
                return lambda k=UNDEFINED: obj.has(k)
            if key == "delete":
                return lambda k=UNDEFINED: obj.delete(k)
            if key == "clear":
                return lambda: obj.clear()
            if key == "forEach":
                return lambda fn=None: [
                    self.call_function(fn, [v, k, obj], UNDEFINED) for k, v in obj.entries()
                ] and UNDEFINED
            if key == "keys":
                return lambda: JSArray(k for k, _ in obj.entries())
            if key == "values":
                return lambda: JSArray(v for _, v in obj.entries())
            if key == "entries":
                return lambda: JSArray(JSArray([k, v]) for k, v in obj.entries())
            return UNDEFINED
        if isinstance(obj, JSSet):
            if key == "size":
                return float(obj.size)
            if key == "add":
                return lambda v=UNDEFINED: obj.add(v)
            if key == "has":
                return lambda v=UNDEFINED: obj.has(v)
            if key == "delete":
                return lambda v=UNDEFINED: obj.delete(v)
            if key == "clear":
                return lambda: obj.clear()
            if key == "forEach":
                return lambda fn=None: [
                    self.call_function(fn, [v, v, obj], UNDEFINED) for v in obj.values()
                ] and UNDEFINED
            if key == "values":
                return lambda: JSArray(obj.values())
            return UNDEFINED
        if isinstance(obj, JSClass):
            if key in obj.statics:
                return obj.statics[key]
            if key == "name":
                return obj.name
            if obj.parent is not None:
                return self.get_member(obj.parent, key)
            return UNDEFINED
        if isinstance(obj, JSArray):
            if key == "length":
                return float(len(obj))
            try:
                idx = int(key)
                if 0 <= idx < len(obj):
                    return obj[idx]
                return UNDEFINED
            except ValueError:
                pass
            return _array_method(self, obj, key)
        if isinstance(obj, str):
            if key == "length":
                return float(len(obj))
            try:
                idx = int(key)
                return obj[idx] if 0 <= idx < len(obj) else UNDEFINED
            except ValueError:
                pass
            return _string_method(self, obj, key)
        if isinstance(obj, float):
            return _number_method(self, obj, key)
        if isinstance(obj, JSRegExp):
            if key == "source":
                return obj.source
            if key == "flags":
                return obj.flags
            if key == "lastIndex":
                return float(obj.last_index)
            if key == "test":
                return lambda s="": obj.re.search(js_to_string(s)) is not None
            if key == "exec":
                return lambda s="": _regex_exec(obj, js_to_string(s))
        if isinstance(obj, JSFunction):
            if key == "call":
                return lambda *a: self.call_function(obj, list(a[1:]), a[0] if a else UNDEFINED)
            if key == "apply":
                return lambda *a: self.call_function(
                    obj, list(a[1]) if len(a) > 1 else [], a[0] if a else UNDEFINED
                )
            if key == "bind":
                def _bind(*a):
                    bound_this = a[0] if a else UNDEFINED
                    bound_args = list(a[1:])
                    return lambda *later: self.call_function(obj, bound_args + list(later), bound_this)
                return _bind
            if key == "name":
                return obj.name
            return obj.properties.get(key, UNDEFINED)
        if isinstance(obj, _CallableObject):
            return obj.props.get(key, UNDEFINED)
        if isinstance(obj, dict):  # host dict
            return from_python(obj.get(key, UNDEFINED))
        return UNDEFINED

    def set_member(self, obj, key: str, val):
        if isinstance(obj, JSObject):
            acc = getattr(obj, "accessors", None)
            if acc is not None and key in acc and acc[key][1] is not None:
                self.call_function(acc[key][1], [val], obj)
                return
            cls = getattr(obj, "jsclass", None)
            if cls is not None:
                setter = self._class_lookup_setter(cls, key)
                if setter is not None:
                    self.call_function(setter, [val], obj)
                    return
            obj[key] = val
            return
        if isinstance(obj, JSClass):
            obj.statics[key] = val
            return
        if isinstance(obj, JSArray):
            if key == "length":
                n = int(js_to_number(val))
                del obj[n:]
                while len(obj) < n:
                    obj.append(UNDEFINED)
                return
            try:
                idx = int(key)
            except ValueError:
                return
            while len(obj) <= idx:
                obj.append(UNDEFINED)
            obj[idx] = val
            return
        if isinstance(obj, JSFunction):
            obj.properties[key] = val
            return
        raise JSError(f"TypeError: cannot set property {key!r}")

    # -- stdlib -------------------------------------------------------------
    def _install_stdlib(self):
        g = self.globals
        interp = self

        def _log(*args):
            pass  # embedder may override console

        console = JSObject()
        console["log"] = _log
        console["warn"] = _log
        console["error"] = _log
        g.declare("console", console)

        math_obj = JSObject()
        for name, fn in [
            ("floor", _math.floor), ("ceil", _math.ceil), ("sqrt", _math.sqrt),
            ("abs", abs), ("exp", _math.exp), ("sin", _math.sin), ("cos", _math.cos),
        ]:
            math_obj[name] = (lambda f: lambda x=0.0: float(f(js_to_number(x))))(fn)
        math_obj["log"] = lambda x=0.0: _math.log(js_to_number(x)) if js_to_number(x) > 0 else float("-inf" if js_to_number(x) == 0 else "nan")
        math_obj["round"] = lambda x=0.0: float(_math.floor(js_to_number(x) + 0.5))
        math_obj["trunc"] = lambda x=0.0: float(_math.trunc(js_to_number(x)))
        math_obj["sign"] = lambda x=0.0: float((js_to_number(x) > 0) - (js_to_number(x) < 0))
        math_obj["min"] = lambda *a: float(min((js_to_number(x) for x in a), default=_math.inf))
        math_obj["max"] = lambda *a: float(max((js_to_number(x) for x in a), default=-_math.inf))
        math_obj["pow"] = lambda a=0.0, b=0.0: js_to_number(a) ** js_to_number(b)
        math_obj["random"] = _js_random
        math_obj["PI"] = _math.pi
        math_obj["E"] = _math.e
        g.declare("Math", math_obj)

        json_obj = JSObject()

        def _parse(s="", *_a):
            try:
                return from_python(_json.loads(js_to_string(s)))
            except (ValueError, TypeError) as ex:
                raise JSError(f"SyntaxError: JSON.parse: {ex}")

        def _stringify(v=UNDEFINED, _replacer=None, indent=None):
            if v is UNDEFINED:
                return UNDEFINED
            ind = None
            if isinstance(indent, float):
                ind = int(indent)
            elif isinstance(indent, str):
                ind = indent
            return _json_stringify(v, ind, 0)

        json_obj["parse"] = _parse
        json_obj["stringify"] = _stringify
        g.declare("JSON", json_obj)

        number_obj = JSObject()
        number_obj["isFinite"] = lambda v=UNDEFINED: isinstance(v, float) and _math.isfinite(v)
        number_obj["isNaN"] = lambda v=UNDEFINED: isinstance(v, float) and _math.isnan(v)
        number_obj["isInteger"] = lambda v=UNDEFINED: isinstance(v, float) and _math.isfinite(v) and v == int(v)
        number_obj["parseFloat"] = _parse_float
        number_obj["parseInt"] = lambda s="", base=10.0: _parse_int(s, base)
        number_obj["MAX_SAFE_INTEGER"] = float(2**53 - 1)
        number_obj["EPSILON"] = 2.220446049250313e-16
        g.declare("Number", _CallableObject(number_obj, lambda v=0.0: js_to_number(v)))

        g.declare("String", _CallableObject(JSObject(), lambda v="": js_to_string(v)))
        g.declare("Boolean", _CallableObject(JSObject(), lambda v=False: js_truthy(v)))
        g.declare("parseInt", lambda s="", base=10.0: _parse_int(s, base))
        g.declare("parseFloat", number_obj["parseFloat"])
        g.declare("isNaN", lambda v=UNDEFINED: _math.isnan(js_to_number(v)))
        g.declare("isFinite", lambda v=UNDEFINED: _math.isfinite(js_to_number(v)))
        g.declare("NaN", float("nan"))
        g.declare("Infinity", _math.inf)
        g.declare("globalThis", JSObject())

        def _obj_pairs(o):
            if isinstance(o, JSObject):
                return list(o.items())
            if isinstance(o, JSArray):
                return [(js_to_string(float(i)), v) for i, v in enumerate(o)]
            return []

        object_obj = JSObject()
        object_obj["keys"] = lambda o=None: JSArray(k for k, _ in _obj_pairs(o))
        object_obj["values"] = lambda o=None: JSArray(v for _, v in _obj_pairs(o))
        object_obj["entries"] = lambda o=None: JSArray(JSArray([k, v]) for k, v in _obj_pairs(o))
        object_obj["assign"] = _object_assign
        object_obj["freeze"] = lambda o=None: o

        def _from_entries(pairs=None):
            o = JSObject()
            seq = pairs.entries() if isinstance(pairs, JSMap) else (list(pairs) if isinstance(pairs, JSArray) else [])
            for pair in seq:
                if isinstance(pair, (JSArray, tuple, list)) and len(pair) >= 2:
                    o[js_to_string(pair[0])] = pair[1]
            return o

        object_obj["fromEntries"] = _from_entries
        g.declare("Object", _CallableObject(object_obj, lambda v=None: v if isinstance(v, JSObject) else JSObject()))

        array_obj = JSObject()
        array_obj["isArray"] = lambda v=None: isinstance(v, JSArray)
        def _array_from_seq(v):
            if isinstance(v, (JSArray, str)):
                return list(v)
            if isinstance(v, JSSet):
                return v.values()
            if isinstance(v, JSMap):
                return [JSArray([k, x]) for k, x in v.entries()]
            if isinstance(v, JSObject) and "length" in v:
                return [v.get(js_to_string(float(i)), UNDEFINED) for i in range(int(js_to_number(v["length"])))]
            return []

        array_obj["from"] = lambda v=None, fn=None: JSArray(
            (interp.call_function(fn, [x, float(i)], UNDEFINED) if fn not in (None, UNDEFINED) else x)
            for i, x in enumerate(_array_from_seq(v))
        )
        array_obj["name"] = "Array"
        g.declare("Array", _CallableObject(array_obj, lambda *a: JSArray(a)))

        date_obj = JSObject()
        date_obj["now"] = lambda: float(int(_time.time() * 1000))
        g.declare("Date", _CallableObject(date_obj, lambda *a: JSObject()))

        # -- Promise / Map / Set ------------------------------------------------
        def _promise_ctor(executor=None):
            p = JSPromise()
            if executor not in (None, UNDEFINED):
                resolve = lambda v=UNDEFINED: interp._promise_settle(p, "fulfilled", v)
                reject = lambda r=UNDEFINED: interp._promise_settle(p, "rejected", r)
                try:
                    interp.call_function(executor, [resolve, reject], UNDEFINED)
                except JSTimeout:
                    raise
                except JSError as e:
                    interp._promise_settle(p, "rejected", interp._error_value(e))
            return p

        promise_statics = JSObject()

        def _p_resolve(v=UNDEFINED):
            if isinstance(v, JSPromise):
                return v
            p = JSPromise()
            interp._promise_settle(p, "fulfilled", v)
            return p

        def _p_reject(r=UNDEFINED):
            p = JSPromise()
            interp._promise_settle(p, "rejected", r)
            return p

        def _p_all(items=None):
            out = JSPromise()
            vals = JSArray()
            seq = list(items) if isinstance(items, JSArray) else []
            remaining = [len(seq)]
            if not seq:
                interp._promise_settle(out, "fulfilled", vals)
                return out
            vals.extend([UNDEFINED] * len(seq))

            def arm(i, it):
                p = it if isinstance(it, JSPromise) else _p_resolve(it)

                def on_ful(v, i=i):
                    vals[i] = v
                    remaining[0] -= 1
                    if remaining[0] == 0:
                        interp._promise_settle(out, "fulfilled", vals)

                def on_rej(r):
                    interp._promise_settle(out, "rejected", r)

                interp._promise_then(p, on_ful, on_rej)

            for i, it in enumerate(seq):
                arm(i, it)
            return out

        promise_statics["resolve"] = _p_resolve
        promise_statics["reject"] = _p_reject
        promise_statics["all"] = _p_all
        promise_global = _CallableObject(promise_statics, _promise_ctor)
        promise_global.instance_check = lambda v: isinstance(v, JSPromise)
        g.declare("Promise", promise_global)

        def _map_ctor(init=None):
            m = JSMap()
            if isinstance(init, JSArray):
                for pair in init:
                    if isinstance(pair, JSArray) and len(pair) >= 2:
                        m.set(pair[0], pair[1])
            return m

        def _set_ctor(init=None):
            s = JSSet()
            if isinstance(init, (JSArray, str)):
                for v in list(init):
                    s.add(v)
            elif isinstance(init, JSSet):
                for v in init.values():
                    s.add(v)
            return s

        map_global = _CallableObject(JSObject(), _map_ctor)
        map_global.instance_check = lambda v: isinstance(v, JSMap)
        set_global = _CallableObject(JSObject(), _set_ctor)
        set_global.instance_check = lambda v: isinstance(v, JSSet)
        g.declare("Map", map_global)
        g.declare("Set", set_global)


class _CallableObject:
    """An object that is also callable (Number(), String(), Object.keys…)."""

    def __init__(self, props: JSObject, call: Callable):
        self.props = props
        self._call = call
        self.name = props.get("name", "")

    def __call__(self, *args):
        return self._call(*args)

    def get(self, key, default=None):
        return self.props.get(key, default)

    def keys(self):
        return self.props.keys()

    def __contains__(self, k):
        return k in self.props

    def __getitem__(self, k):
        return self.props[k]


def _js_random():
    import random

    return random.random()


def _parse_float(s=""):
    m = _re.match(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|Infinity)", js_to_string(s))
    if not m:
        return float("nan")
    txt = m.group(0).strip()
    return _math.inf if txt.endswith("Infinity") else float(txt)


def _parse_int(s, base=10.0):
    s = js_to_string(s).strip()
    b = int(js_to_number(base)) or 10
    m = _re.match(r"[+-]?(0x[0-9a-fA-F]+|\d+)" if b in (10, 16) else r"[+-]?[0-9a-zA-Z]+", s)
    if not m:
        return float("nan")
    try:
        txt = m.group(0)
        if txt.lower().startswith(("0x", "+0x", "-0x")):
            return float(int(txt, 16))
        return float(int(txt, b))
    except ValueError:
        return float("nan")


def _to_int32(v) -> int:
    n = js_to_number(v)
    if _math.isnan(n) or _math.isinf(n):
        return 0
    n = int(n) & 0xFFFFFFFF
    return n - 0x100000000 if n >= 0x80000000 else n


def _to_uint32(v) -> int:
    n = js_to_number(v)
    if _math.isnan(n) or _math.isinf(n):
        return 0
    return int(n) & 0xFFFFFFFF


def _object_assign(target=None, *sources):
    if not isinstance(target, JSObject):
        target = JSObject()
    for s in sources:
        if isinstance(s, JSObject):
            target.update(s)
    return target


def _regex_exec(rx: JSRegExp, s: str):
    start = rx.last_index if rx.global_ else 0
    m = rx.re.search(s, start)
    if m is None:
        rx.last_index = 0
        return None
    if rx.global_:
        rx.last_index = m.end() if m.end() > m.start() else m.end() + 1
    out = JSArray([m.group(0)] + [g if g is not None else UNDEFINED for g in m.groups()])
    return out


def _match_to_array(m) -> JSArray:
    return JSArray([m.group(0)] + [g if g is not None else UNDEFINED for g in m.groups()])


# ---------------------------------------------------------------------------
# built-in methods per type
# ---------------------------------------------------------------------------
def _string_method(interp, s: str, key: str):
    def replace(pattern=UNDEFINED, repl=UNDEFINED, _all=False):
        rs = _replacement(interp, repl)
        if isinstance(pattern, JSRegExp):
            count = 0 if (pattern.global_ or _all) else 1
            return pattern.re.sub(rs, s, count=count)
        pat = js_to_string(pattern)
        if callable(repl) or isinstance(repl, JSFunction):
            idx = s.find(pat)
            if idx < 0:
                return s
            rep = js_to_string(interp.call_function(repl if isinstance(repl, JSFunction) else repl, [pat, float(idx), s], UNDEFINED))
            return s[:idx] + rep + s[idx + len(pat):] if not _all else s.replace(pat, rep)
        rtxt = js_to_string(repl).replace("$&", pat)
        return s.replace(pat, rtxt, -1 if _all else 1)

    table = {
        "toLowerCase": lambda: s.lower(),
        "toUpperCase": lambda: s.upper(),
        "trim": lambda: s.strip(),
        "trimStart": lambda: s.lstrip(),
        "trimEnd": lambda: s.rstrip(),
        "includes": lambda sub="", start=0.0: js_to_string(sub) in s[int(js_to_number(start)):],
        "startsWith": lambda sub="", start=0.0: s.startswith(js_to_string(sub), int(js_to_number(start))),
        "endsWith": lambda sub="": s.endswith(js_to_string(sub)),
        "indexOf": lambda sub="", start=0.0: float(s.find(js_to_string(sub), int(js_to_number(start)))),
        "lastIndexOf": lambda sub="": float(s.rfind(js_to_string(sub))),
        "charAt": lambda i=0.0: s[int(js_to_number(i))] if 0 <= int(js_to_number(i)) < len(s) else "",
        "charCodeAt": lambda i=0.0: float(ord(s[int(js_to_number(i))])) if 0 <= int(js_to_number(i)) < len(s) else float("nan"),
        "slice": lambda a=0.0, b=None: _slice_str(s, a, b),
        "substring": lambda a=0.0, b=None: _substring(s, a, b),
        "padStart": lambda n=0.0, fill=" ": s.rjust(int(js_to_number(n)), js_to_string(fill)[:1] or " "),
        "padEnd": lambda n=0.0, fill=" ": s.ljust(int(js_to_number(n)), js_to_string(fill)[:1] or " "),
        "repeat": lambda n=0.0: s * int(js_to_number(n)),
        "split": lambda sep=UNDEFINED, limit=None: _split(s, sep, limit),
        "concat": lambda *a: s + "".join(js_to_string(x) for x in a),
        "replace": lambda pattern=UNDEFINED, repl=UNDEFINED: replace(pattern, repl, False),
        "replaceAll": lambda pattern=UNDEFINED, repl=UNDEFINED: replace(pattern, repl, True),
        "match": lambda rx=UNDEFINED: _match(s, rx),
        "search": lambda rx=UNDEFINED: _search(s, rx),
        "toString": lambda: s,
        "localeCompare": lambda other="": float((s > js_to_string(other)) - (s < js_to_string(other))),
        "codePointAt": lambda i=0.0: float(ord(s[int(js_to_number(i))])) if 0 <= int(js_to_number(i)) < len(s) else UNDEFINED,
        "normalize": lambda *_a: s,
        "at": lambda i=0.0: (s[int(js_to_number(i))] if -len(s) <= int(js_to_number(i)) < len(s) else UNDEFINED),
    }
    fn = table.get(key)
    if fn is None:
        return UNDEFINED
    return fn


def _replacement(interp, repl):
    if isinstance(repl, JSFunction) or callable(repl):
        def sub_fn(m):
            args = [m.group(0)] + [g if g is not None else UNDEFINED for g in m.groups()]
            args += [float(m.start()), m.string]
            return js_to_string(interp.call_function(repl, args, UNDEFINED))

        return sub_fn
    txt = js_to_string(repl)

    def repl_text(m):
        out = []
        i = 0
        while i < len(txt):
            if txt[i] == "$" and i + 1 < len(txt):
                c = txt[i + 1]
                if c == "&":
                    out.append(m.group(0))
                    i += 2
                    continue
                if c.isdigit():
                    j = i + 1
                    while j < len(txt) and txt[j].isdigit():
                        j += 1
                    idx = int(txt[i + 1 : j])
                    try:
                        out.append(m.group(idx) or "")
                    except Exception:
                        out.append(txt[i:j])
                    i = j
                    continue
                if c == "$":
                    out.append("$")
                    i += 2
                    continue
            out.append(txt[i])
            i += 1
        return "".join(out)

    return repl_text


def _match(s, rx):
    if not isinstance(rx, JSRegExp):
        rx = JSRegExp(_re.escape(js_to_string(rx)), "")
    if rx.global_:
        found = rx.re.findall(s)
        if not found:
            return None
        out = JSArray()
        for m in rx.re.finditer(s):
            out.append(m.group(0))
        return out
    m = rx.re.search(s)
    if m is None:
        return None
    arr = _match_to_array(m)
    return arr


def _search(s, rx):
    if not isinstance(rx, JSRegExp):
        rx = JSRegExp(_re.escape(js_to_string(rx)), "")
    m = rx.re.search(s)
    return float(m.start()) if m else -1.0


def _slice_str(s, a, b):
    start = int(js_to_number(a))
    end = len(s) if b is None or b is UNDEFINED else int(js_to_number(b))
    return s[slice(start if start >= 0 else max(0, len(s) + start), end if end >= 0 else max(0, len(s) + end))]


def _substring(s, a, b):
    start = max(0, int(js_to_number(a)))
    end = len(s) if b is None or b is UNDEFINED else max(0, int(js_to_number(b)))
    if start > end:
        start, end = end, start
    return s[start:end]


def _split(s, sep, limit):
    if sep is UNDEFINED:
        return JSArray([s])
    lim = None if limit is None or limit is UNDEFINED else int(js_to_number(limit))
    if isinstance(sep, JSRegExp):
        parts = sep.re.split(s)
    else:
        sp = js_to_string(sep)
        parts = list(s) if sp == "" else s.split(sp)
    if lim is not None:
        parts = parts[:lim]
    return JSArray(p if p is not None else "" for p in parts)


def _array_method(interp, arr: JSArray, key: str):
    def call1(fn, item, i):
        return interp.call_function(fn, [item, float(i), arr], UNDEFINED)

    table = {
        "push": lambda *a: (arr.extend(a), float(len(arr)))[1],
        "pop": lambda: arr.pop() if arr else UNDEFINED,
        "shift": lambda: arr.pop(0) if arr else UNDEFINED,
        "unshift": lambda *a: (arr.__setitem__(slice(0, 0), list(a)), float(len(arr)))[1],
        "slice": lambda a=0.0, b=None: JSArray(
            arr[_slice_idx(arr, a) : (len(arr) if b is None or b is UNDEFINED else _slice_idx(arr, b))]
        ),
        "splice": lambda start=0.0, dc=None, *items: _splice(arr, start, dc, items),
        "indexOf": lambda v=UNDEFINED, s=0.0: float(next((i for i in range(int(js_to_number(s)), len(arr)) if js_strict_eq(arr[i], v)), -1)),
        "lastIndexOf": lambda v=UNDEFINED: float(next((i for i in range(len(arr) - 1, -1, -1) if js_strict_eq(arr[i], v)), -1)),
        "includes": lambda v=UNDEFINED: any(js_strict_eq(x, v) for x in arr),
        "join": lambda sep=",": js_to_string(sep).join("" if x is None or x is UNDEFINED else js_to_string(x) for x in arr),
        "map": lambda fn=None: JSArray(call1(fn, x, i) for i, x in enumerate(list(arr))),
        "filter": lambda fn=None: JSArray(x for i, x in enumerate(list(arr)) if js_truthy(call1(fn, x, i))),
        "forEach": lambda fn=None: ([call1(fn, x, i) for i, x in enumerate(list(arr))], UNDEFINED)[1],
        "find": lambda fn=None: next((x for i, x in enumerate(list(arr)) if js_truthy(call1(fn, x, i))), UNDEFINED),
        "findIndex": lambda fn=None: float(next((i for i, x in enumerate(list(arr)) if js_truthy(call1(fn, x, i))), -1)),
        "some": lambda fn=None: any(js_truthy(call1(fn, x, i)) for i, x in enumerate(list(arr))),
        "every": lambda fn=None: all(js_truthy(call1(fn, x, i)) for i, x in enumerate(list(arr))),
        "reduce": lambda fn=None, *init: _reduce(interp, arr, fn, init),
        "concat": lambda *a: JSArray(list(arr) + [y for x in a for y in (list(x) if isinstance(x, JSArray) else [x])]),
        "reverse": lambda: (arr.reverse(), arr)[1],
        "sort": lambda fn=None: _sort(interp, arr, fn),
        "flat": lambda depth=1.0: _flat(arr, int(js_to_number(depth))),
        "fill": lambda v=UNDEFINED: (arr.__setitem__(slice(None), [v] * len(arr)), arr)[1],
        "keys": lambda: JSArray(float(i) for i in range(len(arr))),
        "at": lambda i=0.0: (arr[int(js_to_number(i))] if -len(arr) <= int(js_to_number(i)) < len(arr) else UNDEFINED),
        "toString": lambda: js_to_string(arr),
    }
    fn = table.get(key)
    return fn if fn is not None else UNDEFINED


def _slice_idx(arr, v):
    i = int(js_to_number(v))
    return i if i >= 0 else max(0, len(arr) + i)


def _splice(arr, start, dc, items):
    s = _slice_idx(arr, start)
    n = len(arr) - s if dc is None or dc is UNDEFINED else max(0, int(js_to_number(dc)))
    removed = JSArray(arr[s : s + n])
    arr[s : s + n] = list(items)
    return removed


def _reduce(interp, arr, fn, init):
    items = list(arr)
    if init:
        acc = init[0]
        start = 0
    else:
        if not items:
            raise JSError("TypeError: reduce of empty array with no initial value")
        acc = items[0]
        start = 1
    for i in range(start, len(items)):
        acc = interp.call_function(fn, [acc, items[i], float(i), arr], UNDEFINED)
    return acc


def _sort(interp, arr, fn):
    import functools

    if fn is None or fn is UNDEFINED:
        arr.sort(key=js_to_string)
    else:
        def cmp(a, b):
            r = js_to_number(interp.call_function(fn, [a, b], UNDEFINED))
            return -1 if r < 0 else (1 if r > 0 else 0)

        arr.sort(key=functools.cmp_to_key(cmp))
    return arr


def _flat(arr, depth):
    out = JSArray()
    for x in arr:
        if isinstance(x, JSArray) and depth > 0:
            out.extend(_flat(x, depth - 1))
        else:
            out.append(x)
    return out


def _number_method(interp, x: float, key: str):
    table = {
        "toFixed": lambda n=0.0: f"{x:.{int(js_to_number(n))}f}",
        "toString": lambda base=10.0: _num_to_string(x, int(js_to_number(base))),
        "toPrecision": lambda n=None: _fmt_number(x) if n is None else f"{x:.{int(js_to_number(n))}g}",
        "valueOf": lambda: x,
    }
    fn = table.get(key)
    return fn if fn is not None else UNDEFINED


def _num_to_string(x: float, base: int) -> str:
    if base == 10:
        return _fmt_number(x)
    n = int(x)
    if n == 0:
        return "0"
    digits = "0123456789abcdefghijklmnopqrstuvwxyz"
    neg = n < 0
    n = abs(n)
    out = []
    while n:
        out.append(digits[n % base])
        n //= base
    return ("-" if neg else "") + "".join(reversed(out))


def _object_method(interp, obj: JSObject, key: str):
    table = {
        "hasOwnProperty": lambda k="": js_to_string(k) in obj,
        "toString": lambda: js_to_string(obj),
    }
    fn = table.get(key)
    return fn if fn is not None else UNDEFINED
