# SPDX-License-Identifier: Apache-2.0
"""Sampling CPU profiler with flamegraph / pprof output.

Parity target: the reference serves pprof-format CPU profiles and
flamegraphs from its profiling endpoints (``apps/skit/src/
profiling.rs:22-60`` — pprof protobuf + SVG flamegraph via pprof-rs).
The repo's previous ``/api/v1/profile/cpu`` was cProfile over the event
loop only: deterministic tracing (high overhead) and blind to executor
threads, where the codecs, ingest, and batcher dispatch actually run.

This module is the TPU-serving-appropriate replacement: a wall-clock
sampling profiler over ``sys._current_frames()`` — EVERY thread, a few
percent overhead at the default 100 Hz — rendering to

* ``collapsed`` — Brendan Gregg collapsed-stack lines
  (``frame;frame;frame count``), the input format of every flamegraph
  tool (flamegraph.pl, speedscope, inferno);
* ``pprof`` — gzipped ``perftools.profiles.Profile`` protobuf, readable
  by ``go tool pprof`` / ``pprof -http`` — encoded by hand below (the
  message is small and stable; no protobuf dependency).

The proto layout (profile.proto, github.com/google/pprof):
``Profile{sample_type=1, sample=2, location=4, function=5,
string_table=6, time_nanos=9, duration_nanos=10, period_type=11,
period=12}``; ``Sample{location_id=1, value=2}``;
``Location{id=1, line=4}``; ``Line{function_id=1, line=2}``;
``Function{id=1, name=2, filename=4, start_line=5}``;
``ValueType{type=1, unit=2}``.
"""

from __future__ import annotations

import gzip
import sys
import threading
import time
from collections import Counter
from typing import Dict, Iterable, List, Tuple

__all__ = ["sample_stacks", "to_collapsed", "to_pprof"]

# a stack is a tuple of (function, filename, lineno) frames, root FIRST;
# the thread name is prepended as a synthetic root frame
Stack = Tuple[Tuple[str, str, int], ...]


def _snapshot(main_thread_only: bool = False) -> List[Stack]:
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    me = threading.get_ident()
    stacks: List[Stack] = []
    for ident, top in frames.items():
        if ident == me:  # the profiler thread itself
            continue
        stack: List[Tuple[str, str, int]] = []
        f = top
        while f is not None:
            code = f.f_code
            stack.append((code.co_name, code.co_filename, f.f_lineno))
            f = f.f_back
        stack.append((names.get(ident, f"thread-{ident}"), "", 0))
        stacks.append(tuple(reversed(stack)))
    return stacks


def sample_stacks(duration_secs: float, hz: float = 100.0) -> Tuple[Counter, int, int]:
    """Sample every live thread for ``duration_secs`` at ``hz``.

    Blocking — run it in an executor thread (the endpoint does). Returns
    ``(Counter[stack] -> samples, n_samples, period_nanos)``.
    """
    period = 1.0 / max(1.0, hz)
    counts: Counter = Counter()
    n = 0
    deadline = time.monotonic() + duration_secs
    next_t = time.monotonic()
    while time.monotonic() < deadline:
        for stack in _snapshot():
            counts[stack] += 1
        n += 1
        next_t += period
        delay = next_t - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        else:  # fell behind (GIL contention): resync, don't burst
            next_t = time.monotonic()
    return counts, n, int(period * 1e9)


def to_collapsed(counts: Counter) -> str:
    """Collapsed-stack text: one ``frame;frame;... count`` line per stack."""
    lines = []
    for stack, c in sorted(counts.items(), key=lambda kv: -kv[1]):
        name = ";".join(
            fn if not path else f"{fn} ({_short(path)}:{line})"
            for fn, path, line in stack
        )
        lines.append(f"{name} {c}")
    return "\n".join(lines) + "\n"


def _short(path: str) -> str:
    for marker in ("/site-packages/", "/streamkit_tpu_torch/", "/python3."):
        i = path.rfind(marker)
        if i >= 0:
            return path[i + 1 :] if marker == "/site-packages/" else path[i + 1 :]
    parts = path.rsplit("/", 2)
    return "/".join(parts[-2:]) if len(parts) > 1 else path


# -- minimal protobuf wire encoding ------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _uint(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _packed(field: int, values: Iterable[int]) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return _len_delim(field, payload)


def to_pprof(counts: Counter, n_samples: int, period_nanos: int) -> bytes:
    """Encode a sampled profile as a gzipped pprof ``Profile`` message."""
    strings: List[str] = [""]
    str_idx: Dict[str, int] = {"": 0}

    def s(text: str) -> int:
        i = str_idx.get(text)
        if i is None:
            i = len(strings)
            strings.append(text)
            str_idx[text] = i
        return i

    functions: Dict[Tuple[str, str], int] = {}
    locations: Dict[Tuple[str, str, int], int] = {}
    func_msgs: List[bytes] = []
    loc_msgs: List[bytes] = []

    def loc_id(frame: Tuple[str, str, int]) -> int:
        lid = locations.get(frame)
        if lid is not None:
            return lid
        fn, path, line = frame
        fkey = (fn, path)
        fid = functions.get(fkey)
        if fid is None:
            fid = len(functions) + 1
            functions[fkey] = fid
            func_msgs.append(
                _len_delim(
                    5,
                    _uint(1, fid) + _uint(2, s(fn)) + _uint(4, s(_short(path)))
                    + _uint(5, max(0, line)),
                )
            )
        lid = len(locations) + 1
        locations[frame] = lid
        line_msg = _uint(1, fid) + _uint(2, max(0, line))
        loc_msgs.append(_len_delim(4, _uint(1, lid) + _len_delim(4, line_msg)))
        return lid

    sample_msgs: List[bytes] = []
    for stack, c in counts.items():
        # pprof wants leaf FIRST
        ids = [loc_id(f) for f in reversed(stack)]
        sample_msgs.append(
            _len_delim(2, _packed(1, ids) + _packed(2, [c, c * period_nanos]))
        )

    samples_vt = _len_delim(1, _uint(1, s("samples")) + _uint(2, s("count")))
    time_vt = _len_delim(1, _uint(1, s("cpu")) + _uint(2, s("nanoseconds")))
    period_vt = _len_delim(11, _uint(1, s("cpu")) + _uint(2, s("nanoseconds")))

    body = (
        samples_vt
        + time_vt
        + b"".join(sample_msgs)
        + b"".join(loc_msgs)
        + b"".join(func_msgs)
        + b"".join(_len_delim(6, t.encode()) for t in strings)
        + _uint(9, int(time.time() * 1e9))
        + _uint(10, n_samples * period_nanos)
        + period_vt
        + _uint(12, period_nanos)
    )
    return gzip.compress(body)
