# SPDX-License-Identifier: Apache-2.0
"""``spans.py`` on synthetic records and one CPU rehearsal: the queue-wait
counter's reading, the engine's self time, the fused step's phases, and
the idle gaps named by program span.

Run: ``python -m pytest portbench/tests -q``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO]

import spans  # noqa: E402
from devtrace import Op  # noqa: E402
from devtrace import Span as Call  # noqa: E402

S = 10**9


def _sp(name, a, b, **attrs):
    return SimpleNamespace(name=name, start_ns=int(a * S), end_ns=int(b * S), attributes=attrs)


def test_readings_on_a_synthetic_record():
    win = [
        _sp("stt.drain", 1.00, 1.10),  # routes two blocks: their plans run inside it
        _sp("stt.plan", 1.02, 1.03), _sp("stt.plan", 1.04, 1.05),
        _sp("stt.finish", 1.20, 1.50),  # awaits an exact final of 0.2 s
        _sp("stt.final_exact", 1.25, 1.45),
        _sp("stream.encode", 1.0, 1.3), _sp("stream.encode", 2.0, 2.1),
        _sp("stream.decode", 1.3, 1.5), _sp("stream.decode", 2.1, 2.5),
        _sp("stream.encode", 9.0, 9.5),  # after t_host: not read
    ]
    out = spans.readings(win, 1 * S, 5 * S, (10, 100, 1.0), (12, 164, 33.0), dropped=0)
    assert out["calls"] == 2 and out["items"] == 64
    assert abs(out["queue_wait_ms.live"] - 500.0) < 1e-9  # 32 s of waits over 64 items
    parts = out["service_parts_ms"]
    assert abs(parts["stt.drain"] - 40.0) < 1e-6  # 100 ms less two 10 ms plans, over 2 calls
    assert abs(parts["stt.plan"] - 10.0) < 1e-6
    assert abs(parts["stt.finish"] - 50.0) < 1e-6  # 300 ms less the 200 ms final
    assert abs(out["service_ms.live"] - 100.0) < 1e-6
    assert abs(out["encode_host_ms.live"] - 200.0) < 1e-6
    assert abs(out["decode_host_ms.live"] - 300.0) < 1e-6
    assert out["final_exact"]["count"] == 1


def test_cycle_splits_a_call_and_the_time_between_calls():
    def sp(name, a, b, sid=None, parent=None, **attrs):
        return SimpleNamespace(name=name, start_ns=int(a * S), end_ns=int(b * S), span_id=sid,
                               parent_span_id=parent, attributes=attrs)

    got = spans.cycle([
        sp("batcher.call", 1.0, 2.0, "c1", kind="stream_step:x"),
        sp("stream.prep", 1.1, 1.2, parent="c1"), sp("stream.fetch", 1.7, 1.8, parent="c1"),
        sp("batcher.call", 2.5, 3.1, "c2", kind="stream_step:x"),
        sp("stream.prep", 2.5, 2.6, parent="c2"), sp("stream.fetch", 3.0, 3.1, parent="c2"),
        sp("batcher.call", 2.0, 9.0, "r", kind="whisper_ring:x"),
    ])
    assert got["calls"] == 2
    assert abs(got["call"] - 800.0) < 1e-6 and abs(got["head"] - 50.0) < 1e-6
    assert abs(got["tail"] - 100.0) < 1e-6 and abs(got["between"] - 500.0) < 1e-6


def test_dropped_spans_read_none():
    out = spans.readings([_sp("stream.encode", 1, 2)], 0, 5 * S, (0, 0, 0.0), (1, 4, 2.0), dropped=3)
    assert out["encode_host_ms.live"] is None and out["service_ms.live"] is None
    assert out["queue_wait_ms.live"] == 500.0  # a counter: no span to drop


def test_innermost_each_takes_the_shortest_cover():
    items = [(0.0, 10.0, "long"), (2.0, 3.0, "short"), (2.5, 6.0, "mid")]
    assert spans.innermost_each(items, [1.0, 2.2, 2.7, 4.0, 11.0]) == ["long", "short", "short", "mid", None]


def test_idle_gaps_are_named_by_program_span():
    trace = SimpleNamespace(
        window=(100.0, 104.0),
        ops=[Op("k", 100.2, 100.4), Op("k", 100.6, 100.9), Op("k", 101.2, 101.4)],
        spans=[Call("stream_step", 7, 100.5, 101.5, 11)],
        host={11: [Op("aten::mm", 100.9, 101.1), Op("cudaMalloc", 100.95, 100.97)]})
    program = [_sp("stt.session", 99, 105), _sp("batcher.wait", 100.0, 100.5), _sp("batcher.call", 100.5, 101.5),
               _sp("stream.encode", 100.9, 101.0), _sp("stt.finish", 102.0, 102.5)]
    out = spans.idle(trace, program)
    names = dict(out["by_name"])
    assert abs(names["batcher.wait"] - 0.2) < 1e-9  # before the call range
    assert abs(names["stream_step: batcher.call > aten::mm"] - 0.3) < 1e-9
    assert abs(names["no device call under way"] - 2.6) < 1e-9  # stt.session is no cover
    assert abs(out["idle_s"] - 3.3) < 1e-9
    assert abs(names["stream_step: batcher.wait > python"] - 0.2) < 1e-9  # the call range opens mid-gap
    # covered: the wait's and the call's 0.8 s of the holes, stt.finish's 0.5
    assert abs(out["uncovered_share"] - (3.3 - 1.3) / 3.3) < 1e-9


def test_a_cell_rehearses_with_the_tracer_on():
    proc = subprocess.run([sys.executable, os.path.join(HERE, "spans.py"), "--workload", "live64.whisper-medium",
                           "--seed", "3000000017", "--seconds", "8", "--dry-run"],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    result, extra = json.loads(lines[-2]), json.loads(lines[-1])
    assert result["correct"], result["checks"]
    got = extra["spans"]
    assert got["dropped"] == 0 and got["calls"] > 0
    for name in ("queue_wait_ms.live", "service_ms.live", "encode_host_ms.live", "decode_host_ms.live"):
        assert got[name] is not None and got[name] > 0, (name, got)
    assert got["phase_ms"]["batcher.call"] >= got["encode_host_ms.live"] + got["decode_host_ms.live"]
