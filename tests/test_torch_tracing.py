# SPDX-License-Identifier: Apache-2.0
"""The port's span tracer (``utils/tracing.py``) and the spans of the live
path on the CPU: ids without a system call, explicit parents across
threads, spans recorded after the fact, a disabled tracer that allocates
nothing, one clock with ``torch.profiler``'s events, and a small
``SttServingEngine`` run whose spans nest as the engine, the batcher and the
fused step call each other."""

import asyncio
import os
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from streamkit_tpu_torch.engine import audio_ring
from streamkit_tpu_torch.engine.stt_serving import SttServingEngine
from streamkit_tpu_torch.utils import tracing
from streamkit_tpu_torch.utils.speechsynth import synth_speech_with_plan

torch.set_num_threads(2)  # pytest runs files in parallel workers

SR = 16_000
ENGINE_SPANS = {"stt.session", "stt.drain", "stt.plan", "stt.finish", "stt.final_exact"}
CALL_SPANS = {"batcher.wait", "batcher.call"}
STEP_SPANS = {"stream.prep", "stream.vad", "stream.encode", "stream.decode", "stream.fetch"}


@pytest.fixture
def tracer():
    t = tracing.Tracer(max_buffered=1 << 16)
    t.enable()
    return t


@pytest.fixture(autouse=True)
def _process_tracer_off():
    tr = tracing.get_tracer()
    tr.drain()
    yield
    tr.disable()
    tr.drain()


def test_ids_are_w3c_sized_unique_and_need_no_syscall(tracer, monkeypatch):
    def refuse(n):
        raise AssertionError("a span drew from os.urandom")

    monkeypatch.setattr(os, "urandom", refuse)
    for _ in range(200):
        with tracer.span("a"):
            with tracer.span("b"):
                pass
    spans = tracer.drain()
    trace_ids = {s.trace_id for s in spans}
    span_ids = [s.span_id for s in spans]
    assert len(trace_ids) == 200 and len(set(span_ids)) == 400
    assert all(len(t) == 32 and int(t, 16) != 0 for t in trace_ids)
    assert all(len(s) == 16 and int(s, 16) != 0 for s in span_ids)
    doc = tracing.encode_spans(spans[:2])
    assert {r["spanId"] for r in doc["resourceSpans"][0]["scopeSpans"][0]["spans"]} == set(span_ids[:2])


def test_explicit_parent_and_scope_cross_threads(tracer):
    """Context variables do not cross a thread: ``parent=`` and
    :meth:`Span.scope` carry the parent over."""
    out = {}
    with tracer.span("root") as root:
        call = tracer.span("call")

        def worker():
            out["orphan"] = tracer.span("orphan")
            out["orphan"].end()
            with tracer.span("child", parent=root):
                pass
            with call.scope():
                with tracer.span("step"):
                    pass
            out["after"] = tracer.current()

        th = threading.Thread(target=worker)
        th.start()
        th.join()
        call.end()
    spans = {s.name: s for s in tracer.drain()}
    assert spans["orphan"].parent_span_id is None
    assert spans["child"].parent_span_id == root.span_id and spans["child"].trace_id == root.trace_id
    assert spans["call"].parent_span_id == root.span_id
    assert spans["step"].parent_span_id == spans["call"].span_id
    assert out["after"] is None  # the scope leaves the thread as it found it
    assert spans["call"].end_ns >= spans["step"].end_ns


def test_record_writes_a_span_with_known_times(tracer):
    with tracer.span("call") as call:
        tracer.record("wait", 100, 250, {"rows": 3})
    tracer.record("detached", 5, 6, parent=call)
    spans = {s.name: s for s in tracer.drain()}
    w = spans["wait"]
    assert (w.start_ns, w.end_ns, w.attributes) == (100, 250, {"rows": 3})
    assert w.parent_span_id == call.span_id and spans["detached"].parent_span_id == call.span_id


def test_end_is_idempotent_and_failures_are_kept(tracer):
    sp = tracer.span("x")
    sp.fail(ValueError("boom"))
    sp.end()
    sp.end()
    (got,) = tracer.drain()
    assert not got.status_ok and got.status_message == "ValueError: boom"


def test_buffer_bound_counts_drops():
    t = tracing.Tracer(max_buffered=3)
    t.enable()
    for _ in range(5):
        with t.span("x"):
            pass
    t.record("y", 1, 2)
    assert len(t.drain()) == 3 and t.dropped == 3


def _heap(fn):
    """(peak growth, retained growth) of the traced heap while ``fn`` runs."""
    fn()  # warm
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        fn()
        now, peak = tracemalloc.get_traced_memory()
        return peak - base, now - base
    finally:
        tracemalloc.stop()


class _Bare:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


def test_disabled_tracer_is_the_shared_noop_and_allocates_nothing(monkeypatch):
    """Off, a span is the shared no-op, reads no clock and costs the heap
    what a ``with`` over a bare object costs (CPython's own bound
    ``__exit__``), and keeps nothing."""
    t = tracing.Tracer()
    assert t.span("x") is tracing.NOOP_SPAN and t.record("y", 1, 2) is None
    sp = t.span("warm")
    bare = _Bare()
    rows = 7
    turns = [None] * 2000

    def spans():
        for _ in turns:
            with sp.scope():
                with t.span("stream.vad", None, sp) as s:
                    s.set_attribute("rows", rows)
                    t.record("batcher.wait", 1, 2, None, s)
                s.end()

    def withs():
        for _ in turns:
            with bare:
                with bare:
                    pass

    def clock():
        raise AssertionError("a disabled span read the clock")

    monkeypatch.setattr(tracing, "now_ns", clock)
    peak, kept = _heap(spans)
    assert kept <= 0 and peak <= _heap(withs)[0]
    assert t.drain() == [] and t.dropped == 0
    monkeypatch.undo()
    t.enable()
    t.max_buffered = 1 << 20
    assert _heap(spans)[1] > 100_000  # the control: on, every span is kept


def test_spans_share_the_profilers_clock(tracer):
    """A span around a ``record_function`` range contains the range's
    Kineto start: both are nanoseconds since the Unix epoch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("outer") as sp:
            with record_function("skit.clock_probe"):
                (x @ x).sum()
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "skit.clock_probe")
    start = ev.start_ns()
    assert sp.start_ns <= start <= start + ev.duration_ns() <= sp.end_ns
    assert tracing.now_ns is not None and abs(tracing.now_ns() - start) < 60 * 10**9


# -- the live path's spans ------------------------------------------------------
@pytest.fixture
def small_ring():
    saved = dict(audio_ring._RINGS)
    audio_ring._RINGS["cpu"] = audio_ring.SessionAudioRing(max_slots=8, device="cpu")
    yield
    audio_ring._RINGS.clear()
    audio_ring._RINGS.update(saved)


async def _serve(n_sessions: int, seconds: float = 5.0):
    eng = SttServingEngine(model_size="tiny", dtype="float32", max_sessions=4, final_mode="exact",
                           window_buckets=[4.0], partial_interval_ms=250.0, device="cpu")
    await eng.start()
    events = {i: [] for i in range(n_sessions)}
    sids = [eng.open_session(lambda ev, i=i: events[i].append(ev)) for i in range(n_sessions)]
    audio = [synth_speech_with_plan(seconds, SR, seed=i)[0].astype(np.float32) for i in range(n_sessions)]
    for off in range(0, int(seconds * SR), 8000):
        for i, sid in enumerate(sids):
            eng.push(sid, audio[i][off : off + 8000])
        await asyncio.sleep(0.05)
    for sid in sids:
        eng.push(sid, np.zeros(SR, np.float32))
    deadline = asyncio.get_running_loop().time() + 120
    while asyncio.get_running_loop().time() < deadline:
        if all(any(e["type"] == "final" for e in evs) for evs in events.values()):
            break
        await asyncio.sleep(0.1)
    for sid in sids:
        eng.close_session(sid)
    await eng.stop()
    return eng, events


def test_engine_spans_nest_across_the_executor(small_ring):
    tr = tracing.get_tracer()
    tr.max_buffered, saved = 1 << 16, tr.max_buffered
    tr.enable()
    try:
        eng, events = asyncio.run(_serve(2))
    finally:
        tr.disable()
        tr.max_buffered = saved
    spans = tr.drain()
    assert tr.dropped == 0
    by_id = {s.span_id: s for s in spans}
    names = {s.name for s in spans}
    assert ENGINE_SPANS | CALL_SPANS | STEP_SPANS | {"decode.ring"} <= names, names
    assert all(s.end_ns >= s.start_ns > 0 for s in spans)

    calls = [s for s in spans if s.name == "batcher.call"]
    waits = {(s.attributes["kind"], s.attributes["seq"]): s for s in spans if s.name == "batcher.wait"}
    assert len({c.attributes["seq"] for c in calls}) == len(calls)
    for c in calls:
        w = waits[(c.attributes["kind"], c.attributes["seq"])]
        assert w.start_ns <= w.end_ns <= c.start_ns and w.attributes["rows"] == c.attributes["rows"]
        assert c.parent_span_id is None
    # the fused step's phases are children of their batcher.call, across the
    # executor hop, in order
    step_calls = [c for c in calls if c.attributes["kind"] == eng._sstep_kind]
    assert step_calls
    for name in STEP_SPANS:
        for s in (s for s in spans if s.name == name):
            parent = by_id[s.parent_span_id]
            assert parent.name == "batcher.call" and parent.attributes["kind"] == eng._sstep_kind
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    for c in step_calls:
        kids = sorted((s for s in spans if s.parent_span_id == c.span_id), key=lambda s: s.start_ns)
        assert [k.name for k in kids] == ["stream.prep", "stream.vad", "stream.encode", "stream.decode",
                                          "stream.fetch"]
        assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    # rows on the call spans are the batcher's own counts
    stats = eng.batcher.kind_stats[eng._sstep_kind]
    assert len(step_calls) == stats[0] and sum(c.attributes["rows"] for c in step_calls) == stats[1]
    assert all(c.attributes["padded"] >= c.attributes["rows"] for c in step_calls)
    # the dispatch thread's CPU over a call lies within its wall and the process's CPU
    for c in step_calls:
        assert 0 < c.attributes["cpu_ms"] <= c.attributes["proc_cpu_ms"] + 1e-3
        assert c.attributes["cpu_ms"] <= (c.end_ns - c.start_ns) / 1e6 + 1.0
    # a ring decode is traced inside its call, with its steps and host syncs
    for d in (s for s in spans if s.name == "decode.ring"):
        parent = by_id[d.parent_span_id]
        assert parent.name == "batcher.call" and parent.attributes["kind"].startswith("whisper_ring:")
        assert d.attributes["steps"] >= 4 and d.attributes["host_syncs"] >= 1
        assert d.attributes["window"] == 4 * SR
    # each session's block spans share its stt.session's trace
    sessions = {s.attributes["session"]: s for s in spans if s.name == "stt.session"}
    assert len(sessions) == 2
    for s in spans:
        if s.name in ("stt.plan", "stt.finish"):
            root = sessions[s.attributes["session"]]
            assert s.trace_id == root.trace_id and s.parent_span_id == root.span_id
            assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
        elif s.name == "stt.final_exact":
            parent = by_id[s.parent_span_id]
            assert parent.name in ("stt.finish", "stt.session") and s.trace_id == sessions[s.attributes["session"]].trace_id
    plans = [s for s in spans if s.name == "stt.plan"]
    assert sum(1 for s in plans if s.attributes["n_req"] > 0) > 0
    finishes = [s for s in spans if s.name == "stt.finish"]
    texts = sum(1 for evs in events.values() for e in evs)
    assert sum(s.attributes["events"] for s in finishes) <= texts
    assert sum(s.attributes["blocks"] for s in spans if s.name == "stt.drain") >= stats[1]
    # the queue counter stands beside the spans
    assert eng.batcher.kind_wait_s[eng._sstep_kind] > 0


def test_engine_with_the_tracer_off_writes_no_spans(small_ring):
    tr = tracing.get_tracer()
    assert not tr.enabled
    eng, events = asyncio.run(_serve(2, seconds=3.0))
    assert all(any(e["type"] == "final" for e in evs) for evs in events.values())
    assert tr.drain() == [] and eng.batcher.kind_wait_s[eng._sstep_kind] > 0
