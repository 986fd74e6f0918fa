# SPDX-License-Identifier: Apache-2.0
"""The program's own spans and queue counter in a run of a cell.

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1> [--tracer 0|1]

Runs the cell exactly as ``run.py`` does (same arguments, same result line),
with the program's span tracer (``streamkit_tpu_torch.utils.tracing``)
switched on at the window's start (``--tracer 0`` leaves it off: the same
run without spans, for the tracer's own cost). After the run's result line
it prints one more JSON line, ``{"spans": ..., "idle": ...}``:

* ``spans``, over the host window ``[t_w, t_host)`` that ``fused_call_ms.live``
  and ``stream_rows.live`` read (it ends before the profiler is set up):
  ``queue_wait_ms.live`` (the batcher's ``kind_wait_s`` over its items of the
  ``stream_step`` kinds: how long a block waits for its fused call; a counter,
  read with the tracer off too), ``service_ms.live`` (the self time of
  ``stt.drain``, ``stt.plan`` and ``stt.finish`` per fused call: the engine's
  own host work a cycle), ``encode_host_ms.live`` and ``decode_host_ms.live``
  (mean ``stream.encode`` / ``stream.decode`` a call), with their parts and
  the fused call's cycle (:func:`cycle`);
* ``idle`` (a traced run on the card): the traced stretch's idle gaps named
  by the innermost program span under way at each gap's middle, in any
  thread (inside a benchmark call range ``<family>: <span> > <host op>``),
  the idle seconds by that name, and the share of the idle time that no
  program span covers (``stt.session``, open over a session's life, counts
  as no cover).

A run whose tracer dropped spans says so on standard error, and its span
readings are ``None``. ``BENCHMARK.json``'s command stays ``run.py``: these
readings are what per-layer metrics of those names would read once
``run.py`` turns the tracer on in its traced runs.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

SERVICE = ("stt.drain", "stt.plan", "stt.finish")
NO_COVER = ("stt.session",)
BUFFER = 1 << 22  # 30 s of medium is about 80 calls of about 200 spans


def _family_counters(batcher, family: str = "stream_step") -> Tuple[int, int, float]:
    """(calls, items, queue-wait seconds) of a kind family, read together."""
    calls = items = 0
    wait = 0.0
    for name, (c, i, _s) in list(batcher.kind_stats.items()):
        if name.split(":")[0] == family:
            calls, items = calls + c, items + i
            wait += getattr(batcher, "kind_wait_s", {}).get(name, 0.0)
    return calls, items, wait


def _clip(iv: Tuple[float, float], lo: float, hi: float) -> Optional[Tuple[float, float]]:
    a, b = max(iv[0], lo), min(iv[1], hi)
    return (a, b) if b > a else None


def self_times(spans: Iterable, names: Iterable[str], others: Iterable[str] = ()) -> Dict[str, float]:
    """Seconds per name of ``names``: each span's duration less the time
    inside it that another span of ``names`` or ``others`` starting inside
    it covers. The engine's spans all run on the event loop, so a span
    inside another is work the loop did while the outer one awaited."""
    from bisect import bisect_left

    from stats import union_length

    names, others = tuple(names), tuple(others)
    pool = sorted((s for s in spans if s.name in names or s.name in others), key=lambda s: s.start_ns)
    starts = [s.start_ns for s in pool]
    out: Dict[str, float] = defaultdict(float)
    for i, s in enumerate(pool):
        if s.name not in names:
            continue
        a, b = s.start_ns / 1e9, s.end_ns / 1e9
        inner = [iv for o in pool[i + 1 : bisect_left(starts, s.end_ns)]
                 for iv in [_clip((o.start_ns / 1e9, o.end_ns / 1e9), a, b)] if iv is not None]
        out[s.name] += (b - a) - union_length(inner)
    return dict(out)


def readings(spans: List, t_w_ns: int, t_host_ns: int, c0: tuple, c1: tuple, dropped: int) -> dict:
    """The span readings over ``[t_w_ns, t_host_ns)`` (spans wholly inside
    it) and the queue counter between its two reads ``c0``, ``c1``."""
    calls, items, wait = (c1[0] - c0[0], c1[1] - c0[1], c1[2] - c0[2])
    out = {"calls": calls, "items": items, "spans": len(spans), "dropped": dropped,
           "queue_wait_ms.live": 1000.0 * wait / items if items else None}
    win = [s for s in spans if t_w_ns <= s.start_ns and s.end_ns <= t_host_ns]
    if dropped or not calls:
        return dict(out, **{k: None for k in ("service_ms.live", "encode_host_ms.live", "decode_host_ms.live")})

    def mean_ms(name: str) -> Optional[float]:
        d = [(s.end_ns - s.start_ns) / 1e6 for s in win if s.name == name]
        return sum(d) / len(d) if d else None

    selfs = self_times(win, SERVICE, ("stt.final_exact",))
    parts = {name: 1000.0 * selfs.get(name, 0.0) / calls for name in SERVICE}
    exact = [(s.end_ns - s.start_ns) / 1e6 for s in win if s.name == "stt.final_exact"]
    out.update({
        "service_ms.live": sum(parts.values()) if win else None,
        "encode_host_ms.live": mean_ms("stream.encode"),
        "decode_host_ms.live": mean_ms("stream.decode"),
        "service_parts_ms": parts,
        "final_exact": {"count": len(exact), "ms": sum(exact)},
        "drains": {"count": sum(1 for s in win if s.name == "stt.drain"),
                   "blocks": sum(s.attributes.get("blocks", 0) for s in win if s.name == "stt.drain")},
        "phase_ms": {n: mean_ms(n) for n in ("stream.prep", "stream.vad", "stream.encode", "stream.decode",
                                             "stream.fetch", "batcher.call", "batcher.wait")},
        "cycle_ms": cycle(win),
    })
    return out


def cycle(spans: List, family: str = "stream_step") -> dict:
    """A fused call's cycle, means in ms over the calls of ``family``: the
    call span, its head (stacking to ``stream.prep``), its tail (the end of
    ``stream.fetch`` to the scattered results: the hand-back to the event
    loop) and the time from one call's end to the next one's start."""
    calls = sorted((s for s in spans if s.name == "batcher.call"
                    and str(s.attributes.get("kind", "")).split(":")[0] == family), key=lambda s: s.start_ns)
    kids: Dict[str, Dict[str, object]] = defaultdict(dict)
    for s in spans:
        if s.name.startswith("stream.") and getattr(s, "parent_span_id", None):
            kids[s.parent_span_id][s.name] = s
    heads, tails = [], []
    for c in calls:
        k = kids.get(getattr(c, "span_id", None), {})
        if "stream.prep" in k and "stream.fetch" in k:
            heads.append((k["stream.prep"].start_ns - c.start_ns) / 1e6)
            tails.append((c.end_ns - k["stream.fetch"].end_ns) / 1e6)
    between = [(b.start_ns - a.end_ns) / 1e6 for a, b in zip(calls, calls[1:])]
    walls = [(c.end_ns - c.start_ns) / 1e6 for c in calls]

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    def cpu(sel, key):
        sel = [c for c in sel if key in c.attributes]
        wall = sum((c.end_ns - c.start_ns) / 1e6 for c in sel)
        return sum(c.attributes[key] for c in sel) / wall if wall else None

    # the calls over twice the median wall, and how much of their wall the
    # dispatch thread and the process spent on a core
    slow = [c for c, w in zip(calls, walls) if walls and w > 2 * sorted(walls)[len(walls) // 2]]
    return {"calls": len(calls), "call": mean(walls), "head": mean(heads), "tail": mean(tails),
            "between": mean(between), "cpu_share": cpu(calls, "cpu_ms"), "proc_cpu_share": cpu(calls, "proc_cpu_ms"),
            "slow": {"calls": len(slow), "ms": sum((c.end_ns - c.start_ns) / 1e6 for c in slow),
                     "cpu_share": cpu(slow, "cpu_ms"), "proc_cpu_share": cpu(slow, "proc_cpu_ms")}}


def innermost_each(items: Iterable[tuple], points: List[float]) -> list:
    """For ascending ``points``: the payload of the shortest item ``(t0, t1,
    payload)`` that covers each point, or None (one sweep, a heap of the
    items under way keyed by length)."""
    import heapq

    items = sorted(items, key=lambda x: x[0])
    heap, out, j = [], [], 0
    for p in points:
        while j < len(items) and items[j][0] <= p:
            t0, t1, payload = items[j]
            heapq.heappush(heap, (t1 - t0, j, t1, payload))
            j += 1
        while heap and heap[0][2] < p:  # ended before this point: before every later one too
            heapq.heappop(heap)
        out.append(heap[0][3] if heap else None)
    return out


def idle(trace, spans: List, top: int = 10) -> dict:
    """The traced stretch's idle gaps, each named at its middle: inside a
    benchmark call range ``<family>: <span> > <host op>`` (the innermost
    program span under way in any thread, then the innermost host op in the
    call's thread, as ``DeviceTrace`` names it), between calls the innermost
    program span alone, else ``no device call under way``. With the idle
    seconds by name and the share of idle time no program span covers."""
    from stats import gaps, overlap

    w0, w1 = trace.window
    holes = sorted(gaps(((o.t0, o.t1) for o in trace.ops), w0, w1))
    mids = [(a + b) / 2 for a, b in holes]
    cover = [(sp.start_ns / 1e9, sp.end_ns / 1e9, sp.name) for sp in spans if sp.name not in NO_COVER]
    names = innermost_each(cover, mids)
    calls = innermost_each(((c.t0, c.t1, c) for c in trace.spans), mids)
    ops: List[Optional[str]] = [None] * len(holes)
    for thread in {c.thread for c in calls if c is not None}:
        idx = [k for k, c in enumerate(calls) if c is not None and c.thread == thread]
        found = innermost_each(((o.t0, o.t1, o.name) for o in trace.host.get(thread, ())), [mids[k] for k in idx])
        for k, name in zip(idx, found):
            ops[k] = name
    by_name: Dict[str, float] = defaultdict(float)
    named = []
    for (a, b), span, call, op in zip(holes, names, calls, ops):
        if call is not None:
            n = f"{call.family}: {span + ' > ' if span else ''}{op or 'python'}"
        else:
            n = span or "no device call under way"
        by_name[n] += b - a
        named.append((n, b - a))
    # idle time under no program span: the holes less the union of the spans
    merged = []
    for a, b, _ in sorted(cover):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    idle_s = sum(b - a for a, b in holes)
    covered, k = 0.0, 0
    for a, b in holes:
        while k < len(merged) and merged[k][1] < a:
            k += 1
        j = k
        while j < len(merged) and merged[j][0] < b:  # disjoint: their overlaps add up
            covered += overlap(merged[j][0], merged[j][1], a, b)
            j += 1
    named.sort(key=lambda x: -x[1])
    return {"idle_s": idle_s, "uncovered_share": (idle_s - covered) / idle_s if idle_s else None,
            "gaps": [list(g) for g in named[:top]],
            "by_name": [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "calls": pair_calls(trace, spans)}


def pair_calls(trace, spans: List, family: str = "stream_step") -> dict:
    """The program's ``batcher.call`` spans of a family that lie wholly in
    the trace against the benchmark's ``pb.<family>#<n>`` ranges, paired by
    number (the batcher's ``seq`` and the recorder's ``n``): how many of
    each, how many pair, and the median start offset of a pair (range less
    span, ms), which reads the two clocks against each other."""
    import statistics

    w0, w1 = trace.window
    mine = {sp.attributes.get("seq"): sp for sp in spans if sp.name == "batcher.call"
            and str(sp.attributes.get("kind", "")).split(":")[0] == family
            and w0 <= sp.start_ns / 1e9 and sp.end_ns / 1e9 <= w1}
    ranges = {c.seq: c for c in trace.spans if c.family == family}
    both = sorted(set(mine) & set(ranges))
    offsets = [1000.0 * (ranges[k].t0 - mine[k].start_ns / 1e9) for k in both]
    return {"spans": len(mine), "ranges": len(ranges), "paired": len(both),
            "start_offset_ms": statistics.median(offsets) if offsets else None,
            "unpaired_spans": sorted(k for k in mine if k not in ranges)[:10],
            "unpaired_ranges": sorted(k for k in ranges if k not in mine)[:10]}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    tracer_on = True
    if "--tracer" in argv:
        i = argv.index("--tracer")
        tracer_on = argv[i + 1] == "1"
        del argv[i : i + 2]
    sys.path[:0] = [HERE, REPO]
    import devtrace
    import recorder
    import run

    from streamkit_tpu_torch.utils.tracing import get_tracer, now_ns

    tracer = get_tracer()
    st: dict = {}

    def on_init(orig):
        def init(self, *a, **kw):
            orig(self, *a, **kw)
            st["batcher"] = self
        return init

    def on_snapshot(orig):
        def snapshot(self):
            st["c1"], st["t_host_ns"] = _family_counters(self), now_ns()
            return orig(self)
        return snapshot

    def on_window_start(orig):
        def window_start(self):
            t = orig(self)
            st["c0"], st["t_w_ns"] = _family_counters(st["batcher"]), now_ns()
            tracer.drain()
            tracer.max_buffered, tracer.dropped = BUFFER, 0
            if tracer_on:
                tracer.enable()
            return t
        return window_start

    def on_breakdown(orig):
        def breakdown(self, *a, **kw):
            st["trace"] = self
            return orig(self, *a, **kw)
        return breakdown

    recorder.RecordingBatcher.__init__ = on_init(recorder.RecordingBatcher.__init__)
    recorder.RecordingBatcher.snapshot = on_snapshot(recorder.RecordingBatcher.snapshot)
    run.Ctx.window_start = on_window_start(run.Ctx.window_start)
    devtrace.DeviceTrace.breakdown = on_breakdown(devtrace.DeviceTrace.breakdown)
    rc = run.main(argv)
    tracer.disable()
    spans = tracer.drain()
    if rc != 0 or "c1" not in st:
        return rc
    if tracer.dropped:
        run.log(f"# the tracer dropped {tracer.dropped} spans: span readings are None")
    out = {"tracer": tracer_on, "host_window_s": (st["t_host_ns"] - st["t_w_ns"]) / 1e9,
           "spans": readings(spans, st["t_w_ns"], st["t_host_ns"], st["c0"], st["c1"], tracer.dropped)}
    if "trace" in st and tracer_on:
        out["idle"] = idle(st["trace"], spans)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
