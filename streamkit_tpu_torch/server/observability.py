# SPDX-License-Identifier: Apache-2.0
"""Metrics + profiling endpoints.

Parity targets:
* metrics — the reference exports OTLP metrics every 5 s (``apps/skit/src/
  telemetry.rs:22-110``; engine gauges ``engine/src/lib.rs:215-258``,
  distributor counters, session/WS/HTTP metrics). Here the same counters are
  exposed Prometheus-style at ``GET /api/v1/metrics`` (pull model — no
  collector dependency).
* profiling — the reference serves pprof CPU flamegraphs + jemalloc heap
  dumps (``apps/skit/src/profiling.rs:22-60``). Here:
  ``GET /api/v1/profile/cpu?duration_secs=N`` samples every thread's stack
  (or runs cProfile over the event loop); ``GET /api/v1/profile/device?
  duration_secs=N`` records ``torch.profiler`` (CPU, and CUDA on a card:
  every kernel the device ran, those launched through ctypes included) and
  returns its Chrome trace; ``GET /api/v1/profile/heap`` reports host
  allocation growth and the server device's CUDA memory statistics.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import cProfile
import io
import os
import pstats
import tempfile
import time

from . import http as web

__all__ = ["add_observability_routes"]

_START_TIME = time.time()


def collect_metrics(state):
    """Shared metric collection → ``[(name, kind, value, labels)]``
    (``kind`` is ``gauge`` or ``counter``). Feeds both the Prometheus pull
    endpoint and the OTLP push exporter (:mod:`.otlp`)."""
    out = [
        ("skit_uptime_seconds", "gauge", time.time() - _START_TIME, {}),
        ("skit_sessions_active", "gauge", len(state.sessions.list()), {}),
        ("skit_ws_clients", "gauge", len(state._ws_clients), {}),
        ("skit_resource_cache_entries", "gauge", state.resources.stats()["entries"], {}),
        ("skit_resource_cache_hits", "counter", state.resources.hits, {}),
        ("skit_resource_cache_misses", "counter", state.resources.misses, {}),
    ]
    # system metrics (reference pumps sysinfo gauges, telemetry.rs:86-110)
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        out.append(("skit_process_rss_bytes", "gauge", rss_pages * 4096, {}))
    except OSError:
        pass
    # continuous-batcher efficiency (the serving-critical signal: mean
    # batch width per kind tells you whether sessions actually coalesce)
    b = getattr(state, "batcher", None)
    if b is not None:
        bs = b.stats()
        out.append(("skit_batcher_submissions", "counter", bs["submissions"], {}))
        out.append(("skit_batcher_device_calls", "counter", bs["device_calls"], {}))
        out.append(("skit_batcher_batched_items", "counter", bs["batched_items"], {}))
        for kind, ks in bs["kinds"].items():
            labels = {"kind": kind}
            out.append(("skit_batcher_kind_calls", "counter", ks["calls"], labels))
            out.append(("skit_batcher_kind_items", "counter", ks["items"], labels))
            out.append(("skit_batcher_kind_dispatch_seconds", "counter", ks["dispatch_s"], labels))
            # items' wait from submit to their call's start, summed
            out.append(("skit_batcher_kind_queue_seconds", "counter", ks["queue_s"], labels))
    # per-session node stats + distributor counters
    for session in state.sessions.list():
        engine = session.handle._engine
        sid = session.id[:8]
        for name, stats in engine.stats_snapshots.items():
            labels = {"session": sid, "node": name}
            out.append(("skit_node_packets_received", "counter", stats.received, labels))
            out.append(("skit_node_packets_sent", "counter", stats.sent, labels))
            out.append(("skit_node_packets_discarded", "counter", stats.discarded, labels))
            out.append(("skit_node_packets_errored", "counter", stats.errored, labels))
        for node_name, entry in engine.nodes.items():
            for pin, dist in entry.distributors.items():
                labels = {"session": sid, "node": node_name, "pin": pin}
                out.append(("skit_distributor_packets", "counter", dist.packets, labels))
                out.append(("skit_distributor_drops", "counter", dist.drops, labels))
    return out


def _render_metrics(state) -> str:
    lines = []
    seen_types = set()
    for name, kind, value, labels in collect_metrics(state):
        if name not in seen_types:
            seen_types.add(name)
            lines.append(f"# TYPE {name} {kind}")
        if labels:
            lab = ",".join(f'{k}="{v}"' for k, v in labels.items())
            lines.append(f"{name}{{{lab}}} {value}")
        else:
            lines.append(f"{name} {value}")
    return "\n".join(lines) + "\n"


async def metrics_handler(request: web.Request) -> web.Response:
    state = request.app["state"]
    return web.Response(text=_render_metrics(state), content_type="text/plain")


async def profile_cpu(request: web.Request) -> web.Response:
    """CPU profile. ``format`` selects the profiler and rendering:

    * ``collapsed`` (default) — sampling profiler over ALL threads
      (executors included), collapsed-stack flamegraph lines
      (reference parity: profiling.rs serves flamegraphs);
    * ``pprof`` — same samples as gzipped pprof protobuf
      (``go tool pprof``-readable);
    * ``pstats`` — legacy cProfile over the event-loop thread only
      (deterministic tracing; keeps the round-1 behavior reachable).
    """
    duration = min(60.0, float(request.query.get("duration_secs", 5)))
    fmt = request.query.get("format", "collapsed")
    if fmt == "pstats":
        profiler = cProfile.Profile()
        profiler.enable()
        await asyncio.sleep(duration)
        profiler.disable()
        buf = io.StringIO()
        stats = pstats.Stats(profiler, stream=buf)
        stats.sort_stats("cumulative").print_stats(50)
        return web.Response(text=buf.getvalue(), content_type="text/plain")
    if fmt not in ("collapsed", "pprof"):
        raise web.HTTPBadRequest(text="format must be collapsed|pprof|pstats")
    from .profiling import sample_stacks, to_collapsed, to_pprof

    hz = min(1000.0, float(request.query.get("hz", 100)))
    loop = asyncio.get_running_loop()
    counts, n, period = await loop.run_in_executor(
        None, sample_stacks, duration, hz
    )
    if fmt == "pprof":
        return web.Response(
            body=to_pprof(counts, n, period),
            content_type="application/octet-stream",
            headers={"Content-Disposition": "attachment; filename=profile.pb.gz"},
        )
    return web.Response(text=to_collapsed(counts), content_type="text/plain")


# torch.profiler is started and stopped on this one thread (never on the event
# loop: stopping it processes every recorded event), one trace at a time
_PROFILER_THREAD = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="skit-profiler")


async def profile_device(request: web.Request) -> web.Response:
    """Record ``torch.profiler`` for ``duration_secs`` on the server's
    device and return its Chrome trace (viewable in Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    state = request.app["state"]
    duration = min(60.0, float(request.query.get("duration_secs", 5)))
    activities = [ProfilerActivity.CPU]
    if state.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    loop = asyncio.get_running_loop()
    async with request.app.setdefault("profile_lock", asyncio.Lock()):
        prof = profile(activities=activities)
        await loop.run_in_executor(_PROFILER_THREAD, prof.start)
        try:
            await asyncio.sleep(duration)
        finally:
            await loop.run_in_executor(_PROFILER_THREAD, prof.stop)
        fd, path = tempfile.mkstemp(prefix="skit-device-trace-", suffix=".json")
        os.close(fd)
        try:
            await loop.run_in_executor(_PROFILER_THREAD, prof.export_chrome_trace, path)
            with open(path, "rb") as f:
                body = f.read()
        finally:
            os.remove(path)
    return web.Response(body=body, content_type="application/json")


async def profile_heap(request: web.Request) -> web.Response:
    """Heap profile via tracemalloc (the jemalloc/DHAT analog in the
    reference, apps/skit/src/profiling.rs): samples allocations for
    ``duration_secs`` and reports top allocation sites + totals. Device
    memory is reported separately, from ``torch.cuda.memory_stats()``."""
    import tracemalloc

    duration = min(60.0, float(request.query.get("duration_secs", 5)))
    top_n = min(100, int(request.query.get("top", 30)))
    was_tracing = tracemalloc.is_tracing()
    if not was_tracing:
        tracemalloc.start(10)
    before = tracemalloc.take_snapshot()
    await asyncio.sleep(duration)
    after = tracemalloc.take_snapshot()
    current, peak = tracemalloc.get_traced_memory()
    if not was_tracing:
        tracemalloc.stop()
    growth = after.compare_to(before, "lineno")[:top_n]
    top = [
        {
            "site": str(stat.traceback),
            "size_kb": round(stat.size / 1024, 1),
            "size_diff_kb": round(stat.size_diff / 1024, 1),
            "count": stat.count,
        }
        for stat in growth
    ]
    # device memory: the caching allocator's statistics on the server's device
    state = request.app["state"]
    device = {"device": str(state.device)}
    if state.device.type == "cuda":
        import torch

        device.update(
            memory_allocated=torch.cuda.memory_allocated(state.device),
            memory_reserved=torch.cuda.memory_reserved(state.device),
            memory_stats=torch.cuda.memory_stats(state.device),
        )
    return web.json_response(
        {
            "duration_secs": duration,
            "host_current_kb": round(current / 1024, 1),
            "host_peak_kb": round(peak / 1024, 1),
            "top_growth": top,
            "device": device,
        }
    )


def add_observability_routes(app: web.Application, prefix: str) -> None:
    app.router.add_get(f"{prefix}/api/v1/metrics", metrics_handler)
    app.router.add_get(f"{prefix}/api/v1/profile/cpu", profile_cpu)
    app.router.add_get(f"{prefix}/api/v1/profile/device", profile_device)
    app.router.add_get(f"{prefix}/api/v1/profile/heap", profile_heap)
