# SPDX-License-Identifier: Apache-2.0
"""Load-test harness.

Port of the JAX package's ``cli/loadtest.py`` on the port's own client
(:class:`.client.SkitClient` over :mod:`..server.http`). Parity target:
``apps/skit-cli/src/load_test/`` (config.rs:11-100, workers.rs:21-611,
metrics.rs:34-127): TOML scenarios (oneshot / dynamic / mixed), concurrent
workers, success rate + mean/min/max + reservoir-sampled percentiles,
realtime progress output. The summary also carries p95 and
the first few distinct errors (the reference drops them). The
``[populate]`` plugins are uploaded before the run as the CLI's ``plugins
load`` uploads them (a multipart ``file`` part), and a refused upload ends
the run: the JAX package posts the raw bytes, which the upload route
refuses, and goes on without them (ROADMAP §3).
"""

from __future__ import annotations

import asyncio
import random
import time
import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .client import SkitClient

__all__ = ["LoadTestConfig", "Metrics", "run_load_test"]


def _read(path: str, mode: str = "r"):
    with open(path, mode) as f:
        return f.read()


@dataclass
class LoadTestConfig:
    server: str = "http://127.0.0.1:8080"
    duration_secs: float = 10.0
    scenario: str = "oneshot"  # oneshot | dynamic | mixed
    # oneshot
    oneshot_enabled: bool = True
    oneshot_concurrency: int = 4
    oneshot_pipeline: str = ""
    oneshot_input_file: str = ""
    # dynamic
    dynamic_enabled: bool = True
    session_count: int = 4
    tune_interval_ms: float = 200.0
    dynamic_pipelines: List[str] = field(default_factory=list)
    # long-lived broadcaster sessions (reference [dynamic.broadcaster])
    broadcaster_pipeline: str = ""
    broadcaster_count: int = 0
    # populate (reference config.rs [populate]): preload plugins before run
    populate_plugins_native: List[str] = field(default_factory=list)
    populate_plugins_wasm: List[str] = field(default_factory=list)
    # output
    output_format: str = "text"  # text | json
    real_time_updates: bool = True
    update_interval_ms: float = 1000.0

    @staticmethod
    def from_toml(path: str) -> "LoadTestConfig":
        with open(path, "rb") as f:
            doc = tomllib.load(f)
        cfg = LoadTestConfig()
        cfg.server = doc.get("server", {}).get("url", cfg.server)
        test = doc.get("test", {})
        cfg.duration_secs = float(test.get("duration_secs", cfg.duration_secs))
        cfg.scenario = test.get("scenario", cfg.scenario)
        oneshot = doc.get("oneshot", {})
        cfg.oneshot_enabled = bool(oneshot.get("enabled", cfg.oneshot_enabled))
        cfg.oneshot_concurrency = int(oneshot.get("concurrency", cfg.oneshot_concurrency))
        cfg.oneshot_pipeline = oneshot.get("pipeline", cfg.oneshot_pipeline)
        cfg.oneshot_input_file = oneshot.get("input_file", cfg.oneshot_input_file)
        dyn = doc.get("dynamic", {})
        cfg.dynamic_enabled = bool(dyn.get("enabled", cfg.dynamic_enabled))
        cfg.session_count = int(dyn.get("session_count", cfg.session_count))
        cfg.tune_interval_ms = float(dyn.get("tune_interval_ms", cfg.tune_interval_ms))
        pipelines = dyn.get("pipelines")
        if pipelines:
            cfg.dynamic_pipelines = list(pipelines)
        elif dyn.get("pipeline"):
            cfg.dynamic_pipelines = [dyn["pipeline"]]
        bc = dyn.get("broadcaster", {})
        cfg.broadcaster_pipeline = bc.get("pipeline", "")
        cfg.broadcaster_count = int(bc.get("count", 1 if cfg.broadcaster_pipeline else 0))
        pop = doc.get("populate", {})
        if pop.get("load_plugins"):
            cfg.populate_plugins_native = list(pop.get("plugins_native", []))
            cfg.populate_plugins_wasm = list(pop.get("plugins_wasm", []))
        out = doc.get("output", {})
        cfg.output_format = out.get("format", cfg.output_format)
        cfg.real_time_updates = bool(out.get("real_time_updates", cfg.real_time_updates))
        cfg.update_interval_ms = float(out.get("update_interval_ms", cfg.update_interval_ms))
        return cfg


class Metrics:
    """Success counts + latency reservoir (reference metrics.rs:34-127)."""

    RESERVOIR = 10_000
    MAX_ERRORS = 5

    def __init__(self, name: str) -> None:
        self.name = name
        self.ok = 0
        self.failed = 0
        self.total_secs = 0.0
        self.min_secs = float("inf")
        self.max_secs = 0.0
        self._reservoir: List[float] = []
        self._seen = 0
        self._rng = random.Random(0)
        self.errors: List[str] = []

    def record(self, secs: float, ok: bool, error: Optional[BaseException] = None) -> None:
        if ok:
            self.ok += 1
        else:
            self.failed += 1
            msg = f"{type(error).__name__}: {error}"[:300] if error is not None else "failed"
            if len(self.errors) < self.MAX_ERRORS and msg not in self.errors:
                self.errors.append(msg)
        self.total_secs += secs
        self.min_secs = min(self.min_secs, secs)
        self.max_secs = max(self.max_secs, secs)
        self._seen += 1
        if len(self._reservoir) < self.RESERVOIR:
            self._reservoir.append(secs)
        else:  # reservoir sampling keeps percentiles unbiased under load
            j = self._rng.randint(0, self._seen - 1)
            if j < self.RESERVOIR:
                self._reservoir[j] = secs

    def percentile(self, p: float) -> float:
        if not self._reservoir:
            return 0.0
        xs = sorted(self._reservoir)
        return xs[min(len(xs) - 1, int(p / 100.0 * len(xs)))]

    def summary(self) -> dict:
        n = self.ok + self.failed
        return {
            "name": self.name,
            "requests": n,
            "success_rate": (self.ok / n) if n else 0.0,
            "mean_ms": (self.total_secs / n * 1000) if n else 0.0,
            "min_ms": self.min_secs * 1000 if n else 0.0,
            "max_ms": self.max_secs * 1000,
            "p50_ms": self.percentile(50) * 1000,
            "p90_ms": self.percentile(90) * 1000,
            "p95_ms": self.percentile(95) * 1000,
            "p99_ms": self.percentile(99) * 1000,
            "errors": list(self.errors),
        }


async def _oneshot_worker(cfg: LoadTestConfig, metrics: Metrics, stop: asyncio.Event) -> None:
    media = _read(cfg.oneshot_input_file, "rb") if cfg.oneshot_input_file else b""
    pipeline = _read(cfg.oneshot_pipeline)
    async with SkitClient(cfg.server) as client:
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                await client.process_oneshot(pipeline, media)
                metrics.record(time.perf_counter() - t0, True)
            except Exception as e:
                metrics.record(time.perf_counter() - t0, False, e)


def _find_tunable(yaml_text: Optional[str]) -> Optional[tuple]:
    """Locate a live-tunable node in the pipeline (first audio::gain)."""
    if not yaml_text:
        return None
    try:
        import yaml as _yaml

        doc = _yaml.safe_load(yaml_text) or {}
        for node_id, spec in (doc.get("nodes") or {}).items():
            if isinstance(spec, dict) and spec.get("kind") == "audio::gain":
                return (node_id, "gain")
    except Exception:
        pass
    return None


async def _session_worker(
    cfg: LoadTestConfig, metrics: Metrics, tunes: Metrics, stop: asyncio.Event, idx: int
) -> None:
    pipelines = cfg.dynamic_pipelines or [""]
    texts = [_read(p) if p else None for p in pipelines]
    rng = random.Random(idx)
    async with SkitClient(cfg.server) as client:
        ws_ok = True
        try:
            await client.connect_ws()
        except Exception:
            ws_ok = False
        n = 0
        while not stop.is_set():
            yaml_text = texts[(idx + n) % len(texts)]
            n += 1
            tunable = _find_tunable(yaml_text)
            t0 = time.perf_counter()
            sid = None
            try:
                info = await client.create_session_http(name=None, yaml_text=yaml_text)
                sid = info["session_id"]
                metrics.record(time.perf_counter() - t0, True)
            except Exception as e:
                metrics.record(time.perf_counter() - t0, False, e)
            # live-tune loop for the session's lifetime slice (reference
            # workers.rs dynamic workers tune params at tune_interval_ms)
            t_end = time.monotonic() + cfg.tune_interval_ms / 1000.0 * 5
            while not stop.is_set() and time.monotonic() < t_end:
                await asyncio.sleep(cfg.tune_interval_ms / 1000.0)
                if sid and tunable and ws_ok:
                    node_id, param = tunable
                    tt = time.perf_counter()
                    try:
                        await client.tune(sid, node_id, {param: round(rng.uniform(0.25, 2.0), 3)})
                        tunes.record(time.perf_counter() - tt, True)
                    except Exception as e:
                        tunes.record(time.perf_counter() - tt, False, e)
            if sid:
                try:
                    await client.destroy_session_http(sid)
                except Exception:
                    pass


async def _broadcaster_worker(cfg: LoadTestConfig, metrics: Metrics, stop: asyncio.Event) -> None:
    """Long-lived publisher session (reference [dynamic.broadcaster])."""
    yaml_text = _read(cfg.broadcaster_pipeline)
    async with SkitClient(cfg.server) as client:
        t0 = time.perf_counter()
        sid = None
        try:
            info = await client.create_session_http(name="broadcaster", yaml_text=yaml_text)
            sid = info["session_id"]
            metrics.record(time.perf_counter() - t0, True)
        except Exception as e:
            metrics.record(time.perf_counter() - t0, False, e)
        await stop.wait()
        if sid:
            try:
                await client.destroy_session_http(sid)
            except Exception:
                pass


async def _populate(cfg: LoadTestConfig) -> None:
    """Upload the ``[populate]`` plugins before the run (reference
    workers.rs populate phase); raises on the first upload the server
    refuses."""
    paths = cfg.populate_plugins_native + cfg.populate_plugins_wasm
    if not paths:
        return
    async with SkitClient(cfg.server) as client:
        for path in paths:
            try:
                doc = await client.upload_plugin(path)
            except (OSError, RuntimeError) as e:
                raise RuntimeError(f"populate: {path} was not loaded: {e}") from e
            print(f"populate: loaded {doc['kind']} from {path}", flush=True)


async def run_load_test(cfg: LoadTestConfig, realtime: Optional[bool] = None) -> Dict[str, dict]:
    """Run ``cfg`` for ``cfg.duration_secs``, then wait up to 30 s for the
    requests still in flight (``asyncio.TimeoutError`` past that, as in the
    reference); a summary per worker kind (``oneshot``, ``dynamic``,
    ``tune``, ``broadcaster``)."""
    if realtime is None:
        realtime = cfg.real_time_updates
    await _populate(cfg)
    stop = asyncio.Event()
    metrics: Dict[str, Metrics] = {}
    workers: List[asyncio.Task] = []
    if cfg.scenario in ("oneshot", "mixed") and cfg.oneshot_enabled and cfg.oneshot_pipeline:
        m = metrics["oneshot"] = Metrics("oneshot")
        workers += [
            asyncio.ensure_future(_oneshot_worker(cfg, m, stop))
            for _ in range(cfg.oneshot_concurrency)
        ]
    if cfg.scenario in ("dynamic", "mixed") and cfg.dynamic_enabled:
        if cfg.broadcaster_pipeline and cfg.broadcaster_count > 0:
            mb = metrics["broadcaster"] = Metrics("broadcaster")
            workers += [
                asyncio.ensure_future(_broadcaster_worker(cfg, mb, stop))
                for _ in range(cfg.broadcaster_count)
            ]
        m = metrics["dynamic"] = Metrics("dynamic")
        mt = metrics["tune"] = Metrics("tune")
        workers += [
            asyncio.ensure_future(_session_worker(cfg, m, mt, stop, i))
            for i in range(cfg.session_count)
        ]

    t0 = time.monotonic()
    tick = max(0.1, cfg.update_interval_ms / 1000.0)
    while time.monotonic() - t0 < cfg.duration_secs:
        await asyncio.sleep(min(tick, cfg.duration_secs - (time.monotonic() - t0)) or 0.1)
        if realtime:
            parts = [
                f"{m.name}: {m.ok} ok / {m.failed} failed, p50 {m.percentile(50)*1000:.0f}ms"
                for m in metrics.values()
            ]
            print(f"[{time.monotonic()-t0:5.1f}s] " + "; ".join(parts), flush=True)
    stop.set()
    await asyncio.wait_for(asyncio.gather(*workers, return_exceptions=True), timeout=30)
    return {k: m.summary() for k, m in metrics.items()}
