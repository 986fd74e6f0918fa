# SPDX-License-Identifier: Apache-2.0
"""Run one cell of the benchmark of the PyTorch/CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration through its model family
(``families/<model_type>.py``) with weights drawn on the card from the
seed, warms up the cell's shapes (set-up, ``setup_s``), drives the cell's
traffic through the program for ``--seconds``, then holds what it served
against the plain reference. On the card every run profiles the window's
last stretch, which the device-time metrics read. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, last, ``checks`` (each compared number
with its limit, also the last lines of standard error).

``--dry-run`` runs the same control flow on the CPU at the family's small
size and a few sessions; it prints counts and readings, never a
device metric. ``--control`` puts the float8 reference in the program's
place in ``checks`` and ``correct`` (it has to come out not correct).
"""

from __future__ import annotations

import time

T_PROC = time.monotonic()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CACHE = os.path.join(REPO, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "streamkit_tpu")


def _env() -> None:
    """Caches inside the checkout at fixed paths; no library loads JAX; the
    program's VAD reads the weights the reference reads."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["SK_VAD_WEIGHTS"] = os.path.join(HERE, "reference", "vad_weights.npz")


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Ctx:
    """What a traffic driver is given: the cell, the model, the device and
    the measured window's clock."""

    def __init__(self, args, workload: dict, mix: dict, cfg: dict, device, family):
        self.seed = args.seed & ((1 << 63) - 1)
        self.seconds = float(args.seconds)
        # on the card every run traces the window's last stretch: the
        # end-to-end device time is read from it as well
        self.trace_on = bool(args.trace) or device.type == "cuda"
        self.workload, self.mix, self.cfg, self.device = workload, mix, cfg, device
        # the model as its family gives it to the traffic driver (Whisper:
        # dims, port_cfg, port_size)
        for name, value in family.attributes(cfg).items():
            setattr(self, name, value)
        self.warm_timeout = 120.0
        self.trace = None
        self.peaks = None
        self.tree = self.params = None
        self.t_w = self.t_end = self.t_host = None
        self.snap_host = {}
        self.log = log
        self.marks = {}

    def mark(self, name: str) -> None:
        """Note a set-up step's end (seconds since the process started)."""
        self.marks[name] = round(time.monotonic() - T_PROC, 3)

    def window_start(self) -> float:
        self.t_w = time.monotonic()
        self.setup_s = self.t_w - T_PROC
        return self.t_w

    async def measure(self, batcher) -> None:
        """Wait out the window. The program's counters are read at
        ``t_host``: the window's end, or where the run traces (every run on
        the card) the moment the profiler starts being set up, since a
        set-up profiler slows every launch. The trace covers the window's last stretch and is read once
        the window has closed."""
        end = self.t_w + self.seconds
        loop = asyncio.get_running_loop()
        if self.trace_on:
            import devtrace
            import spec

            st = spec.settings()
            stretch = min(st["trace_seconds"], self.seconds / 2)
            await asyncio.sleep(max(0.0, end - stretch - st["trace_prepare_seconds"] - time.monotonic()))
            self.t_host, self.snap_host = time.monotonic(), batcher.snapshot()
            self.trace = devtrace.DeviceTrace(self.device)
            await loop.run_in_executor(None, self.trace.prepare)
            await asyncio.sleep(max(0.0, end - stretch - time.monotonic()))
            batcher.tracing = True
            self.trace.start()
            await asyncio.sleep(max(0.0, max(end, time.monotonic() + stretch) - time.monotonic()))
            self.t_end = time.monotonic()
            batcher.tracing = False
            self.trace.stop()
        else:
            await asyncio.sleep(max(0.0, end - time.monotonic()))
            self.t_end = self.t_host = time.monotonic()
            self.snap_host = batcher.snapshot()

    def window_end(self) -> float:
        return self.t_end

    def drop_program(self) -> None:
        """Free the program's copy of the model before the reference runs."""
        self.params = None
        gc.collect()
        if self.device.type == "cuda":
            import torch

            torch.cuda.empty_cache()


def dry_mix(mix: dict) -> dict:
    out = dict(mix)
    for key in ("sessions", "clients"):
        if key in out:
            out[key] = min(out[key], 3)
    for key in ("judge_segments", "judge_requests"):
        if key in out:
            out[key] = min(out[key], 2)
    return out


def pin_cpus() -> list:
    """Run this process (and every thread it starts) on the first half of
    the CPUs it may use: the program is host-bound, and runs that the
    scheduler spread over other cores read up to 15 % apart."""
    cpus = sorted(os.sched_getaffinity(0))
    keep = cpus[: max(2, len(cpus) // 2)]
    os.sched_setaffinity(0, keep)
    return keep


def main(argv=None) -> int:
    _env()
    cpus = pin_cpus()
    sys.path[:0] = [HERE, REPO]
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dry-run", action="store_true", help="rehearse on the CPU at a small size")
    ap.add_argument("--control", action="store_true",
                    help="judge the float8 control in the program's place (calibration only; the timed runs "
                         "never do); the program's own readings go under 'readings'")
    args = ap.parse_args(argv)

    import spec

    cells = spec.workloads()
    if args.workload not in cells:
        log(f"no cell {args.workload!r}; cells: {', '.join(cells)}")
        return 2
    workload = cells[args.workload]
    mix = spec.mixes()[workload["mix"]]
    cfg = spec.configs()[workload["config"]]
    family = spec.family(cfg)
    import torch

    if args.dry_run:
        device = torch.device("cpu")
        cfg, mix = family.dry_config(cfg), dry_mix(mix)
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
            log(f"this cell needs {workload['chips']} CUDA device(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
        device = torch.device("cuda", 0)
    torch.set_num_threads(2)
    # float32 products in float32 (TF32 would be a lower precision)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Ctx(args, workload, mix, cfg, device, family)
    if device.type == "cuda":
        from roofline import peaks

        from streamkit_tpu_torch.ops import _build

        # every kernel the cell can reach is built in set-up, never in the window
        _build.build_all(family.sources())
        ctx.peaks = peaks(torch.cuda.get_device_name(0))
    ctx.mark("kernels built")
    ctx.tree = family.draw(cfg, ctx.seed, device)
    ctx.params = family.build(ctx.tree)
    ctx.mark("weights drawn")
    driver = spec.traffic_driver(mix["kind"])
    rec = asyncio.run(driver.run(ctx))
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package are loaded: {bad}")
        return 4
    log(f"# set-up steps {json.dumps(ctx.marks)}; window {ctx.t_w - T_PROC:.2f} s; cpus {cpus}")
    rec["window_s"] = ctx.t_end - ctx.t_w
    rec["host_window_s"] = ctx.t_host - ctx.t_w
    rec["setup_s"] = ctx.setup_s
    rec["peaks"] = ctx.peaks
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "count": workload["chips"],
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if device.type == "cuda" else 0}
    breakdown = None
    if ctx.trace is not None:
        rec["trace"] = {"busy_s": ctx.trace.busy_s(), "window_s": ctx.trace.window_s,
                        **(driver.trace_readings(ctx, rec, ctx.trace) if device.type == "cuda" else {})}
        if args.trace:
            device_info.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
            breakdown = ctx.trace.breakdown()
        ctx.trace = None
    names = workload["per_layer"] if args.trace else workload["end_to_end"]
    readers = spec.layer_metrics() if args.trace else spec.end_to_end()
    metrics = {}
    for name in names:
        value = readers[name].read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": readers[name].META["unit"]}
    t_ref = time.monotonic()
    precisions = ("f32", "fp8") if args.control else ("f32",)
    readings = driver.judge(ctx, rec, precisions)
    log(f"# reference {time.monotonic() - t_ref:.1f} s; readings {json.dumps(readings)}")
    if forbidden_modules():
        log(f"modules of JAX or of the JAX package are loaded: {forbidden_modules()}")
        return 4
    limits = workload["limits"]
    if args.control:
        # the control in the program's place: the float8 reference's readings
        # under the names of the numbers it reads (the exact counts judge the
        # program's own events, which the control does not make)
        checks = {name: {"value": readings[name[: -len("_f32")] + "_fp8"], "limit": limit}
                  for name, limit in limits.items() if name.endswith("_f32")}
    else:
        checks = {name: {"value": readings[name], "limit": limit} for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    attempted, failed = driver.counts(rec)
    correct = correct and attempted > 0 and failed == 0
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['value'] <= c['limit'] else 'FAILED'}")
    if args.dry_run:
        out = {"dry_run": True, "correct": correct, "attempted": attempted, "failed": failed,
               "cpu_counts": driver.counts_detail(rec), "readings": readings, "checks": checks}
    else:
        out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
               "device": device_info}
        if breakdown is not None:
            out["breakdown"] = breakdown
        if args.control:
            out["readings"] = readings
        out["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
