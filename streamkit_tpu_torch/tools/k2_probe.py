# SPDX-License-Identifier: Apache-2.0
"""Where the windowed cache write (K2) spends its time, on one NVIDIA card.

    python3 streamkit_tpu_torch/tools/k2_probe.py [--against DIR]

1. Write granularity. Plain probe kernels (``csrc/write_probe.cu``) write
   into each of the 327,680 rows of an int8 encoder cache [32, 8, 1280, 512]
   (512-byte rows) and of a bf16 decoder cache [32, 8, 1280, 64] (128-byte
   rows): 16 bytes in one store and in two 8-byte stores, a full 32-byte
   sector, a 16- and a 32-byte read-modify-write, 64 and 128 bytes.
2. K2 against ``scatter_`` (the same function when every row writes its
   whole window) at the int8 class with starts at multiples of 16 and at
   24 mod 32 (each window across two sectors), and at the bf16 fold class
   (c = 3, any start). With ``--against DIR``, the K2 of the checkout in DIR
   is timed too, in turns with this one's (DIR, this, this, DIR), each in a
   process of its own.

Times are device times by ``torch.profiler``, with the L2 warm (the same
rows rewritten) and cold (a 128 MB write before every launch; only the
probed kernels count). Prints the card's name and power limit, then one JSON
line per case. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROWS = 32 * 8 * 1280  # G * S * F of the streaming table's caches at 8 slots


def device_kernels(fn, iters: int):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


class Timer:
    """Warm and cold device time of one call, in microseconds."""

    def __init__(self):
        import torch

        self.flush = torch.empty(128 << 18, device="cuda")  # 128 MB, more than the 50 MB L2
        self.flush_names = {e.name for e in device_kernels(self._fill, 1)}

    def _fill(self):
        self.flush.fill_(1.0)

    def warm(self, fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        return sum(e.time_range.elapsed_us() for e in device_kernels(fn, iters)) / iters

    def cold(self, fn, iters: int = 10) -> float:
        for _ in range(2):
            self._fill()
            fn()
        ks = [e for e in device_kernels(lambda: (self._fill(), fn()), iters) if e.name not in self.flush_names]
        return sum(e.time_range.elapsed_us() for e in ks) / iters


def granularity(timer: Timer) -> None:
    import torch

    from streamkit_tpu_torch.ops import _build

    def declare(lib):
        lib.sk_write_probe.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.sk_write_probe.restype = ctypes.c_int

    lib = _build.load(_build.Source("write_probe.cu", "nvcc"), declare)
    stream = torch.cuda.current_stream().cuda_stream
    # (label, mode, lanes_log2, offset): mode 0 store, 1 read-modify-write, 2 two 8-byte stores
    cases = [("16 B, one store (half a sector)", 0, 0, 16), ("16 B, two 8-byte stores", 2, 0, 16),
             ("32 B, one full sector", 0, 1, 0), ("32 B read-modify-write", 1, 1, 0),
             ("16 B read-modify-write", 1, 0, 16), ("64 B, two sectors", 0, 2, 0), ("128 B, a full line", 0, 3, 0)]
    for pitch, rows_of in [(512, "int8 encoder cache rows [32, 8, 1280, 512]"),
                           (128, "bf16 decoder cache rows [32, 8, 1280, 64]")]:
        buf = torch.zeros(ROWS * pitch, dtype=torch.uint8, device="cuda")
        for label, mode, lg, off in cases:
            if off + (16 << lg) > pitch:
                continue

            def run():
                err = lib.sk_write_probe(buf.data_ptr(), ROWS, pitch, off, lg, mode, stream)
                if err:
                    raise RuntimeError(f"write probe launch failed ({err})")

            print(json.dumps({"probe": "write granularity", "rows": rows_of, "write": label,
                              "bytes_per_row": 16 << lg, "warm_us": timer.warm(run), "cold_us": timer.cold(run)}),
                  flush=True)
        del buf


def k2(timer: Timer, tree: str) -> None:
    import torch

    from streamkit_tpu_torch.ops import cache_write as cw

    S = 8
    g = torch.Generator(device="cuda").manual_seed(1)
    for label, G, F, T, c, dtype, pos in [
        ("int8 class, starts 0 mod 16", 32, 1280, 512, 16, torch.int8, [64, 272, 0, 336, 192, 128, 192, 416]),
        ("int8 class, starts 24 mod 32", 32, 1280, 512, 16, torch.int8, [24, 56, 88, 120, 152, 184, 216, 248]),
        ("bf16 fold class, any start", 32, 1280, 64, 3, torch.bfloat16, [39, 10, 58, 47, 26, 63, 48, 35]),
    ]:
        if dtype == torch.int8:
            cache = torch.randint(-127, 128, (G, S, F, T), device="cuda", generator=g, dtype=dtype)
            upd = torch.randint(-127, 128, (G, S, F, c), device="cuda", generator=g, dtype=dtype)
        else:
            cache = torch.randn(G, S, F, T, device="cuda", generator=g).to(dtype)
            upd = torch.randn(G, S, F, c, device="cuda", generator=g).to(dtype)
        p = torch.tensor(pos, dtype=torch.int32, device="cuda")
        lim = torch.full((S,), c, dtype=torch.int32, device="cuda")
        idx = ((p.long()[:, None] + torch.arange(c, device="cuda")) % T)[None, :, None, :].expand(G, S, F, c)
        want = cache.clone().scatter_(-1, idx, upd)
        cw.windowed_write_groups(cache, upd, p, lim)
        torch.cuda.synchronize()
        if not torch.equal(cache.view(torch.uint8), want.view(torch.uint8)):
            raise AssertionError(f"{tree}: windowed_write differs from scatter_ at {label}")
        kern = lambda: cw.windowed_write_groups(cache, upd, p, lim)  # noqa: E731
        scat = lambda: cache.scatter_(-1, idx, upd)  # noqa: E731
        print(json.dumps({"probe": "k2", "tree": tree, "case": label, "pos": pos,
                          "kernel_warm_us": timer.warm(kern), "kernel_cold_us": timer.cold(kern),
                          "scatter_warm_us": timer.warm(scat), "scatter_cold_us": timer.cold(scat)}), flush=True)
        del cache, upd, idx, want


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout whose K2 is timed in turns with this one's")
    ap.add_argument("--tree", help=argparse.SUPPRESS)  # K2 only, of the checkout in this directory
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree or ROOT))
    import torch

    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device", file=sys.stderr)
        return 2
    timer = Timer()
    if args.tree:
        k2(timer, args.tree)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    granularity(timer)
    if not args.against:
        k2(timer, ROOT)
        return 0
    del timer
    for tree in (args.against, ROOT, ROOT, args.against):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
