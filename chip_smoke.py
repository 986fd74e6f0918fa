# SPDX-License-Identifier: Apache-2.0
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Builds every hand-written kernel of the slice from ``streamkit_tpu_torch/
   csrc`` (nvcc, sm_90a) and holds each against its plain PyTorch version on
   the card, in bf16 and f32, at every shape the main path gives it (f32
   within 1e-4 of the plain version run in f32; bf16 within twice the plain
   version's own bf16 error), then times kernel, plain version and the
   library call that computes the same function (a yardstick only; the port
   never calls it).
2. Context check: a small f32 Whisper config whose encoder takes the flash
   kernel decodes the same tokens on ``cuda`` as the port on ``cpu``.
3. Main path at full width: Whisper large-v3 (bf16, random weights from a
   seed) behind a ``SessionAudioRing`` and a ``DeviceBatcher`` with the
   ``vad_ring`` / ``whisper_detect`` / ``whisper_ring`` kinds registered as
   the whisper node registers them. Four concurrent sessions stream 10–19 s
   of synthetic audio in 512-sample VAD frames, then detect their language
   and decode their segment from the ring; one session's audio also goes
   through ``transcribe_window``. Kernel launch counts are zeroed just
   before and read just after, and must equal 32 per encode.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result, without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import asyncio
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SR = 16_000
VAD_BLOCK_FRAMES = 4  # whisper node default (vad_block_frames)
STT_GATHER_MS = 1000.0  # the whisper node's SK_STT_GATHER_MS knob: straggler bound
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3 bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def head_split(x: torch.Tensor, h: int) -> torch.Tensor:
    """``[B, T, H*d]`` → the ``[B, H, T, d]`` view the encoder hands the kernel."""
    b, t, hd = x.shape
    return x.reshape(b, t, h, hd // h).transpose(1, 2)


# ---------------------------------------------------------------------------
# 1. kernels against their plain versions
# ---------------------------------------------------------------------------
def kernel_phase():
    import torch.nn.functional as F

    from streamkit_tpu_torch.ops import attention as attn

    t0 = time.monotonic()
    lib = attn.build_kernel()
    log(f"# built {os.path.relpath(lib)} in {attn.build_kernel.seconds:.1f} s "
        f"(wall {time.monotonic() - t0:.1f} s)")
    g = torch.Generator(device="cuda").manual_seed(0)
    entry = None
    # the ring decode's 30 s windows (B=1, 4), the 8 s language-detection
    # window (T=400) and an odd case whose KV tail is a third of a tile
    for shape in [(1, 20, 1500, 64), (4, 20, 1500, 64), (4, 20, 400, 64), (2, 3, 300, 64)]:
        b, h, t, d = shape
        scale = d ** -0.25
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (
                head_split(torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype), h)
                for _ in range(3)
            )
            out = attn.flash_attention(q, k, v, scale)
            torch.cuda.synchronize()
            q32, k32, v32 = q.float(), k.float(), v.float()
            ref = attn.attention_reference(q32, k32, v32, scale)
            err = (out.float() - ref).abs().max().item()
            # Limits against the plain version run in f32: 1e-4 at f32; at
            # bf16 twice the plain version's own bf16 error on these inputs.
            if dtype == torch.float32:
                tol = 1e-4
            else:
                tol = 2 * (attn.attention_reference(q, k, v, scale).float() - ref).abs().max().item()
            line = {"shape": list(shape), "dtype": str(dtype).split(".")[-1], "max_abs_err": err, "tol": tol}
            # what a kernel that forgot the KV-tail mask would return: the
            # zero keys of the last tile join every row's normaliser
            pad = -t % 64
            if pad:
                zeros = q32.new_zeros(b, h, pad, d)
                unmasked = attn.attention_reference(q32, torch.cat([k32, zeros], 2), torch.cat([v32, zeros], 2),
                                                    scale)
                line["tail_unmasked_err"] = (unmasked - ref).abs().max().item()
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"flash_attention {shape} {dtype}: max |err| {err} > {tol}")
            if shape == (2, 3, 300, 64) and line["tail_unmasked_err"] <= tol:
                raise AssertionError(f"the odd case cannot catch a missing tail mask: {line}")
            if dtype == torch.bfloat16 and h == 20:  # the main path's shapes
                flops = 4 * b * h * t * t * d
                nbytes = 4 * b * h * t * d * q.element_size()
                t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES * 1e3
                ms = time_ms(lambda: attn.flash_attention(q, k, v, scale))
                plain_ms = time_ms(lambda: attn.attention_reference(q, k, v, scale), iters=5)
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5))
                line.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
                            bound_by="operations" if t_ops >= t_bytes else "bytes",
                            tflops=flops / ms / 1e9)
                if b == 4 and t == 1500:  # the batched ring decode
                    entry = {"name": "flash_attention", "route": "cuda",
                             "source": "streamkit_tpu_torch/csrc/flash_attention.cu",
                             "replaces": "streamkit_tpu/ops/attention.py:115",
                             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": max(t_ops, t_bytes), "bound_by": line["bound_by"],
                             "library_ms": lib_ms}
            elif dtype == torch.float32 and t == 1500:
                line["ms"] = time_ms(lambda: attn.flash_attention(q, k, v, scale), iters=5)
            log("# k1 " + json.dumps(line))
            del q, k, v, q32, k32, v32, out, ref
    torch.cuda.empty_cache()
    return [entry]


# ---------------------------------------------------------------------------
# 2. cuda tokens == cpu tokens on a small f32 config through the kernel
# ---------------------------------------------------------------------------
def tonal_audio(rng, n: int) -> np.ndarray:
    """Amplitude-modulated tone over noise (one random pitch)."""
    t = np.arange(n) / SR
    f, am = rng.uniform(100, 3000), rng.uniform(1, 8)
    x = 0.3 * np.sin(2 * np.pi * f * t) * (0.5 + 0.5 * np.sin(2 * np.pi * am * t))
    return (x + 0.05 * rng.randn(n)).astype(np.float32)


def context_phase():
    from streamkit_tpu_torch.models.whisper import WhisperConfig, init_params, transcribe_window
    from streamkit_tpu_torch.ops.attention import flash_attention

    cfg = WhisperConfig(n_mels=80, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                        n_vocab=51865, n_text_ctx=32, n_text_state=128, n_text_head=2, n_text_layer=2)
    def make():
        p = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
        with torch.no_grad():  # sharper cross-attention: the greedy path follows the audio
            for layer in p.dec.layers:
                layer.xattn.q.w.mul_(10.0)
                layer.xattn.k.w.mul_(10.0)
                layer.xattn.o.w.mul_(3.0)
        return p

    cpu, gpu = make(), make().to("cuda")  # Module.to moves in place: two trees
    window = cfg.n_audio_ctx * 320
    rng = np.random.RandomState(7)
    audio = np.stack([tonal_audio(rng, window) for _ in range(3)])
    before = flash_attention.launches
    tok_g, len_g = transcribe_window(gpu, cfg, audio, window_samples=window, max_tokens=12)
    launched = flash_attention.launches - before
    tok_c, len_c = transcribe_window(cpu, cfg, audio, window_samples=window, max_tokens=12)
    log(f"# context f32 cuda tokens {tok_g.tolist()} lengths {len_g.tolist()}; flash launches {launched}")
    if not (np.array_equal(tok_g, tok_c) and np.array_equal(len_g, len_c)):
        raise AssertionError(f"cuda tokens {tok_g.tolist()} != cpu tokens {tok_c.tolist()}")
    if launched != cfg.n_audio_layer:
        raise AssertionError(f"expected {cfg.n_audio_layer} flash launches, saw {launched}")


# ---------------------------------------------------------------------------
# 3. main path: large-v3 behind the batcher
# ---------------------------------------------------------------------------
def session_audio(rng, secs: float) -> np.ndarray:
    """Syllable-rate bursts of a few harmonics over low noise."""
    n = int(secs * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    voiced = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 5) * t), 0, None)
    return (0.2 * voiced * env + 0.01 * rng.randn(n)).astype(np.float32)


async def serve(params, cfg, ring, batcher, sessions):
    from streamkit_tpu_torch.models.whisper import detect_language_ring, transcribe_ring
    from streamkit_tpu_torch.ops.vad import VAD_FRAME

    # kinds and knobs as nodes/ml/whisper_node.py:326-397 registers them
    max_tokens, window_buckets = 224, [30.0]
    model_tag = f"large-v3:{max_tokens}:s11"
    batch_kind = f"whisper_ring:{model_tag}"
    vad_kind = f"vad_ring:{VAD_BLOCK_FRAMES}"

    def batched_vad(slot_ids, starts, frames_b):
        return ring.vad_append(slot_ids, starts, frames_b)

    batcher.register(vad_kind, batched_vad, max_batch=128, pad_to=None, gather_ms=0.0)

    def make_ring_stt(window: int, tok_budget: int):
        def batched_stt(slot_ids, starts, lengths, lang_rows):
            return transcribe_ring(params, cfg, ring.ring_ref(), slot_ids, starts, lengths,
                                   window_samples=window, language_index=lang_rows,
                                   max_tokens=tok_budget, with_logprobs=True)
        return batched_stt

    detect_window = int(min(8.0, window_buckets[0]) * SR)
    detect_kind = f"whisper_detect:{model_tag}:{detect_window}"

    def batched_detect(slot_ids, starts, lengths):
        return (detect_language_ring(params, cfg, ring.ring_ref(), slot_ids, starts, lengths,
                                     window_samples=detect_window),)

    batcher.register(detect_kind, batched_detect)
    for b in window_buckets:
        tok_budget = min(max_tokens, max(12, int(b * 4) + 8))
        batcher.register(f"{batch_kind}:{int(b * SR)}", make_ring_stt(int(b * SR), tok_budget),
                         pad_to=None, gather_ms=STT_GATHER_MS)
    stt_kind = f"{batch_kind}:{int(window_buckets[0] * SR)}"
    batcher.set_expected(stt_kind, len(sessions))
    batcher.start()
    # segments close together: every session submits its finals once all
    # have streamed their audio, so the ring decodes batch
    streamed = 0
    all_streamed = asyncio.Event()

    async def session(audio):
        nonlocal streamed
        slot = ring.alloc()
        written = 0
        block = VAD_BLOCK_FRAMES * VAD_FRAME
        probs = []
        t0 = time.monotonic()
        for i in range(len(audio) // block):
            frames = audio[i * block : (i + 1) * block].reshape(VAD_BLOCK_FRAMES, VAD_FRAME)
            probs.append(await batcher.submit(vad_kind, np.int32(slot), np.int32(written % ring.ring_samples),
                                              frames))
            written += block
        t_vad = time.monotonic() - t0
        streamed += 1
        if streamed == len(sessions):
            all_streamed.set()
        await all_streamed.wait()
        t0 = time.monotonic()
        lang = await batcher.submit(detect_kind, np.int32(slot), np.int32(0), np.int32(min(written, detect_window)))
        t_det = time.monotonic() - t0
        t0 = time.monotonic()
        tokens, length, lp = await batcher.submit(stt_kind, np.int32(slot), np.int32(0), np.int32(written),
                                                  np.int32(lang))
        t_stt = time.monotonic() - t0
        ring.free(slot)
        return dict(slot=slot, samples=written, vad_probs=np.concatenate(probs), lang=int(lang),
                    tokens=np.asarray(tokens), n_tokens=int(length), lp_sum=float(lp),
                    vad_ms=t_vad * 1e3, detect_ms=t_det * 1e3, stt_ms=t_stt * 1e3)

    out = await asyncio.gather(*(session(a) for a in sessions))
    batcher.stop()
    return out


def main_path(kernels):
    from streamkit_tpu_torch.engine import DeviceBatcher, SessionAudioRing
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, init_params, transcribe_window
    from streamkit_tpu_torch.ops.attention import flash_attention

    cfg = WHISPER_CONFIGS["large-v3"]
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"# large-v3 bf16: {n_params} parameters on the card in {time.monotonic() - t0:.1f} s")
    rng = np.random.RandomState(0)
    sessions = [session_audio(rng, secs) for secs in (10.0, 13.0, 16.0, 19.0)]
    ring = SessionAudioRing(max_slots=16, device="cuda")
    batcher = DeviceBatcher(device="cuda")

    flash_attention.launches = 0  # counts from here to the end of the main path
    t0 = time.monotonic()
    results = asyncio.run(serve(params, cfg, ring, batcher, sessions))
    t_serve = time.monotonic() - t0
    t0 = time.monotonic()
    tok_w, len_w = transcribe_window(params, cfg, sessions[0])
    t_window = time.monotonic() - t0
    launches = flash_attention.launches

    stats = batcher.stats()
    for r in results:
        log("# session " + json.dumps({k: r[k] for k in ("slot", "samples", "lang", "n_tokens", "lp_sum",
                                                          "vad_ms", "detect_ms", "stt_ms")}))
        if not (r["vad_probs"].shape == (r["samples"] // 512,) and np.all(np.isfinite(r["vad_probs"]))
                and r["vad_probs"].min() >= 0.0 and r["vad_probs"].max() <= 1.0):
            raise AssertionError(f"bad VAD probabilities for slot {r['slot']}")
        cap = r["samples"] // 4000 + 4  # the ring decode's per-row budget (+1, as the reference)
        if not (r["tokens"].shape == (128,) and 1 <= r["n_tokens"] <= cap + 1 and math.isfinite(r["lp_sum"])
                and 0 <= r["lang"] < cfg.n_languages and r["tokens"].max() < cfg.n_vocab):
            raise AssertionError(f"bad decode for slot {r['slot']}: {r}")
    log("# transcribe_window " + json.dumps({"n_tokens": int(len_w[0]), "wall_ms": t_window * 1e3,
                                             "shape": list(tok_w.shape)}))
    if not (tok_w.shape == (1, 224) and 1 <= int(len_w[0]) <= 224):
        raise AssertionError(f"bad transcribe_window output {tok_w.shape} {len_w}")
    log("# batcher " + json.dumps(stats))
    log(f"# main path wall: serve {t_serve * 1e3:.1f} ms, transcribe_window {t_window * 1e3:.1f} ms")

    kinds = stats["kinds"]
    encodes = sum(v["calls"] for k, v in kinds.items() if k.startswith(("whisper_ring:", "whisper_detect:"))) + 1
    want = cfg.n_audio_layer * encodes
    log(f"# flash_attention launches {launches} over {encodes} encodes (expected {want})")
    if launches != want or launches == 0:
        raise AssertionError(f"flash_attention launched {launches} times, expected {want}")
    for k in kernels:
        k["launches"] = launches
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.monotonic()
    kernels = kernel_phase()
    log(f"# kernel phase {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    context_phase()
    log(f"# context phase {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    kernels = main_path(kernels)
    log(f"# main path {time.monotonic() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
