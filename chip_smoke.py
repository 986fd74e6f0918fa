# SPDX-License-Identifier: Apache-2.0
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

0. Builds every native source of the port at once, one compiler each:
   ``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``,
   ``csrc/cache_write.cu``, ``csrc/stream_attention.cu`` and
   ``csrc/decode_attention.cu`` with nvcc for sm_90a, ``csrc/ingest.cpp`` and ``csrc/wasm_rt.cpp`` (the WASM plugin
   runtime) with g++, and prints ptxas's report per kernel (registers,
   shared memory, spills, warnings).
1. Holds each hand-written kernel against its plain PyTorch version on the
   card at the shapes the main paths give it, then times kernel, plain
   version and (where one exists) the single PyTorch call that computes the
   same function, a yardstick the port never calls:
   K1 flash attention (f32 within 1e-4 of the plain version run in f32;
   bf16 within twice the plain version's own bf16 error; timed in turns
   with SDPA: kernel, SDPA, SDPA, kernel; the softmax's exponential count
   and their time at the SFU's 16 a clock per SM);
   K2 windowed cache write at the int8 encoder caches, their f32 scales and
   the bf16 decoder folds (bit-exact at random positions, with a wrapping
   row, a lim = 0 row, lim > c, pos < 0 and pos >= T, and at the path's
   positions; timed at the path's positions with the L2 warm and cold,
   beside scatter_ under the same two conditions), and the fused step's two
   grouped launches against the sum of their single-pair launches;
   K3 int8-history attention at [S, 20, 16, 64, 512] (the K1 limits, and a
   pos = 0 row that must not see the history);
   K4 the decode continuation's cross-attention over the int8 cross caches
   at large-v3's [64, 20, 64, 512] (the K1 limits; columns past each row's
   horizon must change nothing), timed at a live spread of horizons and
   with every column visible.
2. Context checks: a small f32 Whisper whose encoder takes K1 decodes the
   same tokens on ``cuda`` as on ``cpu``; a small f32 streaming table (int8
   caches, identity packing, so K2, K3 and K4 launch) runs fused block steps on
   ``cuda`` and ``cpu`` to equal tokens and caches within tolerance.
3. Node context check: a small f32 Whisper (1500 encoder positions, head
   dim 64, so K1 launches) behind the port's ``WhisperNode`` in a oneshot
   pipeline gives the same Transcription lines on ``cuda`` as on ``cpu``,
   without a batcher and with one (``language: auto``).
4. Segment-final path at full width, the way users reach it: oneshot
   pipelines (``http_input → containers::wav::demuxer →
   plugin::native::whisper → core::json_serialize → http_output``) through
   the port's registry, one ``DeviceBatcher`` and one ``ResourceManager``
   (the model loads once). Whisper large-v3, bf16, random weights from seed
   0, ``language: auto``. A short silent request loads the model and lets
   the node register its kinds; ``warmup_batched_kinds`` warms them; then
   four concurrent requests carry WAV bodies of 10–19 s of synthetic audio
   (the node's ``whisper_detect`` and ``whisper_ring`` kinds), and a fifth
   runs without a batcher (the node's ``transcribe_window`` route).
5. Live captions at full width: two concurrent oneshot requests in the shape
   of ``samples/pipelines/system/live_captions.yml`` (WAV in, JSON out;
   partials from the fused streaming step, finals from the stream, 8-frame
   VAD blocks), 8 s of synthetic speech and 1 s of silence each.
6. Live-partials path at full width: an ``SttServingEngine`` (large-v3
   bf16) in stream mode serves 8 sessions of 8 s synthetic speech and 1 s of
   silence pushed faster than real time, then a 2-session engine in exact
   mode. Every session must see speech_start, partials and finals with
   monotone ``seq``. Both engines take ``resources=`` the manager the
   ``WhisperNode`` paths filled: one build of large-v3, not two.
6b. ``# script``: WAV → whisper → ``core::script`` → JSON lines through the
   oneshot engine, with a JavaScript and a Python ``process(packet)`` that
   rewrite each transcription and add a field, equal to the same request
   without the script, transformed in Python.
6c. ``# host codecs``: which of ``audio::flac::decoder`` (the port's libav
   shim, built with g++ where pkg-config finds libav), ``audio::mp3::decoder``
   (libmpg123) and ``containers::webm::muxer`` registered, a line naming each
   absent library; where FLAC registered, the 10 s segment-final audio as a
   verbatim FLAC through the decoder → whisper, lines equal to the WAV's.
6d. ``# plugins``: the example native gain plugin (g++ with
   ``native/Makefile``'s flags on ``native/plugins/gain/gain_plugin.cpp``),
   the core-WASM gain and the gain component (the port's SDK) loaded into
   the port's registry; phase 4's 10 s WAV → gain 2 → whisper (large-v3
   bf16, 24 tokens) → JSON lines through each runtime and through
   ``audio::gain``, one request at a time on one ``DeviceBatcher``: the four
   responses equal, K1 32 per encode in each, K2, K3 and K4 none; each gain node
   alone over the WAV demuxer's packets (its samples exactly 2x), host ms
   per packet and per second of audio.
7. Profiles a few fused steps at the live-partials path's shape (large-v3,
   8 slots) with ``torch.profiler``: host wall per call against the
   device's kernel time, by kernel.
8. The repo's own sample pipelines: ``speech_to_text.yml`` on
   ``samples/media/speech_30s.ogg`` (whisper at large-v3 bf16), with and
   without the compiler's decode-resample fusion, and ``double_volume.yml``
   on ``samples/media/tone.wav`` with a batcher (the batched ``audio::gain``
   kind; bytes equal to the port's CPU run).
9. A dynamic session: ``live_captions.yml``'s graph through
   ``start_dynamic_engine``, files in place of MoQ at its two ends; every
   fused call must launch exactly 2 K2, 32 K3 and 96 K4, and K1 32 per
   ring decode (the close of a segment still open at the end of the file).
   One load check of libopus comes before 8 and 9, and a line says its
   result: without libopus 8 runs only ``double_volume.yml`` and 9 reads
   ``samples/media/speech_8s.wav`` through the WAV demuxer.
10. DSP through the registry: 128 concurrent oneshot requests of 15 s
   (48 kHz mono, 44.1 kHz stereo → 16 kHz) through ``audio::resampler`` at
   ``compat: exact``, ``backend: device`` and one ``DeviceBatcher`` (the
   slot-table route, end-of-file flush included), byte for byte against the
   same requests on the node's host route (``LinearResampler``), every slot
   free after; one batched step's device time and launches against its
   byte bound; gain branches into ``audio::mixer``, with and without a
   batcher, bit for bit against numpy.
11. Translation at published widths, random weights from seed 0:
   NLLB-200-distilled-600M (``NllbConfig(vocab_size=256206)``: d 1024,
   12 + 12 layers, 16 heads) and opus-mt-en-es (``MarianConfig()``: d 512,
   6 + 6 layers, 8 heads, vocab 65001). 16 texts of 20–120 bytes through
   the two calls the translate nodes make (``BucketedGreedy.run_batched`` on
   one ``DeviceBatcher``, bf16, ``max_tokens`` 128); each bucket's rows
   alone at 16 tokens under the profiler (host wall, device time, idle
   share, decode steps, kernels per step); one beam-4 batch; 2 rows at f32
   (``max_tokens`` 16, greedy) with tokens equal to the port's CPU f32
   run. No kernel of ours is on this path: K1–K3 launch 0 times.
12. The cascade samples as written: ``speech_translate.yml`` (Whisper
   tiny → NLLB → NDJSON) and ``voice_translate.yml`` (… → VITS at
   facebook/mms-tts-eng widths, 24 kHz → WAV), 4 concurrent requests
   (``speech_8s.wav`` and synthetic speech) through the registry, the
   oneshot engine and one ``DeviceBatcher``, against the same requests on
   the CPU at f32: JSON equal byte for byte, WAV headers and lengths equal
   and 16-bit samples within ``WAVE_TOL``, the VITS durations of every
   translated sentence equal; K1 4 per Whisper-tiny encode.
   ``text_to_speech.yml`` runs only where libopus loads (its Opus encoder).
13. Speech models (``# speech models``), random weights, through the
   port's registry and nodes with one ``DeviceBatcher`` per path: Kokoro
   (the golden pack, hidden 512) in ``text_to_speech.yml``'s graph, its
   Opus encoder and Ogg muxer a WAV muxer where libopus is absent, 8
   concurrent requests of 2–4 sentences; Matcha at ``MatchaConfig()`` with
   ``HifiGanConfig()`` (16 rows × 512 frames, one call profiled) and the
   node in 4 concurrent requests; SenseVoice at ``SenseVoiceConfig()``
   (50 layers, bf16) through a config-only ``sensevoice.npz``, 8
   concurrent WAV requests, one 8 × 20 s forward profiled. At f32 on the
   card against the CPU: Kokoro's durations equal and audio within
   ``KOKORO_ATOL``, Matcha's frame counts equal and mel within
   ``MEL_ATOL``, SenseVoice's CTC ids of 2 clips equal. K1–K3 launch 0
   times there.

14. The server (``# server``): ``python3 -m streamkit_tpu_torch.server
   serve --port 0`` as a child process (its log names the port; it answers
   ``/healthz``, ``/api/v1/config`` and ``/api/v1/schema/nodes`` with the
   in-process registry's kinds; SIGINT ends it with 0, no process left on
   the card); then ``create_app(device="cuda")`` on 127.0.0.1:0 in this
   script's loop, every request over real sockets through the port's own
   client: a warm request, phase 4's four STT requests at once as multipart
   ``POST /api/v1/process`` (phase 4's checks, K1 32 per encode, walls
   beside phase 4's), a WAV uploaded as an asset and read back by
   ``transport::http::fetcher`` in a session made by ``POST
   /api/v1/sessions``, ``double_volume.yml`` equal to the CPU's bytes,
   ``live_captions.yml``'s graph built over the WebSocket control plane
   (file reader and WAV demuxer in front) whose captions a WebSocket
   subscriber reads from ``/moq/captions`` beside two WebTransport
   subscribers on the server's QUIC acceptor (the port's native
   ``MoqClient`` and ``MoqLiteClient``, the fingerprint pinned from
   ``/api/v1/moq/fingerprints``; the three receive the same frames and
   the same final line; ``# webtransport``: libcrypto, handshakes, frames
   and dropped groups, host µs to seal and open a 1200-byte packet, 4 MiB
   over one loopback stream) (partials and a final; 2 K2 and
   32 K3 per fused call; a device profile of the session names K3; no
   session or stream-table row left after ``destroysession``), the metrics
   and heap routes, a ``core::script`` ``fetch()`` under the server's
   ``[script]`` allowlist and scoped secret, ``# server plugins``: the three
   plugin files of 6d uploaded, listed, named by the schema, one STT
   request through the uploaded native gain equal to 6d's lines, all three
   deleted, then ``skit-tpu-cli --help`` (a CLI child's start, timed) and
   ``skit-tpu-cli plugins list / load / delete`` as child processes (each
   exits 0), ``# loadtest``:
   ``cli/loadtest.py`` mixed for 30 s (4 oneshot STT workers at a 32-token
   budget, 2 workers cycling live-captions sessions whose gain is tuned
   every 200 ms; every request must succeed, K1 and K3 launch), OTLP pushes
   from a second server (started with ``otlp_endpoint``, on the same model
   cache) to a collector stub naming its session's events, and the f32 node
   check through a ``cuda`` and a ``cpu`` server
   (equal lines, K1 on the card only).

15. Fine-tuning (``# train``, after the context checks): K1's backward
   kernels (``csrc/flash_attention_bwd.cu``: the preprocess, D =
   rowsum(dO∘O), then the main pass over key tiles, dQ summed in a fixed
   order, dK and dV) are held against their plain version on the same
   inputs at f32 (1e-4 of each gradient's largest value) and bf16 (twice
   the plain version's own rounding) at the large-v3 encoder's
   [2, 20, 1500, 64], its cross-attention at 256 × 1500 and strided views
   of one fused [B, T, 3·H·d] buffer at d = 128; a second run gives the same
   bits; the forward with the row statistic stored gives the serving
   launch's output bit for bit; both kernels are timed in turns with SDPA's
   backward (``torch.autograd.grad``, a yardstick the port never calls),
   beside the wrapper's host time per call and the time the main kernel's
   CTAs wait on the ordered dQ's counters. Then ``parallel/train.py``: a
   small f32 config (256 encoder positions, width 128, 2 heads of 64, 2 + 2
   layers, 256 tokens, so both attention kinds take K1) takes 3 steps on
   the card against the same 3 on the CPU (losses, the first step's grads,
   params), 4 K1, 4 preprocess and 4 main backward launches a step, and a
   resume on the card (2 steps, save, load, 1 step) equal bit for bit to
   the straight third step; then Whisper large-v3 (random f32 weights from
   seed 0), 2 windows of 3000 mel frames and 256 tokens, 3 f32 steps on one
   batch (the loss finite and falling) and 2 from the params cast to bf16
   (finite), each under the profiler (wall, device time, idle share, peak
   memory, the top kernels) with exactly 64 K1 and 64 of each backward
   kernel.

15b. The learned VAD's trainer and evaluator (``# vad train``, after 15):
   ``streamkit_tpu_torch/tools/train_vad.py`` from ``init_params(0)``,
   batch 64 of 48-frame clips, ``VAD_TRAIN_STEPS`` Adam steps on the card,
   synthetic clips only where the real-speech sample or libopus is absent
   (a line says which data and why), each step's host ms and peak memory,
   three steps under the profiler (device ms, idle share, kernels; K1–K3
   launch 0 times);
   the same steps on the CPU, each step's loss and the final params within
   the ``VAD_*`` limits; the card's weights saved with ``save_params`` to a
   temporary directory re-score ``samples/media/speech_8s.wav`` through
   ``tools/eval_vad.py`` ``evaluate`` on the card and on the CPU
   (probabilities within ``VAD_PROB_ATOL``, equal segments); the process's
   VAD backend, its weights, ``SK_VAD_BACKEND`` and the bundled weights
   file are as before.

16. The mesh (``# mesh``, last): ``parallel/`` on ``torch.distributed``
   ranks spawned by ``parallel.run_ranks`` (the kernels are built once
   before, by phase 0). The card's machine has one card and NCCL refuses
   two ranks on one device, so: (a) one NCCL rank (world size 1): the small
   f32 config's forward (logits of 2 windows) and 3 fused int8 steps over
   2 slots on a 1 × 1 mesh, equal to the unsharded run with the same
   launches, a checkpoint roundtrip, and ``SttServingEngine(mesh=)`` at a
   small config (2 sessions, every device call a broadcast over NCCL);
   (b) two gloo ranks sharing ``cuda:0`` (gloo stages CUDA tensors through
   the host): the same small checks at tp = 2 and at dp = 2 (logits within
   1e-5, tokens, counts and positions equal, each rank's launches equal to
   the unsharded run's) and a sharded checkpoint (bit for bit, placements
   kept, loaded whole on one device); (c) two gloo ranks at tp = 2 on
   Whisper large-v3 (random weights from seed 0): the bf16 forward, whose
   gap to the one-rank bf16 run must stay within twice the one-rank bf16
   run's own gap to its f32 run, with K1 32 per encode on each rank;
   ``SttServingEngine(mesh=)`` with 4 stream-mode sessions (exactly 2 K2,
   32 K3 and 96 K4 per fused call on each rank, its model's collectives per
   call, no stream row held after close); one bf16 train step (64 K1 and
   64 of each backward kernel on each rank; device time, idle share, peak
   memory per rank). No multi-card time can be taken on one card.

Kernel launch counts are set to 0 just before each path (4, 5, 6, 6b, 6c, each
request of 6d, 8, 9, 11, 12, 13, each request, session and the load test of 14, each train
step of 15, each rank's part of 16) and read just after; each must equal what the code implies (K1: 32 per encode of 256
or more positions at large-v3, 4 at tiny; K2: 2 per fused step call, one
for the encoder caches and their scales and one for the two decoder folds;
K3: 32 per fused step call; K4: 96 per fused step call, one per decoder
layer and decode step; K1's backward kernels: 0 outside 15, one each
per K1 launch of a train step). Every batcher kind these paths dispatch is registered
by the port's nodes or ``SttServingEngine``, never by this script.
Kernel times are device times by the profiler (CUDA-event times of a run of
calls beside them, which include the gaps where the device waits for the
host).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result, without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SR = 16_000
STT_GATHER_MS = 1000.0  # the whisper node's SK_STT_GATHER_MS knob: straggler bound
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 on the CUDA cores, H100 SXM data sheet
H100_BYTES = 3.35e12  # HBM3 bytes/s


def log(msg: str) -> None:
    print(msg, flush=True)


def counters():
    """The launch-counting kernel wrappers, by kernel name."""
    from streamkit_tpu_torch.ops import attention, cache_write, decode_attention, stream_attention

    return {"flash_attention": attention.flash_attention,
            "windowed_write": cache_write.windowed_write_groups,
            "history_attention": stream_attention.history_attention,
            "decode_cross_attention": decode_attention.decode_cross_attention,
            "flash_attention_backward_preprocess": attention._bwd_preprocess,
            "flash_attention_backward_main": attention._bwd_main}


# every kernel's count at 0: a path's expected counts start from it, so K1's
# backward kernels must stay at 0 wherever nothing is trained
ZERO_LAUNCHES = {"flash_attention": 0, "windowed_write": 0, "history_attention": 0, "decode_cross_attention": 0,
                 "flash_attention_backward_preprocess": 0, "flash_attention_backward_main": 0}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def build_phase() -> None:
    """Start one compiler per native source, all at once; raise on failure."""
    from streamkit_tpu_torch.engine import ingest
    from streamkit_tpu_torch.ops import _build, attention, cache_write, decode_attention, stream_attention
    from streamkit_tpu_torch.plugins import wasm

    sources = [attention.SOURCE, attention.BWD_SOURCE, cache_write.SOURCE, stream_attention.SOURCE,
               decode_attention.SOURCE, ingest.SOURCE, wasm.SOURCE]
    t0 = time.monotonic()
    _build.build_all(sources)
    for src in sources:
        log(f"# built {os.path.relpath(src.library())} ({src.compiler}) in "
            f"{_build.build_seconds.get(src.file, 0.0):.1f} s")
        if src.compiler == "nvcc":  # registers, shared memory and spills per kernel
            for k in _build.ptxas_summary(_build.report(src)):
                log(f"# ptxas {src.file} " + json.dumps(k))
    log(f"# build phase wall {time.monotonic() - t0:.1f} s")


def sm_clock_hz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


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


def device_kernels(fn, iters: int):
    """The GPU kernels (and copies) that ``iters`` calls of ``fn`` run, as
    profiler events (CUPTI sees every launch, ctypes ones included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def kernel_ms(fn, iters: int = 20, warmup: int = 3) -> dict:
    """Device time of one ``fn()`` call (the summed duration of the kernels
    it runs, by the profiler) beside the CUDA-event time of a run of calls,
    which also counts the gaps where the device waits for the host."""
    event = time_ms(fn, iters, warmup)
    ks = device_kernels(fn, iters)
    if not ks:
        log("# the profiler saw no device time: CUDA events only")
        return {"ms": event, "event_ms": event}
    return {"ms": sum(e.time_range.elapsed_us() for e in ks) / iters / 1e3, "event_ms": event,
            "kernels_per_call": len(ks) / iters}


def head_split(x: torch.Tensor, h: int) -> torch.Tensor:
    """``[B, T, H*d]`` → the ``[B, H, T, d]`` view the encoder hands the kernel."""
    b, t, hd = x.shape
    return x.reshape(b, t, h, hd // h).transpose(1, 2)


# ---------------------------------------------------------------------------
# 1. kernels against their plain versions
# ---------------------------------------------------------------------------
def k1_phase():
    import torch.nn.functional as F

    from streamkit_tpu_torch.ops import attention as attn

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
            pad = -t % 128  # the kernel's K/V tile: 128 rows
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
                # kernel and SDPA in turns (kernel, SDPA, SDPA, kernel)
                kern = lambda: attn.flash_attention(q, k, v, scale)  # noqa: E731
                sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=d ** -0.5)  # noqa: E731
                turns = [kernel_ms(fn) for fn in (kern, sdpa, sdpa, kern)]
                pt = kernel_ms(lambda: attn.attention_reference(q, k, v, scale), iters=5)
                ms = (turns[0]["ms"] + turns[3]["ms"]) / 2
                lib_ms = (turns[1]["ms"] + turns[2]["ms"]) / 2
                plain_ms = pt["ms"]
                # the softmax's exponentials at 16 a clock on each SM's SFU
                n_exp = b * h * t * t
                sfu_ms = n_exp / (16 * torch.cuda.get_device_properties(0).multi_processor_count * sm_clock_hz()) * 1e3
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    kern()
                host_us = (time.perf_counter() - t0) / 20 * 1e6  # wrapper + tensor maps + launch
                torch.cuda.synchronize()
                line.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_ops, t_bytes),
                            turns_ms=[x["ms"] for x in turns], ratio_to_library=ms / lib_ms,
                            event_ms=turns[0]["event_ms"], plain_event_ms=pt["event_ms"],
                            library_event_ms=turns[1]["event_ms"],
                            bound_by="operations" if t_ops >= t_bytes else "bytes",
                            bound_share=max(t_ops, t_bytes) / ms, tflops=flops / ms / 1e9,
                            exp2_count=n_exp, sfu_ms=sfu_ms, host_us_per_call=host_us)
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
    return entry


# what the backward kernels replace: the library flash kernel's backward
# (jax 0.9.0), which the reference's _lib_flash
# (streamkit_tpu/ops/attention.py:132) reaches under jax.vjp
LIB_FLASH_BWD = {
    "preprocess": "jax/experimental/pallas/ops/tpu/flash_attention.py:273 (di = rowsum(o*do), computed outside "
                  "the backward pallas_calls)",
    "main": "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 (_flash_attention_bwd_dkv) and :1456 "
            "(_flash_attention_bwd_dq)",
}


def backward_bound(kind: str, b: int, h: int, tq: int, tk: int, d: int, dtype) -> tuple:
    """(bound ms, "operations" or "bytes") of the backward's work:
    ``preprocess`` D = rowsum(dO∘O) (Tq·d multiply-adds a head) reading O
    and dO, writing D (its bytes bound it; the kernel's copy of lse and the
    counters it zeroes serve the main pass and are not counted);
    ``main`` 5 products of 2·Tq·Tk·d a head (S, dO V^T, P^T dO, dS^T Q,
    dS K), reading q, k, v, dO, lse and D, writing dq, dk and dv; ``pair``
    the whole backward, 5 products, reading q, k, v, O, dO and lse, writing
    dq, dk and dv."""
    size = torch.finfo(dtype).bits // 8
    products, rows = {"preprocess": (0, 2 * tq * d * size + 4 * tq),
                      "main": (5, (3 * tq + 4 * tk) * d * size + 8 * tq),
                      "pair": (5, (4 * tq + 4 * tk) * d * size + 4 * tq)}[kind]
    flops = products * 2 * b * h * tq * tk * d + (2 * b * h * tq * d if kind == "preprocess" else 0)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, b * h * rows / H100_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def autograd_route_check(q, k, v, do, scale: float) -> dict:
    """``flash_attention`` on leaves that require grad, then ``backward()``
    (K1 with the store, then the two backward kernels) against autograd of
    :func:`attention_reference` on the f32 copies of the same inputs. f32:
    within 1e-4 of each gradient's largest |g|; bf16: within twice the
    error of autograd through the plain attention at bf16."""
    from streamkit_tpu_torch.ops import attention as attn

    def grads(fn, dtype):
        leaves = [x.detach().to(dtype).requires_grad_() for x in (q, k, v)]
        fn(*leaves, scale).backward(do.to(dtype))
        return [x.grad.float() for x in leaves]

    truth = grads(attn.attention_reference, torch.float32)
    got = grads(attn.flash_attention, q.dtype)
    plain = grads(attn.attention_reference, q.dtype) if q.dtype == torch.bfloat16 else None
    report = {}
    for i, name in enumerate(("dq", "dk", "dv")):
        err = (got[i] - truth[i]).abs().max().item()
        if plain is None:
            tol = 1e-4 * truth[i].abs().max().item()
        else:
            tol = 2 * (plain[i] - truth[i]).abs().max().item()
        report[name] = {"max_abs_err": err, "tol": tol}
        if not err <= tol:
            raise AssertionError(f"K1 autograd route {q.dtype} {name}: max |err| {err} > {tol}")
    return report


def backward_split_ms(fn, iters: int = 5) -> dict:
    """Device ms of one ``flash_attention_backward`` call, by kernel: the
    preprocess and the main pass (profiler events by name), and the CUDA-event
    time of the call."""
    total = kernel_ms(fn, iters)
    split = {"preprocess": 0.0, "main": 0.0}
    for e in device_kernels(fn, iters):
        kind = "preprocess" if "flash_bwd_prep" in e.name else "main" if "flash_bwd_" in e.name else None
        if kind is None:
            raise AssertionError(f"K1 backward: an unexpected device kernel {e.name}")
        split[kind] += e.time_range.elapsed_us() / iters / 1e3
    return {**split, "event_ms": total["event_ms"]}


def k1_backward_phase() -> dict:
    """K1's backward kernels (the preprocess, D, then the main pass over key
    tiles) against their plain version on the same inputs (q, k, v, dO and
    the forward's O and row statistic), and against themselves (a second run
    gives the same bits), the forward's row statistic against the plain one
    (f32 within 1e-5, bf16 within 1e-3, in log2 units), the forward with the
    statistic stored against the serving launch (bit for bit), the autograd
    route (``flash_attention`` on inputs that require grad, then
    ``backward()``) against autograd of the plain attention in f32, their
    times beside SDPA's backward, the wrapper's host time per call and the
    time the main kernel waits on the ordered dQ's counters. Returns the
    ``kernels`` entries of the two backward kernels (encoder shape, f32: the
    train path's dtype; bf16 beside it)."""
    import torch.nn.functional as F

    from streamkit_tpu_torch.ops import attention as attn

    g = torch.Generator(device="cuda").manual_seed(1)
    entries = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    # the large-v3 encoder at B = 2, its cross-attention at 256 tokens, and
    # q, k, v as strided views of one fused [B, T, 3*H*d] buffer at d = 128
    # with ragged 64-row tiles
    for label, b, h, tq, tk, d in [("encoder", 2, 20, 1500, 1500, 64), ("cross", 2, 20, 256, 1500, 64),
                                   ("fused-strided", 1, 3, 300, 300, 128)]:
        scale = d ** -0.25
        for dtype in (torch.float32, torch.bfloat16):
            def rand(t, n):
                return torch.randn(b, t, n, device="cuda", generator=g).to(dtype)

            if label == "fused-strided":
                q, k, v = (head_split(x, h) for x in rand(tq, 3 * h * d).split(h * d, dim=-1))
            else:
                q, k, v = head_split(rand(tq, h * d), h), head_split(rand(tk, h * d), h), head_split(rand(tk, h * d), h)
            do = head_split(rand(tq, h * d), h)
            out, lse = attn.flash_attention_lse(q, k, v, scale)
            served = attn.flash_attention(q, k, v, scale)  # no store: the serving paths' launch
            dq, dk, dv = attn.flash_attention_backward(q, k, v, out, do, lse, scale)
            *again, delta = attn._flash_backward(q, k, v, out, do, lse, scale)  # and the preprocess's D
            torch.cuda.synchronize()
            ins32 = [x.float() for x in (q, k, v, out, do)]
            ref = attn.attention_backward_reference(*ins32[:4], ins32[4], lse, scale)
            # the row statistic the backward rebuilds P from: a wrong row
            # would pass the check above, which feeds lse to both sides
            lse_err = (lse - attn.attention_lse_reference(*ins32[:3], scale)[1]).abs().max().item()
            lse_tol = 1e-5 if dtype == torch.float32 else 1e-3
            # the preprocess's D, as the main pass read it
            want_d = attn.attention_backward_preprocess_reference(out, do)
            d_err = (delta - want_d).abs().max().item()
            d_tol = 1e-5 * want_d.abs().max().item()  # summation order over d
            line = {"case": label, "shape": [b, h, tq, tk, d], "dtype": str(dtype).split(".")[-1],
                    "forward_store_off_bit_equal": torch.equal(out, served),
                    "repeat_bit_equal": all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)),
                    "lse": {"max_abs_err": lse_err, "tol": lse_tol}, "D": {"max_abs_err": d_err, "tol": d_tol}}
            if not lse_err <= lse_tol:
                raise AssertionError(f"K1 forward {label} {dtype}: row statistic max |err| {lse_err} > {lse_tol}")
            if not d_err <= d_tol:
                raise AssertionError(f"K1 backward preprocess {label} {dtype}: D max |err| {d_err} > {d_tol}")
            line["autograd"] = autograd_route_check(q, k, v, do, scale)
            if dtype == torch.bfloat16:  # the plain version at bf16: its rounding alone
                plain16 = attn.attention_backward_reference(q, k, v, out, do, lse, scale)
            for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                err = (got.float() - want).abs().max().item()
                # f32: summation order over up to 1500 keys; bf16: twice the
                # plain version's own bf16 error (its roundings of P, dS and
                # the result) on the same inputs
                if dtype == torch.float32:
                    tol = 1e-4 * want.abs().max().item()
                else:
                    tol = 2 * (plain16[("dq", "dk", "dv").index(name)].float() - want).abs().max().item()
                line[name] = {"max_abs_err": err, "tol": tol, "max_abs": want.abs().max().item()}
                if not math.isfinite(err) or err > tol or got.shape != want.shape or got.dtype != dtype:
                    raise AssertionError(f"K1 backward {label} {dtype} {name}: max |err| {err} > {tol}")
            if not line["forward_store_off_bit_equal"]:
                raise AssertionError(f"K1 forward {label} {dtype}: the row-statistic store changed the output")
            if not line["repeat_bit_equal"]:
                raise AssertionError(f"K1 backward {label} {dtype}: a second run gave other bits")
            if label != "fused-strided":
                full = lambda: attn.flash_attention_backward(q, k, v, out, do, lse, scale)  # noqa: E731
                # SDPA's backward alone: one forward, then grads in turns with the kernels
                leaves = [x.detach().requires_grad_() for x in (q, k, v)]
                o_lib = F.scaled_dot_product_attention(*leaves, scale=scale * scale)
                lib = lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True)  # noqa: E731
                turns = [backward_split_ms(full), kernel_ms(lib, iters=5), kernel_ms(lib, iters=5),
                         backward_split_ms(full)]
                plain = {"preprocess": kernel_ms(lambda: attn.attention_backward_preprocess_reference(out, do))["ms"],
                         "main": kernel_ms(lambda: attn.attention_backward_main_reference(
                             q, k, v, do, lse, want_d, scale), iters=3)["ms"]}
                times = {kind: (turns[0][kind] + turns[3][kind]) / 2 for kind in ("preprocess", "main")}
                lib_ms = (turns[1]["ms"] + turns[2]["ms"]) / 2
                # one PyTorch call of the preprocess's function (D alone)
                vecdot_ms = kernel_ms(lambda: torch.linalg.vecdot(out, do))["ms"]
                for kind in ("preprocess", "main", "pair"):
                    ms = times["preprocess"] + times["main"] if kind == "pair" else times[kind]
                    bound, by = backward_bound(kind, b, h, tq, tk, d, dtype)
                    line[f"{kind}_ms"], line[f"{kind}_bound_ms"], line[f"{kind}_bound_by"] = ms, bound, by
                    line[f"{kind}_bound_share"] = bound / ms
                # the wrapper's host time per call (enqueue only: the card
                # runs behind), and the main kernel's waits on dQ counters
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    full()
                host_us = (time.perf_counter() - t0) / 20 * 1e6
                torch.cuda.synchronize()
                spin = torch.zeros(1, dtype=torch.int64, device="cuda")
                attn._flash_backward(q, k, v, out, do, lse, scale, spin=spin)
                # summed over the CTAs' waiting threads (f32: thread 0, the CTA
                # behind it; bf16: the dQ writer threads, beside the consumers,
                # and the last key tile's consumers); one CTA per SM is resident
                wait_ms = spin.item() / clock * 1e3
                line.update(library_ms=lib_ms, library_preprocess_ms=vecdot_ms, plain_ms=plain,
                            turns_ms=[turns[0], turns[1]["ms"], turns[2]["ms"], turns[3]],
                            ratio_to_library=(times["preprocess"] + times["main"]) / lib_ms,
                            host_us_per_call=host_us, dq_wait_ms_summed=wait_ms,
                            dq_wait_share=wait_ms / (times["main"] * sms))
                if label == "encoder":
                    for kind in ("preprocess", "main"):
                        name = f"flash_attention_backward_{kind}"
                        err = d_err if kind == "preprocess" else max(line[x]["max_abs_err"] for x in ("dq", "dk", "dv"))
                        numbers = {"max_abs_err": err, "ms": times[kind], "plain_ms": plain[kind],
                                   "bound_ms": line[f"{kind}_bound_ms"], "bound_by": line[f"{kind}_bound_by"],
                                   "library_ms": vecdot_ms if kind == "preprocess" else lib_ms}
                        if dtype == torch.float32:  # the train path's shape and dtype
                            entries[name] = {
                                "name": name, "route": "cuda",
                                "source": "streamkit_tpu_torch/csrc/flash_attention_bwd.cu",
                                "replaces": LIB_FLASH_BWD[kind], **numbers,
                                "library": "torch.linalg.vecdot(o, do)" if kind == "preprocess" else
                                "torch.autograd.grad through scaled_dot_product_attention (dQ, dK and dV)",
                                "shape": [b, h, tq, tk, d], "dtype": "float32"}
                        else:
                            entries[name]["bfloat16"] = numbers
                del leaves, o_lib, spin
            log("# k1 backward " + json.dumps(line))
            del q, k, v, do, out, lse, served, dq, dk, dv, again, delta, ref, ins32
    torch.cuda.empty_cache()
    return entries


def cold_ms(fn, flush: torch.Tensor, iters: int = 10) -> float:
    """Device time of one ``fn()`` call into a cold L2: every call follows a
    write of ``flush`` (more than the L2 holds), and only ``fn``'s kernels
    count (the profiler's, by name: the flush's names are left out)."""
    fill = lambda: flush.fill_(1.0)  # noqa: E731
    fill_names = {e.name for e in device_kernels(fill, 1)}
    for _ in range(2):
        fill()
        fn()
    ks = [e for e in device_kernels(lambda: (fill(), fn()), iters) if e.name not in fill_names]
    return sum(e.time_range.elapsed_us() for e in ks) / iters / 1e3


FLUSH_BYTES = 128 << 20  # a write of it between launches leaves the 50 MB L2 cold


def k2_phase(S: int):
    """Windowed cache write at the three classes the streaming table gives
    it with S slots. Bit-exact against the plain version at random
    positions (a wrapping row, a lim = 0 row, a lim > c row, pos < 0 and
    pos >= T) and at the path's positions (multiples of 8 for the encoder
    caches and scales, any column for the folds). Timed at the path's
    positions with every row writing its window, L2 warm (the same windows
    rewritten) and cold (a 128 MB write before each launch), beside
    scatter_ under the same two conditions. Then the fused step's two
    grouped launches (the 8-pair encoder write, the fold pair), bit-exact
    against the plain version looped over the pairs and timed against the
    sum of their single-pair launches."""
    from streamkit_tpu_torch.ops import cache_write as cw

    g = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def rand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, device="cuda", generator=g, dtype=torch.int8)
        return torch.randn(shape, device="cuda", generator=g).to(dtype)

    def path_pos(T, chunked):
        """The fused step's starts: encoder writes at multiples of CHUNK_POS
        = 8, folds at any column."""
        if chunked:
            return torch.randint(0, T // 8, (S,), device="cuda", generator=g, dtype=torch.int32) * 8
        return torch.randint(0, T, (S,), device="cuda", generator=g, dtype=torch.int32)

    def exact(pairs, pos, lim, label):
        """One launch over ``pairs`` against the plain version looped over
        them; returns the largest |difference| (0 when bit-exact)."""
        want = [cw.windowed_write_reference(cache.clone(), upd, pos, lim) for cache, upd in pairs]
        got = [cache.clone() for cache, _ in pairs]
        cw.windowed_write_many([(o, upd) for o, (_, upd) in zip(got, pairs)], pos, lim)
        torch.cuda.synchronize()
        for o, w in zip(got, want):
            if not torch.equal(o.view(torch.uint8), w.view(torch.uint8)):
                raise AssertionError(f"windowed_write {label}: differs from the plain version")
        return max((o.double() - w.double()).abs().max().item() for o, w in zip(got, want))

    def nbytes(pairs):
        return sum(2 * u.numel() * u.element_size() for _, u in pairs) + 8 * S

    entry = None
    # (label, G, F, T, c, dtype, chunked): the encoder caches (4 kinds, 20
    # heads x 64), their scales, the decoder folds (dec_t = 64 at a 32-token
    # budget, c = max_steps = 3)
    classes = [("int8 enc cache", 32, 1280, 512, 16, torch.int8, True),
               ("f32 scales", 32, 20, 512, 16, torch.float32, True),
               ("bf16 fold", 32, 1280, 64, 3, torch.bfloat16, False)]
    for label, G, F_, T, c, dtype, chunked in classes:
        cache, upd = rand((G, S, F_, T), dtype), rand((G, S, F_, c), dtype)
        pos = torch.randint(0, T, (S,), device="cuda", generator=g, dtype=torch.int32)
        lim = torch.randint(0, c + 1, (S,), device="cuda", generator=g, dtype=torch.int32)
        pos[0], lim[0], lim[1] = T - 2, c, 0  # wraps; writes nothing
        pos[2], lim[2], pos[3] = -5, c + 3, T + 3  # pos < 0 and lim > c; pos >= T
        pos_p = path_pos(T, chunked)
        lim_full = torch.full((S,), c, device="cuda", dtype=torch.int32)
        err = max(exact([(cache, upd)], pos, lim, label), exact([(cache, upd)], pos_p, lim, label),
                  exact([(cache, upd)], pos_p, lim_full, label))
        # every row writes its whole window: one scatter_ along the time
        # axis computes the same function there
        idx = ((pos_p.long()[:, None] + torch.arange(c, device="cuda")) % T)[None, :, None, :].expand(G, S, F_, c)
        scat = cache.clone().scatter_(-1, idx, upd)
        kern = cw.windowed_write_groups(cache.clone(), upd, pos_p, lim_full)
        if not torch.equal(scat.view(torch.uint8), kern.view(torch.uint8)):
            raise AssertionError(f"windowed_write {label}: scatter_ yardstick computes another function")
        moved = nbytes([(cache, upd)])
        bound = moved / H100_BYTES * 1e3
        work = cache.clone()
        kern_fn = lambda: cw.windowed_write_groups(work, upd, pos_p, lim_full)  # noqa: E731
        scat_fn = lambda: work.scatter_(-1, idx, upd)  # noqa: E731
        kt, lt = kernel_ms(kern_fn), kernel_ms(scat_fn)
        k_cold, l_cold = cold_ms(kern_fn, flush), cold_ms(scat_fn, flush)
        pt = kernel_ms(lambda: cw.windowed_write_reference(work, upd, pos_p, lim_full), iters=10)
        line = dict(case=label, shape=[G, S, F_, T], c=c, dtype=str(dtype).split(".")[-1],
                    positions="multiples of 8" if chunked else "any column", pos=pos_p.tolist(), bit_exact=True,
                    max_abs_err=err, ms=kt["ms"], ms_cold=k_cold, plain_ms=pt["ms"], library_ms=lt["ms"],
                    library_ms_cold=l_cold, bound_ms=bound, bytes=moved, event_ms=kt["event_ms"],
                    plain_event_ms=pt["event_ms"], library_event_ms=lt["event_ms"])
        log("# k2 " + json.dumps(line))
        if entry is None:  # the int8 encoder caches
            entry = {"name": "windowed_write", "route": "cuda",
                     "source": "streamkit_tpu_torch/csrc/cache_write.cu",
                     "replaces": "streamkit_tpu/ops/cache_write.py:209",
                     "max_abs_err": err, "ms": kt["ms"], "ms_cold": k_cold, "plain_ms": pt["ms"],
                     "bound_ms": bound, "bound_by": "bytes", "library_ms": lt["ms"], "library_ms_cold": l_cold,
                     "case": label}
        del cache, upd, scat, kern, work, idx

    # the fused step's two launches: every encoder cache with its scales
    # (multiples of 8), both decoder folds (any column)
    for label, specs, chunked in [("encoder 8-pair write", [classes[0], classes[1]] * 4, True),
                                  ("fold pair", [classes[2]] * 2, False)]:
        pairs = [(rand((G, S, F_, T), dt), rand((G, S, F_, c), dt)) for _, G, F_, T, c, dt, _ in specs]
        c = specs[0][4]
        pos_p = path_pos(min(s[3] for s in specs), chunked)
        lim_full = torch.full((S,), c, device="cuda", dtype=torch.int32)
        lim = torch.randint(0, c + 1, (S,), device="cuda", generator=g, dtype=torch.int32)
        err = max(exact(pairs, pos_p, lim, label), exact(pairs, pos_p, lim_full, label))
        many = lambda: cw.windowed_write_many(pairs, pos_p, lim_full)  # noqa: E731
        singles = lambda: [cw.windowed_write_groups(a, u, pos_p, lim_full) for a, u in pairs]  # noqa: E731
        mt, st = kernel_ms(many), kernel_ms(singles)
        host = {}
        for name, fn in (("many", many), ("singles", singles)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            host[name] = (time.perf_counter() - t0) / 20 * 1e6  # wrapper(s) + launch(es), µs
            torch.cuda.synchronize()
        moved = nbytes(pairs)
        line = dict(case=label, pairs=len(pairs), max_abs_err=err, ms=mt["ms"], ms_cold=cold_ms(many, flush),
                    singles_ms=st["ms"], singles_ms_cold=cold_ms(singles, flush), bound_ms=moved / H100_BYTES * 1e3,
                    bytes=moved, kernels_per_call=mt.get("kernels_per_call"),
                    singles_kernels_per_call=st.get("kernels_per_call"), host_us_per_call=host["many"],
                    singles_host_us_per_call=host["singles"], event_ms=mt["event_ms"],
                    singles_event_ms=st["event_ms"])
        log("# k2 " + json.dumps(line))
        entry[("grouped" if chunked else "fold_pair") + "_ms"] = mt["ms"]
        entry[("grouped" if chunked else "fold_pair") + "_ms_cold"] = line["ms_cold"]
        del pairs
    del flush
    torch.cuda.empty_cache()
    return entry


def k3_phase(S: int):
    """History attention at [S, 20, 16, 64, 512] in bf16 and f32 against the
    plain version run in f32, and a pos = 0 row that must not see history."""
    from streamkit_tpu_torch.ops import stream_attention as sa

    B, H, c, hd, T = S, 20, 16, 64, 512
    g = torch.Generator(device="cuda").manual_seed(2)
    i8 = lambda *s: torch.randint(-127, 128, s, device="cuda", generator=g, dtype=torch.int8)  # noqa: E731
    sc = lambda *s: torch.rand(s, device="cuda", generator=g) * 0.02 + 0.001  # noqa: E731
    q32 = torch.randn(B, H, c, hd, device="cuda", generator=g) * 0.3
    kw = dict(k8=i8(B, H, hd, T), ks=sc(B, H, T), v8=i8(B, H, hd, T), vs=sc(B, H, T),
              ck8=i8(B, H, hd, c), cks=sc(B, H, c), cv8=i8(B, H, hd, c), cvs=sc(B, H, c))
    # a fresh row, a full history, and rows in between (the engine's mix)
    pos = torch.linspace(0, T, B, device="cuda").round().to(torch.int32)
    op = hd ** -0.25
    entry = None
    for dtype in (torch.bfloat16, torch.float32):
        qs = q32.to(dtype)
        out = sa.history_attention(qs, **kw, pos=pos, op_scale=op)
        torch.cuda.synchronize()
        ref = sa.history_attention_reference(qs.float(), **kw, pos=pos, op_scale=op)
        err = (out - ref).abs().max().item()
        if dtype == torch.float32:
            tol = 1e-4
        else:
            tol = 2 * (sa.history_attention_reference(qs, **kw, pos=pos, op_scale=op) - ref).abs().max().item()
        # history must not leak into a pos = 0 row
        junk = dict(kw, k8=torch.full_like(kw["k8"], 99), v8=torch.full_like(kw["v8"], -99))
        leak = (sa.history_attention(qs, **junk, pos=pos, op_scale=op) - out)[0].abs().max().item()
        line = dict(shape=[B, H, c, hd, T], dtype=str(dtype).split(".")[-1], max_abs_err=err, tol=tol,
                    pos0_leak=leak)
        if not math.isfinite(err) or err > tol or leak != 0.0:
            raise AssertionError(f"history_attention {dtype}: {line}")
        if dtype == torch.bfloat16:
            rows = pos.long()
            hist_cols = int(rows.sum())  # the kernel reads only the valid history columns
            nbytes = (qs.numel() * qs.element_size() + out.numel() * 4 + 4 * B
                      + H * hist_cols * (2 * hd + 8) + B * H * c * (2 * hd + 8))
            flops = 4 * H * c * hd * (hist_cols + B * c)
            t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES * 1e3
            kt = kernel_ms(lambda: sa.history_attention(qs, **kw, pos=pos, op_scale=op))
            pt = kernel_ms(lambda: sa.history_attention_reference(qs, **kw, pos=pos, op_scale=op), iters=10)
            ms, plain_ms = kt["ms"], pt["ms"]
            line.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=max(t_ops, t_bytes),
                        event_ms=kt["event_ms"], plain_event_ms=pt["event_ms"],
                        bound_by="operations" if t_ops >= t_bytes else "bytes", bytes=nbytes, flops=flops,
                        bound_share=max(t_ops, t_bytes) / ms)
            entry = {"name": "history_attention", "route": "cuda",
                     "source": "streamkit_tpu_torch/csrc/stream_attention.cu",
                     "replaces": "streamkit_tpu/ops/stream_attention.py:147",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": line["bound_ms"],
                     "bound_by": line["bound_by"], "library_ms": None}
        else:
            line.update(kernel_ms(lambda: sa.history_attention(qs, **kw, pos=pos, op_scale=op)))
        log("# k3 " + json.dumps(line))
    log("# k3 library: no single PyTorch call takes int8 K/V with per-column scales and the two masks")
    return entry


def k4_phase(S: int = 64):
    """The decode continuation's cross-attention at large-v3's [S, 20, 64,
    512] in bf16 and f32 against the plain version run in f32, with columns
    past each row's horizon that must change nothing; timed in bf16 beside
    its bound and the plain version at a live spread of horizons and with
    every column visible. The timed calls take 4 layers' caches in turn
    (4 x 84 MB), so the 50 MB L2 holds none of a call's bytes, as on the
    path, where 32 layers take turns."""
    from streamkit_tpu_torch.ops import decode_attention as da

    B, H, hd, T, layers = S, 20, 64, 512, 4
    g = torch.Generator(device="cuda").manual_seed(5)
    i8 = lambda *s: torch.randint(-127, 128, s, device="cuda", generator=g, dtype=torch.int8)  # noqa: E731
    sc = lambda *s: torch.rand(s, device="cuda", generator=g) * 0.02 + 0.001  # noqa: E731
    q32 = torch.randn(B, H, 1, hd, device="cuda", generator=g) * 0.3
    caches = [dict(k8=i8(B, H, hd, T), ks=sc(B, H, T), v8=i8(B, H, hd, T), vs=sc(B, H, T)) for _ in range(layers)]
    kw = caches[0]
    # live speech: segments of 0.2-4.2 s at 50 encoder columns a second, a
    # row not yet encoded and a full one
    live = torch.randint(10, 211, (B,), device="cuda", generator=g, dtype=torch.int32)
    live[:2] = torch.tensor([0, T], dtype=torch.int32)
    full = torch.full((B,), T, dtype=torch.int32, device="cuda")
    op = hd ** -0.25
    entry = {"name": "decode_cross_attention", "route": "cuda", "source": "streamkit_tpu_torch/csrc/decode_attention.cu",
             "replaces": "no TPU kernel: the plain expression of streamkit_tpu/models/whisper/streaming.py:740-742, "
                         "which XLA fuses", "library_ms": None}
    for dtype in (torch.bfloat16, torch.float32):
        qs = q32.to(dtype)
        for label, ep in (("live", live), ("full", full)):
            out = da.decode_cross_attention(qs, **kw, ep=ep, op_scale=op)
            torch.cuda.synchronize()
            ref = da.decode_cross_attention_reference(qs.float(), **kw, ep=ep, op_scale=op)
            err = (out - ref).abs().max().item()
            if dtype == torch.float32:
                tol = 1e-4
            else:
                tol = 2 * (da.decode_cross_attention_reference(qs, **kw, ep=ep, op_scale=op) - ref).abs().max().item()
            past = torch.arange(T, device="cuda")[None, None, :] >= torch.clamp(ep, min=1)[:, None, None]
            junk = dict(k8=kw["k8"].masked_fill(past[:, :, None, :], 99),
                        v8=kw["v8"].masked_fill(past[:, :, None, :], -99),
                        ks=kw["ks"].masked_fill(past, 7.0), vs=kw["vs"].masked_fill(past, 7.0))
            moved = (da.decode_cross_attention(qs, **junk, ep=ep, op_scale=op) - out).abs().max().item()
            line = dict(shape=[B, H, hd, T], dtype=str(dtype).split(".")[-1], horizons=label,
                        ep_mean=float(ep.float().mean()), max_abs_err=err, tol=tol, past_horizon_moved=moved)
            if not math.isfinite(err) or err > tol or moved != 0.0:
                raise AssertionError(f"decode_cross_attention {dtype}: {line}")
            if dtype == torch.bfloat16:
                cols = int(torch.clamp(ep, min=1).sum())  # the kernel reads only the visible columns
                nbytes = qs.numel() * qs.element_size() + out.numel() * 4 + 4 * B + H * cols * (2 * hd + 8)
                flops = 4 * H * hd * cols  # f32 on the CUDA cores
                t_ops, t_bytes = flops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES * 1e3
                turn = iter(range(1 << 30))
                kt = kernel_ms(lambda: da.decode_cross_attention(qs, **caches[next(turn) % layers], ep=ep,
                                                                 op_scale=op))
                pt = kernel_ms(lambda: da.decode_cross_attention_reference(qs, **caches[next(turn) % layers], ep=ep,
                                                                           op_scale=op), iters=10)
                line.update(ms=kt["ms"], plain_ms=pt["ms"], bound_ms=max(t_ops, t_bytes), event_ms=kt["event_ms"],
                            plain_event_ms=pt["event_ms"], plain_kernels_per_call=pt.get("kernels_per_call"),
                            bound_by="operations" if t_ops >= t_bytes else "bytes", bytes=nbytes, flops=flops,
                            bound_share=max(t_ops, t_bytes) / kt["ms"])
                suffix = "" if label == "live" else "_full"
                entry.update({"max_abs_err" + suffix: err, "ms" + suffix: kt["ms"], "plain_ms" + suffix: pt["ms"],
                              "bound_ms" + suffix: line["bound_ms"], "bound_by": line["bound_by"]})
            else:
                line.update(kernel_ms(lambda: da.decode_cross_attention(qs, **kw, ep=ep, op_scale=op)))
            log("# k4 " + json.dumps(line))
    log("# k4 library: no single PyTorch call takes int8 K/V with per-column scales and per-row horizons")
    del caches, kw
    torch.cuda.empty_cache()
    return entry


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
    reset_counts()
    tok_g, len_g = transcribe_window(gpu, cfg, audio, window_samples=window, max_tokens=12)
    counts = read_counts()
    launched = counts["flash_attention"]
    tok_c, len_c = transcribe_window(cpu, cfg, audio, window_samples=window, max_tokens=12)
    log(f"# context f32 cuda tokens {tok_g.tolist()} lengths {len_g.tolist()}; flash launches {launched}")
    if not (np.array_equal(tok_g, tok_c) and np.array_equal(len_g, len_c)):
        raise AssertionError(f"cuda tokens {tok_g.tolist()} != cpu tokens {tok_c.tolist()}")
    if counts != {**ZERO_LAUNCHES, "flash_attention": cfg.n_audio_layer}:
        raise AssertionError(f"expected {cfg.n_audio_layer} flash launches and no other, saw {counts}")


# ---------------------------------------------------------------------------
# 2c. fine-tuning: parallel/train.py through K1 and its backward kernels
# ---------------------------------------------------------------------------
TRAIN_LR = 1e-5  # large-v3 at a usual fine-tuning rate
SMALL_TRAIN = dict(n_mels=80, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2, n_vocab=512,
                   n_text_ctx=256, n_text_state=128, n_text_head=2, n_text_layer=2)


def train_batch(cfg, b: int, t: int, device: str, seed: int):
    """(mel, tokens_in, tokens_out, mask) from a seed: 30 s of random mel at
    Whisper's log-mel scale, random targets, every position counted."""
    rng = np.random.RandomState(seed)
    mel = torch.from_numpy((rng.randn(b, 2 * cfg.n_audio_ctx, cfg.n_mels) * 0.3).astype(np.float32))
    tin = torch.from_numpy(rng.randint(0, cfg.n_vocab, (b, t)))
    tout = torch.from_numpy(rng.randint(0, cfg.n_vocab, (b, t)))
    return tuple(x.to(device) for x in (mel, tin, tout, torch.ones(b, t)))


def train_launches(cfg) -> dict:
    """One train step's launches: K1 and each backward kernel once per
    encoder layer and once per cross-attention (the tokens take the gate)."""
    n = cfg.n_audio_layer + cfg.n_text_layer
    return {**ZERO_LAUNCHES, "flash_attention": n, "flash_attention_backward_preprocess": n,
            "flash_attention_backward_main": n}


def small_train_check() -> dict:
    """The small f32 config: 3 steps on the card against the same 3 on the
    CPU (losses, the first step's grads, the params), the launches of each
    card step, and a resume on the card (2 steps, save, load, 1 step) equal
    to the third step without the reload."""
    import tempfile

    from streamkit_tpu_torch.models.whisper import WhisperConfig, seeded_params
    from streamkit_tpu_torch.parallel import init_train_state, make_train_step
    from streamkit_tpu_torch.utils.checkpoint import load_train_state, save_train_state

    cfg, lr = WhisperConfig(**SMALL_TRAIN), 1e-3
    step = make_train_step(cfg, lr)
    report = {"losses": {}, "launches": []}
    grads, states = {}, {}
    # cuDNN's deterministic convolution algorithms, so the resumed step can
    # equal the straight one bit for bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for dev in ("cpu", "cuda"):
            batch = train_batch(cfg, 2, 256, dev, seed=3)
            state = init_train_state(seeded_params(cfg, device=dev), lr)
            losses = []
            for i in range(3):
                if dev == "cuda":
                    reset_counts()
                if i == 2 and dev == "cuda":  # the state after 2 steps, saved and loaded back
                    with tempfile.TemporaryDirectory() as tmp:
                        save_train_state(tmp, state)
                        resumed = load_train_state(tmp, state)
                state, loss = step(state, *batch)
                losses.append(loss.item())
                if dev == "cuda":
                    report["launches"].append(read_counts())
                if i == 0:
                    grads[dev] = {n: p.grad.detach().cpu() for n, p in state.params.named_parameters()}
            report["losses"][dev] = losses
            states[dev] = state
        resumed, loss_r = step(resumed, *batch)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    want = train_launches(cfg)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(report["losses"]["cuda"], report["losses"]["cpu"]))
    grad_err = max((grads["cuda"][n] - g).abs().max().item() / g.abs().max().item()
                   for n, g in grads["cpu"].items())
    diffs = [(a.detach().cpu() - b.detach()).abs() for a, b in
             zip(states["cuda"].params.parameters(), states["cpu"].params.parameters())]
    param_err = max(d.max().item() for d in diffs)
    near = sum(int((d <= 1e-6).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    resume_equal = loss_r.item() == report["losses"]["cuda"][2] and all(
        torch.equal(a, b) for a, b in zip(resumed.params.parameters(), states["cuda"].params.parameters()))
    report.update(loss_rel_err=loss_err, grad_err_of_leaf_max=grad_err, param_max_abs_err=param_err,
                  params_within_1e6=near, resume_bit_equal=resume_equal, expected_launches=want)
    log("# train small f32 " + json.dumps(report))
    # limits as the CPU tests hold the port to the JAX package: the loss
    # within 1e-5 relative, each grad leaf within 1e-4 of its largest |g|,
    # params within 3 lr with 99.9% of them within 1e-6
    if loss_err > 1e-5 or grad_err > 1e-4 or param_err > 3 * lr or near < 0.999:
        raise AssertionError(f"train step: card against CPU out of limits: {report}")
    if any(c != want for c in report["launches"]) or not resume_equal:
        raise AssertionError(f"train step: launches {report['launches']} (want {want}) or resume {resume_equal}")
    return report


def large_train_steps(state, step, batch, n: int, label: str):
    """``n`` steps at full width, each under the profiler (device time, idle
    share) with its launches counted from 0 and its peak memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    for _ in range(n):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            state, loss = step(state, *batch)
            loss = loss.item()  # waits for the step
            wall = time.monotonic() - t0
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        by_name = {}
        for e in kernels:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
        row = {"loss": loss, "wall_s": wall, "device_ms": device_ms, "idle_share": 1 - device_ms / (wall * 1e3),
               "kernels": len(kernels), "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": read_counts(), "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])}
        log(f"# train large-v3 {label} step " + json.dumps(row))
        out.append(row)
    return out, state


def train_phase() -> dict:
    """Fine-tuning through the port's ``parallel/train.py``: the small-config
    check, then Whisper large-v3 (random f32 weights from seed 0) at B = 2
    windows of 3000 mel frames and 256 tokens: 3 f32 steps on one batch (the
    loss finite and falling), then 2 steps from the params cast to bf16 (the
    loss finite). Returns the launches of the full-width run."""
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, seeded_params
    from streamkit_tpu_torch.parallel import init_train_state, make_train_step

    small = small_train_check()
    cfg = WHISPER_CONFIGS["large-v3"]
    t0 = time.monotonic()
    params = seeded_params(cfg, torch.float32, device="cuda")
    init_s = time.monotonic() - t0
    step = make_train_step(cfg, TRAIN_LR)
    batch = train_batch(cfg, 2, 256, "cuda", seed=11)
    f32, state = large_train_steps(init_train_state(params, TRAIN_LR), step, batch, 3, "f32")
    # bf16: the trained params cast, a fresh AdamW (the f32 moments freed first)
    del state
    for p in params.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    params.to(torch.bfloat16)
    batch = (batch[0].to(torch.bfloat16), *batch[1:])
    bf16, state = large_train_steps(init_train_state(params, TRAIN_LR), step, batch, 2, "bf16")
    del state, params, batch
    torch.cuda.empty_cache()
    want = train_launches(cfg)
    losses = [r["loss"] for r in f32 + bf16]
    log(f"# train large-v3: init {init_s:.1f} s; f32 losses {losses[:3]}, bf16 losses {losses[3:]}; "
        f"launches per step {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[2] < losses[1] < losses[0]:
        raise AssertionError(f"train large-v3: losses {losses} are not finite or do not fall over the f32 steps")
    if any(r["launches"] != want for r in f32 + bf16):
        raise AssertionError(f"train large-v3: launches {[r['launches'] for r in f32 + bf16]}, want {want} a step")
    total = {name: sum(r["launches"][name] for r in f32 + bf16) for name in ZERO_LAUNCHES}
    return {"small": small, "f32": f32, "bf16": bf16, "launches": total, "init_s": init_s}


# ---------------------------------------------------------------------------
# 2d. the learned VAD's trainer and evaluator
# ---------------------------------------------------------------------------
VAD_TRAIN_STEPS = 24
VAD_PROFILED = (1, VAD_TRAIN_STEPS // 2, VAD_TRAIN_STEPS - 1)  # the card's steps run under the profiler
# card against CPU, both f32 (TF32 off): cuBLAS and the CPU's BLAS sum in
# other orders, and 48 LSTM frames carry each rounding on, so a step's loss
# agrees to about 1e-6 relative; 1e-4 leaves room for the steps compounding
VAD_LOSS_RTOL = 1e-4
# Adam normalises each coordinate's step to about lr: one whose gradient
# is at rounding level can step either way, so the bound is 2 lr a step;
# all but a few must agree far closer
VAD_PARAM_NEAR, VAD_PARAM_NEAR_SHARE = 1e-5, 0.999
# a probability of the re-scored 8 s sample, card against CPU (250 frames
# of the same recurrence)
VAD_PROB_ATOL = 1e-4


def vad_train_steps(tv, batches, device: str) -> tuple:
    """The trainer from ``init_params(0)`` over ``batches`` on ``device`` →
    (params, per-step rows). On the card every step gives its host ms, peak
    memory and K1 / K2 / K3 launches (none: the VAD is no kernel of ours);
    the steps of ``VAD_PROFILED`` run under the profiler (CUDA activity
    only) for device ms, idle share and kernels: parsing a step's 9,600
    kernel events takes seconds, so not every step is profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(device)
    params, opt = tv.init_training(device)
    rows = []
    for it, batch in enumerate(batches):
        x = tv.to_device(batch, dev)
        if device != "cuda":
            t0 = time.monotonic()
            loss, acc = tv.train_step(params, opt, *x)
            rows.append({"loss": loss.item(), "acc": acc.item(), "host_ms": (time.monotonic() - t0) * 1e3})
            continue
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) if it in VAD_PROFILED else contextlib.nullcontext() as prof:
            t0 = time.monotonic()
            loss, acc = tv.train_step(params, opt, *x)
            loss, acc = loss.item(), acc.item()  # waits for the step
            wall = time.monotonic() - t0
        row = {"step": it, "loss": loss, "acc": acc, "host_ms": wall * 1e3,
               "peak_mb": torch.cuda.max_memory_allocated() / 2**20, "launches": read_counts()}
        if prof is not None:
            ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            busy = sum(e.time_range.elapsed_us() for e in ks) / 1e3
            row.update(device_ms=busy, idle_share=max(0.0, 1.0 - busy / (wall * 1e3)), kernels=len(ks))
        rows.append(row)
    return params, rows


def vad_train_phase() -> dict:
    """``# vad train``: the port's VAD trainer (``tools/train_vad.py``) from
    ``init_params(0)``, batch 64 of 48-frame clips, ``VAD_TRAIN_STEPS``
    steps on the card, then the same steps on the CPU: each step's loss and
    the final params held within the VAD_* limits. The card's weights are
    saved with ``save_params`` to a temporary directory and re-score
    ``samples/media/speech_8s.wav`` through the evaluator's ``evaluate`` on
    the card and on the CPU: probabilities within ``VAD_PROB_ATOL``, the
    same ``SpeechSegmenter`` segments. The trainer and the evaluator touch
    no process-wide VAD state; the phase checks that the backend, its
    weights, ``SK_VAD_BACKEND`` and the bundled file are as they were."""
    import hashlib
    import statistics
    import tempfile

    from streamkit_tpu_torch.models import silero_vad as sv
    from streamkit_tpu_torch.ops import vad as V
    from streamkit_tpu_torch.tools import eval_vad
    from streamkit_tpu_torch.tools import train_vad as tv

    def bundled_digest() -> str:
        with open(tv.BUNDLED_WEIGHTS, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = (V.vad_backend(), id(V._LEARNED_PARAMS), os.environ.get("SK_VAD_BACKEND"), bundled_digest())
    real = tv._load_real()  # prints which data and why
    log(f"# vad train data: {'real speech (' + tv._REAL_SAMPLE + ') and synthetic' if real else 'synthetic only'}")
    t0 = time.monotonic()
    batches = [tv.make_dataset(tv.BATCH, seed=it) for it in range(VAD_TRAIN_STEPS)]
    data_s = time.monotonic() - t0
    t0 = time.monotonic()
    cuda_params, cuda_rows = vad_train_steps(tv, batches, "cuda")
    cuda_s = time.monotonic() - t0
    t0 = time.monotonic()
    cpu_params, cpu_rows = vad_train_steps(tv, batches, "cpu")
    cpu_s = time.monotonic() - t0
    loss_err = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(cuda_rows, cpu_rows))
    diffs = [(cuda_params[k].detach().cpu() - cpu_params[k].detach()).abs() for k in cpu_params]
    param_err = max(d.max().item() for d in diffs)
    near = sum(int((d <= VAD_PARAM_NEAR).sum()) for d in diffs) / sum(d.numel() for d in diffs)
    moved = max((cuda_params[k].detach().cpu() - torch.from_numpy(v)).abs().max().item()
                for k, v in sv.init_params(0).items())
    warm, profiled = cuda_rows[1:], [r for r in cuda_rows if "device_ms" in r]
    report = {
        "steps": VAD_TRAIN_STEPS, "batch": tv.BATCH, "clip_frames": tv.CLIP_FRAMES, "data": "real+synthetic" if real
        else "synthetic", "data_s": data_s, "cuda_s": cuda_s, "cpu_s": cpu_s,
        "losses_cuda": [r["loss"] for r in cuda_rows], "losses_cpu": [r["loss"] for r in cpu_rows],
        "loss_rel_err": loss_err, "param_max_abs_err": param_err, "params_within_near": near, "moved": moved,
        "first_step_host_ms": cuda_rows[0]["host_ms"],
        "step_median": {**{k: statistics.median(r[k] for r in warm) for k in ("host_ms", "peak_mb")},
                        **{k: statistics.median(r[k] for r in profiled) for k in ("device_ms", "idle_share", "kernels")}},
        "step_range": {"host_ms": [min(r["host_ms"] for r in warm), max(r["host_ms"] for r in warm)],
                       **{k: [min(r[k] for r in profiled), max(r[k] for r in profiled)]
                          for k in ("device_ms", "idle_share", "kernels")}},
        "profiled": [{k: r[k] for k in ("step", "host_ms", "device_ms", "idle_share", "kernels", "peak_mb")}
                     for r in profiled],
        "cpu_step_median_ms": statistics.median(r["host_ms"] for r in cpu_rows[1:]),
        "launches": {name: sum(r["launches"][name] for r in cuda_rows) for name in ZERO_LAUNCHES},
    }
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vad_trained.npz")
        sv.save_params(cuda_params, path)
        with open(os.path.join(SAMPLES, "media", "speech_8s.wav"), "rb") as f:  # 16 kHz mono 16-bit
            audio = (wav_samples(f.read()) / 32768.0).astype(np.float32)
        scored = {}
        for dev in ("cuda", "cpu"):
            t0 = time.monotonic()
            scored[dev] = eval_vad.evaluate(audio, device=dev, weights=path)
            scored[dev]["wall_s"] = time.monotonic() - t0
    prob_err = {b: float(np.abs(scored["cuda"]["backends"][b]["probs"] - scored["cpu"]["backends"][b]["probs"]).max())
                for b in ("learned", "spectral")}
    same_segments = all(scored["cuda"]["backends"][b]["segments"] == scored["cpu"]["backends"][b]["segments"]
                        for b in ("learned", "spectral"))
    after = (V.vad_backend(), id(V._LEARNED_PARAMS), os.environ.get("SK_VAD_BACKEND"), bundled_digest())
    report["rescore"] = {
        "frames": scored["cuda"]["frames"], "prob_max_abs_err": prob_err, "same_segments": same_segments,
        "segments": {b: scored["cuda"]["backends"][b]["segments"] for b in ("learned", "spectral")},
        "learned": {k: scored["cuda"]["backends"]["learned"][k] for k in ("loud_decile", "quiet_decile", "over_half")},
        "recall_by_quintile": scored["cuda"]["recall_by_quintile"],
        "wall_s": {dev: scored[dev]["wall_s"] for dev in scored},
    }
    report["process_state_kept"] = after == before
    log("# vad train " + json.dumps(report))
    finite = all(math.isfinite(r["loss"]) for r in cuda_rows + cpu_rows)
    if not finite or loss_err > VAD_LOSS_RTOL or param_err > 2 * tv.LR * VAD_TRAIN_STEPS \
            or near < VAD_PARAM_NEAR_SHARE or moved < tv.LR:
        raise AssertionError(f"vad train: card against CPU out of limits: {report}")
    if max(prob_err.values()) > VAD_PROB_ATOL or not same_segments:
        raise AssertionError(f"vad train: re-scored speech_8s.wav differs between card and CPU: {report['rescore']}")
    if report["launches"] != ZERO_LAUNCHES:
        raise AssertionError(f"vad train launched kernels of ours: {report['launches']}")
    if after != before:
        raise AssertionError(f"vad train changed the process's VAD: {before} -> {after}")
    return report


# ---------------------------------------------------------------------------
# 3. main path: oneshot pipelines through the port's registry and WhisperNode
# ---------------------------------------------------------------------------
def session_audio(rng, secs: float) -> np.ndarray:
    """Syllable-rate bursts of a few harmonics over low noise."""
    n = int(secs * SR)
    t = np.arange(n) / SR
    f0 = rng.uniform(90, 220)
    voiced = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 5) * t), 0, None)
    return (0.2 * voiced * env + 0.01 * rng.randn(n)).astype(np.float32)


def wav_body(audio: np.ndarray) -> bytes:
    """16 kHz mono s16 WAV bytes: the body of a ``POST /api/v1/process``."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _crc(data: bytes, poly: int, bits: int) -> int:
    """FLAC's frame CRCs: CRC-8 (poly 0x07) of the header, CRC-16 (0x8005)
    of the frame, MSB first, initial value 0."""
    top, mask, crc = 1 << (bits - 1), (1 << bits) - 1, 0
    for b in data:
        crc ^= b << (bits - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & mask if crc & top else (crc << 1) & mask
    return crc


def flac_verbatim(pcm16: np.ndarray, rate: int = SR, block: int = 4096) -> bytes:
    """Mono 16-bit FLAC of ``pcm16`` with verbatim subframes: the minimal
    encoder of ``tests/test_av_decoder.py``, taking the int16 samples
    themselves, so the decoder must return the WAV body's samples exactly."""
    total = len(pcm16)
    # STREAMINFO: block sizes, frame sizes unknown, rate, mono, 16 bits, total, no MD5
    info = (block << 128 | block << 112 | rate << 44 | 15 << 36 | total).to_bytes(18, "big") + bytes(16)
    out = bytearray(b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info)
    s16 = np.asarray(pcm16, dtype=">i2")
    for idx, start in enumerate(range(0, total, block)):
        chunk = s16[start : start + block]
        # sync, fixed block size; block-size code 7 (16-bit size - 1 follows), rate from
        # STREAMINFO, mono, 16 bits; the frame number UTF-8 coded
        head = bytes([0xFF, 0xF8, 0x70, 0x08]) + chr(idx).encode("utf-8") + (len(chunk) - 1).to_bytes(2, "big")
        head += bytes([_crc(head, 0x07, 8)])
        frame = head + b"\x02" + chunk.tobytes()  # subframe header: verbatim, no wasted bits
        out += frame + _crc(frame, 0x8005, 16).to_bytes(2, "big")
    return bytes(out)


def stt_doc(whisper_params: dict) -> dict:
    """``http_input → wav demuxer → whisper → json_serialize → http_output``."""
    return {"name": "speech-to-text", "mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"},
        {"kind": "containers::wav::demuxer"},
        {"kind": "plugin::native::whisper", "params": whisper_params},
        {"kind": "core::json_serialize", "params": {"newline_delimited": True}},
        {"kind": "streamkit::http_output", "params": {"content_type": "application/json"}},
    ]}


def stt_pipeline(whisper_params: dict):
    """:func:`stt_doc`, compiled as the server compiles a request's pipeline."""
    from streamkit_tpu_torch.api import compile_pipeline_dict

    return compile_pipeline_dict(stt_doc(whisper_params))


@contextlib.contextmanager
def knobs(**values):
    """Set the node's ``SK_*`` environment knobs for one path, then restore
    them (later paths size their own stream tables)."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def node_registry(device: str):
    from streamkit_tpu_torch.core import NodeRegistry
    from streamkit_tpu_torch.nodes import register_nodes

    reg = NodeRegistry()
    register_nodes(reg, device=device)
    return reg


async def oneshot(registry, pipeline, body: bytes, resources, batcher):
    """One request → (Transcription lines, wall seconds)."""
    from streamkit_tpu_torch.engine import run_oneshot_pipeline

    async def stream():
        for i in range(0, len(body), 1 << 16):
            yield body[i : i + (1 << 16)]

    t0 = time.monotonic()
    result = await run_oneshot_pipeline(registry, pipeline, input_stream=stream(), resources=resources,
                                        batcher=batcher)
    out = await result.read_all()
    wall = time.monotonic() - t0
    if result.content_type != "application/json":
        raise AssertionError(f"response content type {result.content_type}")
    return transcripts(out), wall


def transcripts(body: bytes) -> list:
    """The response's Transcription lines. The JSON carries no ``is_final``;
    the node's order gives it: a segment's final is the last line with its
    start, every earlier one is a partial."""
    rows = []
    for line in body.decode().splitlines():
        if not line.strip():
            continue
        tr = json.loads(line)["Transcription"]
        (seg,) = tr["segments"]
        rows.append({"text": tr["text"], "language": tr["language"], "start_ms": seg["start_time_ms"],
                     "end_ms": seg["end_time_ms"], "confidence": seg["confidence"]})
    last = {r["start_ms"]: i for i, r in enumerate(rows)}
    for i, r in enumerate(rows):
        r["is_final"] = last[r["start_ms"]] == i
    return rows


def check_transcripts(rows: list, secs: float, label: str, partials: bool = False) -> None:
    from streamkit_tpu_torch.models.whisper import WHISPER_LANGUAGES

    finals = [r for r in rows if r["is_final"]]
    ok = bool(finals) and (not partials or len(finals) < len(rows))
    for r in rows:
        conf = r["confidence"]
        ok = ok and r["text"] != "" and r["language"] in WHISPER_LANGUAGES
        ok = ok and 0 <= r["start_ms"] < r["end_ms"] <= secs * 1000 + 64
        ok = ok and (conf is None or (math.isfinite(conf) and 0.0 < conf <= 1.0))
    if not ok:
        raise AssertionError(f"{label}: bad transcripts {rows}")


def show(rows: list, label: str) -> None:
    for r in rows:
        log(f"# {label} " + json.dumps(dict(r, text=r["text"][:96] + ("…" if len(r["text"]) > 96 else ""))))


def flash_per_encode() -> int:
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS

    return WHISPER_CONFIGS["large-v3"].n_audio_layer


def cross_per_call(layers: int = 0) -> int:
    """K4 launches per fused call: one per decoder layer (large-v3's by
    default) and decode step (``SK_STREAM_STEPS``, as the node and the
    engine read it)."""
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS

    return (layers or WHISPER_CONFIGS["large-v3"].n_text_layer) * int(os.environ.get("SK_STREAM_STEPS", "3"))


def kind_calls(stats: dict, prefix: str) -> int:
    return sum(v["calls"] for k, v in stats["kinds"].items() if k.startswith(prefix))


SEGMENT_WALLS = {}  # audio seconds → the batched request's in-process wall (phase 4), for the server phase


def segment_final_path(resources):
    """Path 3: four concurrent oneshot requests through one ``DeviceBatcher``
    (the node's ``vad_ring`` / ``whisper_detect`` / ``whisper_ring`` kinds),
    then a fifth without a batcher (``transcribe_window``). Returns the
    launch counts of the batched run and of the whole path."""
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.nodes.ml.whisper_node import warmup_batched_kinds

    registry = node_registry("cuda")
    pipeline = stt_pipeline({"model_size": "large-v3", "dtype": "bfloat16", "language": "auto"})
    rng = np.random.RandomState(0)
    secs = (10.0, 13.0, 16.0, 19.0)
    sessions = [session_audio(rng, s) for s in secs]
    bodies = [wav_body(a) for a in sessions]

    async def run():
        batcher = DeviceBatcher(device="cuda")
        # a short silent request: the node loads the model into the shared
        # cache and registers its kinds; then every kind is warmed
        t0 = time.monotonic()
        await oneshot(registry, pipeline, wav_body(np.zeros(SR, np.float32)), resources, batcher)
        log(f"# warm request (model load, kind registration) {time.monotonic() - t0:.1f} s")
        t0 = time.monotonic()
        warmed = await warmup_batched_kinds(batcher, sweep_to=0)
        log(f"# warmed {warmed} in {time.monotonic() - t0:.1f} s")
        for name in batcher.registered_kinds():
            if name.startswith(("whisper_ring:", "whisper_detect:")):
                batcher.set_expected(name, len(bodies))  # the four finals batch
        before = batcher.stats()
        reset_counts()  # counts from here to the end of this path
        t0 = time.monotonic()
        out = await asyncio.gather(*(oneshot(registry, pipeline, b, resources, batcher) for b in bodies))
        t_batched = time.monotonic() - t0
        counts = read_counts()
        stats = batcher.stats()
        batcher.stop()
        t0 = time.monotonic()
        rows_w, wall_w = await oneshot(registry, pipeline, bodies[0], resources, None)
        t_window = time.monotonic() - t0
        return before, stats, out, counts, rows_w, wall_w, t_batched, t_window

    with knobs(SK_STT_GATHER_MS=STT_GATHER_MS):
        before, stats, out, counts_b, rows_w, wall_w, t_batched, t_window = asyncio.run(run())
    counts = read_counts()
    for i, ((rows, wall), s) in enumerate(zip(out, secs)):
        SEGMENT_WALLS[s] = wall
        log("# request " + json.dumps({"audio_s": s, "wall_s": wall, "lines": len(rows), "batcher": True}))
        show(rows, f"request {i} transcription")
        check_transcripts(rows, s, f"request {i}")
        if any(r["confidence"] is None for r in rows if r["is_final"]):
            raise AssertionError(f"request {i}: a ring-decode final without a confidence")
    log("# request " + json.dumps({"audio_s": secs[0], "wall_s": wall_w, "lines": len(rows_w), "batcher": False}))
    show(rows_w, "request 4 (no batcher) transcription")
    check_transcripts(rows_w, secs[0], "request 4 (no batcher)")
    log("# batcher " + json.dumps(stats))
    log(f"# segment-final path wall: 4 batched requests {t_batched * 1e3:.1f} ms, "
        f"unbatched request {t_window * 1e3:.1f} ms")

    per = flash_per_encode()
    encodes = sum(kind_calls(stats, p) - kind_calls(before, p) for p in ("whisper_ring:", "whisper_detect:"))
    # unbatched: language detection on the first segment, one decode per final
    window_encodes = 1 + sum(r["is_final"] for r in rows_w)
    want_b, want = per * encodes, per * (encodes + window_encodes)
    log(f"# flash_attention launches {counts['flash_attention']} over {encodes} batched + {window_encodes} "
        f"unbatched encodes (expected {want}; batched {counts_b['flash_attention']}, expected {want_b})")
    if (counts_b != {**ZERO_LAUNCHES, "flash_attention": want_b} or want_b == 0
            or counts != {**ZERO_LAUNCHES, "flash_attention": want}):
        raise AssertionError(f"segment-final path launches {counts} (batched {counts_b}), "
                             f"expected {want} flash_attention only")
    return counts


def live_captions_path(resources, n_sessions: int = 2, speech_s: float = 8.0):
    """Path 3b: concurrent oneshot requests in the shape of
    ``samples/pipelines/system/live_captions.yml`` (WAV in, JSON out): live
    partials from the fused streaming step, finals from the stream. Returns
    the launch counts of its run."""
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    registry = node_registry("cuda")
    pipeline = stt_pipeline({"model_size": "large-v3", "language": "en", "dtype": "bfloat16",
                             "partial_transcripts": True, "partial_interval_ms": 250, "streaming_partials": True,
                             "final_from_stream": True, "vad_block_frames": 8, "min_silence_duration_ms": 700,
                             "max_segment_duration_secs": 30.0})
    secs = speech_s + 1.0
    bodies = [wav_body(np.concatenate([synth_speech(speech_s, seed=i), np.zeros(SR, np.float32)]))
              for i in range(n_sessions)]

    async def run():
        batcher = DeviceBatcher(device="cuda")
        reset_counts()  # counts from here to the end of this path
        t0 = time.monotonic()
        out = await asyncio.gather(*(oneshot(registry, pipeline, b, resources, batcher) for b in bodies))
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
        counts = read_counts()
        batcher.stop()
        return out, counts, batcher.stats(), wall

    # the node's stream-table knobs: a row per request and one fused call per
    # block as soon as every request's block has arrived
    with knobs(SK_STREAM_SLOTS=max(4, n_sessions), SK_STREAM_PAD=n_sessions):
        out, counts, stats, wall = asyncio.run(run())
    for i, (rows, w) in enumerate(out):
        n_final = sum(r["is_final"] for r in rows)
        log("# live request " + json.dumps({"audio_s": secs, "wall_s": w, "partials": len(rows) - n_final,
                                            "finals": n_final}))
        show([r for r in rows if r["is_final"]], f"live request {i} final")
        check_transcripts(rows, secs, f"live request {i}", partials=True)
    calls = kind_calls(stats, "stream_step:")
    want = {**ZERO_LAUNCHES, "flash_attention": flash_per_encode() * (kind_calls(stats, "whisper_ring:")
                                                      + kind_calls(stats, "whisper_detect:")),
            "windowed_write": 2 * calls, "history_attention": flash_per_encode() * calls,
            "decode_cross_attention": cross_per_call() * calls}
    log("# live batcher " + json.dumps(stats))
    log(f"# live-captions path: {calls} fused calls, launches {counts}, expected {want}; wall {wall:.1f} s")
    if counts != want or calls == 0:
        raise AssertionError(f"live-captions path launched {counts}, expected {want}")
    return counts


def node_context_phase():
    """The node on ``cuda`` against the node on ``cpu``: a small f32 config
    whose encoder takes K1 (1500 positions, head dim 64), the same pipeline
    and WAV, with and without a batcher (the second with ``language:
    auto``). The Transcription lines must agree: text, language, segment
    bounds and finality exactly, confidence within 1e-4."""
    from streamkit_tpu_torch.core import ResourceManager
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    WHISPER_CONFIGS["node-check"] = WhisperConfig(
        n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2, n_vocab=51865,
        n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2)
    audio = np.concatenate([np.zeros(SR // 2, np.float32), synth_speech(2.5, seed=21), np.zeros(SR, np.float32)])
    body = wav_body(audio)
    report = {}
    for label, params, batched in [("window", {"language": "en"}, False), ("ring", {"language": "auto"}, True)]:
        pipeline = stt_pipeline(dict(model_size="node-check", dtype="float32", max_tokens=12, **params))
        got, k1 = {}, {}
        for device in ("cuda", "cpu"):
            async def run(device=device):
                batcher = DeviceBatcher(device=device) if batched else None
                rows, _ = await oneshot(node_registry(device), pipeline, body, ResourceManager(), batcher)
                if batcher is not None:
                    batcher.stop()
                return rows

            reset_counts()
            got[device] = asyncio.run(run())
            k1[device] = read_counts()
        g, c = got["cuda"], got["cpu"]
        same = len(g) == len(c) and all(
            {k: v for k, v in a.items() if k != "confidence"} == {k: v for k, v in b.items() if k != "confidence"}
            and (a["confidence"] is None) == (b["confidence"] is None)
            and (a["confidence"] is None or abs(a["confidence"] - b["confidence"]) <= 1e-4)
            for a, b in zip(g, c))
        report[label] = {"lines": len(g), "rows": g, "flash_launches": {d: c["flash_attention"] for d, c in k1.items()}}
        check_transcripts(g, len(audio) / SR, f"node context {label}")
        n = k1["cuda"]["flash_attention"]
        if not same or n == 0 or k1["cuda"] != {**ZERO_LAUNCHES, "flash_attention": n} or k1["cpu"] != ZERO_LAUNCHES:
            raise AssertionError(f"node context {label}: cuda {g} != cpu {c} (K1 launches {k1})")
    WHISPER_CONFIGS.pop("node-check")
    log("# node context " + json.dumps(report))


# ---------------------------------------------------------------------------
# 2b. the streaming table: cuda == cpu on a small f32 config through K2, K3, K4
# ---------------------------------------------------------------------------
def stream_context_phase():
    from streamkit_tpu_torch.engine import SessionAudioRing
    from streamkit_tpu_torch.models.whisper import StreamTable, WhisperConfig, init_params
    from streamkit_tpu_torch.models.whisper.streaming import CHUNK_SAMPLES, RIGHT_CTX
    from streamkit_tpu_torch.ops.vad import VAD_FRAME
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    cfg = WhisperConfig(n_mels=80, n_audio_ctx=256, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                        n_vocab=51865, n_text_ctx=32, n_text_state=128, n_text_head=2, n_text_layer=2)
    S, n_steps, block = 3, 6, 8 * VAD_FRAME
    prefix = np.asarray([cfg.token_sot, cfg.token_language(0), cfg.token_transcribe, cfg.token_no_timestamps])
    audio = np.stack([synth_speech(n_steps * block / SR + 0.1, seed=s)[: n_steps * block] for s in range(S)])

    def run(device, params):
        ring = SessionAudioRing(max_slots=S + 1, ring_samples=1 << 16, device=device)
        for k in range(S):
            ring.alloc()
        tbl = StreamTable(cfg, torch.float32, max_slots=S, enc_t=256, dec_t=32, kv_int8=True, device=device)
        tip, probs = 0, []
        for step in range(n_steps):
            written = step * block
            n_req = max(0, min((written + block - RIGHT_CTX - tip) // CHUNK_SAMPLES, 2))
            meta = np.stack([np.concatenate([[s, s, written, tip, n_req, int(step > 0), int(step == 0)], prefix])
                             for s in range(S)]).astype(np.int32)
            frames = audio[:, written : written + block].reshape(S, 8, VAD_FRAME)
            probs.append(tbl.step(params, ring, meta, None, None, None, None, None, frames, max_steps=3)[0].cpu())
            tip += n_req * CHUNK_SAMPLES
        return tbl, torch.cat(probs, 1)

    def make():
        p = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
        with torch.no_grad():  # sharper cross-attention: the greedy path follows the audio
            for layer in p.dec.layers:
                layer.xattn.q.w.mul_(10.0)
                layer.xattn.k.w.mul_(10.0)
                layer.xattn.o.w.mul_(3.0)
        return p

    cpu, gpu = make(), make().to("cuda")
    reset_counts()
    tg, pg = run("cuda", gpu)
    torch.cuda.synchronize()
    counts = read_counts()
    tc, pc = run("cpu", cpu)
    report = {"tokens": tg._tokens.tolist(), "n_tok": tg._n_tok.tolist(), "enc_pos": tg._enc_pos.tolist(),
              "launches": counts, "vad_max_abs_err": (pg - pc).abs().max().item()}
    for name in ("_tokens", "_n_tok", "_fed", "_enc_pos"):
        if not torch.equal(getattr(tg, name).cpu(), getattr(tc, name)):
            raise AssertionError(f"stream context: {name} differs between cuda and cpu: {report}")
    # limits: int8 codes off by at most one on at most 0.1% of entries,
    # scales and the f32 decoder caches within 1e-4
    for w in ("enc_k", "enc_v", "xk", "xv", "dec_k", "dec_v"):
        a, b = tg.cache_view(w), tc.cache_view(w)
        if isinstance(a, tuple):
            d = np.abs(a[0].astype(np.int32) - b[0].astype(np.int32))
            report[w] = {"codes_off": float((d > 0).mean()), "max_code_diff": int(d.max()),
                         "scale_max_rel": float((np.abs(a[1] - b[1]) / np.maximum(b[1], 1e-12)).max())}
            ok = d.max() <= 1 and (d > 0).mean() <= 1e-3 and report[w]["scale_max_rel"] <= 1e-4
        else:
            report[w] = {"max_abs_err": float(np.abs(a - b).max())}
            ok = report[w]["max_abs_err"] <= 1e-4
        if not ok:
            raise AssertionError(f"stream context: {w} differs between cuda and cpu: {report}")
    want = {**ZERO_LAUNCHES, "windowed_write": 2 * n_steps, "history_attention": cfg.n_audio_layer * n_steps,
            "decode_cross_attention": cfg.n_text_layer * 3 * n_steps}
    log("# stream context " + json.dumps(report))
    if report["vad_max_abs_err"] > 1e-4 or counts != want or int(tg._n_tok.min()) <= 4:
        raise AssertionError(f"stream context: launches {counts} (want {want}), {report}")


# ---------------------------------------------------------------------------
# 4. live-partials path: SttServingEngine at large-v3 width
# ---------------------------------------------------------------------------
async def run_engine(final_mode: str, n_sessions: int, speech_s: float, seed0: int, mesh=None,
                     model_size: str = "large-v3", dtype: str = "bfloat16", resources=None):
    from streamkit_tpu_torch.engine import SttServingEngine
    from streamkit_tpu_torch.utils.tracing import get_tracer

    eng = SttServingEngine(model_size=model_size, dtype=dtype, max_sessions=n_sessions,
                           final_mode=final_mode, device="cuda", mesh=mesh, resources=resources)
    t0 = time.monotonic()
    await eng.start()
    t_start = time.monotonic() - t0
    # the fused calls' walls: the batcher's call spans of the stream kind
    tracer = get_tracer()
    tracer.drain()
    tracer.max_buffered, dropped0 = max(tracer.max_buffered, 1 << 18), tracer.dropped
    tracer.enable()
    try:
        events, t_serve = await serve_sessions(eng, n_sessions, speech_s, seed0)
    finally:
        tracer.disable()
    call_walls = [(sp.end_ns - sp.start_ns) / 1e9 for sp in tracer.drain()
                  if sp.name == "batcher.call" and sp.attributes["kind"] == eng._sstep_kind]
    if tracer.dropped != dropped0:
        raise AssertionError(f"the tracer dropped {tracer.dropped - dropped0} spans of the engine run")
    stats = eng.batcher.stats()
    out = dict(mode=final_mode, sessions=n_sessions, start_s=t_start, serve_s=t_serve, stats=stats,
               finals_stream=eng.finals_stream, finals_fallback=eng.finals_fallback, sstep_kind=eng._sstep_kind,
               call_walls=call_walls, mesh_calls=eng.mesh_calls,
               rows_held=eng._tbl.max_slots - len(eng._tbl._free))
    del eng
    torch.cuda.empty_cache()
    return events, out


async def serve_sessions(eng, n_sessions: int, speech_s: float, seed0: int):
    """Feed ``n_sessions`` sessions of synthetic speech at 10x real time
    until every block is served, then close them and stop the engine →
    (events by session, serve seconds)."""
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    events = {i: [] for i in range(n_sessions)}
    sids = [eng.open_session(lambda ev, i=i: events[i].append(ev)) for i in range(n_sessions)]
    audio = [np.concatenate([synth_speech(speech_s, seed=seed0 + i), np.zeros(SR, np.float32)])
             for i in range(n_sessions)]
    t0 = time.monotonic()
    for off in range(0, audio[0].size, SR // 2):  # 0.5 s pieces every 50 ms: 10x real time
        for i, sid in enumerate(sids):
            eng.push(sid, audio[i][off : off + SR // 2])
        await asyncio.sleep(0.05)
    deadline = time.monotonic() + 300
    n_blocks = audio[0].size // eng.block_samples
    while time.monotonic() < deadline:
        done = eng.batcher.stats()["kinds"].get(eng._sstep_kind, {}).get("items", 0) >= n_blocks * n_sessions
        if done and all(s.q.empty() and not s.processing for s in eng._sessions.values()):
            break
        await asyncio.sleep(0.1)
    t_serve = time.monotonic() - t0
    for sid in sids:
        eng.close_session(sid)
    await eng.stop()
    return events, t_serve


def check_events(events, mode):
    for i, evs in events.items():
        types = [e["type"] for e in evs]
        seqs = [e["seq"] for e in evs]
        ok = ("speech_start" in types and "final" in types and ("partial" in types or mode == "exact")
              and seqs == sorted(seqs))
        texts = [e for e in evs if "text" in e]
        ok = ok and [e["seq"] for e in texts] == list(range(len(texts)))
        ok = ok and all(e["end_ms"] > e["start_ms"] >= 0 for e in texts if e["type"] == "final")
        log(f"# {mode} session {i}: " + json.dumps({t: types.count(t) for t in sorted(set(types))}))
        if not ok:
            raise AssertionError(f"{mode} session {i}: bad event flow {evs}")


def live_partials_path(resources, cfg_layers: int = 32):
    """Path 4, both engines on ``resources``, which the ``WhisperNode``
    paths filled: the engines take that model (one build of large-v3, not
    two). Returns the launch counts of its run."""
    builds = resources.misses
    reset_counts()  # counts from here to the end of this path
    t0 = time.monotonic()
    ev_s, out_s = asyncio.run(run_engine("stream", 8, 8.0, seed0=0, resources=resources))
    ev_x, out_x = asyncio.run(run_engine("exact", 2, 8.0, seed0=100, resources=resources))
    torch.cuda.synchronize()
    counts = read_counts()
    t_path = time.monotonic() - t0
    shared = {"builds": resources.misses, "hits": resources.hits, "entries": resources.stats()["entries"],
              "engine_start_s": [out_s["start_s"], out_x["start_s"]]}
    log("# shared model " + json.dumps(shared))
    if builds != 1 or resources.misses != 1:
        raise AssertionError(f"shared model: {resources.misses} builds of large-v3 (node and engines), expected 1")
    check_events(ev_s, "stream")
    check_events(ev_x, "exact")
    calls = 0
    flash_encodes = 0
    for out in (out_s, out_x):
        kinds = out["stats"]["kinds"]
        step = kinds[out["sstep_kind"]]
        calls += step["calls"]
        # an exact-final ring decode of >= 8 s has >= 256 encoder positions: K1
        flash_encodes += sum(v["calls"] for k, v in kinds.items()
                             if k.startswith("whisper_ring:") and int(k.rsplit(":", 1)[1]) >= 8 * SR)
        walls = out["call_walls"]
        log(f"# {out['mode']} engine " + json.dumps({
            "start_s": out["start_s"], "serve_s": out["serve_s"], "fused_calls": step["calls"],
            "fused_items": step["items"], "fused_mean_batch": step["items"] / max(step["calls"], 1),
            "fused_call_ms_mean": 1e3 * float(np.mean(walls)), "fused_call_ms_median": 1e3 * float(np.median(walls)),
            "fused_call_ms_max": 1e3 * float(np.max(walls)), "finals_stream": out["finals_stream"],
            "finals_fallback": out["finals_fallback"], "batcher": out["stats"]}))
    want = {**ZERO_LAUNCHES, "flash_attention": cfg_layers * flash_encodes, "windowed_write": 2 * calls,
            "history_attention": cfg_layers * calls, "decode_cross_attention": cross_per_call(cfg_layers) * calls}
    log(f"# live-partials path: launches {counts}, expected {want}; wall {t_path:.1f} s")
    if counts != want or calls == 0:
        raise AssertionError(f"live-partials path launched {counts}, expected {want}")
    return counts


def profile_fused_step(S: int = 8, warm: int = 4, steps: int = 3):
    """Where one fused step's time goes at the live-partials path's shape
    (large-v3 bf16, S = 8 slots, every row speaking): host wall per call
    against the device's kernel time, by kernel."""
    from streamkit_tpu_torch.engine import SessionAudioRing
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, StreamTable, init_params
    from streamkit_tpu_torch.models.whisper.streaming import CHUNK_SAMPLES, RIGHT_CTX
    from streamkit_tpu_torch.ops.vad import VAD_FRAME
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    cfg = WHISPER_CONFIGS["large-v3"]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), torch.bfloat16, device="cuda")
    ring = SessionAudioRing(max_slots=S, device="cuda")
    for _ in range(S):
        ring.alloc()
    tbl = StreamTable(cfg, torch.bfloat16, max_slots=S, dec_t=64, kv_int8=True, device="cuda")
    block = 8 * VAD_FRAME
    n = warm + 2 * steps
    audio = np.stack([synth_speech(n * block / SR + 0.1, seed=50 + s)[: n * block] for s in range(S)])
    prefix = [cfg.token_sot, cfg.token_language(0), cfg.token_transcribe, cfg.token_no_timestamps]
    state = {"tip": 0, "step": 0}

    def one():
        step, tip = state["step"], state["tip"]
        written = step * block
        n_req = max(0, min((written + block - RIGHT_CTX - tip) // CHUNK_SAMPLES, 2))
        meta = np.asarray([[s, s, written, tip, n_req, 1, int(step == 0)] + prefix for s in range(S)], np.int32)
        out = tbl.step(params, ring, meta, None, None, None, None, None,
                       audio[:, written : written + block].reshape(S, 8, VAD_FRAME), max_steps=3)
        [o.cpu() for o in out]  # the engine's fetch
        state["step"], state["tip"] = step + 1, tip + n_req * CHUNK_SAMPLES

    for _ in range(warm):
        one()
    t0 = time.monotonic()
    for _ in range(steps):  # unprofiled: the profiler's host overhead stays out of the wall time
        one()
    wall_ms = (time.monotonic() - t0) / steps * 1e3
    ks = device_kernels(one, steps)
    by_name: dict = {}
    for e in ks:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    share = lambda key: sum(v[1] for k, v in by_name.items() if key in k) / steps  # noqa: E731
    report = {"wall_ms_per_call": wall_ms, "device_ms_per_call": busy,
              "device_idle_share": 1.0 - busy / wall_ms, "kernels_per_call": len(ks) / steps,
              "windowed_write_ms": share("windowed_write"), "history_attention_ms": share("history_attention"),
              "decode_cross_attention_ms": share("decode_cross_attention"),
              "direct_copy_ms": share("direct_copy"),
              "windowed_write_kernels_per_call": sum(v[0] for k, v in by_name.items() if "windowed_write" in k) / steps,
              "top": [[k[:80], v[0] / steps, v[1] / steps] for k, v in top]}
    log("# fused-step profile " + json.dumps(report))
    del params, tbl
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 5. DSP on the card: the filter nodes through the registry
# ---------------------------------------------------------------------------
def numpy_mix(xs, chans, dst: int, out: int) -> np.ndarray:
    """``mix_frames`` in numpy: channel conversion, zero-pad or cut, then
    left-to-right f32 accumulation."""
    acc = np.zeros(xs[0].shape[:-1] + (out,), np.float32)
    for x, ch in zip(xs, chans):
        y = x.reshape(x.shape[:-1] + (-1, ch))
        if ch == 1 and dst == 2:
            y = np.repeat(y, 2, axis=-1)
        elif ch == 2 and dst == 1:
            y = (y[..., 0:1] + y[..., 1:2]) * np.float32(0.5)
        elif ch != dst:
            y = y[..., np.arange(dst) % ch]
        y = y.reshape(y.shape[:-2] + (-1,))
        n = y.shape[-1]
        y = np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, out - n)]) if n < out else y[..., :out]
        acc = acc + y
    return acc


def float_wav(x: np.ndarray, rate: int, ch: int) -> bytes:
    """A 32-bit float WAV of the interleaved samples ``x``."""
    import struct

    data = x.astype("<f4").tobytes()
    return b"".join([b"RIFF", struct.pack("<I", 36 + len(data)), b"WAVE", b"fmt ",
                     struct.pack("<IHHIIHH", 16, 3, ch, rate, rate * ch * 4, ch * 4, 32),
                     b"data", struct.pack("<I", len(data)), data])


def float_samples(wav: bytes) -> np.ndarray:
    """The samples of a streamed 32-bit float WAV from ``containers::wav::muxer``
    (a 44-byte header, then the data)."""
    if wav[:4] != b"RIFF" or wav[36:40] != b"data":
        raise AssertionError("not the muxer's float WAV")
    return np.frombuffer(wav[44:], "<f4")


def run_requests(registry, pipeline, bodies, batched: bool):
    """Every body as its own oneshot request, all at once (one
    ``DeviceBatcher`` on the card when ``batched``) → (responses, wall s,
    the stopped batcher or None)."""
    from streamkit_tpu_torch.engine import DeviceBatcher

    async def run():
        batcher = DeviceBatcher(device="cuda") if batched else None
        t0 = time.monotonic()
        got = await asyncio.gather(*(oneshot_bytes(registry, pipeline, b, batcher=batcher) for b in bodies))
        wall = time.monotonic() - t0
        if batcher is not None:
            batcher.stop()
        return [out for _, out, _ in got], wall, batcher

    return asyncio.run(run())


def dsp_phase(S: int = 128, secs: float = 15.0) -> dict:
    """The filter nodes on the card, through the port's registry and oneshot
    engine. (1) The resampler's slot-table route: S concurrent requests of
    ``secs`` of audio each (``http_input → containers::wav::demuxer →
    audio::resampler → containers::wav::muxer → http_output``; the resampler
    at ``compat: exact``, ``backend: device``, 960-frame chunks, 20 ms output
    frames) share one ``DeviceBatcher``, for 48 kHz mono and 44.1 kHz stereo
    to 16 kHz. Every response must equal, byte for byte, the same request
    without a batcher, which the node serves on the host
    (``LinearResampler``). Each input ends 333 frames past a whole chunk, so
    the end-of-file flush also goes through the slot table; after the
    requests every slot must be free. One batched step at batch S is then
    profiled (device time, device launches) against its byte bound. (2) Gain
    and mixer: ``double_volume.yml``-style gain branches fanned out from one
    demuxer into ``audio::mixer`` (stereo in, mono out), with a batcher (the
    gains through the batched ``audio::gain`` kind) and without one, against
    numpy bit for bit."""
    from streamkit_tpu_torch.api import compile_pipeline_dict
    from streamkit_tpu_torch.nodes.audio.filters import resampler_slot_table
    from streamkit_tpu_torch.ops.resample import max_output_frames

    chunk, tail = 960, 333
    registry = node_registry("cuda")
    resample = compile_pipeline_dict({"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"}, {"kind": "containers::wav::demuxer"},
        {"kind": "audio::resampler", "params": {"target_sample_rate": SR, "chunk_frames": chunk,
                                                "output_frame_size": 320, "compat": "exact", "backend": "device"}},
        {"kind": "containers::wav::muxer", "params": {"bits": 32}}, {"kind": "streamkit::http_output"}]})
    report = {}
    for rate, ch in ((48000, 1), (44100, 2)):
        frames = int(secs * rate) + tail
        bodies = [float_wav(np.random.default_rng(1000 * ch + i).standard_normal(frames * ch, dtype=np.float32)
                            * np.float32(0.3), rate, ch) for i in range(S)]
        got, wall, batcher = run_requests(registry, resample, bodies, batched=True)
        want, host_wall, _ = run_requests(registry, resample, bodies, batched=False)
        kind = f"resample:{rate}:{SR}:{chunk}:{ch}"
        table = resampler_slot_table(rate, SR, chunk, ch, "cuda")
        for i in range(S):
            if got[i] != want[i]:
                raise AssertionError(f"dsp {kind}: request {i} differs from the host LinearResampler's")
        owed = -(-frames * SR // rate)  # the output frames a whole input is owed
        if len(float_samples(got[0])) != -(-owed // 320) * 320 * ch:
            raise AssertionError(f"dsp {kind}: {len(float_samples(got[0]))} samples for {frames} input frames")
        ks = batcher.stats()["kinds"].get(kind, {"calls": 0, "items": 0, "dispatch_s": 0.0})
        if ks["items"] != S * -(-frames // chunk) or table is None or table.in_use != 0:
            raise AssertionError(f"dsp {kind}: {ks} chunks through the slot table, "
                                 f"{table and table.in_use} slots still held")
        # one batched step at batch S (fresh rows: the sessions freed theirs)
        step = batcher.registered_kinds()[kind].fn
        slots = [table.alloc() for _ in range(S)]
        ids = np.asarray(slots, np.int32)
        x = torch.from_numpy(np.stack([float_samples(b)[: chunk * ch].reshape(chunk, ch) for b in bodies])).cuda()
        prof = kernel_ms(lambda: step(ids, x), iters=20)
        for slot in slots:
            table.free(slot)
        max_out = max_output_frames(chunk, rate, SR)
        nbytes = (S * chunk * ch * 4 + 2 * S * (ch + 1) * 4  # chunks in; rows gathered and written back
                  + S * max_out * ch * 4 + S * 4 + S * 8)  # outputs, valid counts, slot ids
        report[kind] = {"sessions": S, "audio_s": frames / rate, "bit_exact": True, "slots_in_use_after": 0,
                        "wall_s": wall, "host_route_wall_s": host_wall, "calls": ks["calls"], "items": ks["items"],
                        "mean_batch": ks["items"] / max(ks["calls"], 1), "dispatch_s": ks["dispatch_s"],
                        "step_ms": prof["ms"], "step_event_ms": prof["event_ms"],
                        "step_launches": prof.get("kernels_per_call"), "step_batch": S, "step_bytes": nbytes,
                        "step_bound_ms": nbytes / H100_BYTES * 1e3}
        log("# dsp " + json.dumps({kind: report[kind]}))
        del bodies, got, want, x
    # gain and mixer nodes on the card against numpy, bit for bit
    g_a, g_b, rate, ch = 2.0, 1 / 3, 48000, 2
    mix = compile_pipeline_dict({"mode": "oneshot", "nodes": {
        "http_input": {"kind": "streamkit::http_input"},
        "demux": {"kind": "containers::wav::demuxer", "needs": "http_input"},
        "gain_a": {"kind": "audio::gain", "params": {"gain": g_a}, "needs": "demux"},
        "gain_b": {"kind": "audio::gain", "params": {"gain": g_b}, "needs": "demux"},
        # a sync timeout far above any round's wait: each round mixes both branches
        "mixer": {"kind": "audio::mixer", "params": {"num_inputs": 2, "output_channels": 1, "sync_timeout_ms": 60000},
                  "needs": ["gain_a", "gain_b"]},
        "mux": {"kind": "containers::wav::muxer", "params": {"bits": 32}, "needs": "mixer"},
        "http_output": {"kind": "streamkit::http_output", "needs": "mux"}}})
    kinds = {n.kind for n in mix.nodes.values()}
    if not {"audio::gain", "audio::mixer"} <= kinds:
        raise AssertionError(f"dsp: the mix pipeline compiled to {kinds}")
    x = np.random.default_rng(7).standard_normal(2 * rate * ch + 2 * 77, dtype=np.float32) * np.float32(0.3)
    expect = numpy_mix([x * np.float32(g_a), x * np.float32(g_b)], [ch, ch], 1, x.size // ch)
    for batched in (True, False):
        (out,), wall, batcher = run_requests(registry, mix, [float_wav(x, rate, ch)], batched)
        if float_samples(out).tobytes() != expect.tobytes():
            raise AssertionError(f"dsp: gain → mixer on the card (batcher {batched}) differs from numpy")
        calls = kind_calls(batcher.stats(), "audio::gain") if batched else 0
        if batched and calls == 0:
            raise AssertionError(f"dsp: the gain nodes never reached the batched kind: {batcher.stats()}")
        report[f"gain_mixer_{'batched' if batched else 'unbatched'}"] = {"wall_s": wall, "gain_calls": calls,
                                                                        "bit_exact": True}
    log("# dsp gain and mixer nodes on the card equal numpy bit for bit " + json.dumps(
        {k: v for k, v in report.items() if k.startswith("gain_mixer")}))
    return report


# ---------------------------------------------------------------------------
# 6. the repo's own sample pipelines: Ogg/Opus STT and the gain request
# ---------------------------------------------------------------------------
SAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "samples")


def sample_pipeline(name: str, **step_params):
    """A sample pipeline as written, with ``step_params[kind]`` merged into
    that step's params, compiled as the server compiles a request's."""
    import yaml

    from streamkit_tpu_torch.api import compile_pipeline_dict

    with open(os.path.join(SAMPLES, "pipelines", "system", name)) as f:
        doc = yaml.safe_load(f)
    for step in doc["steps"]:
        if step["kind"] in step_params:
            step["params"] = dict(step.get("params") or {}, **step_params[step["kind"]])
    return compile_pipeline_dict(doc)


async def oneshot_bytes(registry, pipeline, body: bytes, resources=None, batcher=None):
    """One request → (content type, response bytes, wall seconds)."""
    from streamkit_tpu_torch.engine import run_oneshot_pipeline

    async def stream():
        for i in range(0, len(body), 1 << 16):
            yield body[i : i + (1 << 16)]

    t0 = time.monotonic()
    result = await run_oneshot_pipeline(registry, pipeline, input_stream=stream(), resources=resources,
                                        batcher=batcher)
    out = await result.read_all()
    return result.content_type, out, time.monotonic() - t0


def ogg_opus_path(resources, opus: bool) -> dict:
    """``speech_to_text.yml`` on ``samples/media/speech_30s.ogg`` (the whisper
    step at large-v3 bf16, every other step as written) through the port's
    registry on the card and one ``DeviceBatcher``, twice: fused (the
    resampler set to ``output_frame_size: 0``, so the compiler folds it into
    a 16 kHz Opus decode) and unfused (as written: ``audio::resampler``,
    rubato, on the host). Then ``double_volume.yml`` on
    ``samples/media/tone.wav`` with a ``DeviceBatcher``, so the gain runs as
    the batched ``audio::gain`` kind: the card's response bytes must equal
    the port's CPU run. Without libopus only the second runs."""
    from streamkit_tpu_torch.engine import DeviceBatcher

    report = {}
    registry = node_registry("cuda")
    if opus:
        with open(os.path.join(SAMPLES, "media", "speech_30s.ogg"), "rb") as f:
            body = f.read()
        whisper = {"model_size": "large-v3", "dtype": "bfloat16"}
        for label, extra in (("fused", {"audio::resampler": {"output_frame_size": 0}}), ("unfused", {})):
            pipeline = sample_pipeline("speech_to_text.yml", **{"plugin::native::whisper": whisper}, **extra)
            kinds = [n.kind for n in pipeline.nodes.values()]
            if ("audio::resampler" in kinds) != (label == "unfused"):
                raise AssertionError(f"ogg {label}: compiled kinds {kinds}")

            async def run(pipeline=pipeline):
                batcher = DeviceBatcher(device="cuda")
                reset_counts()  # counts from here to the end of this request
                ct, out, wall = await oneshot_bytes(registry, pipeline, body, resources, batcher)
                torch.cuda.synchronize()
                counts = read_counts()
                batcher.stop()
                return ct, out, wall, counts, batcher.stats()

            ct, out, wall, counts, stats = asyncio.run(run())
            if ct != "application/json":
                raise AssertionError(f"ogg {label}: content type {ct}")
            rows = transcripts(out)
            show([r for r in rows if r["is_final"]], f"ogg {label} final")
            check_transcripts(rows, 30.0, f"ogg {label}")
            encodes = kind_calls(stats, "whisper_ring:") + kind_calls(stats, "whisper_detect:")
            want = {**ZERO_LAUNCHES, "flash_attention": flash_per_encode() * encodes}
            report[label] = {"kinds": kinds, "wall_s": wall, "lines": len(rows), "encodes": encodes,
                             "launches": counts, "batcher": stats}
            log("# ogg " + json.dumps({label: report[label]}))
            if counts != want or encodes == 0:
                raise AssertionError(f"ogg {label}: launches {counts}, expected {want}")
    with open(os.path.join(SAMPLES, "media", "tone.wav"), "rb") as f:
        tone = f.read()
    pipeline = sample_pipeline("double_volume.yml")

    async def run_gain():
        batcher = DeviceBatcher(device="cuda")
        ct, out, wall = await oneshot_bytes(registry, pipeline, tone, batcher=batcher)
        batcher.stop()
        return ct, out, wall, batcher.stats()

    ct_g, out_g, wall_g, stats = asyncio.run(run_gain())
    ct_c, out_c, _ = asyncio.run(oneshot_bytes(node_registry("cpu"), pipeline, tone))
    report["double_volume"] = {"wall_s": wall_g, "bytes": len(out_g), "equal_to_cpu": out_g == out_c,
                               "gain_calls": kind_calls(stats, "audio::gain")}
    log("# double_volume " + json.dumps(report["double_volume"]))
    if ct_g != ct_c or out_g != out_c or len(out_g) <= 44:
        raise AssertionError("double_volume: the card's WAV differs from the CPU run")
    if report["double_volume"]["gain_calls"] == 0:
        raise AssertionError(f"double_volume: the gain node never reached the batched kind: {stats}")
    return report


# ---------------------------------------------------------------------------
# 7. a dynamic session: live_captions.yml's graph with files at its ends
# ---------------------------------------------------------------------------
def dynamic_session_path(resources, opus: bool, speed: float = 4.0) -> dict:
    """``live_captions.yml``'s graph as a dynamic session on the card, built
    with ``add_node`` / ``connect`` and started through
    ``start_dynamic_engine`` with one ``DeviceBatcher``. Its two ends are
    files: ``core::file_reader`` → ``containers::ogg::demuxer`` →
    ``core::pacer`` (4× real time) in place of the MoQ subscriber, and
    ``core::file_writer`` in place of the publisher. The Opus decoder,
    resampler and whisper step take the YAML's params (large-v3 bf16,
    streaming partials, finals from the stream, 8-frame VAD blocks). The
    input is ``samples/media/speech_30s.ogg``; without libopus,
    ``samples/media/speech_8s.wav`` enters through ``containers::wav::demuxer``
    instead. Every fused call launches 2 K2 and 32 K3; K1 launches only in
    the ring decodes of the batcher's ``whisper_ring`` / ``whisper_detect``
    kinds (a segment still open when the file ends is closed with one), 32
    per encode. Returns the launch counts."""
    import tempfile

    import yaml

    from streamkit_tpu_torch.engine import DeviceBatcher, DynamicEngineConfig, start_dynamic_engine

    with open(os.path.join(SAMPLES, "pipelines", "system", "live_captions.yml")) as f:
        steps = {s["kind"]: s.get("params") or {} for s in yaml.safe_load(f)["steps"]}
    registry = node_registry("cuda")
    media = os.path.join(SAMPLES, "media", "speech_30s.ogg" if opus else "speech_8s.wav")
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "captions.jsonl")
        if opus:
            nodes = [("reader", "core::file_reader", {"path": media}), ("demux", "containers::ogg::demuxer", {}),
                     ("pacer", "core::pacer", {"speed": speed}), ("decode", "audio::opus::decoder", {})]
        else:
            nodes = [("reader", "core::file_reader", {"path": media}), ("demux", "containers::wav::demuxer", {}),
                     ("pacer", "core::pacer", {"speed": speed})]
        nodes += [("resample", "audio::resampler", steps["audio::resampler"]),
                  ("stt", "plugin::native::whisper", steps["plugin::native::whisper"]),
                  ("json", "core::json_serialize", steps["core::json_serialize"]),
                  ("writer", "core::file_writer", {"path": out_path})]

        async def run():
            batcher = DeviceBatcher(device="cuda")
            handle = start_dynamic_engine(registry, DynamicEngineConfig(session_id="live-captions"),
                                          resources=resources, batcher=batcher)
            telemetry = await handle.subscribe_telemetry()
            events = []

            async def collect():
                while True:
                    ev = await telemetry.recv_optional()
                    if ev is None:
                        return
                    if ev.event_type in ("stt.partial", "stt.result"):
                        events.append(ev.event_type)

            collector = asyncio.ensure_future(collect())
            reset_counts()  # counts from here to the end of the session
            t0 = time.monotonic()
            for name, kind, params in nodes:
                await handle.add_node(name, kind, params)
            for (a, _, _), (b, _, _) in zip(nodes, nodes[1:]):
                await handle.connect(a, "out", b, "in")
            states = {}
            while time.monotonic() - t0 < 600:
                await asyncio.sleep(0.25)
                states = await handle.get_node_states()
                if any(st.kind.value == "failed" for st in states.values()):
                    raise AssertionError(f"dynamic session: a node failed: {states}")
                if len(states) == len(nodes) and all(st.kind.value == "stopped" for st in states.values()):
                    break
            else:
                raise AssertionError(f"dynamic session did not end: {states}")
            wall = time.monotonic() - t0
            torch.cuda.synchronize()
            counts = read_counts()
            await handle.shutdown_and_wait()
            collector.cancel()
            batcher.stop()
            final_states = {n: st.kind.value for n, st in states.items()}
            return wall, counts, batcher.stats(), events, final_states

        with knobs(SK_STREAM_SLOTS=4, SK_STREAM_PAD=1):
            wall, counts, stats, events, states = asyncio.run(run())
        with open(out_path) as f:
            rows = transcripts(f.read().encode())
    calls = kind_calls(stats, "stream_step:")
    encodes = kind_calls(stats, "whisper_ring:") + kind_calls(stats, "whisper_detect:")
    finals = events.count("stt.result")
    # partials before each final: every final follows at least one partial
    # of its segment (the partials since the previous final)
    per_final, run_len = [], 0
    for ev in events:
        if ev == "stt.partial":
            run_len += 1
        else:
            per_final.append(run_len)
            run_len = 0
    report = {"media": os.path.basename(media), "speed": speed, "wall_s": wall, "fused_calls": calls,
              "ring_encodes": encodes,
              "mean_batch": stats["kinds"].get(next((k for k in stats["kinds"] if k.startswith("stream_step:")), ""),
                                               {}).get("items", 0) / max(calls, 1),
              "partials": events.count("stt.partial"), "finals": finals, "partials_per_final": per_final,
              "lines": len(rows), "launches": counts, "states": states, "batcher": stats}
    log("# dynamic session " + json.dumps(report))
    show([r for r in rows if r["is_final"]], "dynamic session final")
    want = {**ZERO_LAUNCHES, "flash_attention": flash_per_encode() * encodes, "windowed_write": 2 * calls,
            "history_attention": flash_per_encode() * calls, "decode_cross_attention": cross_per_call() * calls}
    if counts != want or calls == 0:
        raise AssertionError(f"dynamic session launched {counts}, expected {want}")
    if finals == 0 or min(per_final) < 1 or len(rows) != len(events):
        raise AssertionError(f"dynamic session: partials {per_final} before its {finals} finals, "
                             f"{len(rows)} lines for {len(events)} events")
    if set(states.values()) != {"stopped"}:
        raise AssertionError(f"dynamic session: states after the end {states}")
    return counts


# ---------------------------------------------------------------------------
# the script node and the host codecs at full width
# ---------------------------------------------------------------------------
SCRIPT_JS = """
function process(packet) {
  if (packet.type !== 'Transcription') return packet;
  const text = packet.data.text;
  return { type: 'Custom', type_id: 'skit/caption@1',
           data: { text: '[caption] ' + text.toUpperCase(), words: text.split(' ').length } };
}
"""
SCRIPT_PY = """
def process(p):
    if p.kind != 'transcription':
        return p
    return custom_packet('skit/caption@1', {'text': '[caption] ' + p.text.upper(), 'words': len(p.text.split(' '))})
"""


def caption(text: str) -> dict:
    """What both scripts make of a transcription, in Python."""
    return {"text": "[caption] " + text.upper(), "words": len(text.split(" "))}


# the whisper step of the script, host-codec and fetch requests: large-v3 bf16
# at a short token budget (the requests compare lines, not quality)
SHORT_WHISPER = {"model_size": "large-v3", "dtype": "bfloat16", "language": "en", "max_tokens": 24}


def with_script(doc: dict, params: dict) -> dict:
    """:func:`stt_doc`'s pipeline with a ``core::script`` step after whisper."""
    steps = list(doc["steps"])
    steps.insert(3, {"kind": "core::script", "params": params})
    return dict(doc, steps=steps)


def script_path(resources) -> dict:
    """``# script``: WAV → whisper → ``core::script`` → JSON lines through the
    oneshot engine, once with a JavaScript ``process(packet)`` and once with
    the Python dialect, each rewriting every transcription's text and adding
    a field; both must equal the same request without the script node,
    transformed in Python. No batcher: the three requests compute alike.
    Returns the launch counts (K1 32 per encode)."""
    from streamkit_tpu_torch.api import compile_pipeline_dict
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    registry = node_registry("cuda")
    body = wav_body(np.concatenate([synth_speech(6.0, seed=31), np.zeros(SR, np.float32)]))
    plain = stt_doc(SHORT_WHISPER)
    docs = {"plain": plain,
            "javascript": with_script(plain, {"script": SCRIPT_JS, "language": "javascript", "timeout_ms": 10000}),
            "python": with_script(plain, {"script": SCRIPT_PY, "language": "python", "timeout_ms": 10000})}
    reset_counts()
    out, walls = {}, {}
    for label, doc in docs.items():
        _, out[label], walls[label] = asyncio.run(oneshot_bytes(registry, compile_pipeline_dict(doc), body, resources))
    torch.cuda.synchronize()
    counts = read_counts()
    rows = transcripts(out["plain"])
    want = [caption(r["text"]) for r in rows]
    got = {label: [json.loads(line)["Custom"]["data"] for line in out[label].decode().splitlines() if line.strip()]
           for label in ("javascript", "python")}
    report = {"lines": len(rows), "walls_s": walls, "launches": counts, "first": want[:1],
              "equal": {label: got[label] == want for label in got}}
    log("# script " + json.dumps(report))
    if not rows or not all(report["equal"].values()):
        raise AssertionError(f"script: {got} != {want}")
    if counts["flash_attention"] == 0 or counts["flash_attention"] % flash_per_encode():
        raise AssertionError(f"script path launched {counts}")
    return counts


def host_codecs_path(resources) -> dict:
    """``# host codecs``: which of the FLAC, MP3 and WebM kinds registered on
    this machine (a line names each absent library). Where FLAC registered,
    the 10 s segment-final WAV is encoded as verbatim FLAC and sent through
    ``audio::flac::decoder`` → whisper: its lines must equal the WAV
    request's (the decoder returns the WAV's 16-bit samples exactly). No
    batcher. Returns the launch counts."""
    from streamkit_tpu_torch.api import compile_pipeline_dict
    from streamkit_tpu_torch.nodes.codecs import flac_available, mp3_available

    registry = node_registry("cuda")
    kinds = {k: registry.contains(k) for k in ("audio::flac::decoder", "audio::mp3::decoder",
                                               "containers::webm::muxer")}
    log("# host codecs registered " + json.dumps(kinds))
    if kinds["audio::flac::decoder"] != flac_available() or kinds["audio::mp3::decoder"] != mp3_available():
        raise AssertionError(f"host codecs: registry {kinds} against the library checks")
    if not kinds["containers::webm::muxer"]:
        raise AssertionError("containers::webm::muxer needs no library and must register")
    if not kinds["audio::mp3::decoder"]:
        log("# libmpg123 is absent: audio::mp3::decoder is not registered")
    reset_counts()
    report = {"kinds": kinds}
    if kinds["audio::flac::decoder"]:
        audio = session_audio(np.random.RandomState(0), 10.0)  # phase 4's first body
        wav = wav_body(audio)
        pcm16 = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
        flac = flac_verbatim(pcm16)
        doc = stt_doc(SHORT_WHISPER)
        flac_doc = dict(doc, steps=[doc["steps"][0], {"kind": "audio::flac::decoder"}, *doc["steps"][2:]])
        rows = {}
        for label, d, data in (("wav", doc, wav), ("flac", flac_doc, flac)):
            _, out, wall = asyncio.run(oneshot_bytes(registry, compile_pipeline_dict(d), data, resources))
            rows[label] = transcripts(out)
            report[f"{label}_wall_s"] = wall
        report.update(flac_bytes=len(flac), wav_bytes=len(wav), lines=len(rows["wav"]),
                      equal=rows["flac"] == rows["wav"])
        show([r for r in rows["flac"] if r["is_final"]], "flac final")
        if not rows["wav"] or rows["flac"] != rows["wav"]:
            raise AssertionError(f"host codecs: FLAC lines {rows['flac']} != WAV lines {rows['wav']}")
    else:
        from streamkit_tpu_torch.nodes.codecs import av

        log("# libav (libavformat, libavcodec, libavutil, libswresample, found by pkg-config) is absent: "
            "audio::flac::decoder is not registered: " + json.dumps(av.unavailable_reason))
    torch.cuda.synchronize()
    report["launches"] = counts = read_counts()
    log("# host codecs " + json.dumps(report))
    if counts["flash_attention"] % flash_per_encode() or (kinds["audio::flac::decoder"] and not counts["flash_attention"]):
        raise AssertionError(f"host codecs path launched {counts}")
    return counts


# ---------------------------------------------------------------------------
# the plugin hosts in front of Whisper
# ---------------------------------------------------------------------------
# exact in f32; the component fixture's guest reads its gain from one ASCII
# digit of the params, so the four runtimes share an integer gain
PLUGIN_GAIN = 2
PLUGINS = {}  # the plugin files, request and lines of plugins_path, for the server phase


def build_plugin_files(directory: str) -> dict:
    """The three plugin files, built from the checkout into ``directory``: the
    example native plugin (``native/plugins/gain/gain_plugin.cpp``) with g++
    and ``native/Makefile``'s flags, the core-WASM gain and the gain component
    with the port's SDK → {runtime: path}. A failed build raises."""
    from streamkit_tpu_torch.plugins.component_asm import build_gain_component
    from streamkit_tpu_torch.plugins.wasm_asm import build_gain_wasm

    files = {"native": os.path.join(directory, "gain_cpp.so"), "wasm": os.path.join(directory, "wgain.wasm"),
             "component": os.path.join(directory, "gain-component.wasm")}
    t0 = time.monotonic()
    proc = subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra", "-o", files["native"],
                           os.path.join(REPO_DIR, "native", "plugins", "gain", "gain_plugin.cpp")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on the native gain plugin ({proc.returncode}):\n{proc.stderr}")
    log(f"# built {files['native']} (g++) in {time.monotonic() - t0:.1f} s")
    for runtime, data in (("wasm", build_gain_wasm()), ("component", build_gain_component())):
        with open(files[runtime], "wb") as f:
            f.write(data)
    return files


def plugin_doc(kind: str, params: dict) -> dict:
    """:func:`stt_doc` at :data:`SHORT_WHISPER` with a gain step after the WAV demuxer."""
    doc = stt_doc(SHORT_WHISPER)
    steps = list(doc["steps"])
    steps.insert(2, {"kind": kind, "params": params})
    return dict(doc, steps=steps)


async def run_node(registry, kind: str, params, packets: list):
    """One node of ``kind`` alone over ``packets`` → (wall seconds, outputs)."""
    from streamkit_tpu_torch.core import Channel, NodeContext, OutputSender

    node = registry.create_node(kind, params)
    inp, out = Channel(len(packets) + 1), Channel(1 << 16)  # room for every output: drained after the run
    ctx = NodeContext(node_name="timed", inputs={"in": inp}, output=OutputSender("timed", direct={"out": out}))
    for pkt in packets:
        await inp.send(pkt)
    inp.close()
    t0 = time.perf_counter()
    await node.run(ctx)
    wall = time.perf_counter() - t0
    outs = []
    while not out.is_empty:
        outs.append(await out.recv_optional())
    return wall, outs


def plugins_path(resources) -> dict:
    """``# plugins``: the three plugin runtimes in front of Whisper large-v3.

    Builds the three plugin files (:func:`build_plugin_files`), loads them
    into the port's registry (``plugin::native::gain_cpp``,
    ``plugin::wasm::wgain`` on the core-WASM host, ``plugin::wasm::gain`` on
    the component host) and sends phase 4's 10 s WAV through WAV demuxer →
    gain :data:`PLUGIN_GAIN` → whisper (:data:`SHORT_WHISPER`) → JSON lines,
    once per runtime and once through ``audio::gain``, one request at a time
    through one ``DeviceBatcher``: the four responses must be equal, each
    request must launch K1 32 per encode and no K2 or K3. Then each gain node
    alone over the demuxer's packets of the same WAV: host time per packet
    and per second of audio. Returns the launch counts of the four requests."""
    import tempfile

    from streamkit_tpu_torch.api import compile_pipeline_dict
    from streamkit_tpu_torch.core import Packet
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.plugins.native import load_native_plugin
    from streamkit_tpu_torch.plugins.wasm import SOURCE, load_wasm_plugin

    tmp = tempfile.TemporaryDirectory(prefix="skit-plugins-")
    files = build_plugin_files(tmp.name)
    registry = node_registry("cuda")
    kinds = {"native": load_native_plugin(registry, files["native"]).kind,
             "wasm": load_wasm_plugin(registry, files["wasm"]).kind,
             "component": load_wasm_plugin(registry, files["component"]).kind}
    log("# plugins loaded " + json.dumps({"kinds": kinds, "wasm_runtime": os.path.relpath(SOURCE.library())}))
    if kinds != {"native": "plugin::native::gain_cpp", "wasm": "plugin::wasm::wgain", "component": "plugin::wasm::gain"}:
        raise AssertionError(f"plugins registered as {kinds}")
    steps = {"native": (kinds["native"], {"gain": float(PLUGIN_GAIN)}),
             "wasm": (kinds["wasm"], {"gain": float(PLUGIN_GAIN)}),
             "component": (kinds["component"], {"gain": PLUGIN_GAIN}),
             "audio::gain": ("audio::gain", {"gain": float(PLUGIN_GAIN)})}
    audio = session_audio(np.random.RandomState(0), 10.0)  # phase 4's first body
    body = wav_body(audio)
    per = flash_per_encode()

    async def requests():
        batcher = DeviceBatcher(device="cuda")
        out = {}
        try:
            for label, step in steps.items():
                before = batcher.stats()
                reset_counts()
                ctype, data, wall = await oneshot_bytes(registry, compile_pipeline_dict(plugin_doc(*step)), body,
                                                        resources, batcher)
                torch.cuda.synchronize()
                counts, stats = read_counts(), batcher.stats()
                encodes = sum(kind_calls(stats, p) - kind_calls(before, p) for p in ("whisper_ring:", "whisper_detect:"))
                out[label] = {"wall_s": wall, "content_type": ctype, "body": data, "encodes": encodes,
                              "launches": counts}
        finally:
            batcher.stop()
        return out

    async def host_times():
        demux = [Packet.new_binary(body[i : i + (1 << 16)]) for i in range(0, len(body), 1 << 16)]
        _, frames = await run_node(registry, "containers::wav::demuxer", None, demux)
        times = {}
        for label, (kind, params) in steps.items():
            walls = []
            for _ in range(4):  # the first run warms the node's host path
                wall, outs = await run_node(registry, kind, params, frames)
                walls.append(wall)
            got = np.concatenate([o.audio.samples for o in outs])
            want = np.concatenate([f.audio.samples for f in frames]) * np.float32(PLUGIN_GAIN)
            if not np.array_equal(got, want):
                raise AssertionError(f"{label}: the gain node's samples differ from x * {PLUGIN_GAIN}")
            best = min(walls[1:])
            times[label] = {"packets": len(frames), "ms_per_packet": best * 1e3 / len(frames),
                            "ms_per_audio_s": best * 1e3 / (len(audio) / SR),
                            "runs_ms": [w * 1e3 for w in walls]}
        return times

    try:
        with knobs(SK_STT_GATHER_MS=STT_GATHER_MS):
            out = asyncio.run(requests())
        times = asyncio.run(host_times())
    finally:
        PLUGINS.update(files=files, tmp=tmp, body=body, steps=steps)
    rows = {label: transcripts(o["body"]) for label, o in out.items()}
    report = {label: {k: v for k, v in o.items() if k != "body"} for label, o in out.items()}
    for label, r in report.items():
        r.update(lines=len(rows[label]), equal_to_audio_gain=out[label]["body"] == out["audio::gain"]["body"],
                 host=times[label])
        log(f"# plugins {label} " + json.dumps(r))
    show([r for r in rows["native"] if r["is_final"]], "plugins final")
    check_transcripts(rows["audio::gain"], 10.0, "plugins audio::gain")
    total = dict(ZERO_LAUNCHES)
    for label, o in out.items():
        want = {**ZERO_LAUNCHES, "flash_attention": per * o["encodes"]}
        if o["launches"] != want or o["encodes"] != out["audio::gain"]["encodes"] or o["encodes"] == 0:
            raise AssertionError(f"plugins {label}: launched {o['launches']} for {o['encodes']} encodes, "
                                 f"expected {want} and audio::gain's {out['audio::gain']['encodes']} encodes")
        if o["body"] != out["audio::gain"]["body"]:
            raise AssertionError(f"plugins {label}: lines {rows[label]} != audio::gain's {rows['audio::gain']}")
        total = {k: total[k] + o["launches"][k] for k in total}
    PLUGINS["lines"] = rows["audio::gain"]
    return total


# ---------------------------------------------------------------------------
# 8. translation at full width: NLLB-200-distilled-600M and opus-mt-en-es
# ---------------------------------------------------------------------------
def translate_texts(n: int = 16) -> list:
    """``n`` ASCII texts of 20 to 120 bytes, from seed 0."""
    rng = np.random.RandomState(0)
    words = ("the a speech card stream model session sentence audio token decoder batch translate "
             "device host kernel text word line").split()
    out = []
    for size in np.linspace(20, 120, n).astype(int):
        s = ""
        while len(s) < size:
            s += words[rng.randint(len(words))] + " "
        out.append(s[:size])
    return out


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_to(tree, device, dtype=None, keep_f32=()):
    """A parameter tree's tensors moved (and floats cast) as one."""
    if isinstance(tree, dict):
        return {k: (v.to(device) if k in keep_f32 else tree_to(v, device, dtype, keep_f32)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device, dtype, keep_f32) for v in tree]
    return tree.to(device, dtype) if dtype is not None and tree.is_floating_point() else tree.to(device)


@contextlib.contextmanager
def count_steps(module, name: str):
    """Count the calls of ``module.name`` (a model's cached decode step) made
    while the block runs, from any thread."""
    import threading

    real = getattr(module, name)
    box = {"n": 0}
    lock = threading.Lock()

    def counted(*a, **kw):
        with lock:
            box["n"] += 1
        return real(*a, **kw)

    setattr(module, name, counted)
    try:
        yield box
    finally:
        setattr(module, name, real)


def profile_call(fn, module, step_name: str) -> dict:
    """One call under the profiler (CUDA activity only, so the host pays
    little for it): host wall, device time (the kernels' summed durations),
    idle share, decode steps (cached decoder steps, the prefix's included)
    and kernels per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with count_steps(module, step_name) as steps, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ks) / 1e6
    n = max(1, steps["n"])
    return {"wall_s": wall, "device_s": busy, "idle_share": max(0.0, 1.0 - busy / wall), "decode_steps": steps["n"],
            "host_ms_per_step": wall / n * 1e3, "device_ms_per_step": busy / n * 1e3, "kernels": len(ks),
            "kernels_per_step": len(ks) / n}


def translate_family(family: str) -> dict:
    """One family at its published widths, random weights from seed 0: the
    two calls ``TranslateNode.run`` / ``MarianTranslateNode.run`` make
    (``BucketedGreedy.run_batched`` on one ``DeviceBatcher``) for 16 texts at
    bf16 and ``max_tokens`` 128; each bucket's rows again alone, profiled at
    ``max_tokens`` 16; one beam-4 batch (timed at 128 tokens, profiled at
    16); and 2 rows at f32 (``max_tokens`` 16, greedy) whose tokens must
    equal the port's CPU f32 run."""
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.models import marian, nllb
    from streamkit_tpu_torch.nodes.ml import marian_node, translate_node
    from streamkit_tpu_torch.nodes.ml._text_batching import BucketedGreedy

    if family == "nllb":
        mod, step_name, cfg = nllb, "nllb_decode_step", nllb.NllbConfig(vocab_size=256206)
        tok = translate_node._ByteTokenizer()
        lang = np.asarray(tok.lang_token("spa_Latn"), np.int32)
        init, keep = nllb.nllb_init_params, ()

        def greedy(p, max_tokens):
            return lambda src, tgt: nllb.nllb_greedy_cached(p, cfg, src, tgt, max_tokens=max_tokens)

        def beam(p, max_tokens):
            return lambda src, tgt: nllb.nllb_beam_translate(p, cfg, src, tgt, max_tokens=max_tokens, beam=4)
    else:
        mod, step_name, cfg = marian, "marian_decode_step", marian.MarianConfig()
        tok = marian_node._ByteTok(cfg)
        lang = None
        init, keep = marian.marian_init_params, ("logits_bias",)

        def greedy(p, max_tokens):
            return lambda src: marian.marian_greedy_cached(p, cfg, src, max_tokens=max_tokens)

        def beam(p, max_tokens):
            return lambda src: marian.marian_beam_translate(p, cfg, src, max_tokens=max_tokens, beam=4)

    extras = () if lang is None else (lang,)
    t0 = time.monotonic()
    cpu = init(cfg, 0, device="cpu")  # the node's draw: numpy on the host, then moved
    bf16 = tree_to(cpu, "cuda", torch.bfloat16, keep)
    report = {"config": cfg.__dict__, "draw_s": time.monotonic() - t0,
              "params": sum(t.numel() for t in tree_leaves(bf16))}
    texts = translate_texts()
    ids = [tok.encode(t) for t in texts]
    bg = BucketedGreedy(f"{family}:{id(bf16)}:128:b1", cfg.max_positions, cfg.pad_token_id, greedy(bf16, 128),
                        device="cuda")

    async def run():
        batcher = DeviceBatcher(device="cuda")
        t0 = time.monotonic()
        out = await asyncio.gather(*(bg.run_batched(batcher, x, *extras) for x in ids))
        wall = time.monotonic() - t0
        batcher.stop()
        return out, wall, batcher.stats()

    reset_counts()
    with count_steps(mod, step_name) as steps:
        out, wall, stats = asyncio.run(run())
    report["batched"] = {"texts": len(texts), "wall_s": wall, "decode_steps": steps["n"], "batcher": stats,
                         "launches": read_counts()}
    # lengths count the non-pad tokens: a random opus-mt emits its pad (= its
    # decoder start) as a real token, so 0 is a valid length there
    for toks, n in out:
        if toks.shape != (128,) or not 0 <= n <= 128 or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError(f"{family}: bad decode {toks[:8]}, length {n}")
    report["batched"]["first_tokens"] = [out[0][0][:4].tolist(), out[-1][0][:4].tolist()]
    report["batched"]["lengths"] = [n for _, n in out]
    if any(report["batched"]["launches"].values()):
        raise AssertionError(f"{family}: a Whisper kernel launched on the translation path")
    by_bucket = {}
    for x in ids:
        tb, padded = bg._bucketed(x)
        by_bucket.setdefault(tb, []).append(padded)
    # each bucket's call alone, profiled: the batched calls above ran at once
    # on the batcher's executor threads, so their device time is not theirs
    # alone; 16 tokens (18 steps) keep the trace small, and a step is a step
    report["calls"] = {}
    for tb, rows in sorted(by_bucket.items()):
        src = torch.as_tensor(np.stack(rows), device="cuda")
        ext = [torch.as_tensor(np.repeat(e[None], len(rows), 0), device="cuda") for e in extras]
        with torch.inference_mode():
            report["calls"][tb] = dict(rows=len(rows), max_tokens=16,
                                       **profile_call(lambda: greedy(bf16, 16)(src, *ext), mod, step_name))
    tb = sorted(by_bucket)[len(by_bucket) // 2]
    src = torch.as_tensor(np.stack(by_bucket[tb]), device="cuda")
    ext = [torch.as_tensor(np.repeat(e[None], src.shape[0], 0), device="cuda") for e in extras]
    with torch.inference_mode():
        t0 = time.monotonic()
        beam(bf16, 128)(src, *ext)
        torch.cuda.synchronize()
        report["beam4"] = dict(bucket=tb, rows=src.shape[0], wall_128_s=time.monotonic() - t0, max_tokens=16,
                               **profile_call(lambda: beam(bf16, 16)(src, *ext), mod, step_name))
    # f32 on the card against the CPU: 2 rows, greedy (beam 4 at f32 is held
    # against the CPU on the nodes' small configuration by the card tests)
    t0 = time.monotonic()
    f32 = tree_to(cpu, "cuda")
    src2 = np.stack([bg._bucketed(x)[1] for x in ids[:2]])[:, : max(len(x) for x in ids[:2])]
    ext2 = [np.repeat(e[None], 2, 0) for e in extras]
    equal = {}
    with torch.inference_mode():
        for label, make in (("greedy", greedy),):
            got = [tuple(t.cpu() for t in make(p, 16)(torch.as_tensor(src2, device=d),
                                                      *[torch.as_tensor(e, device=d) for e in ext2]))
                   for p, d in ((f32, "cuda"), (cpu, "cpu"))]
            equal[label] = all(torch.equal(a, b) for a, b in zip(*got))
            report[f"f32_{label}_tokens"] = got[0][0].tolist()
    report["f32_equal_to_cpu"] = equal
    report["f32_check_s"] = time.monotonic() - t0
    del bf16, f32, cpu
    torch.cuda.empty_cache()
    log(f"# translate {family} " + json.dumps(report))
    if not all(equal.values()):
        raise AssertionError(f"{family}: f32 tokens on the card differ from the CPU's: {equal}")
    return report


def translate_phase() -> dict:
    log("# translate: plugin::native::nllb / plugin::native::helsinki reach these widths only through "
        "model_path (transformers and a tokenizer file, which the repo lacks); the phase makes the "
        "node's own two calls with the node's byte tokenizer")
    out = {}
    for family in ("nllb", "marian"):
        t0 = time.monotonic()
        out[family] = translate_family(family)
        log(f"# translate {family} wall {time.monotonic() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 9. the cascade samples: Whisper → NLLB (→ VITS) through the registry
# ---------------------------------------------------------------------------
WAVE_TOL = 32  # 16-bit steps: 1e-3 of full scale between cuDNN's and the CPU's f32 convolutions


def wav_samples(body: bytes) -> np.ndarray:
    return np.frombuffer(body[44:], "<i2").astype(np.int32)


def cascade_phase(opus: bool) -> dict:
    """``speech_translate.yml`` and ``voice_translate.yml`` as written (the
    whisper and nllb steps set to their default ``dtype: float32``
    explicitly), 4 concurrent WAV requests (``speech_8s.wav`` and 6 s of
    synthetic speech, seeds 30–32) through the port's registry, the oneshot
    engine, one ``ResourceManager`` and one ``DeviceBatcher``, after a warm
    request; the same requests through the CPU registry and a CPU batcher.
    Every JSON response equals the CPU's byte for byte; every WAV response
    has the CPU's header and length and its 16-bit samples within
    ``WAVE_TOL``. The VITS durations (frames per token, mms-tts-eng widths)
    of each translated sentence are equal on the card and the CPU. K1
    launches 4 per Whisper-tiny encode of the batcher's ``whisper_ring`` /
    ``whisper_detect`` calls; K2, K3 and K4 not at all."""
    from streamkit_tpu_torch.core import ResourceManager
    from streamkit_tpu_torch.engine import DeviceBatcher
    from streamkit_tpu_torch.models import vits
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS
    from streamkit_tpu_torch.nodes.ml.tts_node import VITS_RANDOM_VOCAB, SentenceSplitter
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    with open(os.path.join(SAMPLES, "media", "speech_8s.wav"), "rb") as f:
        bodies = [f.read()]
    bodies += [wav_body(np.concatenate([synth_speech(6.0, seed=30 + i), np.zeros(SR, np.float32)]))
               for i in range(3)]
    f32 = {"plugin::native::whisper": {"dtype": "float32"}, "plugin::native::nllb": {"dtype": "float32"}}
    per_encode = WHISPER_CONFIGS["tiny"].n_audio_layer
    report, texts = {}, []
    for name in ("speech_translate.yml", "voice_translate.yml"):
        pipeline = sample_pipeline(name, **f32)
        runs = {}
        for dev in ("cuda", "cpu"):
            registry = node_registry(dev)

            async def run(registry=registry, dev=dev):
                resources = ResourceManager()
                warm = DeviceBatcher(device=dev)
                await oneshot_bytes(registry, pipeline, bodies[0], resources, warm)  # loads the models
                warm.stop()
                batcher = DeviceBatcher(device=dev)  # its stats count the four requests alone
                if dev == "cuda":
                    torch.cuda.synchronize()
                reset_counts()  # counts from here to the end of the four requests
                t0 = time.monotonic()
                res = await asyncio.gather(*(oneshot_bytes(registry, pipeline, b, resources, batcher)
                                             for b in bodies))
                wall = time.monotonic() - t0
                if dev == "cuda":
                    torch.cuda.synchronize()
                counts = read_counts()
                batcher.stop()
                return res, wall, counts, batcher.stats()

            runs[dev] = asyncio.run(run())
        (card, wall, counts, stats), (host, wall_cpu, _, _) = runs["cuda"], runs["cpu"]
        encodes = kind_calls(stats, "whisper_ring:") + kind_calls(stats, "whisper_detect:")
        want = {**ZERO_LAUNCHES, "flash_attention": per_encode * encodes}
        entry = {"wall_s": wall, "wall_cpu_s": wall_cpu, "request_wall_s": [r[2] for r in card], "encodes": encodes,
                 "launches": counts, "batcher": stats}
        if name == "speech_translate.yml":
            equal = [(a[0], a[1]) == (b[0], b[1]) for a, b in zip(card, host)]
            lines = [[json.loads(x)["Text"] for x in r[1].decode().splitlines() if x.strip()] for r in card]
            texts = [t for ls in lines for t in ls]
            entry.update(equal_to_cpu=equal, lines=[len(ls) for ls in lines],
                         first_line=[ls[0][:48] if ls else None for ls in lines])
            ok = all(equal) and all(ls for ls in lines) and all(r[0] == "application/json" for r in card)
        else:
            diffs = [int(np.abs(wav_samples(a[1]) - wav_samples(b[1])).max()) if len(a[1]) == len(b[1]) else None
                     for a, b in zip(card, host)]
            entry.update(bytes=[len(r[1]) for r in card], max_sample_diff=diffs,
                         equal_bytes=[a[1] == b[1] for a, b in zip(card, host)])
            ok = all(r[0] == "audio/wav" for r in card) and all(
                a[1][:44] == b[1][:44] and len(a[1]) == len(b[1]) > 44 and d is not None and d <= WAVE_TOL
                for a, b, d in zip(card, host, diffs))
        report[name] = entry
        log(f"# cascade {name} " + json.dumps(entry))
        if not ok:
            raise AssertionError(f"cascade {name}: the card's responses differ from the CPU run")
        if counts != want or encodes == 0:
            raise AssertionError(f"cascade {name}: launches {counts}, expected {want}")
        kinds = {k.split(":")[0] for k in stats["kinds"]}
        if not {"whisper_ring", "nllb"} <= kinds or (name == "voice_translate.yml" and "tts_vits" not in kinds):
            raise AssertionError(f"cascade {name}: batcher kinds {sorted(kinds)}")
    # the VITS durations of each translated sentence, card against CPU
    cfg = vits.VitsConfig(sampling_rate=24000)
    tok = vits.VitsCharTokenizer(VITS_RANDOM_VOCAB)
    sentences = []
    for t in texts:
        sp = SentenceSplitter()
        sentences += sp.push(t + " ") + sp.flush()
    durs = {}
    with torch.inference_mode():
        for dev in ("cuda", "cpu"):
            params = vits.vits_init_params(cfg, device=dev)
            durs[dev] = []
            for s in sentences:
                x = torch.as_tensor(tok.encode(s)[None], device=dev)
                hidden, _, _ = vits.text_encoder(params, cfg, x)
                m = torch.ones_like(hidden[..., :1])
                durs[dev].append(vits.durations(vits.predict_durations(params, cfg, hidden, m), m, 1.0).cpu())
    equal = [torch.equal(a, b) for a, b in zip(durs["cuda"], durs["cpu"])]
    report["vits_durations"] = {"sentences": len(sentences), "equal": all(equal),
                                "frames": [int(d.sum()) for d in durs["cuda"]]}
    log("# cascade vits durations " + json.dumps(report["vits_durations"]))
    if not sentences or not all(equal):
        raise AssertionError(f"cascade: VITS durations differ on the card: {equal}")
    if not opus:
        log("# cascade text_to_speech.yml: libopus is absent, so its audio::opus::encoder step does not "
            "register: not run")
        return report
    pipeline = sample_pipeline("text_to_speech.yml")
    text = b"Hello from the card. This sentence is spoken by the port's text to speech node."
    out = {}
    for dev in ("cuda", "cpu"):
        async def run_tts(dev=dev):
            batcher = DeviceBatcher(device=dev)
            res = await oneshot_bytes(node_registry(dev), pipeline, text, batcher=batcher)
            batcher.stop()
            return res

        out[dev] = asyncio.run(run_tts())
    report["text_to_speech.yml"] = {dev: {"content_type": r[0], "bytes": len(r[1]), "wall_s": r[2]}
                                    for dev, r in out.items()}
    log("# cascade text_to_speech.yml " + json.dumps(report["text_to_speech.yml"]))
    if not all(r[1][:4] == b"OggS" and len(r[1]) > 1000 for r in out.values()):
        raise AssertionError("cascade text_to_speech.yml: no Ogg stream")
    return report

# ---------------------------------------------------------------------------
# 10. speech models at full width: Kokoro, Matcha and SenseVoice
# ---------------------------------------------------------------------------
KOKORO_DIR = os.path.join(SAMPLES, "kokoro-golden")
KOKORO_ATOL = 1e-4  # f32 audio, card against CPU: cuDNN's and the CPU's convolutions, 4 LSTM scans
MEL_ATOL = 1e-3  # f32 mel (peaks near 6) after 10 Euler steps, card against CPU


def kokoro_texts(n: int = 8) -> list:
    """``n`` request bodies of 2–4 sentences each, from seed 0, in the
    golden pack's characters; every third sentence is long enough (16
    words) to need more than the 512 frames the reference keeps."""
    rng = np.random.RandomState(0)
    words = ("the a speech card stream model voice sentence audio port style frame hello world quick brown fox "
             "jumps over lazy dog").split()
    out = []
    for i in range(n):
        sents = [" ".join(words[rng.randint(len(words))] for _ in range(16 if (i + j) % 3 == 0 else 4))
                 .capitalize() + "." for j in range(2 + i % 3)]
        out.append(" ".join(sents).encode())
    return out


def speech_pipeline(opus: bool):
    """``text_to_speech.yml``'s graph with the golden pack as the kokoro
    step's model dir; without libopus its Opus encoder and Ogg muxer become
    a WAV muxer."""
    import yaml

    from streamkit_tpu_torch.api import compile_pipeline_dict

    with open(os.path.join(SAMPLES, "pipelines", "system", "text_to_speech.yml")) as f:
        doc = yaml.safe_load(f)
    steps = []
    for step in doc["steps"]:
        if step["kind"] == "plugin::native::kokoro":
            step["params"] = dict(step.get("params") or {}, model_dir=KOKORO_DIR)
        if not opus and step["kind"] == "audio::opus::encoder":
            step = {"kind": "containers::wav::muxer"}
        elif not opus and step["kind"] == "containers::ogg::muxer":
            continue
        steps.append(step)
    doc["steps"] = steps
    return compile_pipeline_dict(doc)


def concurrent_requests(registry, pipeline, bodies, warm: bytes):
    """A warm request (it loads the model and registers the batcher kinds),
    then every body as its own oneshot request at once through one
    ``DeviceBatcher`` and one ``ResourceManager``, the kernel counts set to
    0 just before → (responses, wall s, launches, batcher stats)."""
    from streamkit_tpu_torch.core import ResourceManager
    from streamkit_tpu_torch.engine import DeviceBatcher

    async def run():
        resources = ResourceManager()
        warm_batcher = DeviceBatcher(device="cuda")
        await oneshot_bytes(registry, pipeline, warm, resources, warm_batcher)
        warm_batcher.stop()
        batcher = DeviceBatcher(device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.monotonic()
        res = await asyncio.gather(*(oneshot_bytes(registry, pipeline, b, resources, batcher) for b in bodies))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts()
        batcher.stop()
        await resources.clear()
        return res, wall, counts, batcher.stats()

    return asyncio.run(run())


def kind_summary(stats: dict, prefix: str) -> dict:
    calls = kind_calls(stats, prefix)
    items = sum(v["items"] for k, v in stats["kinds"].items() if k.startswith(prefix))
    return {"calls": calls, "items": items, "mean_batch": items / calls if calls else 0.0}


def kokoro_path(opus: bool) -> dict:
    """Kokoro through ``text_to_speech.yml``'s graph (the golden pack:
    hidden 512, style 256, 2 voices, 32 tokens; random from ``PRNGKey(0)``):
    8 concurrent requests of 2–4 sentences after a warm one; one
    ``kokoro_core`` call profiled; durations and audio at f32 on the card
    against the CPU."""
    from streamkit_tpu_torch.models import kokoro

    registry = node_registry("cuda")
    pipeline = speech_pipeline(opus)
    bodies = kokoro_texts()
    res, wall, counts, stats = concurrent_requests(registry, pipeline, bodies, b"A warm request. It loads the model.")
    ctype = "audio/ogg" if opus else "audio/wav"
    report = {"requests": len(bodies), "wall_s": wall, "request_wall_s": [r[2] for r in res], "bytes": [len(r[1]) for r in res],
              "launches": counts, "kokoro_dur": kind_summary(stats, "kokoro_dur:"),
              "kokoro_core": kind_summary(stats, "kokoro_core:")}
    if opus:
        ok = all(r[0] == ctype and r[1][:4] == b"OggS" and len(r[1]) > 8000 for r in res)
    else:  # 16-bit samples at 48 kHz: at least 1 s of sound each, none silent
        ok = all(r[0] == ctype and len(r[1]) > 44 + 96000 and np.abs(wav_samples(r[1])).max() > 0 for r in res)
    # f32, card against CPU: one batch of four sentences in the 64-token
    # bucket, the first needing 760 frames (cut to 512) with random weights
    cfg, cpu, tokens, voices = kokoro.load_kokoro_dir(KOKORO_DIR, device="cpu")
    card = tree_to(cpu, "cuda")
    sentences = ["hello there, this is a test of kokoro.", "the quick brown fox", "hello world, a frame.", "a"]
    ids = [tokens.encode(s) for s in sentences]
    tok, mask = (np.stack(a) for a in zip(*(kokoro.kokoro_token_row(i, cfg) for i in ids)))
    style = np.stack([voices[0][min(len(i), voices.shape[1] - 1)] for i in ids]).astype(np.float32)
    out = {}
    with torch.inference_mode():
        for dev, params in (("cuda", card), ("cpu", cpu)):
            args = [torch.as_tensor(a, device=dev) for a in (tok, mask, style)]
            dur = kokoro.kokoro_durations_batch(params, cfg, *args).cpu()
            fr = [kokoro.kokoro_frames(dur[r].numpy(), len(i), 1.0) for r, i in enumerate(ids)]
            f_pad = max(len(f[0]) for f in fr)
            fi = np.stack([np.pad(f[0], (0, f_pad - len(f[0]))) for f in fr])
            fm = np.stack([np.pad(f[1], (0, f_pad - len(f[1]))) for f in fr])
            core = [torch.as_tensor(a, device=dev) for a in (fi, fm)]
            audio, _ = kokoro.kokoro_core_batch(params, cfg, *args, *core, f_pad)
            out[dev] = (dur, audio.cpu(), [f[2] for f in fr])
            if dev == "cuda":
                report["core_call"] = dict(rows=len(ids), t_pad=tok.shape[1], f_pad=f_pad, **profile_call(
                    lambda: kokoro.kokoro_core_batch(params, cfg, *args, *core, f_pad), kokoro, "_bilstm"))
    diff = float((out["cuda"][1] - out["cpu"][1]).abs().max())
    report.update(f32_durations_equal=bool(torch.equal(out["cuda"][0], out["cpu"][0])), f32_max_abs_err=diff,
                  f32_frames=out["cpu"][2], f32_tol=KOKORO_ATOL)
    log("# speech models kokoro " + json.dumps(report))
    if not ok:
        raise AssertionError(f"kokoro: bad responses {[(r[0], len(r[1])) for r in res]}")
    if counts != ZERO_LAUNCHES or report["kokoro_core"]["calls"] == 0 or report["kokoro_dur"]["calls"] == 0:
        raise AssertionError(f"kokoro: launches {counts}, batcher {stats['kinds'].keys()}")
    if not report["f32_durations_equal"] or not diff <= KOKORO_ATOL or max(out["cpu"][2]) != 512:
        raise AssertionError(f"kokoro: the card's f32 run differs from the CPU's ({diff})")
    return report


def matcha_path() -> dict:
    """Matcha at its published widths (``MatchaConfig()``: d 192, 2 heads, 6
    encoder layers, ffn 768, 80 mels, decoder 256 × 4 blocks, 10 Euler
    steps) and ``HifiGanConfig()``, random from seed 0: one call of
    ``matcha_synthesize_mel`` + ``hifigan_generate`` at 16 rows × 64 tokens
    (512 frames) profiled, mel and frame counts of 2 rows at f32 on the card
    against the CPU; then the node (its own small random model) in 4
    concurrent requests through one batcher."""
    from streamkit_tpu_torch.api import compile_pipeline_dict
    from streamkit_tpu_torch.models import matcha
    from streamkit_tpu_torch.models.tts import HifiGanConfig, hifigan_generate, hifigan_init_params

    cfg, vcfg = matcha.MatchaConfig(), HifiGanConfig()
    cpu = matcha.matcha_init_params(cfg, 0, device="cpu")
    card, vcard = tree_to(cpu, "cuda"), hifigan_init_params(vcfg, 0, device="cuda")
    texts = translate_texts(16)
    ids = np.zeros((16, 64), np.int32)
    mask = np.zeros((16, 64), np.float32)
    for r, t in enumerate(texts):
        b = np.frombuffer(t.encode()[:64], np.uint8) % cfg.vocab_size
        ids[r, : len(b)], mask[r, : len(b)] = b, 1.0
    ids_c, mask_c = torch.as_tensor(ids, device="cuda"), torch.as_tensor(mask, device="cuda")

    def call():
        mel, n = matcha.matcha_synthesize_mel(card, cfg, ids_c, 512, mask=mask_c)
        return hifigan_generate(vcard, vcfg, mel), n

    report = {"config": cfg.__dict__, "params": sum(t.numel() for t in tree_leaves(card)), "rows": 16, "frames": 512}
    with torch.inference_mode():
        audio, n = call()  # warm
        torch.cuda.synchronize()
        reset_counts()
        report["call"] = profile_call(call, matcha, "_velocity")
        report["launches"] = read_counts()
        ok = bool(torch.isfinite(audio).all()) and audio.shape == (16, 512 * 256) and int(n.min()) > 0
        got = [matcha.matcha_synthesize_mel(p, cfg, torch.as_tensor(ids[:2], device=d), 512,
                                            mask=torch.as_tensor(mask[:2], device=d))
               for p, d in ((card, "cuda"), (cpu, "cpu"))]
    diff = float((got[0][0].cpu() - got[1][0]).abs().max())
    report.update(n_frames=n.cpu().tolist(), f32_frames_equal=bool(torch.equal(got[0][1].cpu(), got[1][1])),
                  f32_mel_max_abs_err=diff, f32_tol=MEL_ATOL)
    # the node: 4 concurrent requests through the registry and one batcher
    pipeline = compile_pipeline_dict({"mode": "oneshot", "steps": [
        {"kind": "streamkit::http_input"}, {"kind": "core::text_chunker", "params": {"min_length": 10}},
        {"kind": "plugin::native::matcha"}, {"kind": "containers::wav::muxer"}, {"kind": "streamkit::http_output"}]})
    bodies = [t.encode() for t in translate_texts(4)]
    res, wall, counts, stats = concurrent_requests(node_registry("cuda"), pipeline, bodies, b"A warm request.")
    report["node"] = {"requests": len(bodies), "wall_s": wall, "bytes": [len(r[1]) for r in res], "launches": counts,
                      "matcha": kind_summary(stats, "matcha:")}
    log("# speech models matcha " + json.dumps(report))
    if not ok or not all(r[0] == "audio/wav" and len(r[1]) > 44 + 22050 for r in res):
        raise AssertionError("matcha: bad audio")
    if report["launches"] != ZERO_LAUNCHES or counts != ZERO_LAUNCHES or report["node"]["matcha"]["calls"] == 0:
        raise AssertionError(f"matcha: launches {report['launches']} / {counts}, batcher {stats['kinds'].keys()}")
    if not report["f32_frames_equal"] or not diff <= MEL_ATOL:
        raise AssertionError(f"matcha: the card's f32 mel differs from the CPU's ({diff})")
    return report


def sensevoice_path() -> dict:
    """SenseVoice at its published widths (``SenseVoiceConfig()``: d 512, 4
    heads, 50 layers, ffn 2048, vocab 25055, 80 mels, LFR 7/6), random from
    seed 0, bf16, through a model dir holding a config-only
    ``sensevoice.npz``: ``speech_8s.wav`` and 7 synthetic clips of 6–20 s as
    concurrent oneshot requests (WAV → sensevoice → JSON) through one
    batcher; one batched forward at 8 × 20 s profiled; the CTC ids of 2
    clips at f32 on the card against the CPU."""
    import dataclasses
    import tempfile

    from streamkit_tpu_torch.api import compile_pipeline_dict
    from streamkit_tpu_torch.models import sensevoice as sv
    from streamkit_tpu_torch.ops.mel import log_mel_spectrogram
    from streamkit_tpu_torch.utils.speechsynth import synth_speech

    cfg = sv.SenseVoiceConfig()
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "streamkit_tpu_torch", "_build")
    os.makedirs(build_dir, exist_ok=True)
    clips = [synth_speech(float(s), seed=40 + i) for i, s in enumerate(np.linspace(6, 20, 7))]
    with open(os.path.join(SAMPLES, "media", "speech_8s.wav"), "rb") as f:
        bodies = [f.read()] + [wav_body(c) for c in clips]
    report = {"config": dataclasses.asdict(cfg), "clip_s": [8.0] + [len(c) / SR for c in clips]}
    with tempfile.TemporaryDirectory(dir=build_dir) as model_dir:
        np.savez(os.path.join(model_dir, "sensevoice.npz"), config=np.asarray(dataclasses.asdict(cfg), dtype=object))
        pipeline = compile_pipeline_dict({"mode": "oneshot", "steps": [
            {"kind": "streamkit::http_input"}, {"kind": "containers::wav::demuxer"},
            {"kind": "plugin::native::sensevoice", "params": {"model_dir": model_dir, "language": "en"}},
            {"kind": "core::json_serialize", "params": {"newline_delimited": True}},
            {"kind": "streamkit::http_output", "params": {"content_type": "application/json"}}]})
        res, wall, counts, stats = concurrent_requests(node_registry("cuda"), pipeline, bodies,
                                                       wav_body(synth_speech(2.0, seed=39)))
    lines = [[json.loads(x)["Transcription"] for x in r[1].decode().splitlines() if x.strip()] for r in res]
    report.update(requests=len(bodies), wall_s=wall, request_wall_s=[r[2] for r in res], launches=counts,
                  segments=[len(ls) for ls in lines], sensevoice=kind_summary(stats, "sensevoice:"))
    ok = all(r[0] == "application/json" and ls and all(t["language"] == "en" for t in ls)
             for r, ls in zip(res, lines))
    # one batched forward at 8 × 20 s (bf16, the node's dtype), profiled
    cpu = sv.sensevoice_params_from_numpy(sv.sensevoice_init_numpy(cfg, 0), cfg, device="cpu")
    bf16 = tree_to(cpu, "cuda", torch.bfloat16)
    report["params"] = sum(t.numel() for t in tree_leaves(cpu))
    audio = torch.as_tensor(np.stack([synth_speech(20.0, seed=60 + i)[: 20 * SR] for i in range(8)]), device="cuda")
    with torch.inference_mode():
        mel = log_mel_spectrogram(audio, cfg.n_mels)
        t_lfr = (mel.shape[1] + cfg.lfr_n - 1) // cfg.lfr_n
        mask = torch.ones(8, t_lfr, device="cuda")
        lang = torch.full((8,), sv.LANGUAGES["en"], dtype=torch.int32, device="cuda")
        forward = lambda: sv.sensevoice_logits(bf16, cfg, mel, mask, lang, torch.ones_like(lang))  # noqa: E731
        forward()
        torch.cuda.synchronize()
        reset_counts()
        report["forward_8x20s"] = dict(t_lfr=t_lfr, **profile_call(forward, sv, "_fsmn"))
        report["forward_launches"] = read_counts()
        del bf16
        # f32 CTC ids of 2 clips (6 s and 8.3 s), card against CPU
        card = tree_to(cpu, "cuda")
        ids = {}
        for dev, params in (("cuda", card), ("cpu", cpu)):
            ids[dev] = []
            for c in clips[:2]:
                m = log_mel_spectrogram(torch.as_tensor(c[None], device=dev), cfg.n_mels)
                n = (m.shape[1] + cfg.lfr_n - 1) // cfg.lfr_n
                one = torch.ones(1, dtype=torch.int32, device=dev)
                logits = sv.sensevoice_logits(params, cfg, m, torch.ones(1, n, device=dev), 2 * one, one)
                ids[dev] += sv.ctc_collapse(logits[:, 2:].argmax(-1).cpu().numpy(), np.ones((1, n), bool))
    del card, cpu
    torch.cuda.empty_cache()
    report.update(f32_ids_equal=ids["cuda"] == ids["cpu"], f32_ids_lengths=[len(x) for x in ids["cuda"]])
    log("# speech models sensevoice " + json.dumps(report))
    if not ok:
        raise AssertionError(f"sensevoice: bad responses {report['segments']}")
    if counts != ZERO_LAUNCHES or report["forward_launches"] != ZERO_LAUNCHES or report["sensevoice"]["calls"] == 0:
        raise AssertionError(f"sensevoice: launches {counts}, batcher {stats['kinds'].keys()}")
    if not report["f32_ids_equal"]:
        raise AssertionError("sensevoice: the card's f32 CTC ids differ from the CPU's")
    return report


def speech_phase(opus: bool) -> dict:
    """The three speech-model paths; ``launches`` sums each kernel's
    launches over them (each path counts from 0 and must see none)."""
    out = {"launches": dict(ZERO_LAUNCHES)}
    for name, fn in (("kokoro", lambda: kokoro_path(opus)), ("matcha", matcha_path), ("sensevoice", sensevoice_path)):
        t0 = time.monotonic()
        out[name] = fn()
        log(f"# speech models {name} wall {time.monotonic() - t0:.1f} s")
        for counts in (out[name]["launches"], out[name].get("node", {}).get("launches", {}),
                       out[name].get("forward_launches", {})):
            for k, v in counts.items():
                out["launches"][k] += v
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 14. the server: the port's entry point, over real sockets
# ---------------------------------------------------------------------------
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def node_states_done(pipeline: dict) -> bool:
    """Every node of a session's pipeline snapshot stopped; raises on a failure."""
    states = [n.get("state") for n in pipeline["nodes"].values()]
    if any(isinstance(st, dict) and "failed" in st for st in states):
        raise AssertionError(f"server session: a node failed: {pipeline['nodes']}")
    return bool(states) and all(isinstance(st, dict) and "stopped" in st for st in states)


def server_subprocess_phase() -> dict:
    """(a) ``python3 -m streamkit_tpu_torch.server serve --address 127.0.0.1
    --port 0`` as a child process: its log names the port it bound; it
    answers ``/healthz``, ``/api/v1/config`` and ``/api/v1/schema/nodes``
    (the kinds the in-process registry on ``cuda`` describes), then exits 0 on
    SIGINT and leaves no compute process on the card."""
    import re
    import signal
    import threading

    from streamkit_tpu_torch.server.http import ClientSession

    env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    proc = subprocess.Popen([sys.executable, "-m", "streamkit_tpu_torch.server", "serve", "--address", "127.0.0.1",
                             "--port", "0"], cwd=REPO_DIR, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    lines, port, bound = [], [], threading.Event()

    def drain():  # the child's log, read to its end so the pipe never fills
        for line in proc.stderr:
            lines.append(line)
            m = re.search(r"serving on 127\.0\.0\.1:(\d+)", line)
            if m and not port:
                port.append(int(m.group(1)))
                bound.set()
        bound.set()

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        if not bound.wait(300) or not port:
            raise AssertionError("server subprocess reported no port: " + "".join(lines[-20:]))
        t_bound = time.monotonic() - t0
        base = f"http://127.0.0.1:{port[0]}"

        async def ask():
            client, out = ClientSession(timeout=120), {}
            for path in ("/healthz", "/api/v1/config", "/api/v1/schema/nodes"):
                r = await client.get(base + path)
                out[path] = (r.status, await r.json())
            return out

        got = asyncio.run(ask())
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.split()
    kinds = sorted(n["kind"] for n in got["/api/v1/schema/nodes"][1]["nodes"])
    # the schema lists the kinds the registry can describe: all but those
    # that need params to build (core::script), as in the JAX server
    want = sorted(d.kind for d in node_registry("cuda").definitions())
    report = {"port": port[0], "bound_after_s": t_bound, "exit_code": rc, "kinds": len(kinds),
              "health": got["/healthz"], "config_status": got["/api/v1/config"][0],
              "pid_left_on_card": str(proc.pid) in apps,
              "warnings": [ln.strip() for ln in lines if " WARNING " in ln]}
    log("# server subprocess " + json.dumps(report))
    if (got["/healthz"] != (200, {"status": "ok"}) or got["/api/v1/config"][0] != 200 or kinds != want
            or rc != 0 or report["pid_left_on_card"]):
        raise AssertionError(f"server subprocess: {report}; kinds {kinds} against {want}")
    return report


def asset_file_app(root: str):
    """Serves the files under ``root`` at ``/assets/{id}``: the server (as the
    JAX one) lists, uploads and deletes assets but returns no asset's bytes,
    so the fetcher reads the uploaded file from here."""
    from streamkit_tpu_torch.server import http

    async def get(request):
        path = os.path.join(root, os.path.basename(request.match_info["id"]))
        if not os.path.isfile(path):
            raise http.HTTPNotFound()
        return http.FileResponse(path)

    app = http.Application()
    app.router.add_get("/assets/{id}", get)
    return app


def stream_slots_held() -> dict:
    """Held rows of every stream table, by table."""
    from streamkit_tpu_torch.models.whisper import streaming

    return {f"{tag}@{dev}": t.max_slots - len(t._free) for (tag, dev), t in streaming._TABLES.items()}


def recording_app(paths):
    """A loopback stub on the port's HTTP layer: keeps every request to
    ``paths`` (method, path, headers, body, host seconds at arrival) and
    answers it with JSON. An OTLP collector and a ``fetch()`` target."""
    from streamkit_tpu_torch.server import http

    app = http.Application()
    app["seen"] = []

    async def handle(request):
        body = await request.read()
        app["seen"].append({"method": request.method, "path": request.path, "t": time.monotonic(),
                            "headers": {k.lower(): v for k, v in request.headers.items()}, "body": body})
        return http.json_response({"ok": True, "path": request.path})

    for path in paths:
        for method in ("GET", "POST"):
            app.router.add_route(method, path, handle)
    return app


SCRIPT_SECRET_ENV = "SKIT_SMOKE_SCRIPT_TOKEN"
FETCH_SCRIPT = """
def process(p):
    if p.kind != 'transcription':
        return p
    reply = fetch('STUB/allowed/caption')
    try:
        fetch('STUB/denied/caption')
        refused = ''
    except Exception as e:
        refused = str(e)
    return custom_packet('skit/fetch@1', {'reply': reply, 'refused': refused})
"""


def loadtest_files(directory: str, base: str, stt: dict, body: bytes, live: dict, speech8: str) -> str:
    """The load test's TOML and the files it names: oneshot ``stt`` (at
    :data:`LOADTEST_WHISPER`'s budget) on ``body`` at concurrency 4; 2 dynamic sessions of the live-captions graph
    (WAV in, an ``audio::gain`` before the whisper step, captions to a sink),
    their gain tuned every 200 ms; 30 s, mixed."""
    import yaml

    oneshot_yml, media, live_yml = (os.path.join(directory, n) for n in ("lt_stt.yml", "lt_speech.wav", "lt_live.yml"))
    with open(oneshot_yml, "w") as f:
        yaml.safe_dump(stt, f)
    with open(media, "wb") as f:
        f.write(body)
    nodes = {"reader": {"kind": "core::file_reader", "params": {"path": speech8}},
             "demux": {"kind": "containers::wav::demuxer", "needs": "reader"},
             "pacer": {"kind": "core::pacer", "params": {"speed": 4.0}, "needs": "demux"},
             "resample": {"kind": "audio::resampler", "params": live["audio::resampler"], "needs": "pacer"},
             "gain": {"kind": "audio::gain", "params": {"gain": 1.0}, "needs": "resample"},
             "stt": {"kind": "plugin::native::whisper", "params": live["plugin::native::whisper"], "needs": "gain"},
             "json": {"kind": "core::json_serialize", "params": live["core::json_serialize"], "needs": "stt"},
             "sink": {"kind": "core::sink", "needs": "json"}}
    with open(live_yml, "w") as f:
        yaml.safe_dump({"name": "loadtest live captions", "mode": "dynamic", "nodes": nodes}, f, sort_keys=False)
    toml = os.path.join(directory, "loadtest.toml")
    with open(toml, "w") as f:
        f.write(f'[server]\nurl = "{base}"\n\n[test]\nduration_secs = {LOADTEST_SECS}\nscenario = "mixed"\n\n'
                f'[oneshot]\nenabled = true\nconcurrency = 4\npipeline = "{oneshot_yml}"\ninput_file = "{media}"\n\n'
                f'[dynamic]\nenabled = true\nsession_count = 2\ntune_interval_ms = 200\npipelines = ["{live_yml}"]\n\n'
                f'[output]\nformat = "text"\nreal_time_updates = true\nupdate_interval_ms = 5000\n')
    return toml


LOADTEST_SECS = 30.0
LOADTEST_ONESHOT_SECS = 15.0  # the oneshot workers alone, before the mixed run
# The load test's oneshot whisper step. A 10 s utterance is about 25 words,
# some 32 tokens; random weights never emit end-of-text, so the budget alone
# sets each request's decode length (at the default 224 one request outlasts
# the 30 s run, and each worker finishes a single round).
LOADTEST_WHISPER = {"model_size": "large-v3", "dtype": "bfloat16", "language": "auto", "max_tokens": 32}


async def server_plugins_step(client, base: str, state, post_process) -> dict:
    """Step 7b of the server phase, on the files :func:`plugins_path` built:
    ``POST /api/v1/plugins`` with each of the three, ``GET`` lists them with
    their ABI version and runtime, ``/api/v1/schema/nodes`` names their
    kinds, one multipart ``POST /api/v1/process`` through the uploaded native
    gain gives the lines of the ``# plugins`` requests (K1 32 per encode, no
    K2 or K3), each is deleted (native: ``deleted``, WASM: ``removed``); then
    ``skit-tpu-cli plugins list``, ``load`` and ``delete`` as child processes
    against this server, each exiting 0."""
    from streamkit_tpu_torch.server.http import FormData

    files, per = PLUGINS["files"], flash_per_encode()
    want_kinds = {"native": "plugin::native::gain_cpp", "wasm": "plugin::wasm::wgain", "component": "plugin::wasm::gain"}
    uploads = {}
    for runtime, path in files.items():
        form = FormData()
        with open(path, "rb") as f:
            form.add_field("file", f.read(), filename=os.path.basename(path))
        r = await client.post(base + "/api/v1/plugins", data=form)
        uploads[runtime] = (r.status, await r.json())
    listed = (await (await client.get(base + "/api/v1/plugins")).json())["plugins"]
    schema = {n["kind"] for n in (await (await client.get(base + "/api/v1/schema/nodes")).json())["nodes"]}
    before = state.batcher.stats()
    reset_counts()
    _, out, wall = await post_process(base, plugin_doc(*PLUGINS["steps"]["native"]), PLUGINS["body"])
    torch.cuda.synchronize()
    counts, stats = read_counts(), state.batcher.stats()
    encodes = sum(kind_calls(stats, p) - kind_calls(before, p) for p in ("whisper_ring:", "whisper_detect:"))
    rows = transcripts(out)
    deletes = {}
    for runtime, kind in want_kinds.items():
        r = await client.delete(f"{base}/api/v1/plugins/{kind}")
        deletes[runtime] = (r.status, await r.json())
    left = (await (await client.get(base + "/api/v1/plugins")).json())["plugins"]
    env = dict(os.environ, PYTHONPATH=REPO_DIR + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # a CLI child's start alone: the interpreter, the CLI's imports, --help
    t0 = time.monotonic()
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "streamkit_tpu_torch.cli", "--help", cwd=REPO_DIR, env=env,
        stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
    await asyncio.wait_for(proc.communicate(), 300)
    help_s, help_rc = time.monotonic() - t0, proc.returncode
    cli = []
    for args in (["list"], ["load", files["native"]], ["delete", want_kinds["native"]]):
        t0 = time.monotonic()
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "streamkit_tpu_torch.cli", "plugins", *args, "-s", base, cwd=REPO_DIR, env=env,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        stdout, stderr = await asyncio.wait_for(proc.communicate(), 300)
        cli.append({"args": args, "rc": proc.returncode, "wall_s": time.monotonic() - t0,
                    "stdout": stdout.decode()[-300:], "stderr": stderr.decode()[-300:]})
    report = {"uploads": uploads, "listed": [(p["kind"], p["runtime"], p["abi_version"]) for p in listed],
              "wall_s": wall, "lines": len(rows), "equal_to_plugins_path": rows == PLUGINS["lines"],
              "encodes": encodes, "launches": counts, "deletes": deletes, "left": left,
              "cli": [{k: c[k] for k in ("args", "rc", "wall_s")} for c in cli], "cli_help_s": help_s,
              "left_after_cli": (await (await client.get(base + "/api/v1/plugins")).json())["plugins"]}
    log("# server plugins " + json.dumps(report))
    walls = ", ".join(f"{c['wall_s']:.2f}" for c in cli)
    log(f"# cli child start: --help {help_s:.2f} s (rc {help_rc}); plugins children {walls} s "
        "(8.24-11.19 s a child when the CLI imported torch)")
    want_listed = [("plugin::native::gain_cpp", "native", 2), ("plugin::wasm::wgain", "wasm", 1),
                   ("plugin::wasm::gain", "wasm", 1)]
    if (any(uploads[r] != (201, {"kind": k, "description": uploads[r][1].get("description")})
            for r, k in want_kinds.items())
            or report["listed"] != want_listed or not set(want_kinds.values()) <= schema
            or deletes != {"native": (200, {"deleted": want_kinds["native"]}),
                           "wasm": (200, {"removed": want_kinds["wasm"]}),
                           "component": (200, {"removed": want_kinds["component"]})} or left):
        raise AssertionError(f"server plugins: {report}")
    if rows != PLUGINS["lines"]:
        raise AssertionError(f"server plugins: lines {rows} != the # plugins requests' {PLUGINS['lines']}")
    if counts != {**ZERO_LAUNCHES, "flash_attention": per * encodes} or encodes == 0:
        raise AssertionError(f"server plugins request launched {counts} for {encodes} encodes")
    if help_rc != 0 or any(c["rc"] != 0 for c in cli) or "gain_cpp" not in cli[1]["stdout"] \
            or report["left_after_cli"]:
        raise AssertionError(f"skit-tpu-cli plugins: {cli}")
    return report


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


class WebTransportSubscribers:
    """The two WebTransport subscribers of the server's live session: the
    port's native ``MoqClient`` and its ``MoqLiteClient`` on the server's
    QUIC acceptor, each pinning the fingerprint that
    ``/api/v1/moq/fingerprints`` serves."""

    def __init__(self, relay, broadcast: str) -> None:
        self.relay, self.broadcast = relay, broadcast
        self.clients, self.frames, self.tasks, self.consumers, self.handshake_ms = {}, {}, [], {}, {}

    async def subscribe(self, fps: dict) -> None:
        from streamkit_tpu_torch.moq.lite_session import MoqLiteClient
        from streamkit_tpu_torch.moq.session import MoqClient

        pins = [bytes.fromhex(f) for f in fps["fingerprints"]]
        for label, cls in (("native", MoqClient), ("lite", MoqLiteClient)):
            bc = self.relay.get(self.broadcast)
            before = set(bc._consumers)
            client = self.clients[label] = cls()
            t0 = time.perf_counter()
            await client.connect("127.0.0.1", fps["port"], pins)
            self.handshake_ms[label] = (time.perf_counter() - t0) * 1e3
            sub = await client.subscribe(self.broadcast, timeout=30)
            t0 = time.monotonic()
            while len(bc._consumers) == len(before):  # the acceptor's relay subscription
                if time.monotonic() - t0 > 30:
                    raise AssertionError(f"the WebTransport {label} subscriber never reached the relay")
                await asyncio.sleep(0.01)
            (self.consumers[label],) = set(bc._consumers) - before
            out = self.frames[label] = []
            self.tasks.append(asyncio.ensure_future(self._collect(sub, out)))

    @staticmethod
    async def _collect(sub, out: list) -> None:
        while True:
            f = await sub.recv()
            if f is None:
                return
            out.append(f)

    async def finish(self, ws_frames: list) -> dict:
        """Once the WebSocket subscriber has the whole broadcast: wait for the
        WebTransport ones to drain, close them, and compare."""
        t0 = time.monotonic()
        while any(len(f) < len(ws_frames) for f in self.frames.values()) and time.monotonic() - t0 < 20:
            await asyncio.sleep(0.05)
        for task in self.tasks:
            task.cancel()
        for client in self.clients.values():
            client.close()
        subs = {"websocket": ws_frames, **{k: [(p, ts) for p, ts, _ in v] for k, v in self.frames.items()}}
        final = {}
        for label, got in subs.items():
            finals = [r["text"] for r in transcripts(b"".join(p for p, _ in got)) if r["is_final"]]
            final[label] = finals[-1] if finals else None
        common = set.intersection(*(set(v) for v in subs.values()))
        same = len({tuple(f for f in v if f in common) for v in subs.values()}) == 1
        dropped = {"websocket": None, **{k: c.dropped_groups for k, c in self.consumers.items()}}
        report = {"handshake_ms": self.handshake_ms, "frames": {k: len(v) for k, v in subs.items()},
                  "dropped_groups": dropped, "common_frames": len(common), "common_equal": same,
                  "final_line_equal": len(set(final.values())) == 1 and None not in final.values()}
        if not (same and common and report["final_line_equal"]):
            raise AssertionError(f"webtransport subscribers disagree with the WebSocket one: {report}; "
                                 f"finals {final}")
        if not any(dropped.values()) and len({tuple(v) for v in subs.values()}) != 1:
            raise AssertionError(f"webtransport subscribers dropped no group but got other frames: {report}")
        return report


class _NoWebTransport:
    """Stands in for :class:`WebTransportSubscribers` where no libcrypto loads."""

    def __init__(self, reason: str) -> None:
        self.reason = reason

    async def finish(self, ws_frames: list) -> dict:
        return {"absent": self.reason}


async def webtransport_subscribers(state, client, base: str, broadcast: str):
    """Join the live session's WebSocket subscriber on ``broadcast`` with the
    two WebTransport subscribers, or say why there are none (libcrypto
    absent: then the server runs no acceptor and 404s the fingerprints)."""
    from streamkit_tpu_torch.quic import _libcrypto

    r = await client.get(base + "/api/v1/moq/fingerprints")
    fps = await r.json() if r.status == 200 else None
    try:
        _libcrypto.lib()
    except _libcrypto.LibcryptoUnavailable as e:
        if state.webtransport is not None or r.status != 404:
            raise AssertionError(f"an acceptor runs although libcrypto does not load: {r.status} {fps}")
        log(f"# webtransport: OpenSSL's libcrypto is absent ({e}): the server serves MoQ over /moq/{{path}} only")
        return _NoWebTransport(str(e))
    if state.webtransport is None or r.status != 200 or fps["port"] != state.webtransport.port:
        raise AssertionError(f"libcrypto loads but the acceptor is missing: {r.status} {fps}")
    subs = WebTransportSubscribers(state.moq_relay, broadcast)
    await subs.subscribe(fps)
    return subs


async def quic_push_s(nbytes: int) -> float:
    """Seconds to push ``nbytes`` over one QUIC stream between the port's own
    client and server on loopback, until the server acknowledges the count."""
    import hashlib

    from streamkit_tpu_torch.quic.connection import StreamEvent
    from streamkit_tpu_torch.quic.endpoint import connect, serve
    from streamkit_tpu_torch.quic.tls import generate_self_signed

    cert, key = generate_self_signed()

    async def on_conn(proto):
        await proto.handshake_done
        got = 0
        while True:
            ev = await proto.events.get()
            if isinstance(ev, StreamEvent):
                got += len(ev.data)
                if ev.fin:
                    proto.conn.send_stream_data(ev.stream_id, str(got).encode(), fin=True)
                    proto.transmit()

    server, transport = await serve("127.0.0.1", 0, cert, key, on_conn)
    client, proto = await connect("127.0.0.1", transport.get_extra_info("sockname")[1],
                                  [hashlib.sha256(cert).digest()])
    try:
        blob = os.urandom(nbytes)
        t0 = time.perf_counter()
        sid = proto.conn.open_bidi_stream()
        proto.conn.send_stream_data(sid, blob, fin=True)
        proto.transmit()
        reply = b""
        while True:
            ev = await asyncio.wait_for(proto.events.get(), 120)
            if isinstance(ev, StreamEvent) and ev.stream_id == sid:
                reply += ev.data
                if ev.fin:
                    break
        wall = time.perf_counter() - t0
    finally:
        client.close()
        server.close()
    if int(reply) != nbytes:
        raise AssertionError(f"quic push: the server counted {reply!r} of {nbytes} bytes")
    return wall


async def webtransport_report(subs: dict) -> dict:
    """``# webtransport``: the subscribers' comparison, libcrypto's path and
    version, host µs to seal and to open one 1200-byte packet (AES-128-GCM
    with the header as AAD, one key set) and to make one header-protection
    mask, and the seconds to push 4 MiB over one loopback stream."""
    import importlib.util

    from streamkit_tpu_torch.quic import _libcrypto

    # the port never imports it; recorded because the JAX stack needs it
    report = dict(subs, cryptography_installed=importlib.util.find_spec("cryptography") is not None)
    if "absent" not in subs:
        from streamkit_tpu_torch.quic.crypto import keys_from_secret

        keys = keys_from_secret(os.urandom(32))
        header, payload, n = os.urandom(22), os.urandom(1200), 2000
        t0 = time.perf_counter()
        sealed = [keys.seal(pn, header, payload) for pn in range(n)]
        seal_us = (time.perf_counter() - t0) / n * 1e6
        t0 = time.perf_counter()
        opened = [keys.open(pn, header, c) for pn, c in enumerate(sealed)]
        open_us = (time.perf_counter() - t0) / n * 1e6
        t0 = time.perf_counter()
        for c in sealed:
            keys.hp_mask(c[4:20])
        mask_us = (time.perf_counter() - t0) / n * 1e6
        if any(o != payload for o in opened):
            raise AssertionError("webtransport: a sealed packet did not open to its payload")
        push_s = await quic_push_s(4 << 20)
        report.update(libcrypto=_libcrypto.library_path(), libcrypto_version=_libcrypto.version(),
                      seal_1200_us=seal_us, open_1200_us=open_us, hp_mask_us=mask_us,
                      push_4mib_s=push_s, push_4mib_mib_per_s=4 / push_s)
    report["card"] = card_line()
    log("# webtransport " + json.dumps(report))
    return report


def server_phase() -> dict:
    """(b) ``create_app(device="cuda")`` on 127.0.0.1:0 in this script's
    loop; every request through real sockets and the port's client:

    1. a warm request (the model loads; the batched kinds are then warmed
       and the whisper kinds set to coalesce four, as in phase 4);
    2. four concurrent multipart ``POST /api/v1/process`` with phase 4's
       pipeline (large-v3 bf16, ``language: auto``) and its four WAV
       bodies: phase 4's transcript checks, K1 32 per encode, each wall
       beside phase 4's in-process wall for the same body;
    3. a WAV uploaded through ``POST /api/v1/assets``, read back over HTTP
       by ``transport::http::fetcher`` in a session made by ``POST
       /api/v1/sessions`` (fetcher → WAV demuxer → whisper → JSON lines to
       a file): Transcription lines, K1 32 per encode;
    4. ``double_volume.yml`` on ``tone.wav``: bytes equal to the port's CPU run;
    5. ``live_captions.yml``'s graph built over the WebSocket control plane
       (``createsession``, ``addnode``, ``connect``; ``core::file_reader`` on
       ``speech_8s.wav`` and the WAV demuxer in place of the MoQ subscriber
       and the Opus decoder, a 4× pacer), its captions published by
       ``transport::moq::publisher {broadcast: captions}`` and read by a
       WebSocket subscriber on ``/moq/captions`` and by two WebTransport
       subscribers over QUIC (:func:`webtransport_subscribers`; where
       OpenSSL's libcrypto does not load, the WebSocket one alone):
       partials and a final;
       exactly 2 K2, 32 K3 and 96 K4 per fused call, K1 32 per ring decode; a
       device profile taken meanwhile names K3; after ``destroysession`` no
       session and no stream-table row is left;
    6. ``/api/v1/metrics`` and the heap route (CUDA memory in use);
    7. ``# script`` fetch: a oneshot request whose ``core::script`` step
       (Python dialect) calls ``fetch()`` on a loopback stub in the
       allowlist of the server's ``[script]`` config, with a secret header
       scoped to it, and on a URL outside it: the header arrives, the other
       call is refused;
    7b. ``# server plugins``: :func:`server_plugins_step`;
    8. ``# loadtest``: ``cli/loadtest.py`` ``run_load_test`` (what
       ``skit-tpu-cli lt`` runs) on one TOML: 4 oneshot workers with step
       2's pipeline at a 32-token budget on its 10 s body, alone for 15 s
       (``# loadtest_oneshot_only``), then mixed for 30 s with 2 dynamic
       workers cycling sessions of the live-captions graph (an
       ``audio::gain`` before the whisper step, tuned every 200 ms); every
       request must succeed; K1, K2, K3 and K4 launches and each batched
       kind's calls and host wall a call are counted over each run;
    9. OTLP: a second server on the same model cache, started with
       ``otlp_endpoint`` on a collector stub and a 1 s interval, serves one
       session of step 3's graph (24 tokens); the stub must get
       ``/v1/metrics`` and ``/v1/logs`` naming the session's events
       (``sessioncreated``, the whisper step's ``stt.result`` telemetry);
       host ms per push. Only this step runs with the pusher and span
       recording on: both stop with that server.

    (c) The node context check through servers: a small f32 Whisper whose
    encoder takes K1, the same request to this server and to one on
    ``cpu``: equal Transcription lines (confidence within 1e-4)."""
    import tempfile
    import wave

    import yaml

    from streamkit_tpu_torch.core.moq_gateway import decode_media_frame
    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig
    from streamkit_tpu_torch.nodes.ml.whisper_node import warmup_batched_kinds
    from streamkit_tpu_torch.server import ServerConfig, create_app
    from streamkit_tpu_torch.server.http import AppRunner, ClientSession, FormData, WSMsgType
    from streamkit_tpu_torch.utils.speechsynth import synth_speech
    from streamkit_tpu_torch.utils.tracing import get_tracer

    report = {}
    per = flash_per_encode()
    rng = np.random.RandomState(0)
    secs = (10.0, 13.0, 16.0, 19.0)
    bodies = [wav_body(session_audio(rng, s)) for s in secs]  # phase 4's bodies
    stt = stt_doc({"model_size": "large-v3", "dtype": "bfloat16", "language": "auto"})
    with open(os.path.join(SAMPLES, "pipelines", "system", "live_captions.yml")) as f:
        live = {st["kind"]: st.get("params") or {} for st in yaml.safe_load(f)["steps"]}
    with open(os.path.join(SAMPLES, "pipelines", "system", "double_volume.yml")) as f:
        double_volume = f.read()
    with open(os.path.join(SAMPLES, "media", "tone.wav"), "rb") as f:
        tone = f.read()
    _, tone_cpu, _ = asyncio.run(oneshot_bytes(node_registry("cpu"), sample_pipeline("double_volume.yml"), tone))
    speech8 = os.path.join(SAMPLES, "media", "speech_8s.wav")
    with wave.open(speech8) as w:
        speech8_s = w.getnframes() / w.getframerate()
    WHISPER_CONFIGS["server-check"] = WhisperConfig(
        n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2, n_vocab=51865,
        n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2)
    check_audio = np.concatenate([np.zeros(SR // 2, np.float32), synth_speech(2.5, seed=21),
                                  np.zeros(SR, np.float32)])
    script_body = wav_body(np.concatenate([synth_speech(6.0, seed=31), np.zeros(SR, np.float32)]))
    tmp = tempfile.TemporaryDirectory()
    cfg = ServerConfig()
    cfg.moq_host, cfg.moq_port = "127.0.0.1", 0  # the WebTransport acceptor on an ephemeral UDP port
    cfg.assets_dir = os.path.join(tmp.name, "assets")
    cfg.plugins_dir = os.path.join(tmp.name, "plugins")

    async def run():
        collector_app = recording_app(["/v1/metrics", "/v1/logs", "/v1/traces"])
        collector_runner = AppRunner(collector_app)
        collector_base = f"http://127.0.0.1:{await collector_runner.start('127.0.0.1', 0)}"
        fetch_app = recording_app(["/allowed/{tail:.*}", "/denied/{tail:.*}"])
        fetch_runner = AppRunner(fetch_app)
        stub_base = f"http://127.0.0.1:{await fetch_runner.start('127.0.0.1', 0)}"
        cfg.script_fetch_allowlist = [{"url": f"{stub_base}/allowed/*", "methods": ["GET"]}]
        cfg.script_secrets = {"smoke_token": {"env": SCRIPT_SECRET_ENV, "allowed_fetch_urls": [f"{stub_base}/allowed/*"]}}
        os.environ[SCRIPT_SECRET_ENV] = "smoke-secret-0"
        app = create_app(cfg, device="cuda")
        state = app["state"]
        runner = AppRunner(app)
        base = f"http://127.0.0.1:{await runner.start('127.0.0.1', 0)}"
        client = ClientSession(timeout=900)
        files = AppRunner(asset_file_app(os.path.join(cfg.assets_dir, "user")))
        files_base = f"http://127.0.0.1:{await files.start('127.0.0.1', 0)}"
        cpu_runner = otlp_runner = None

        async def post_process(url, doc, body, config_text=None):
            form = FormData()
            form.add_field("config", config_text or json.dumps(doc))  # JSON is YAML
            form.add_field("media", body, filename="in.wav", content_type="audio/wav")
            t0 = time.monotonic()
            r = await client.post(url + "/api/v1/process", data=form)
            out = await r.read()
            if r.status != 200:
                raise AssertionError(f"server request {r.status}: {out[:500]!r}")
            return r.headers.get("Content-Type"), out, time.monotonic() - t0

        async def stt_request(body):
            ctype, out, wall = await post_process(base, stt, body)
            if ctype != "application/json":
                raise AssertionError(f"server response content type {ctype}")
            return transcripts(out), wall

        async def wait_session(sid, limit_s=600.0, url=None):
            t0 = time.monotonic()
            while time.monotonic() - t0 < limit_s:
                await asyncio.sleep(0.25)
                r = await client.get(f"{url or base}/api/v1/sessions/{sid}/pipeline")
                if node_states_done((await r.json())["pipeline"]):
                    return time.monotonic() - t0
            raise AssertionError(f"server session {sid} did not end")

        try:
            # 1. warm request, then the batched kinds warmed as in phase 4
            t0 = time.monotonic()
            await stt_request(wav_body(np.zeros(SR, np.float32)))
            report["warm_request_s"] = time.monotonic() - t0
            await warmup_batched_kinds(state.batcher, sweep_to=0)
            whisper_kinds = [k for k in state.batcher.registered_kinds()
                             if k.startswith(("whisper_ring:", "whisper_detect:"))]
            for name in whisper_kinds:
                state.batcher.set_expected(name, len(bodies))

            # 2. four concurrent oneshot STT requests
            before = state.batcher.stats()
            reset_counts()
            t0 = time.monotonic()
            out = await asyncio.gather(*(stt_request(b) for b in bodies))
            report["oneshot_wall_s"] = time.monotonic() - t0
            counts, stats = read_counts(), state.batcher.stats()
            for name in whisper_kinds:
                state.batcher.set_expected(name, None)
            encodes = sum(kind_calls(stats, p) - kind_calls(before, p) for p in ("whisper_ring:", "whisper_detect:"))
            for i, ((rows, wall), sec) in enumerate(zip(out, secs)):
                log("# server request " + json.dumps({"audio_s": sec, "wall_s": wall,
                                                      "phase4_in_process_wall_s": SEGMENT_WALLS.get(sec),
                                                      "lines": len(rows)}))
                show(rows, f"server request {i} transcription")
                check_transcripts(rows, sec, f"server request {i}")
                if any(r["confidence"] is None for r in rows if r["is_final"]):
                    raise AssertionError(f"server request {i}: a ring-decode final without a confidence")
            want = {**ZERO_LAUNCHES, "flash_attention": per * encodes}
            kinds = {k: {f: v[f] - before["kinds"].get(k, {}).get(f, 0) for f in ("calls", "items")}
                     for k, v in stats["kinds"].items()}
            report["oneshot"] = {"warm_request_s": report["warm_request_s"], "wall_s": report["oneshot_wall_s"],
                                 "encodes": encodes, "launches": counts, "expected": want,
                                 "kinds": {k: v for k, v in kinds.items() if v["calls"]}}
            log("# server oneshot " + json.dumps(report["oneshot"]))
            if counts != want or encodes == 0:
                raise AssertionError(f"server oneshot requests launched {counts}, expected {want}")

            # 3. the fetcher reads an uploaded asset back over HTTP
            form = FormData()
            form.add_field("file", bodies[0], filename="speech.wav", content_type="audio/wav")
            r = await client.post(base + "/api/v1/assets", data=form)
            uploaded = (r.status, await r.json())
            out_path = os.path.join(tmp.name, "fetched.jsonl")

            def fetcher_session(whisper_params, path):
                return {"mode": "dynamic", "nodes": {
                    "fetch": {"kind": "transport::http::fetcher", "params": {"url": f"{files_base}/assets/speech.wav"}},
                    "demux": {"kind": "containers::wav::demuxer", "needs": "fetch"},
                    "stt": {"kind": "plugin::native::whisper", "needs": "demux", "params": whisper_params},
                    "json": {"kind": "core::json_serialize", "params": {"newline_delimited": True}, "needs": "stt"},
                    "writer": {"kind": "core::file_writer", "params": {"path": path}, "needs": "json"}}}

            session_doc = fetcher_session({"model_size": "large-v3", "dtype": "bfloat16", "language": "en"}, out_path)
            before = state.batcher.stats()
            reset_counts()
            r = await client.post(base + "/api/v1/sessions", json={"name": "fetch", "yaml": json.dumps(session_doc)})
            created = await r.json()
            if r.status != 201 or uploaded != (201, {"id": "speech.wav"}):
                raise AssertionError(f"fetcher session: upload {uploaded}, create {r.status} {created}")
            wall = await wait_session(created["session_id"])
            counts, stats = read_counts(), state.batcher.stats()
            await (await client.delete(f"{base}/api/v1/sessions/{created['session_id']}")).read()
            with open(out_path, "rb") as f:
                rows = transcripts(f.read())
            show([r for r in rows if r["is_final"]], "server fetcher final")
            check_transcripts(rows, secs[0], "server fetcher session")
            encodes = sum(kind_calls(stats, p) - kind_calls(before, p) for p in ("whisper_ring:", "whisper_detect:"))
            want = {**ZERO_LAUNCHES, "flash_attention": per * encodes}
            report["fetcher"] = {"wall_s": wall, "lines": len(rows), "encodes": encodes, "launches": counts}
            log("# server fetcher " + json.dumps(report["fetcher"]))
            if counts != want or encodes == 0:
                raise AssertionError(f"server fetcher session launched {counts}, expected {want}")

            # 4. double_volume.yml as written
            ctype, out_g, wall = await post_process(base, None, tone, config_text=double_volume)
            report["double_volume"] = {"wall_s": wall, "bytes": len(out_g), "equal_to_cpu": out_g == tone_cpu}
            log("# server double_volume " + json.dumps(report["double_volume"]))
            if out_g != tone_cpu or ctype != "audio/wav":
                raise AssertionError("server double_volume: the card's WAV differs from the CPU run")

            # 5. a live session over the WebSocket control plane, captions over /moq/captions
            ws = await client.ws_connect(base.replace("http", "ws", 1) + "/api/v1/control")
            events = []

            async def req(action, **fields):
                corr = f"{action}-{time.monotonic()}"
                await ws.send_json({"type": "request", "correlation_id": corr,
                                    "payload": {"action": action, **fields}})
                while True:
                    msg = await ws.receive(timeout=120)
                    if msg.type is not WSMsgType.TEXT:
                        raise AssertionError(f"control plane closed: {msg}")
                    doc = json.loads(msg.data)
                    if doc["type"] == "response" and doc["correlation_id"] == corr:
                        if doc["payload"].get("action") == "error":
                            raise AssertionError(f"control plane {action}: {doc['payload']}")
                        return doc["payload"]
                    events.append(doc["payload"].get("event"))

            nodes = [("reader", "core::file_reader", {"path": speech8}), ("demux", "containers::wav::demuxer", {}),
                     ("pacer", "core::pacer", {"speed": 4.0}),
                     ("resample", "audio::resampler", live["audio::resampler"]),
                     ("stt", "plugin::native::whisper", live["plugin::native::whisper"]),
                     ("json", "core::json_serialize", live["core::json_serialize"]),
                     ("publish", "transport::moq::publisher", live["transport::moq::publisher"])]
            before = state.batcher.stats()
            reset_counts()
            t0 = time.monotonic()
            sid = (await req("createsession", name="live-captions"))["session_id"]
            for name, kind, params in nodes:
                await req("addnode", session_id=sid, node_id=name, kind=kind, params=params)
            for (a, _, _), (b, _, _) in list(zip(nodes, nodes[1:]))[1:]:
                await req("connect", session_id=sid, from_node=a, from_pin="out", to_node=b, to_pin="in")
            broadcast = live["transport::moq::publisher"]["broadcast"]
            while state.moq_relay.get(broadcast) is None:
                if time.monotonic() - t0 > 60:
                    raise AssertionError(f"broadcast {broadcast!r} was never announced")
                await asyncio.sleep(0.02)
            sub = await client.ws_connect(base.replace("http", "ws", 1) + f"/moq/{broadcast}?direction=subscribe")
            frames = []

            async def collect():
                while True:
                    msg = await sub.receive()
                    if msg.type is not WSMsgType.BINARY:
                        return msg
                    frames.append(decode_media_frame(msg.data))

            async def device_profile():
                r = await client.get(base + "/api/v1/profile/device?duration_secs=4")
                return r.status, await r.read()

            collector = asyncio.ensure_future(collect())
            while state.moq_relay.get(broadcast).subscriber_count == 0:
                if time.monotonic() - t0 > 60:
                    raise AssertionError(f"the WebSocket subscriber never attached to {broadcast!r}")
                await asyncio.sleep(0.01)
            wt_subs = await webtransport_subscribers(state, client, base, broadcast)
            profiling = asyncio.ensure_future(device_profile())
            await asyncio.sleep(0.5)  # the profiler starts before the first block
            await req("connect", session_id=sid, from_node="reader", from_pin="out", to_node="demux", to_pin="in")
            while True:
                await asyncio.sleep(0.25)
                if node_states_done((await req("getpipeline", session_id=sid))["pipeline"]):
                    break
                if time.monotonic() - t0 > 600:
                    raise AssertionError("server live session did not end")
            session_wall = time.monotonic() - t0
            end_msg = await asyncio.wait_for(collector, 60)
            wt_report = await wt_subs.finish([(p, ts) for p, ts, _ in frames])
            trace_status, trace = await profiling
            torch.cuda.synchronize()
            counts, stats = read_counts(), state.batcher.stats()
            await req("destroysession", session_id=sid)
            r = await client.get(base + "/api/v1/sessions")
            left = await r.json()
            held = stream_slots_held()
            await ws.close()
            calls = kind_calls(stats, "stream_step:") - kind_calls(before, "stream_step:")
            encodes = sum(kind_calls(stats, p) - kind_calls(before, p) for p in ("whisper_ring:", "whisper_detect:"))
            rows = transcripts(b"".join(p for p, _, _ in frames))
            n_final = sum(r["is_final"] for r in rows)
            report["session"] = {"wall_s": session_wall, "fused_calls": calls, "ring_encodes": encodes,
                                 "frames": len(frames), "partials": len(rows) - n_final, "finals": n_final,
                                 "subscriber_end": [end_msg.type.name, end_msg.data], "launches": counts,
                                 "trace_bytes": len(trace), "trace_names_k3": b"history_attention" in trace,
                                 "sessions_after": left, "stream_rows_held_after": held,
                                 "events": {e: events.count(e) for e in set(events)}}
            log("# server session " + json.dumps(report["session"]))
            show([r for r in rows if r["is_final"]], "server session final")
            check_transcripts(rows, speech8_s, "server live session", partials=True)
            want = {**ZERO_LAUNCHES, "flash_attention": per * encodes, "windowed_write": 2 * calls,
                    "history_attention": per * calls, "decode_cross_attention": cross_per_call() * calls}
            if counts != want or calls == 0:
                raise AssertionError(f"server live session launched {counts}, expected {want}")
            if trace_status != 200 or b"history_attention" not in trace:
                raise AssertionError(f"device profile ({trace_status}, {len(trace)} bytes) does not name K3")
            if left != {"sessions": []} or any(held.values()):
                raise AssertionError(f"after destroysession: sessions {left}, stream rows held {held}")
            report["webtransport"] = await webtransport_report(wt_report)

            # 6. observability
            r = await client.get(base + "/api/v1/metrics")
            metrics = (await r.read()).decode()
            r = await client.get(base + "/api/v1/profile/heap?duration_secs=0.5")
            heap = (await r.json())["device"]
            report["observability"] = {"metrics_lines": len(metrics.splitlines()),
                                       "memory_allocated": heap.get("memory_allocated"),
                                       "memory_reserved": heap.get("memory_reserved")}
            log("# server observability " + json.dumps(report["observability"]))
            if "skit_batcher_device_calls" not in metrics or not heap.get("memory_allocated"):
                raise AssertionError(f"server observability: {report['observability']}")

            # 7. core::script fetch() under the server's [script] policy
            fetch_doc = with_script(stt_doc(SHORT_WHISPER), {
                "script": FETCH_SCRIPT.replace("STUB", stub_base), "timeout_ms": 10000,
                "headers": [{"secret": "smoke_token", "header": "Authorization", "template": "Bearer {}"}]})
            reset_counts()
            _, out, wall = await post_process(base, fetch_doc, script_body)
            counts = read_counts()
            customs = [json.loads(line)["Custom"]["data"] for line in out.decode().splitlines() if line.strip()]
            seen = fetch_app["seen"]
            report["script_fetch"] = {
                "wall_s": wall, "lines": len(customs), "launches": counts,
                "stub_requests": [(r["method"], r["path"], r["headers"].get("authorization")) for r in seen],
                "replies": [c["reply"] for c in customs][:2], "refused": [c["refused"] for c in customs][:2]}
            log("# script fetch " + json.dumps(report["script_fetch"]))
            if (not customs or counts["flash_attention"] == 0 or len(seen) != len(customs)
                    or any((r["path"], r["headers"].get("authorization")) != ("/allowed/caption", "Bearer smoke-secret-0")
                           for r in seen)
                    or any(json.loads(c["reply"]) != {"ok": True, "path": "/allowed/caption"} for c in customs)
                    or any("URL not in global allowlist" not in c["refused"] for c in customs)):
                raise AssertionError(f"script fetch: {report['script_fetch']}")

            # 7b. the plugin routes: the three files of plugins_path uploaded, used, deleted
            report["plugins"] = await server_plugins_step(client, base, state, post_process)

            # 8. the load test: cli/loadtest.py against this server, first its
            # oneshot workers alone, then mixed with the live sessions
            import dataclasses

            from streamkit_tpu_torch.cli.loadtest import LoadTestConfig, run_load_test

            lt_cfg = LoadTestConfig.from_toml(loadtest_files(tmp.name, base, stt_doc(LOADTEST_WHISPER), bodies[0], live,
                                                              speech8))
            keep = ("requests", "success_rate", "mean_ms", "p50_ms", "p95_ms", "max_ms", "errors")
            for label, run_cfg in (
                    ("loadtest_oneshot_only",
                     dataclasses.replace(lt_cfg, scenario="oneshot", duration_secs=LOADTEST_ONESHOT_SECS)),
                    ("loadtest", lt_cfg)):
                before = state.batcher.stats()
                reset_counts()
                t0 = time.monotonic()
                results = await run_load_test(run_cfg)
                lt_wall = time.monotonic() - t0
                t1 = time.monotonic()
                while (state.sessions.list() or any(stream_slots_held().values())) and time.monotonic() - t1 < 60:
                    await asyncio.sleep(0.25)
                torch.cuda.synchronize()
                counts, stats = read_counts(), state.batcher.stats()
                calls = kind_calls(stats, "stream_step:") - kind_calls(before, "stream_step:")
                encodes = sum(kind_calls(stats, p) - kind_calls(before, p) for p in ("whisper_ring:", "whisper_detect:"))
                # each batched kind's calls over the run and the mean host wall of one
                kinds = {}
                for k, v in stats["kinds"].items():
                    was = before["kinds"].get(k, {})
                    n = v["calls"] - was.get("calls", 0)
                    if n:
                        kinds[k] = {"calls": n, "items": v["items"] - was.get("items", 0),
                                    "ms_per_call": 1e3 * (v["dispatch_s"] - was.get("dispatch_s", 0)) / n}
                fused_ms = sum(v["ms_per_call"] * v["calls"] for k, v in kinds.items() if k.startswith("stream_step:"))
                report[label] = {
                    "scenario": run_cfg.scenario, "duration_s": run_cfg.duration_secs, "wall_s": lt_wall,
                    "summary": {k: {f: v[f] for f in keep} for k, v in results.items()},
                    "oneshot_rounds_per_worker": results.get("oneshot", {}).get("requests", 0)
                    / run_cfg.oneshot_concurrency,
                    "tunes_sent": results.get("tune", {}).get("requests", 0), "launches": counts,
                    "fused_calls": calls, "fused_call_ms_mean": fused_ms / max(calls, 1),
                    "ring_encodes": encodes, "kinds": kinds,
                    "sessions_after": len(state.sessions.list()), "stream_rows_held_after": stream_slots_held()}
                log(f"# {label} " + json.dumps(report[label]))
                want = {**ZERO_LAUNCHES, "flash_attention": per * encodes, "windowed_write": 2 * calls,
                        "history_attention": per * calls, "decode_cross_attention": cross_per_call() * calls}
                expect = ("oneshot", "dynamic", "tune") if run_cfg.scenario == "mixed" else ("oneshot",)
                failed = [k for k in expect
                          if k not in results or results[k]["requests"] == 0 or results[k]["success_rate"] < 1.0]
                if (failed or counts != want or counts["flash_attention"] == 0
                        or (run_cfg.scenario == "mixed" and counts["history_attention"] == 0)):
                    errors = {k: results[k]["errors"] for k in failed if k in results}
                    raise AssertionError(f"{label}: kinds failing {failed} (errors {errors}), launches {counts} "
                                         f"(expected {want})")
                if report[label]["sessions_after"] or any(report[label]["stream_rows_held_after"].values()):
                    raise AssertionError(f"{label} left sessions or stream rows: {report[label]}")

            # 9. OTLP: a second server, started with otlp_endpoint, on the same
            # model cache; one session of step 3's graph while it pushes
            otlp_cfg = ServerConfig()
            otlp_cfg.moq_enabled = False
            otlp_cfg.assets_dir = cfg.assets_dir
            otlp_cfg.otlp_endpoint = collector_base
            otlp_cfg.otlp_interval_secs = 1.0
            otlp_app = create_app(otlp_cfg, device="cuda")
            otlp_state = otlp_app["state"]
            otlp_state.resources = state.resources  # large-v3 as step 1 built it
            otlp_runner = AppRunner(otlp_app)
            otlp_base = f"http://127.0.0.1:{await otlp_runner.start('127.0.0.1', 0)}"
            otlp_out = os.path.join(tmp.name, "otlp.jsonl")
            reset_counts()
            r = await client.post(otlp_base + "/api/v1/sessions",
                                  json={"name": "otlp", "yaml": json.dumps(fetcher_session(SHORT_WHISPER, otlp_out))})
            created = await r.json()
            if r.status != 201:
                raise AssertionError(f"OTLP session: create {r.status} {created}")
            sid = created["session_id"]
            wall = await wait_session(sid, url=otlp_base)
            await (await client.delete(f"{otlp_base}/api/v1/sessions/{sid}")).read()
            torch.cuda.synchronize()
            counts = read_counts()
            encodes = sum(kind_calls(otlp_state.batcher.stats(), p) for p in ("whisper_ring:", "whisper_detect:"))

            def otlp_docs(path):
                return [json.loads(r["body"]) for r in collector_app["seen"] if r["path"] == path]

            def session_events():
                names = set()
                for doc in otlp_docs("/v1/logs"):
                    for rec in doc["resourceLogs"][0]["scopeLogs"][0]["logRecords"]:
                        attrs = {a["key"]: a["value"]["stringValue"] for a in rec["attributes"]}
                        if attrs.get("session_id") != sid:
                            continue
                        name = rec["body"]["stringValue"]
                        if name == "nodetelemetry":
                            name += ":" + json.loads(attrs.get("data", "{}")).get("event_type", "")
                        names.add(name)
                return names

            want_events = {"sessioncreated", "nodetelemetry:stt.result"}
            t0 = time.monotonic()
            while time.monotonic() - t0 < 30 and not (want_events <= session_events() and otlp_docs("/v1/metrics")):
                await asyncio.sleep(0.25)
            otlp = otlp_state.otlp
            await otlp_runner.cleanup()  # stops the pusher
            otlp_runner = None
            get_tracer().disable()  # pusher_from_config turned span recording on
            with open(otlp_out, "rb") as f:
                rows = transcripts(f.read())
            metric_names = {m["name"] for doc in otlp_docs("/v1/metrics")
                            for m in doc["resourceMetrics"][0]["scopeMetrics"][0]["metrics"]}
            report["otlp"] = {"posts": {p: len(otlp_docs(p)) for p in ("/v1/metrics", "/v1/logs", "/v1/traces")},
                              "exports": otlp.exports, "failures": otlp.failures,
                              "host_ms_per_push": 1e3 * otlp.export_seconds / max(otlp.exports, 1),
                              "session_wall_s": wall, "lines": len(rows), "encodes": encodes, "launches": counts,
                              "session_events": sorted(session_events()),
                              "metrics_named": sorted(metric_names)[:12]}
            log("# server otlp " + json.dumps(report["otlp"]))
            if not want_events <= session_events() or "skit_sessions_active" not in metric_names or otlp.failures:
                raise AssertionError(f"OTLP: the collector stub did not get the session's events: {report['otlp']}")
            check_transcripts(rows, secs[0], "server OTLP session")
            if counts != {**ZERO_LAUNCHES, "flash_attention": per * encodes} or encodes == 0:
                raise AssertionError(f"server OTLP session launched {counts} for {encodes} encodes")

            # (c) the f32 context check through two servers. The CPU server
            # starts only now: a server installs the process-wide MoQ relay and
            # gateway, which the live session above must find as its own.
            cpu_cfg = ServerConfig()
            cpu_cfg.moq_enabled = False
            cpu_runner = AppRunner(create_app(cpu_cfg, device="cpu"))
            cpu_base = f"http://127.0.0.1:{await cpu_runner.start('127.0.0.1', 0)}"
            doc = stt_doc({"model_size": "server-check", "dtype": "float32", "max_tokens": 12, "language": "en"})
            got, launched = {}, {}
            for label, url in (("cuda", base), ("cpu", cpu_base)):
                reset_counts()
                _, body, _ = await post_process(url, doc, wav_body(check_audio))
                got[label] = transcripts(body)
                launched[label] = read_counts()
            report["context_launches"] = {label: c["flash_attention"] for label, c in launched.items()}
            g, c = got["cuda"], got["cpu"]
            same = len(g) == len(c) and all(
                {k: v for k, v in a.items() if k != "confidence"} == {k: v for k, v in b.items() if k != "confidence"}
                and (a["confidence"] is None) == (b["confidence"] is None)
                and (a["confidence"] is None or abs(a["confidence"] - b["confidence"]) <= 1e-4)
                for a, b in zip(g, c))
            n = report["context_launches"]["cuda"]
            report["context"] = {"lines": len(g), "rows": g, "flash_launches": report["context_launches"]}
            log("# server context " + json.dumps(report["context"]))
            check_transcripts(g, len(check_audio) / SR, "server context")
            if (not same or n == 0 or launched["cuda"] != {**ZERO_LAUNCHES, "flash_attention": n}
                    or launched["cpu"] != ZERO_LAUNCHES):
                raise AssertionError(f"server context: cuda {g} != cpu {c} (K1 launches {launched})")
        finally:
            if cpu_runner is not None:
                await cpu_runner.cleanup()
            if otlp_runner is not None:
                await otlp_runner.cleanup()
            await files.cleanup()
            await runner.cleanup()
            await fetch_runner.cleanup()
            await collector_runner.cleanup()

    try:
        with knobs(SK_STT_GATHER_MS=STT_GATHER_MS, SK_STREAM_SLOTS=4, SK_STREAM_PAD=1):
            asyncio.run(run())
    finally:
        from streamkit_tpu_torch.nodes.core_nodes.script import set_global_script_config

        get_tracer().disable()  # step 9's OTLP pusher turned span recording on
        set_global_script_config([], {})
        os.environ.pop(SCRIPT_SECRET_ENV, None)
        WHISPER_CONFIGS.pop("server-check", None)
        tmp.cleanup()
    return report


# ---------------------------------------------------------------------------
# 16. the mesh: dp × tp ranks of torch.distributed (parallel/)
# ---------------------------------------------------------------------------
MESH_ENGINE_CFG = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2, n_audio_layer=2,
                       n_vocab=51866, n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2)


def affine_random(params, seed: int):
    """``params`` with every leaf that the init sets to one constant (the
    biases, the layer-norm gains and shifts) moved off it in place by seeded
    noise of 0.1, drawn on the host: a bias added once per tp rank, or the
    wrong block of a split bias, then shows in every mesh check."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in params.parameters():
            if p.numel() and bool((p == p.flatten()[0]).all()):
                p.add_((0.1 * torch.randn(p.shape, generator=gen)).to(p.device, p.dtype))
    return params


def mesh_fused_blocks(params, tbl, ring, n_blocks: int = 3) -> None:
    """``n_blocks`` fused identity-packed steps over every slot of ``tbl``
    from one seed (global ids: on a mesh each rank runs its own slots)."""
    S, block = tbl.max_slots, 8 * 512
    audio = (np.random.RandomState(0).randn(S, n_blocks * block) * 0.2).astype(np.float32)
    tip = 0
    for step in range(n_blocks):
        written = step * block
        n_req = max(0, min((written + block - 200 - tip) // 2560, 2))
        meta = np.asarray([[s, s, written, tip, n_req, int(step > 0), int(step == 0), 1, 2, 3, 4]
                           for s in range(S)], np.int32)
        tbl.step(params, ring, meta, None, None, None, None, None,
                 audio[:, written : written + block].reshape(S, 8, 512), max_steps=3)
        tip += n_req * 2560


def mesh_small_run(mesh=None) -> dict:
    """The small f32 config (the train check's: 2 + 2 layers of 2 heads of
    64, so K1 takes its encoder; random biases and layer norms), whole or on
    ``mesh``: the teacher-forced logits of 2 windows (rows over dp) and 3
    fused int8 steps over 2 slots, each part's launches counted from 0 on
    this process. ``tests/test_torch_kernels_cuda.py`` runs it too."""
    import torch.distributed as dist

    from streamkit_tpu_torch.engine.audio_ring import SessionAudioRing
    from streamkit_tpu_torch.models.whisper import StreamTable, WhisperConfig, seeded_params
    from streamkit_tpu_torch.models.whisper.model import decode_logits, encode
    from streamkit_tpu_torch.parallel import shard_batch, shard_params
    from streamkit_tpu_torch.parallel.serving import gather_rows, shard_audio_ring, shard_stream_table

    cfg = WhisperConfig(**SMALL_TRAIN)
    params = affine_random(seeded_params(cfg, device="cuda"), 3)
    if mesh is not None:
        params = shard_params(mesh, params, cfg)
    rng = np.random.RandomState(2)
    mel = torch.from_numpy((rng.randn(2, 512, 80) * 0.3).astype(np.float32)).cuda()
    tokens = torch.from_numpy(rng.randint(0, 512, (2, 8))).cuda()
    if mesh is not None:
        mel, tokens = shard_batch(mesh, mel, tokens)
    out = {}
    reset_counts()
    with torch.no_grad():
        logits = decode_logits(params, cfg, tokens, encode(params, cfg, mel))
    torch.cuda.synchronize()
    out["forward_launches"] = read_counts()
    if mesh is not None and mesh.size(0) > 1:
        parts = [torch.empty_like(logits) for _ in range(mesh.size(0))]
        dist.all_gather(parts, logits.contiguous(), group=mesh.get_group("dp"))
        logits = torch.cat(parts)
    out["logits"] = logits.cpu().numpy()
    ring = SessionAudioRing(max_slots=2, ring_samples=1 << 14, device="cuda")
    for _ in range(2):
        ring.alloc()
    tbl = StreamTable(cfg, torch.float32, max_slots=2, enc_t=64, dec_t=32, kv_int8=True, device="cuda")
    if mesh is not None:
        shard_stream_table(mesh, tbl)
        shard_audio_ring(mesh, ring)
    reset_counts()
    mesh_fused_blocks(params, tbl, ring)
    torch.cuda.synchronize()
    out["fused_launches"] = read_counts()
    rows = (tbl._tokens, tbl._n_tok, tbl._enc_pos)
    out["rows"] = gather_rows(tbl.shard, *rows) if mesh is not None else tuple(x.cpu().numpy() for x in rows)
    return out


def mesh_checkpoint_roundtrip(mesh, directory: str) -> dict:
    """The small config's params saved from the mesh and loaded back into
    the sharded template (bit for bit, placements kept) and, on rank 0, into
    a one-device template (the whole tree)."""
    import torch.distributed as dist

    from streamkit_tpu_torch.models.whisper import WhisperConfig, seeded_params
    from streamkit_tpu_torch.ops.tensor_parallel import tp_of
    from streamkit_tpu_torch.parallel import shard_params
    from streamkit_tpu_torch.utils.checkpoint import load_params, save_params

    cfg = WhisperConfig(**SMALL_TRAIN)
    full = affine_random(seeded_params(cfg, device="cuda"), 3)
    local = shard_params(mesh, full, cfg)
    save_params(directory, local, step=0)
    back = load_params(directory, local)
    pairs = list(zip(local.parameters(), back.parameters()))
    out = {"bit_equal": all(torch.equal(a, b) for a, b in pairs),
           "placements_kept": all(tp_of(a) == tp_of(b) for a, b in pairs),
           "split_leaves": sum(tp_of(b) is not None for _, b in pairs)}
    if dist.get_rank() == 0:
        one = load_params(directory, seeded_params(cfg, device="cuda"))
        out["one_device_equal"] = all(torch.equal(a, b) for a, b in zip(one.parameters(), full.parameters()))
    dist.barrier()
    return out


def mesh_small_rank(tps, directory: str, with_engine: bool) -> dict:
    """On every rank: the small config on a mesh of each ``tp`` in ``tps``;
    the first mesh also runs the checkpoint roundtrip and, with
    ``with_engine``, a small-config engine (rank 0 serves 2 sessions, the
    other ranks follow)."""
    import torch.distributed as dist

    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, WhisperConfig
    from streamkit_tpu_torch.parallel import make_mesh

    world, out = dist.get_world_size(), {"rank": dist.get_rank(), "backend": dist.get_backend()}
    for i, tp in enumerate(tps):
        mesh = make_mesh(world, tp=tp, device="cuda")
        out[f"tp{tp}"] = mesh_small_run(mesh)
        if i == 0:
            out["checkpoint"] = mesh_checkpoint_roundtrip(mesh, os.path.join(directory, f"tp{tp}"))
            if with_engine:
                WHISPER_CONFIGS["mesh-check"] = WhisperConfig(**MESH_ENGINE_CFG)
                out["engine"] = mesh_engine(mesh, "mesh-check", "float32", 2, 3.0, layers=2)
    return out


def mesh_engine(mesh, model_size: str, dtype: str, n_sessions: int, speech_s: float, layers: int) -> dict:
    """``SttServingEngine(mesh=)`` in stream mode: rank 0 serves
    ``n_sessions`` sessions, the other ranks follow its device calls; this
    rank's launches, counted from 0, against the calls it ran."""
    import torch.distributed as dist

    from streamkit_tpu_torch.engine import SttServingEngine
    from streamkit_tpu_torch.ops.tensor_parallel import collectives

    reset_counts()
    tp_before = dict(collectives)
    if dist.get_rank() == 0:
        events, out = asyncio.run(run_engine("stream", n_sessions, speech_s, seed0=300, mesh=mesh,
                                             model_size=model_size, dtype=dtype))
        check_events(events, f"mesh {model_size}")
        calls = out["mesh_calls"]
        report = {"fused_calls": out["stats"]["kinds"][out["sstep_kind"]]["calls"], "rows_held": out["rows_held"],
                  "serve_s": out["serve_s"], "start_s": out["start_s"], "finals_stream": out["finals_stream"],
                  "finals_fallback": out["finals_fallback"],
                  "fused_call_ms_median": 1e3 * float(np.median(out["call_walls"]))}
        sstep = out["sstep_kind"]
    else:
        eng = SttServingEngine(model_size=model_size, dtype=dtype, max_sessions=n_sessions, final_mode="stream",
                               device="cuda", mesh=mesh)
        asyncio.run(eng.start())
        eng.follow()
        calls, report, sstep = eng.mesh_calls, {}, eng._sstep_kind
        del eng
    torch.cuda.synchronize()
    counts = read_counts()
    fused = calls.get(sstep, 0)
    # the model's tp collectives per device call (one broadcast of the call
    # from rank 0 beside them, and one all-gather over dp where dp > 1)
    report["tp_collectives_per_call"] = {k: (collectives[k] - tp_before[k]) / max(sum(calls.values()), 1)
                                         for k in collectives}
    # exact-final fallbacks: a ring decode of >= 8 s has >= 256 encoder positions (K1)
    encodes = sum(v for k, v in calls.items() if k.startswith("whisper_ring:") and int(k.rsplit(":", 1)[1]) >= 8 * SR)
    want = {**ZERO_LAUNCHES, "flash_attention": layers * encodes, "windowed_write": 2 * fused,
            "history_attention": layers * fused, "decode_cross_attention": cross_per_call(layers) * fused}
    torch.cuda.empty_cache()
    return {**report, "launches": counts, "expected": want, "calls": calls}


def mesh_large_rank(n_sessions: int, speech_s: float) -> dict:
    """Two ranks sharing the card at tp = 2, Whisper large-v3 (random weights
    from seed 0, biases and layer norms from seed 21): the bf16 forward against the one-rank bf16 and f32
    forwards (rank 0 runs both), the engine, and one bf16 train step."""
    import torch.distributed as dist

    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS, seeded_params
    from streamkit_tpu_torch.models.whisper.model import decode_logits, encode
    from streamkit_tpu_torch.parallel import init_train_state, make_mesh, make_train_step, shard_params

    rank = dist.get_rank()
    mesh = make_mesh(2, tp=2, device="cuda")
    cfg = WHISPER_CONFIGS["large-v3"]
    out = {"rank": rank}
    t0 = time.monotonic()
    params = affine_random(seeded_params(cfg, torch.float32, device="cuda"), 21)
    out["init_s"] = time.monotonic() - t0
    rng = np.random.RandomState(21)
    mel = torch.from_numpy((rng.randn(1, 3000, cfg.n_mels) * 0.3).astype(np.float32)).cuda()
    tokens = torch.from_numpy(rng.randint(0, cfg.n_vocab, (1, 16))).cuda()

    def forward(p, m):
        with torch.no_grad():
            return decode_logits(p, cfg, tokens, encode(p, cfg, m)).float()

    one32 = forward(params, mel) if rank == 0 else None
    params.to(torch.bfloat16)
    one16 = forward(params, mel.to(torch.bfloat16)) if rank == 0 else None
    local = shard_params(mesh, params, cfg)
    del params
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.monotonic()
    got = forward(local, mel.to(torch.bfloat16))
    torch.cuda.synchronize()
    out["forward"] = {"launches": read_counts(), "wall_s": time.monotonic() - t0, "layers": cfg.n_audio_layer,
                      "q_local": list(local["enc"]["layers"][0]["attn"]["q"]["w"].shape)}
    if rank == 0:
        out["forward"].update(gap_mesh_to_one_bf16=(got - one16).abs().max().item(),
                              gap_one_bf16_to_f32=(one16 - one32).abs().max().item(), shape=list(got.shape))
    del one32, one16
    dist.barrier()
    out["engine"] = mesh_engine(mesh, "large-v3", "bfloat16", n_sessions, speech_s, layers=cfg.n_audio_layer)
    dist.barrier()
    step = make_train_step(cfg, TRAIN_LR, mesh=mesh)
    batch = train_batch(cfg, 2, 256, "cuda", seed=11)
    batch = (batch[0].to(torch.bfloat16), *batch[1:])
    rows, _ = large_train_steps(init_train_state(local, TRAIN_LR), step, batch, 1, f"bf16 tp=2 rank {rank}")
    out["train"] = rows[0]
    return out


def mesh_gloo_rank(directory: str, n_sessions: int, speech_s: float) -> dict:
    """Both parts of the phase that run on two gloo ranks, in one spawn."""
    return {"small": mesh_small_rank([2, 1], directory, False), "large": mesh_large_rank(n_sessions, speech_s)}


def mesh_phase() -> dict:
    """The sharded half of ``parallel/`` on the card. The card's machine has
    one card and NCCL refuses two ranks on one device, so: NCCL at world
    size 1, then two gloo ranks sharing ``cuda:0`` (small f32 config at
    tp = 2 and at dp = 2, a sharded checkpoint; large-v3 bf16 at tp = 2:
    forward, ``SttServingEngine(mesh=)``, one train step). A rank's failure
    fails the script. Returns each kernel's launches per rank."""
    import tempfile

    from streamkit_tpu_torch.models.whisper import WHISPER_CONFIGS
    from streamkit_tpu_torch.parallel import run_ranks

    torch.cuda.empty_cache()
    one = mesh_small_run()
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. NCCL at world size 1: the mesh path and an engine over NCCL
        t0 = time.monotonic()
        (nccl,) = run_ranks(mesh_small_rank, 1, [1], os.path.join(tmp, "nccl"), True, device="cuda",
                            timeout_s=300)
        report["nccl_world1_s"] = time.monotonic() - t0
        # 2-5. two gloo ranks on cuda:0: the small config at tp = 2, then
        # dp = 2; large-v3 bf16 at tp = 2
        t0 = time.monotonic()
        ranks = run_ranks(mesh_gloo_rank, 2, os.path.join(tmp, "gloo"), 4, 3.0, device="cuda", backend="gloo",
                          timeout_s=600)
        report["gloo_s"] = time.monotonic() - t0
    gloo, large = [r["small"] for r in ranks], [r["large"] for r in ranks]
    checks = []
    for label, res in [("nccl world 1", nccl["tp1"])] + [(f"gloo rank {r['rank']} tp {tp}", r[f"tp{tp}"])
                                                          for r in gloo for tp in (2, 1)]:
        gap = float(np.abs(res["logits"] - one["logits"]).max())
        same = all(np.array_equal(a, b) for a, b in zip(res["rows"], one["rows"]))
        ok = (same and gap <= 1e-5 and res["forward_launches"] == one["forward_launches"]
              and res["fused_launches"] == one["fused_launches"])
        checks.append({"run": label, "logits_gap": gap, "rows_equal": same, "forward": res["forward_launches"],
                       "fused": res["fused_launches"], "ok": ok})
    report["small"] = checks
    report["one_rank_small"] = {"forward": one["forward_launches"], "fused": one["fused_launches"]}
    report["nccl_backend"] = nccl["backend"]
    report["checkpoint"] = {"nccl": nccl["checkpoint"], "gloo": [r["checkpoint"] for r in gloo]}
    report["nccl_engine"] = nccl["engine"]
    log("# mesh small " + json.dumps(report))
    bad = [c for c in checks if not c["ok"]]
    if bad or nccl["backend"] != "nccl":
        raise AssertionError(f"mesh small config: {bad or nccl['backend']}")
    ckpts = [nccl["checkpoint"], *report["checkpoint"]["gloo"]]
    if not all(c["bit_equal"] and c["placements_kept"] and c.get("one_device_equal", True) for c in ckpts) or \
            not gloo[0]["checkpoint"]["split_leaves"] or gloo[0]["checkpoint"].get("one_device_equal") is not True:
        raise AssertionError(f"mesh checkpoint roundtrip: {ckpts}")
    eng = nccl["engine"]
    if eng["launches"] != eng["expected"] or eng["rows_held"] != 0 or not eng["fused_calls"]:
        raise AssertionError(f"mesh engine at world 1: {eng}")

    for r in large:
        log(f"# mesh large-v3 rank {r['rank']} " + json.dumps(r))
    fwd = large[0]["forward"]
    train_want = train_launches(WHISPER_CONFIGS["large-v3"])
    for r in large:
        e = r["engine"]
        if r["forward"]["launches"] != {**ZERO_LAUNCHES, "flash_attention": r["forward"]["layers"]}:
            raise AssertionError(f"mesh forward rank {r['rank']}: launches {r['forward']['launches']}")
        if e["launches"] != e["expected"] or not e["calls"]:
            raise AssertionError(f"mesh engine rank {r['rank']}: launches {e['launches']}, want {e['expected']}")
        if r["train"]["launches"] != train_want or not math.isfinite(r["train"]["loss"]):
            raise AssertionError(f"mesh train rank {r['rank']}: {r['train']}")
    if large[0]["engine"]["rows_held"] != 0:
        raise AssertionError(f"mesh engine left stream rows: {large[0]['engine']}")
    if not fwd["gap_mesh_to_one_bf16"] <= 2 * fwd["gap_one_bf16_to_f32"]:
        raise AssertionError(f"mesh large-v3 forward: {fwd}")
    log("# mesh phase " + json.dumps({k: v for k, v in report.items() if k.endswith("_s")}))
    per_rank = {name: {"forward_tp2": [r["forward"]["launches"][name] for r in large],
                       "engine_tp2": [r["engine"]["launches"][name] for r in large],
                       "train_tp2": [r["train"]["launches"][name] for r in large],
                       "small_tp2": [r["tp2"]["forward_launches"][name] + r["tp2"]["fused_launches"][name]
                                     for r in gloo],
                       "nccl_world1": [nccl["tp1"]["forward_launches"][name] + nccl["tp1"]["fused_launches"][name]
                                       + nccl["engine"]["launches"][name]]}
                for name in ZERO_LAUNCHES}
    return {"report": report, "large": large, "launches_mesh": per_rank}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = card_line()
    log(smi)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t_script = time.monotonic()
    # every f32 comparison on the card runs in full f32 (cuDNN's TF32 is on by default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_phase()
    t0 = time.monotonic()
    k1, k2, k3, k4 = k1_phase(), k2_phase(8), k3_phase(8), k4_phase(64)
    bwd = k1_backward_phase()
    log(f"# kernel phase {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    context_phase()
    stream_context_phase()
    node_context_phase()
    log(f"# context phase {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    train = train_phase()
    log(f"# train phase (small f32 card against CPU, large-v3 f32 and bf16 steps) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    vad_train_phase()
    log(f"# vad train phase (the VAD trainer on the card against the CPU, save, re-score) {time.monotonic() - t0:.1f} s")
    from streamkit_tpu_torch.core import ResourceManager

    resources = ResourceManager()  # one model load for both node paths
    t0 = time.monotonic()
    seg = segment_final_path(resources)
    log(f"# segment-final path (oneshot, WhisperNode) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    captions = live_captions_path(resources)
    log(f"# live-captions path (oneshot, WhisperNode) {time.monotonic() - t0:.1f} s")
    from streamkit_tpu_torch.nodes.codecs import opus_available

    opus = opus_available()  # the one load check of libopus: it picks the Opus phases' branch
    log(f"# libopus {'loads' if opus else 'is absent: the Ogg/Opus request is skipped; the dynamic session reads speech_8s.wav'}")
    t0 = time.monotonic()
    ogg = ogg_opus_path(resources, opus)
    log(f"# ogg/opus path (speech_to_text.yml, double_volume.yml) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    dynamic = dynamic_session_path(resources, opus)
    log(f"# dynamic session path (live_captions.yml graph) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    live = live_partials_path(resources)
    log(f"# live-partials path (SttServingEngine on the nodes' model) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    script = script_path(resources)
    log(f"# script path (core::script, JavaScript and Python) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    codecs = host_codecs_path(resources)
    log(f"# host codecs path (FLAC, MP3, WebM kinds) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    plugins = plugins_path(resources)
    log(f"# plugins path (native, core WASM, component, audio::gain) {time.monotonic() - t0:.1f} s")
    asyncio.run(resources.clear())
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    translate_phase()
    log(f"# translate phase (NLLB-200-distilled-600M, opus-mt-en-es widths) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    cascade = cascade_phase(opus)
    log(f"# cascade phase (speech_translate.yml, voice_translate.yml) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    speech = speech_phase(opus)
    log(f"# speech models phase (Kokoro, Matcha, SenseVoice) {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    profile_fused_step()
    log(f"# fused-step profile {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    dsp_phase()
    log(f"# dsp phase {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    server_subprocess_phase()
    try:
        server = server_phase()
    finally:
        PLUGINS["tmp"].cleanup()
    log(f"# server phase {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    mesh = mesh_phase()
    log(f"# mesh phase (NCCL at world size 1; two gloo ranks on the card: small f32, large-v3 bf16 at tp = 2) "
        f"{time.monotonic() - t0:.1f} s")
    ogg_k1 = {label: ogg[label]["launches"]["flash_attention"] for label in ("fused", "unfused") if label in ogg}
    k1.update(launches=seg["flash_attention"], path="oneshot segment finals (WhisperNode)",
              launches_live_captions=captions["flash_attention"], launches_live_partials=live["flash_attention"],
              launches_ogg_opus=ogg_k1, launches_dynamic_session=dynamic["flash_attention"],
              launches_speech_translate=cascade["speech_translate.yml"]["launches"]["flash_attention"],
              launches_voice_translate=cascade["voice_translate.yml"]["launches"]["flash_attention"],
              launches_speech_models=speech["launches"]["flash_attention"],
              launches_server_oneshot=server["oneshot"]["launches"]["flash_attention"],
              launches_server_fetcher=server["fetcher"]["launches"]["flash_attention"],
              launches_server_session=server["session"]["launches"]["flash_attention"],
              launches_server_context=server["context_launches"]["cuda"],
              launches_server_script_fetch=server["script_fetch"]["launches"]["flash_attention"],
              launches_loadtest=server["loadtest"]["launches"]["flash_attention"],
              launches_loadtest_oneshot_only=server["loadtest_oneshot_only"]["launches"]["flash_attention"],
              launches_server_otlp=server["otlp"]["launches"]["flash_attention"],
              launches_script=script["flash_attention"], launches_host_codecs=codecs["flash_attention"],
              launches_plugins=plugins["flash_attention"],
              launches_server_plugins=server["plugins"]["launches"]["flash_attention"],
              launches_train=train["launches"]["flash_attention"])
    for name, entry in bwd.items():
        entry.update(launches=train["launches"][name],
                     path="train steps (parallel/train.py, large-v3, 3 f32 + 2 bf16)",
                     launches_train_small=sum(c[name] for c in train["small"]["launches"]))
    k2.update(launches=captions["windowed_write"], path="oneshot live captions (WhisperNode)",
              launches_live_partials=live["windowed_write"], launches_dynamic_session=dynamic["windowed_write"],
              launches_speech_models=speech["launches"]["windowed_write"],
              launches_server_session=server["session"]["launches"]["windowed_write"],
              launches_loadtest=server["loadtest"]["launches"]["windowed_write"])
    k3.update(launches=captions["history_attention"], path="oneshot live captions (WhisperNode)",
              launches_live_partials=live["history_attention"],
              launches_dynamic_session=dynamic["history_attention"],
              launches_speech_models=speech["launches"]["history_attention"],
              launches_server_session=server["session"]["launches"]["history_attention"],
              launches_loadtest=server["loadtest"]["launches"]["history_attention"])
    k4.update(launches=captions["decode_cross_attention"], path="oneshot live captions (WhisperNode)",
              launches_live_partials=live["decode_cross_attention"],
              launches_dynamic_session=dynamic["decode_cross_attention"],
              launches_speech_models=speech["launches"]["decode_cross_attention"],
              launches_server_session=server["session"]["launches"]["decode_cross_attention"],
              launches_loadtest=server["loadtest"]["launches"]["decode_cross_attention"])
    for entry in (k1, k2, k3, k4, *bwd.values()):
        entry["launches_mesh"] = mesh["launches_mesh"][entry["name"]]
    log(f"# whole script {time.monotonic() - t_script:.1f} s")
    log(json.dumps({"kernels": [k1, k2, k3, k4, *bwd.values()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
