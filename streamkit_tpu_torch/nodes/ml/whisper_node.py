# SPDX-License-Identifier: Apache-2.0
"""Whisper STT node: VAD-segmented speech → Transcription packets.

Parity target: ``plugins/native/whisper`` (whisper.cpp + Silero VAD):

* 512-sample VAD frames gate a speech buffer (``vad.rs:19-60``),
* transcribe on ≥``min_silence_duration_ms`` (700) silence or at
  ``max_segment_duration_secs`` (30) forced cut (``lib.rs:404-490``),
* process-wide model cache keyed by (model, params) — here the
  :class:`ResourceManager` with a ``ResourceKey`` (``lib.rs:170-180``),
* emits ``Transcription`` packets + ``vad.speech_start/end`` and
  ``stt.result`` telemetry.

Beyond the reference: optional **live partial transcripts** — while a
segment is open, the in-progress audio is re-decoded every
``partial_interval_ms`` and emitted with ``is_final=false`` (BASELINE
config #3); the reference only emits whole segments.

The node keeps its model, VAD state, audio ring slot and stream-table row
on the device it was registered with (``register_nodes(device=...)``):
every path below (batched ring decodes, the fused streaming step, and the
unbatched window decode a full ring table degrades to) runs there.
"""

from __future__ import annotations

import asyncio
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ...core import (
    AudioFormat,
    ChannelClosed,
    ConfigurationError,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketMetadata,
    PacketType,
    ProcessorNode,
    ResourceKey,
    TelemetryEmitter,
    TranscriptionData,
    TranscriptionSegment,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason
from ...device import resolve_device
from ...engine.audio_ring import get_audio_ring
from ...models.whisper import (
    WHISPER_CONFIGS,
    WhisperDetokenizer,
    load_pretrained,
    seeded_params,
    transcribe_window,
)
from ...models.whisper.config import WHISPER_LANGUAGES, language_index
from ...ops.vad import VAD_FRAME, vad_frame_probs, vad_init_state
from .vad_node import SpeechSegmenter

_SR = 16_000


async def warmup_batched_kinds(batcher, *, sweep_to: int = 0, log=None) -> list:
    """Compile-warm every whisper-owned batcher kind at its serving shape.

    This module registers four kind families (``vad_ring:…``,
    ``whisper_ring:…``, ``whisper_detect:…``, ``stream_step:…``) and owns
    their name formats — benches and serving hosts must call this instead of
    parsing kind strings themselves (the format changed twice in two rounds
    and silently broke a chip bench each time).

    A first call builds the hand-written kernels (nvcc) and sets up the
    library handles and allocator pools of each (kind, padded-batch) shape,
    which would stall a live batch, so every shape the serving phase can hit
    runs once up front. Kinds registered with ``pad_to`` warm at exactly that
    size; un-padded kinds sweep powers of two up to ``sweep_to``. Warmups use
    HIGH slot ids (sessions allocate from the low end; VAD state resets on
    alloc, ring reads mask by length) so live sessions are untouched.

    Returns the list of ``(kind, batch_size)`` pairs warmed.
    """
    warmed = []

    def sizes(pad: Optional[int]) -> list:
        if pad:
            return [pad]
        out = [nb for nb in (1, 2, 4, 8, 16, 32, 64) if nb <= max(sweep_to, 1)]
        return out or [1]

    for name, kind in sorted(batcher.registered_kinds().items()):
        fields = name.split(":")
        if fields[0] == "vad_ring":
            block = int(fields[1])
            args = lambda j, block=block: (  # noqa: E731
                np.int32(120 - j), np.int32(0),
                np.zeros((block, VAD_FRAME), np.float32),
            )
        elif fields[0] == "whisper_ring":
            window = int(fields[-1])
            args = lambda j, window=window: (  # noqa: E731
                np.int32(120 - j), np.int32(0), np.int32(window), np.int32(0),
            )
        elif fields[0] == "whisper_detect":
            # rare path (first segment of auto-language sessions): warm the
            # single-row call only — sweeping batch sizes would spend
            # minutes of warmup on a kind most runs never call
            window = int(fields[-1])
            args = lambda j, window=window: (  # noqa: E731
                np.int32(120 - j), np.int32(0), np.int32(min(window, VAD_FRAME)),
            )
            for nb in sizes(kind.pad_to)[:1] if kind.pad_to else [1]:
                await asyncio.gather(*(batcher.submit(name, *args(j)) for j in range(nb)))
                warmed.append((name, nb))
                if log is not None:
                    log(f"# warmed {name} batch={nb}")
            continue
        elif fields[0] == "stream_step":
            block = int(fields[-1])
            # meta layout: streaming.META_COLS (slot, stream, wpos, cstart,
            # n_req, do_dec, do_reset) + 4-token prefix. One warm call per
            # batch size covers every runtime value — the warm row is fully
            # INERT (stream 0, no decode, no reset: the masked-row no-op) so
            # it never perturbs live slots and stays in range for any table
            # width.
            args = lambda j, block=block: (  # noqa: E731
                np.asarray([120, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.int32),
                np.zeros((block, VAD_FRAME), np.float32),
            )
        else:
            continue
        for nb in sizes(kind.pad_to):
            await asyncio.gather(*(batcher.submit(name, *args(j)) for j in range(nb)))
            warmed.append((name, nb))
            if log is not None:
                log(f"# warmed {name} batch={nb}")
    return warmed


class WhisperNode(ProcessorNode):
    """Speech-to-text (``plugin::native::whisper``)."""

    KIND = "plugin::native::whisper"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "model_path": None,  # HF checkpoint dir (vocab.json for text out)
                "model_size": "tiny",  # used with random init when no model_path
                "language": "en",
                "vad_model_path": None,  # accepted for reference-yaml compat
                "vad_threshold": 0.5,
                "min_silence_duration_ms": 700,
                "max_segment_duration_secs": 30.0,
                "partial_transcripts": False,
                "partial_interval_ms": 300,
                # incremental streaming partials: per-session device-resident
                # encoder/decoder caches — each partial costs one 160 ms
                # chunk encode + a few decode steps instead of a full bucket
                # re-encode (models/whisper/streaming.py). Falls back to the
                # bucket re-decode path when the stream table is exhausted.
                "streaming_partials": True,
                # serve segment FINALS from the stream table's continuation
                # decode (tokens already computed by the partial ticks)
                # instead of an exact bidirectional bucket re-decode. Cuts
                # the per-segment device cost from a 250-350 ms bucket call
                # to zero extra work — a latency/throughput profile knob; the
                # default keeps the reference's exact-final contract. Falls
                # back to the exact decode when the stream horizon froze or
                # the segment never streamed.
                "final_from_stream": False,
                # chunked-encoder window buckets (seconds): a segment decodes
                # in the smallest bucket that fits, slashing transfer/encode
                # cost for short segments and live partials. [30.0] = always
                # the canonical full whisper window (maximum fidelity).
                "window_buckets": [30.0],
                # VAD frames scored per device call (1 = every 32 ms; higher
                # values batch scoring, cutting dispatch rate at the cost of
                # segmentation granularity — still far under the 700 ms
                # silence threshold)
                "vad_block_frames": 4,
                "allow_random_init": True,  # offline/dev mode when no weights
                "dtype": "float32",
                "max_tokens": 224,
                "suppress_blank": True,  # whisper.cpp set_suppress_blank
                "suppress_non_speech_tokens": True,  # set_suppress_nst
                "n_threads": 0,  # reference compat (PyTorch owns scheduling)
            },
        )
        self.device = resolve_device(device)
        self.model_path = cfg["model_path"]
        self.model_size = cfg["model_size"]
        self.language = cfg["language"]
        self.suppress_blank = bool(cfg["suppress_blank"])
        self.suppress_nst = bool(cfg["suppress_non_speech_tokens"])
        self.vad_threshold = float(cfg["vad_threshold"])
        self.min_silence_ms = float(cfg["min_silence_duration_ms"])
        self.max_segment_secs = float(cfg["max_segment_duration_secs"])
        self.partials = bool(cfg["partial_transcripts"])
        self.partial_interval = float(cfg["partial_interval_ms"]) / 1000.0
        self.streaming_partials = bool(cfg["streaming_partials"]) and (
            os.environ.get("SK_STREAM_PARTIALS", "1") == "1"
        )
        self.final_from_stream = bool(cfg["final_from_stream"]) or (
            os.environ.get("SK_STREAM_FINALS", "0") == "1"
        )
        self.window_buckets = sorted(float(b) for b in cfg["window_buckets"])
        self.vad_block = max(1, int(cfg["vad_block_frames"]))
        self.allow_random_init = bool(cfg["allow_random_init"])
        self.dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
        self.max_tokens = int(cfg["max_tokens"])
        if self.model_path is None and not self.allow_random_init:
            raise ConfigurationError("model_path is required when allow_random_init is false")

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.raw_audio(AudioFormat(16000, 0))])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.transcription())]

    async def _load_model(self, ctx: NodeContext):
        """Shared, content-addressed model load (reference model cache)."""

        async def loader():
            loop = asyncio.get_running_loop()

            def build():
                if self.model_path and os.path.isdir(self.model_path):
                    cfg, params = load_pretrained(self.model_path, self.dtype, self.device)
                    tok = WhisperDetokenizer.from_model_dir(self.model_path)
                else:
                    if not self.allow_random_init:
                        raise ConfigurationError(f"model not found: {self.model_path}")
                    cfg = WHISPER_CONFIGS[self.model_size]
                    params = seeded_params(cfg, self.dtype, self.device)
                    tok = WhisperDetokenizer()
                return cfg, params, tok

            return await loop.run_in_executor(None, build)

        key = ResourceKey.from_params(
            "whisper",
            {"path": self.model_path, "size": self.model_size, "dtype": str(self.dtype),
             "device": str(self.device)},
        )
        if ctx.resources is not None:
            return await ctx.resources.get_or_create(key, loader)
        return await loader()

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx)
        model_cfg, params, detok = await self._load_model(ctx)
        ctx.emit_state(NodeState.running())

        dev = self.device
        vad_state = vad_init_state((), dev)
        vad_slot = None
        seg = SpeechSegmenter(self.vad_threshold, self.min_silence_ms, self.max_segment_secs)
        buf = np.zeros(0, dtype=np.float32)
        # language=auto (whisper.cpp semantics): detect on the first speech
        # segment (one decoder step after <|sot|>, argmax over the language
        # block), then pin for the session. Until then decode as English.
        auto_lang = str(self.language).lower() == "auto"
        lang_index = 0 if auto_lang else language_index(self.language)
        lang_code = "en" if auto_lang else self.language

        # whisper.cpp-parity suppression (lib.rs:633-635): non-speech symbol
        # tokens biased out of every step; blank + eot biased out of the
        # first sampled token. Needs a real vocab (the sets derive from it);
        # numeric-fallback detokenizers suppress nothing.
        suppress_bias = None
        begin_bias = None
        n_vocab = model_cfg.n_vocab
        if self.suppress_nst:
            nst = [i for i in detok.non_speech_tokens() if i < n_vocab]
            if nst:
                b = np.zeros(n_vocab, np.float32)
                b[np.asarray(nst)] = -1e9
                suppress_bias = torch.from_numpy(b).to(dev)
        if self.suppress_blank:
            # tiny test configs (n_vocab < real token ids) have no blank/eot
            # in range — suppression is a no-op there
            ids = [i for i in (model_cfg.token_eot, detok.blank_token())
                   if i is not None and i < n_vocab]
            if ids:
                b = np.zeros(n_vocab, np.float32)
                b[np.asarray(ids)] = -1e9
                begin_bias = torch.from_numpy(b).to(dev)
        loop = asyncio.get_running_loop()
        last_partial = 0.0
        partial_task = None
        seq = 0

        def decode_sync(audio: np.ndarray):
            nonlocal lang_index, lang_code, auto_lang
            if auto_lang:
                from ...models.whisper.decode import detect_language_window

                lang_index = int(detect_language_window(params, model_cfg, audio))
                lang_code = WHISPER_LANGUAGES[lang_index]
                auto_lang = False
            tokens, lengths = transcribe_window(
                params, model_cfg, audio, language_index=lang_index,
                max_tokens=self.max_tokens,
                suppress_bias=suppress_bias, begin_bias=begin_bias,
            )
            return detok.decode(tokens[0][: int(lengths[0])])

        # continuous batching: segments from ALL sessions sharing this model
        # are packed into one batched device call per kind. Each audio block
        # crosses the host boundary exactly once — inside the VAD call, which
        # also appends it to the session's device-resident ring
        # (engine/audio_ring.py). Decodes (partials AND finals) then reference
        # audio by (slot, start, length): three scalars per session instead of
        # a padded window per decode.
        batch_kind = None
        ring = None
        written = 0  # absolute samples written to the ring (== frames scored × 512)
        if ctx.batcher is not None:
            from ...models.whisper.decode import transcribe_ring

            ring = get_audio_ring(dev)
            # language rides PER-ROW through every batched kind (meta prefix
            # on the stream path, lang rows on the ring decodes), so sessions
            # with different — or auto-detected — languages share programs.
            # Suppression settings are baked into the registered closures
            # (and the stream table), so they MUST be part of the tag.
            model_tag = (
                f"{self.model_path or self.model_size}:{self.max_tokens}"
                f":s{int(self.suppress_blank)}{int(self.suppress_nst)}"
            )
            batch_kind = f"whisper_ring:{model_tag}"
            vad_kind = f"vad_ring:{self.vad_block}"

            def batched_vad(slot_ids, starts, frames_b):
                return ring.vad_append(slot_ids, starts, frames_b)

            # fixed-size padding (serving knob): one batch shape per kind
            # instead of one per power-of-2 batch size
            pad_vad = int(os.environ.get("SK_VAD_PAD_TO", "0")) or None
            pad_stt = int(os.environ.get("SK_STT_PAD_TO", "0")) or None
            ctx.batcher.register(
                vad_kind,
                batched_vad,
                max_batch=128,
                pad_to=pad_vad,
                gather_ms=float(os.environ.get("SK_VAD_GATHER_MS", "0")),
            )

            def make_ring_stt(window: int, tok_budget: int):
                def batched_stt(slot_ids, starts, lengths, lang_rows):
                    return transcribe_ring(
                        params, model_cfg, ring.ring_ref(),
                        slot_ids, starts, lengths,
                        window_samples=window,
                        language_index=lang_rows,
                        max_tokens=tok_budget,
                        suppress_bias=suppress_bias, begin_bias=begin_bias,
                        with_logprobs=True,
                    )

                return batched_stt

            # detection needs only a few seconds of audio — cap the window
            # so the extra encode before the first decode stays cheap
            # (fusing detection into _ring_stt is the next optimization)
            detect_window = int(min(8.0, self.window_buckets[0]) * _SR)
            detect_kind = f"whisper_detect:{model_tag}:{detect_window}"

            def batched_detect(slot_ids, starts, lengths):
                from ...models.whisper.decode import detect_language_ring

                return (
                    detect_language_ring(
                        params, model_cfg, ring.ring_ref(),
                        slot_ids, starts, lengths,
                        window_samples=detect_window,
                    ),
                )

            ctx.batcher.register(detect_kind, batched_detect)

            # gather window: hold a partial decode batch briefly so
            # co-arriving sessions coalesce into one padded call (decode is
            # the expensive kind; VAD stays immediate)
            gather_ms = float(os.environ.get("SK_STT_GATHER_MS", "0"))
            for b in self.window_buckets:
                # token budget scales with the bucket: speech averages
                # ~2.5 tok/s, so short partial buckets never need the full
                # budget — sequential decode steps are the latency cost
                tok_budget = min(self.max_tokens, max(12, int(b * 4) + 8))
                ctx.batcher.register(
                    f"{batch_kind}:{int(b * _SR)}",
                    make_ring_stt(int(b * _SR), tok_budget),
                    pad_to=pad_stt,
                    gather_ms=gather_ms,
                )

        # -- incremental streaming decode (models/whisper/streaming.py) ------
        # Used for live partials AND (``final_from_stream``) for zero-cost
        # segment finals: the continuation decode consumes each utterance as
        # it arrives, so at segment close its newest tokens ARE the final —
        # no bucket re-decode on the device queue (the round-4 engine bench
        # spent ~75% of its dispatch on whisper_ring bucket re-decodes).
        stream_tbl = None
        stream_id = None
        use_stream = self.streaming_partials and (
            self.partials or self.final_from_stream
        )
        if batch_kind is not None and use_stream:
            from ...models.whisper.streaming import (
                CHUNK_SAMPLES,
                RIGHT_CTX,
                get_stream_table,
            )

            stream_tbl = get_stream_table(
                model_tag, model_cfg, self.dtype, device=dev,
                suppress_bias=suppress_bias, begin_bias=begin_bias,
            )
            stream_id = stream_tbl.try_alloc()
            if stream_id is None:
                stream_tbl = None  # table exhausted: bucket-partial fallback
            else:
                if self.final_from_stream:
                    # force-cut segments at the stream horizon (minus an
                    # 8-chunk catch-up margin) so stream finals never freeze
                    # into exact-decode fallbacks (stt_serving.py rationale)
                    horizon_frames = int(
                        (stream_tbl.enc_t // 8 - 8) * CHUNK_SAMPLES / VAD_FRAME
                    )
                    seg.max_segment_frames = min(
                        seg.max_segment_frames, max(horizon_frames, 16)
                    )
                stream_pad = int(
                    os.environ.get(
                        "SK_STREAM_PAD", str(min(64, stream_tbl.max_slots))
                    )
                )
                stream_steps = int(os.environ.get("SK_STREAM_STEPS", "3"))
                # chunk budget per fused call must cover the block rate
                # (stt_serving derivation): 8-frame blocks → 2, 16-frame → 4
                n_chunks = max(
                    2, -(-(self.vad_block * VAD_FRAME) // CHUNK_SAMPLES)
                )
                # fused per-block step: VAD + ring append + chunk encode +
                # decode continuation in ONE batched call — replaces the
                # 3-call chain (vad, enc, dec) whose per-call Python dispatch
                # saturated a 1-core serving host. Identity
                # packing (StreamTable.identity_step_fn): batch row p IS
                # stream slot p, zero cache gathers.
                sstep_kind = f"stream_step:{model_tag}:{self.vad_block}"
                if not ctx.batcher.is_registered(sstep_kind):
                    trash = ring.trash_slot()
                    batched_sstep = stream_tbl.identity_step_fn(
                        params, ring, trash, stream_steps, n_chunks=n_chunks,
                    )
                    block_ms = self.vad_block * VAD_FRAME * 1000.0 / _SR
                    sgather = float(
                        os.environ.get(
                            "SK_STREAM_GATHER_MS", str(0.8 * block_ms)
                        )
                    )
                    ctx.batcher.register(
                        sstep_kind, batched_sstep, pad_to=stream_pad,
                        gather_ms=sgather, host_inputs=True,
                    )
        def _prefix_for(idx: int) -> np.ndarray:
            return np.asarray(
                [
                    model_cfg.token_sot,
                    model_cfg.token_language(idx),
                    model_cfg.token_transcribe,
                    model_cfg.token_no_timestamps,
                ],
                np.int32,
            )

        stream_prefix = None
        if stream_tbl is not None:
            stream_prefix = _prefix_for(lang_index)
        # fused-path streaming cursors (all sample counts absolute)
        st_ready = False  # reset done for the currently open segment
        st_tip = 0  # next chunk start
        st_pos = 0  # encoder positions filled this segment
        st_last_dec = 0.0  # partial-decode cooldown
        st_last_tok = None  # (tok_row, n_tok) from the newest fused decode
        st_pending_reset = False  # fused do_reset rides the NEXT block's step

        def _bucket_samples(n: int) -> int:
            for b in self.window_buckets:
                if n <= int(b * _SR):
                    return int(b * _SR)
            return int(self.window_buckets[-1] * _SR)

        last_confidence = None  # mean token prob of the newest ring decode

        async def decode_text(samples: np.ndarray, start_f: int, end_f: int) -> str:
            nonlocal lang_index, lang_code, auto_lang, stream_prefix
            if batch_kind is not None:
                n = min((end_f - start_f) * VAD_FRAME, int(self.window_buckets[-1] * _SR))
                if auto_lang:
                    lang = await ctx.batcher.submit(
                        detect_kind,
                        np.int32(vad_slot),
                        np.int32((start_f * VAD_FRAME) % ring.ring_samples),
                        np.int32(min(n, detect_window)),
                    )
                    lang_index = int(lang)
                    lang_code = WHISPER_LANGUAGES[lang_index]
                    auto_lang = False
                    if stream_prefix is not None:
                        stream_prefix = _prefix_for(lang_index)
                    telemetry.emit("stt.language", {"detected": lang_code})
                window = _bucket_samples(n)
                tokens, length, lp_sum = await ctx.batcher.submit(
                    f"{batch_kind}:{window}",
                    np.int32(vad_slot),
                    np.int32((start_f * VAD_FRAME) % ring.ring_samples),
                    np.int32(n),
                    np.int32(lang_index),
                )
                nonlocal last_confidence
                n_out = int(length)
                # mean chosen-token probability (exp of the avg log-prob) —
                # the reference's whisper.cpp wrapper reports None here
                last_confidence = float(np.exp(lp_sum / max(1, n_out))) if n_out else None
                return detok.decode(tokens[:n_out])
            return await loop.run_in_executor(None, decode_sync, samples)

        async def send_transcription(text: str, start_f, end_f, is_final: bool) -> None:
            nonlocal seq
            start_ms = start_f * VAD_FRAME * 1000 // _SR
            end_ms = end_f * VAD_FRAME * 1000 // _SR
            data = TranscriptionData(
                text=text,
                segments=(
                    TranscriptionSegment(
                        text, start_ms, end_ms,
                        confidence=last_confidence if is_final else None,
                    ),
                ),
                language=lang_code,
                is_final=is_final,
            )
            meta = PacketMetadata(timestamp_us=start_ms * 1000, sequence=seq)
            seq += 1
            if is_final:
                telemetry.emit("stt.result", {"text": text, "start_ms": start_ms, "end_ms": end_ms})
            else:
                telemetry.emit("stt.partial", {"text": text})
            await ctx.output.send("out", Packet.new_transcription(data, meta))
            stats.packet_sent()

        async def emit_transcription(samples, start_f, end_f, is_final: bool) -> None:
            if samples.shape[0] < VAD_FRAME:
                return
            text = await decode_text(samples, start_f, end_f)
            await send_transcription(text, start_f, end_f, is_final)

        if batch_kind is not None:
            # overload shedding: a full ring table degrades this session to
            # the unbatched local path (slower, still correct) instead of
            # failing the node — admission limits (server config
            # max_concurrent_sessions) should keep this from happening; this
            # is the backstop (VERDICT r4 #5)
            try:
                vad_slot = ring.alloc()
            except RuntimeError:
                telemetry.emit(
                    "stt.degraded", {"reason": "audio ring table exhausted"}
                )
                ctx.emit_state(NodeState.degraded("audio ring table exhausted"))
                batch_kind = None
                if stream_tbl is not None and stream_id is not None:
                    stream_tbl.free(stream_id)
                stream_tbl = None
                stream_id = None

        # Transcription emission runs on a per-session sequential worker so
        # the ingest/VAD loop NEVER stalls behind a decode (finals previously
        # ran inline and blocked the session for the decode duration).
        # FIFO on one worker preserves the ordering contract: a segment's
        # final is its last packet, sequence numbers stay monotonic.
        emit_q: asyncio.Queue = asyncio.Queue()
        seg_gen = [0]  # bumped when a segment closes; stales queued partials
        inflight_partial: list = [None]

        def enqueue_final(seg_samples, start_f, end_f) -> None:
            seg_gen[0] += 1
            t = inflight_partial[0]
            if t is not None and not t.done():
                # the stale partial must never land after (and outsequence)
                # its segment's final
                t.cancel()
            emit_q.put_nowait(("final", seg_samples, start_f, end_f, seg_gen[0]))

        async def emit_worker() -> None:
            nonlocal last_confidence
            while True:
                item = await emit_q.get()
                if item is None:
                    return
                kind_, samples_, start_f_, end_f_, gen_ = item
                if kind_ == "ptext":
                    # fused-step partial: text already decoded on device —
                    # no further device work, just ordered emission
                    if gen_ != seg_gen[0]:
                        continue  # segment already closed: stale
                    await send_transcription(samples_, start_f_, end_f_, False)
                elif kind_ == "ftext":
                    # streaming final: text comes from the stream table's
                    # continuation decode, no device work at close. The
                    # stream path computes no confidence — clear the ring
                    # decode's value so a PREVIOUS segment's confidence is
                    # never attached to this one
                    last_confidence = None
                    await send_transcription(samples_, start_f_, end_f_, True)
                elif kind_ == "partial":
                    if gen_ != seg_gen[0]:
                        continue  # segment already closed: stale
                    t = asyncio.ensure_future(
                        emit_transcription(samples_, start_f_, end_f_, False)
                    )
                    inflight_partial[0] = t
                    try:
                        await t
                    except asyncio.CancelledError:
                        pass
                    finally:
                        inflight_partial[0] = None
                else:
                    await emit_transcription(samples_, start_f_, end_f_, True)

        emit_task = asyncio.ensure_future(emit_worker())
        try:
            while True:
                batch = await ctx.recv_batch("in")
                if batch is None:
                    break
                pieces = [buf]
                for pkt in batch:
                    stats.packet_received()
                    if pkt.audio is None:
                        stats.packet_discarded()
                        continue
                    if pkt.audio.format.sample_rate != _SR:
                        raise ConfigurationError(
                            f"whisper requires 16kHz input, got {pkt.audio.format.sample_rate}"
                        )
                    samples = pkt.audio.samples
                    if pkt.audio.format.channels > 1:  # downmix
                        samples = samples.reshape(-1, pkt.audio.format.channels).mean(axis=1)
                    pieces.append(samples)
                if len(pieces) == 1:
                    continue
                buf = np.concatenate(pieces)
                if len(buf) // VAD_FRAME < self.vad_block:
                    continue
                # score in EXACT vad_block-sized calls: a single static shape
                # per kind (variable frame counts would each batch apart)
                all_probs = []
                all_frames = []
                partial_emit = None  # (tok_row, n_tok, end_f) from a fused step
                while len(buf) // VAD_FRAME >= self.vad_block:
                    block = buf[: self.vad_block * VAD_FRAME].reshape(self.vad_block, VAD_FRAME)
                    buf = buf[self.vad_block * VAD_FRAME :]
                    all_frames.append(block)
                    if ctx.batcher is not None:
                        if stream_tbl is not None:
                            # ONE fused call: VAD + ring append + chunk
                            # encode + decode continuation. The chunk gather
                            # runs after the append, so audio from THIS block
                            # can be encoded and decoded in the same call.
                            # Silent/idle sessions ride the SAME kind with
                            # n_req=0/do_dec=False (bit-exact no-op on their
                            # caches): one kind means all co-paced sessions
                            # coalesce into ONE device call per block period
                            # — two kinds would split the batch and double
                            # the call rate.
                            if seg.in_speech and st_ready:
                                avail = written + block.size - RIGHT_CTX - st_tip
                                room = (stream_tbl.enc_t - st_pos) // 8
                                n_req = max(0, min(avail // CHUNK_SAMPLES, n_chunks))
                                if room < n_req:
                                    n_req = 0  # horizon full: partials freeze
                                now = time.monotonic()
                                # finals-only stream mode decodes EVERY block
                                # so the continuation stays caught up (the
                                # final is its newest tokens); partials apply
                                # the emission-interval cooldown
                                do_dec = st_pos + 8 * n_req > 0 and (
                                    not self.partials
                                    or now - st_last_dec >= self.partial_interval
                                )
                                if do_dec:
                                    st_last_dec = now
                            else:
                                n_req = 0
                                do_dec = False
                            do_rst = st_pending_reset
                            st_pending_reset = False
                            if auto_lang and (do_rst or do_dec) and written > 0:
                                # first decode of an auto session: detect the
                                # language from audio ALREADY in the ring
                                # (this block is appended by the fused step
                                # only after this detect call)
                                avail = int(min(detect_window, written))
                                lang = await ctx.batcher.submit(
                                    detect_kind,
                                    np.int32(vad_slot),
                                    np.int32((written - avail) % ring.ring_samples),
                                    np.int32(max(1, avail)),
                                )
                                lang_index = int(lang)
                                lang_code = WHISPER_LANGUAGES[lang_index]
                                auto_lang = False
                                stream_prefix = _prefix_for(lang_index)
                                telemetry.emit("stt.language", {"detected": lang_code})
                            meta_row = np.concatenate(
                                [
                                    np.asarray(
                                        [
                                            vad_slot,
                                            stream_id,
                                            written % ring.ring_samples,
                                            st_tip % ring.ring_samples,
                                            n_req,
                                            int(do_dec),
                                            int(do_rst),
                                        ],
                                        np.int32,
                                    ),
                                    stream_prefix,
                                ]
                            )
                            probs, tok_row, ntk, _ = await ctx.batcher.submit(
                                sstep_kind, meta_row, block
                            )
                            st_tip += n_req * CHUNK_SAMPLES
                            st_pos += n_req * 8
                            if do_dec:
                                partial_emit = (tok_row, int(ntk), st_tip // VAD_FRAME)
                                st_last_tok = (tok_row, int(ntk))
                        else:
                            probs = await ctx.batcher.submit(
                                vad_kind,
                                np.int32(vad_slot),
                                np.int32(written % ring.ring_samples),
                                block,
                            )
                        written += block.size
                        all_probs.append(np.asarray(probs))
                    else:
                        probs, vad_state = vad_frame_probs(
                            vad_state, torch.as_tensor(block, dtype=torch.float32, device=dev)
                        )
                        all_probs.append(probs.cpu().numpy())
                frames = np.concatenate(all_frames)
                probs = np.concatenate(all_probs)
                n_frames = frames.shape[0]
                for i in range(n_frames):
                    for kind, seg_samples, start_f, end_f in seg.push(frames[i], float(probs[i])):
                        if kind == "speech_start":
                            telemetry.emit("vad.speech_start", {})
                            if stream_tbl is not None:
                                # open the streaming row on the NEXT block's
                                # fused step (do_reset) — a standalone reset
                                # call per utterance would serialize on the
                                # device at high session counts
                                st_pending_reset = True
                                st_tip = start_f * VAD_FRAME
                                st_pos = 0
                                st_ready = True
                                st_last_tok = None
                        else:
                            telemetry.emit("vad.speech_end", {})
                            if stream_tbl is not None:
                                st_ready = False
                            # streaming final: the continuation decode has
                            # already consumed the whole utterance plus the
                            # VAD hangover silence — its newest tokens ARE
                            # the final. Guarded: the encode tip must have
                            # reached the end of speech (a frozen horizon or
                            # a never-streamed segment falls back to the
                            # exact bucket decode).
                            if (
                                self.final_from_stream
                                and st_last_tok is not None
                                and st_last_tok[1] > len(stream_prefix)
                                and st_tip >= end_f * VAD_FRAME - 2 * CHUNK_SAMPLES
                            ):
                                ftext = detok.decode(
                                    st_last_tok[0][len(stream_prefix) : st_last_tok[1]]
                                )
                                seg_gen[0] += 1
                                t = inflight_partial[0]
                                if t is not None and not t.done():
                                    t.cancel()
                                emit_q.put_nowait(
                                    ("ftext", ftext, start_f, end_f, seg_gen[0])
                                )
                            else:
                                enqueue_final(seg_samples, start_f, end_f)
                            st_last_tok = None
                # emit the fused step's partial AFTER segment events: if this
                # block closed the segment, the partial is stale (the final
                # supersedes it) and is dropped here
                if (
                    partial_emit is not None
                    and self.partials
                    and seg.in_speech
                    and st_ready
                    and partial_emit[1] > len(stream_prefix)
                ):
                    tok_row, ntk, end_f = partial_emit
                    text = detok.decode(tok_row[len(stream_prefix) : ntk])
                    emit_q.put_nowait(
                        ("ptext", text, seg._segment_start_frame, end_f, seg_gen[0])
                    )
                # bucket-fallback live partials (streaming sessions emit
                # partials from the fused step instead): only enqueued
                # when the emit worker is idle; a final closing the segment
                # cancels any in-flight partial decode
                if self.partials and stream_tbl is None and seg.in_speech:
                    now = time.monotonic()
                    if (
                        now - last_partial >= self.partial_interval
                        and seg._segment
                        and emit_q.empty()
                        and inflight_partial[0] is None
                    ):
                        last_partial = now
                        partial_audio = np.concatenate(seg._segment)
                        emit_q.put_nowait(
                            ("partial", partial_audio, seg._segment_start_frame,
                             seg._frame_idx, seg_gen[0])
                        )
            for kind, seg_samples, start_f, end_f in seg.flush():
                enqueue_final(seg_samples, start_f, end_f)
            emit_q.put_nowait(None)
            await emit_task
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        finally:
            if not emit_task.done():
                emit_q.put_nowait(None)
                try:
                    await asyncio.wait_for(emit_task, timeout=5)
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    emit_task.cancel()
            if stream_tbl is not None and stream_id is not None:
                stream_tbl.free(stream_id)
            if vad_slot is not None:
                ring.free(vad_slot)
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
