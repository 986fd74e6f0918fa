# SPDX-License-Identifier: Apache-2.0
"""Streaming TTS node: Text → RawAudio.

Port of ``streamkit_tpu/nodes/ml/tts_node.py``. Parity target:
``plugin::native::kokoro`` (``plugins/native/kokoro/src/
kokoro_node.rs:25-123,444-532``; piper shares the shape): buffers incoming
Text, a sentence splitter extracts complete sentences, each sentence is
synthesized as one unit, the remainder is flushed at the end of input.
Synthesis runs on the device the node was registered with, by one of three
backends: Kokoro (:mod:`streamkit_tpu_torch.models.kokoro`; ``backend:
kokoro``, or ``auto`` on a model dir holding ``voices.bin``), VITS
(:mod:`streamkit_tpu_torch.models.vits`), or the acoustic model and HiFi-GAN
vocoder (:mod:`streamkit_tpu_torch.models.tts`).
"""

from __future__ import annotations

import asyncio
import os
import re
from typing import List, Optional

import numpy as np
import torch

from ...core import (
    AudioFormat,
    AudioFrame,
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
    parse_config_optional,
)
from ...core.state import NodeState, StopReason
from ...device import resolve_device
from ...models.tts import (
    AcousticConfig,
    HifiGanConfig,
    acoustic_generate,
    acoustic_init_params,
    acoustic_params_from_numpy,
    hifigan_generate,
    hifigan_init_params,
    hifigan_params_from_numpy,
)

__all__ = ["SentenceSplitter", "TtsNode", "VITS_RANDOM_VOCAB", "FASTSPEECH_VOCODER"]

_SENTENCE_RE = re.compile(r"(.*?[.!?…]+(?:\s+|$))", re.S)

# the character vocabulary of a VITS node without a checkpoint (the
# reference node's; ids 1..43 against the default config's 38 rows: the ids
# past the table take its last row, see models/vits.py text_encoder)
VITS_RANDOM_VOCAB = {c: i + 1 for i, c in enumerate("abcdefghijklmnopqrstuvwxyz0123456789 .,!?'-")}
# the vocoder of the fastspeech backend (hop 200: 120 frames a second at 24 kHz)
FASTSPEECH_VOCODER = HifiGanConfig(upsample_rates=(5, 5, 4, 2), upsample_kernel_sizes=(10, 10, 8, 4))


class SentenceSplitter:
    """Extracts complete sentences from streamed text (reference kokoro
    ``SentenceSplitter``)."""

    def __init__(self, max_len: int = 400) -> None:
        self._buf = ""
        self.max_len = max_len

    def push(self, text: str) -> List[str]:
        self._buf += text
        out: List[str] = []
        while True:
            m = _SENTENCE_RE.match(self._buf)
            if m and m.group(1).strip():
                out.append(m.group(1).strip())
                self._buf = self._buf[m.end(1):]
                continue
            if len(self._buf) > self.max_len:
                out.append(self._buf[: self.max_len].strip())
                self._buf = self._buf[self.max_len:]
                continue
            return out

    def flush(self) -> List[str]:
        rest = self._buf.strip()
        self._buf = ""
        return [rest] if rest else []


class TtsNode(ProcessorNode):
    """Text → synthesized RawAudio (``plugin::native::kokoro`` class)."""

    KIND = "plugin::native::kokoro"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "model_path": None,  # npz (fastspeech) or HF VitsModel dir
                "model_dir": None,  # reference param name (kokoro/piper config)
                "backend": "auto",  # auto | vits | fastspeech | kokoro
                "sample_rate": 24000,
                "frames_per_char": 6,  # mel frames per input char (≈70ms/char)
                "speed": 1.0,
                "noise_scale": 0.667,  # piper/VITS sampling temperature
                "noise_scale_w": 0.8,  # duration-noise (stochastic duration)
                "length_scale": 1.0,
                "speaker_id": 0,
                "voice": None,  # accepted for reference-yaml compat
                "num_threads": None,  # reference compat (PyTorch owns scheduling)
                "min_sentence_length": None,
                "execution_provider": None,
                "emit_telemetry": True,
                "telemetry_preview_chars": 120,
                "allow_random_init": True,
            },
        )
        self.device = resolve_device(device)
        self.model_path = cfg["model_path"] or cfg["model_dir"]
        self.backend = str(cfg["backend"])
        if self.backend not in ("auto", "vits", "fastspeech", "kokoro"):
            raise ConfigurationError(f"unknown tts backend: {self.backend!r}")
        self.speaker_id = int(cfg["speaker_id"])
        if not 0 <= self.speaker_id <= 102:  # v1.1 voices (config.rs:14)
            raise ConfigurationError("speaker_id must be 0-102")
        if not 0.5 <= float(cfg["speed"]) <= 2.0:  # config.rs:18
            raise ConfigurationError("speed must be 0.5-2.0")
        self.sample_rate = int(cfg["sample_rate"])
        self.frames_per_char = float(cfg["frames_per_char"])
        self.speed = float(cfg["speed"])
        self.allow_random_init = bool(cfg["allow_random_init"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.text(), PacketType.transcription()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.raw_audio(AudioFormat(self.sample_rate, 1)))]

    def _pick_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        if self.model_path and os.path.isdir(self.model_path):
            # voices.bin is the kokoro model-dir signature (kokoro_node.rs:706)
            if os.path.exists(os.path.join(self.model_path, "voices.bin")):
                return "kokoro"
            if os.path.exists(os.path.join(self.model_path, "config.json")):
                return "vits"
        return "fastspeech"

    async def _load(self, ctx: NodeContext):
        backend = self._pick_backend()
        dev = self.device

        async def loader():
            loop = asyncio.get_running_loop()

            def build():
                if backend == "kokoro":
                    from ...models.kokoro import load_kokoro_dir

                    if not (self.model_path and os.path.isdir(self.model_path)):
                        raise ConfigurationError(f"kokoro backend requires a model dir: {self.model_path}")
                    return ("kokoro",) + load_kokoro_dir(self.model_path, device=dev)
                if backend == "vits":
                    from ...models.vits import VitsCharTokenizer, VitsConfig, load_vits, vits_init_params

                    if self.model_path and os.path.isdir(self.model_path):
                        return ("vits",) + load_vits(self.model_path, device=dev)
                    if not self.allow_random_init:
                        raise ConfigurationError(f"model not found: {self.model_path}")
                    vcfg = VitsConfig(sampling_rate=self.sample_rate)
                    return "vits", vcfg, vits_init_params(vcfg, device=dev), VitsCharTokenizer(VITS_RANDOM_VOCAB)
                acfg, vcfg = AcousticConfig(), FASTSPEECH_VOCODER
                if self.model_path and os.path.exists(self.model_path):
                    blob = np.load(self.model_path, allow_pickle=True)
                    return ("fastspeech", acfg, acoustic_params_from_numpy(blob["acoustic"].item(), acfg, device=dev),
                            vcfg, hifigan_params_from_numpy(blob["vocoder"].item(), vcfg, device=dev))
                if self.model_path and not self.allow_random_init:
                    raise ConfigurationError(f"model not found: {self.model_path}")
                return ("fastspeech", acfg, acoustic_init_params(acfg, device=dev), vcfg,
                        hifigan_init_params(vcfg, device=dev))

            return await loop.run_in_executor(None, build)

        key = ResourceKey.from_params("tts", {"path": self.model_path, "backend": backend, "device": str(dev)})
        if ctx.resources is not None:
            return await ctx.resources.get_or_create(key, loader)
        return await loader()

    def _kokoro(self, ctx: NodeContext, loaded):
        """The Kokoro backend's format, one-sentence synthesis and (with a
        batcher) cross-session synthesis: durations and the encode, expand
        and decode core are two batcher kinds, since the frame bucket is
        known only after the durations."""
        from ...models.kokoro import (
            SAMPLE_RATE,
            TOKEN_BUCKETS,
            kokoro_bucket,
            kokoro_core_batch,
            kokoro_durations_batch,
            kokoro_finish,
            kokoro_frames,
            kokoro_synthesize,
            kokoro_token_row,
        )

        _, kcfg, kparams, ktokens, kvoices = loaded
        if self.speaker_id >= kvoices.shape[0]:
            raise ConfigurationError(
                f"speaker_id {self.speaker_id} out of range: voices.bin has {kvoices.shape[0]} voices"
            )
        pack = kvoices[self.speaker_id]

        def synth_sync(sentence: str) -> np.ndarray:
            return kokoro_synthesize(kparams, kcfg, ktokens.encode(sentence), pack, speed=self.speed)

        if ctx.batcher is None:
            return AudioFormat(SAMPLE_RATE, 1), synth_sync, None
        tag = f"{self.model_path or 'randinit'}:{self.speaker_id}:{self.speed}"

        def dur_fn(tok_b, tm_b, st_b):
            with torch.inference_mode():
                return kokoro_durations_batch(kparams, kcfg, tok_b, tm_b, st_b)

        def core_fn(f_pad: int):
            def fn(tok_b, tm_b, st_b, fi_b, fm_b):
                with torch.inference_mode():
                    return kokoro_core_batch(kparams, kcfg, tok_b, tm_b, st_b, fi_b, fm_b, f_pad)[0]

            return fn

        async def synth_batched(sentence: str) -> np.ndarray:
            ids = ktokens.encode(sentence)
            if not ids:
                return np.zeros(0, np.float32)
            t = len(ids)
            tok, t_mask = kokoro_token_row(ids, kcfg)
            style = np.asarray(pack[min(t, pack.shape[0] - 1)], np.float32)
            kind = f"kokoro_dur:{tag}:{kokoro_bucket(t, TOKEN_BUCKETS)}"
            ctx.batcher.register(kind, dur_fn, max_batch=16, transient=True)
            dur = await ctx.batcher.submit(kind, tok, t_mask, style)
            fi, f_mask, kept = kokoro_frames(dur, t, self.speed)
            kind = f"kokoro_core:{tag}:{len(tok)}:{len(fi)}"
            ctx.batcher.register(kind, core_fn(len(fi)), max_batch=16, transient=True)
            audio = await ctx.batcher.submit(kind, tok, t_mask, style, fi, f_mask)
            return kokoro_finish(audio, kept)

        return AudioFormat(SAMPLE_RATE, 1), synth_sync, synth_batched

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx)
        loaded = await self._load(ctx)
        ctx.emit_state(NodeState.running())
        splitter = SentenceSplitter()
        loop = asyncio.get_running_loop()
        dev = self.device
        seq = 0
        synth_batched = None  # set by the backend that batches across sessions

        if loaded[0] == "kokoro":
            fmt, synth_sync, synth_batched = self._kokoro(ctx, loaded)
        elif loaded[0] == "vits":
            from ...models.vits import synthesize as vits_synthesize

            _, mcfg, mparams, tok = loaded
            fmt = AudioFormat(mcfg.sampling_rate, 1)

            def _encode(sentence: str) -> np.ndarray:
                return tok.encode(sentence) if tok else np.frombuffer(
                    sentence.encode(), np.uint8
                ).astype(np.int32) % mcfg.vocab_size

            def synth_sync(sentence: str) -> np.ndarray:
                ids = torch.as_tensor(_encode(sentence)[None], device=dev)
                # pow-2 frame buckets; if the predicted length fills a
                # bucket, grow it and synthesize again
                n_frames = 1 << max(6, int(ids.shape[1] * 4 - 1).bit_length())
                with torch.inference_mode():
                    for _ in range(4):
                        wave, n_valid = vits_synthesize(mparams, mcfg, ids, max_frames=n_frames,
                                                        speaking_rate=self.speed)
                        n = int(n_valid[0])
                        if n < n_frames * mcfg.hop:
                            return wave[0, :n].float().cpu().numpy()
                        n_frames *= 2
                return wave[0].float().cpu().numpy()

            # cross-session batching: sentences from ALL tts nodes sharing
            # this model coalesce into one padded and masked synthesize call
            # per token bucket (4 frames a token, the same growth rule)
            if ctx.batcher is not None:
                tag = f"{self.model_path or 'randinit'}:{self.speed}"

                def make_fn(tb: int):
                    frames = 4 * tb

                    def fn(ids_b: torch.Tensor, mask_b: torch.Tensor):
                        with torch.inference_mode():
                            return vits_synthesize(mparams, mcfg, ids_b, mask=mask_b.float(), max_frames=frames,
                                                   speaking_rate=self.speed)

                    return fn

                async def _synth_batched(sentence: str) -> np.ndarray:
                    ids = _encode(sentence)
                    # coarse buckets (min 64 tokens): typical sentences share
                    # one shape, so concurrent sessions actually coalesce
                    tb = 1 << max(6, (max(1, len(ids)) - 1).bit_length())
                    wave = np.zeros(0, np.float32)
                    for _ in range(4):
                        kind = f"tts_vits:{tag}:{tb}"
                        ctx.batcher.register(kind, make_fn(tb), max_batch=16, transient=True)
                        padded = np.zeros(tb, np.int32)
                        padded[: len(ids)] = ids[:tb]
                        mask = np.zeros(tb, np.float32)
                        mask[: len(ids)] = 1.0
                        wave, n_valid = await ctx.batcher.submit(kind, padded, mask)
                        n = int(n_valid)
                        if n < 4 * tb * mcfg.hop:
                            return np.asarray(wave[:n], np.float32)
                        tb *= 2
                    return np.asarray(wave, np.float32)

                synth_batched = _synth_batched
        else:
            _, acfg, aparams, vcfg, vparams = loaded
            fmt = AudioFormat(self.sample_rate, 1)

            def synth_sync(sentence: str) -> np.ndarray:
                ids = np.frombuffer(sentence.encode()[: acfg.max_text], np.uint8).astype(np.int32)
                if len(ids) == 0:
                    return np.zeros(0, np.float32)
                # frame budget: chars × frames_per_char / speed, in pow-2
                # frame buckets
                want = int(len(ids) * self.frames_per_char / self.speed)
                n_frames = 1 << max(5, (want - 1).bit_length())
                n_frames = min(n_frames, acfg.max_frames)
                with torch.inference_mode():
                    mel = acoustic_generate(aparams, acfg, torch.as_tensor(ids[None], device=dev), n_frames)
                    wav = hifigan_generate(vparams, vcfg, mel)
                keep = int(want * np.prod(vcfg.upsample_rates))
                return wav[0, :keep].float().cpu().numpy()

        async def emit_sentence(sentence: str) -> None:
            nonlocal seq
            if synth_batched is not None:
                wav = await synth_batched(sentence)
            else:
                wav = await loop.run_in_executor(None, synth_sync, sentence)
            if wav.shape[0] == 0:
                return
            telemetry.emit("tts.sentence", {"text": sentence[:120], "samples": int(wav.shape[0])})
            # emit in 20ms frames for downstream pacing/encoding
            frame = (fmt.sample_rate * 20) // 1000
            for i in range(0, len(wav), frame):
                chunk = wav[i: i + frame]
                f = AudioFrame(chunk, fmt)
                await ctx.output.send(
                    "out",
                    Packet.new_audio(f, PacketMetadata(duration_us=f.duration_us(), sequence=seq)),
                )
                seq += 1
                stats.packet_sent()

        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                text = pkt.text if pkt.text is not None else (
                    pkt.transcription.text if pkt.transcription else None
                )
                if not text:
                    stats.packet_discarded()
                    continue
                for sentence in splitter.push(text + " "):
                    await emit_sentence(sentence)
            for sentence in splitter.flush():
                await emit_sentence(sentence)
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
