# SPDX-License-Identifier: Apache-2.0
"""SenseVoice STT node (``plugin::native::sensevoice``).

Port of ``streamkit_tpu/nodes/ml/sensevoice_node.py``. Parity target:
``plugins/native/sensevoice/`` (sherpa-onnx SenseVoice-small,
config.rs:9-49): VAD-gated segmentation, then one non-autoregressive
encoder + CTC pass per segment on the node's device
(:mod:`streamkit_tpu_torch.models.sensevoice`).

Reference params validated: ``language`` ∈ auto/zh/en/ja/ko/yue, ``use_itn``,
the VAD knobs; ``num_threads`` / ``execution_provider`` are accepted for
YAML compatibility. A model dir holds ``sensevoice.npz``: its ``config``,
its optional ``pieces`` and its weights under '/'-joined keys of the
parameter tree, each applied over the random init after a shape check (the
reference reads the config and pieces and ignores the weights).
"""

from __future__ import annotations

import asyncio
import os
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
from ...models import override_leaves
from ...models.sensevoice import (
    LANGUAGES,
    SenseVoiceConfig,
    ctc_collapse,
    sensevoice_init_numpy,
    sensevoice_params_from_numpy,
    sensevoice_logits,
)
from ...ops.mel import log_mel_spectrogram
from ...ops.vad import VAD_FRAME, vad_frame_probs, vad_init_state
from .vad_node import SpeechSegmenter

_SR = 16000

__all__ = ["SenseVoiceNode", "RANDOM_INIT_CONFIG", "load_sensevoice_dir"]

# the model of a node without a model dir: the reference node's own small
# configuration, drawn from seed 0 (mechanics-only mode)
RANDOM_INIT_CONFIG = SenseVoiceConfig(vocab_size=300, d_model=64, heads=4, ffn_dim=128, layers=2, fsmn_kernel=5)


def load_sensevoice_dir(model_dir: str, dtype=torch.float32, device=None):
    """``model_dir/sensevoice.npz`` → (config, parameters on ``device``,
    pieces or None). Every array key other than ``config`` and ``pieces``
    names a leaf of the parameter tree and replaces its random init."""
    npz = os.path.join(model_dir, "sensevoice.npz")
    if not os.path.exists(npz):
        raise ConfigurationError(f"sensevoice: no sensevoice.npz under {model_dir}")
    data = np.load(npz, allow_pickle=True)
    cfg = SenseVoiceConfig(**data["config"].item())
    pieces = list(data["pieces"]) if "pieces" in data else None
    flat = {k: data[k] for k in data.files if k not in ("config", "pieces")}
    tree = override_leaves(sensevoice_init_numpy(cfg, 0), flat, "sensevoice.npz")
    return cfg, sensevoice_params_from_numpy(tree, cfg, dtype, device), pieces


class SenseVoiceNode(ProcessorNode):
    """RawAudio (16 kHz) → Transcription via SenseVoice-class CTC."""

    KIND = "plugin::native::sensevoice"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "model_dir": None,
                "model_path": None,  # alias
                "language": "auto",
                "use_itn": True,
                "use_vad": True,
                "vad_threshold": 0.5,
                "min_silence_duration_ms": 700.0,
                "max_segment_duration_secs": 30.0,
                "vad_model_path": None,  # accepted (VAD is built in)
                "num_threads": 0,  # accepted for reference-yaml compat
                "execution_provider": "tpu",
                "allow_random_init": True,
                "dtype": "bfloat16",
            },
        )
        self.device = resolve_device(device)
        self.model_dir = cfg["model_dir"] or cfg["model_path"]
        lang = str(cfg["language"]).lower()
        if lang not in LANGUAGES:
            raise ConfigurationError(
                f"sensevoice: unknown language {lang!r} (valid: {sorted(LANGUAGES)})"
            )
        self.language = lang
        self.use_itn = bool(cfg["use_itn"])
        self.use_vad = bool(cfg["use_vad"])
        self.vad_threshold = float(cfg["vad_threshold"])
        self.min_silence_ms = float(cfg["min_silence_duration_ms"])
        self.max_segment_secs = float(cfg["max_segment_duration_secs"])
        self.allow_random_init = bool(cfg["allow_random_init"])
        self.dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.raw_audio(AudioFormat(_SR, 0))])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.transcription())]

    async def _load(self, ctx: NodeContext):
        dev = self.device

        async def loader():
            def build():
                if self.model_dir and os.path.isdir(self.model_dir):
                    return load_sensevoice_dir(self.model_dir, self.dtype, dev)
                if not self.allow_random_init:
                    raise ConfigurationError(f"sensevoice model not found: {self.model_dir}")
                cfg = RANDOM_INIT_CONFIG
                return cfg, sensevoice_params_from_numpy(sensevoice_init_numpy(cfg, 0), cfg, self.dtype, dev), None

            return await asyncio.get_running_loop().run_in_executor(None, build)

        key = ResourceKey.from_params(
            "sensevoice", {"dir": self.model_dir, "dtype": str(self.dtype), "device": str(dev)}
        )
        if ctx.resources is not None:
            return await ctx.resources.get_or_create(key, loader)
        return await loader()

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx)
        cfg, params, pieces = await self._load(ctx)
        ctx.emit_state(NodeState.running())
        loop = asyncio.get_running_loop()
        dev = self.device
        lang_id = LANGUAGES[self.language]
        itn = 1 if self.use_itn else 0

        def _ids_to_text(ids) -> str:
            if pieces is not None:
                return "".join(pieces[i] for i in ids if 0 <= i < len(pieces)).replace("▁", " ").strip()
            return " ".join(str(i) for i in ids)  # mechanics mode: raw ids

        def frame_ids(samples: np.ndarray, n_valid: np.ndarray):
            """``[b, samples]`` audio with valid lengths → (framewise CTC
            argmax ``[b, T_lfr]``, valid-frame mask ``[b, T_lfr]``) on the host."""
            with torch.inference_mode():
                mel = log_mel_spectrogram(torch.as_tensor(samples, device=dev), cfg.n_mels)
                t_lfr = (mel.shape[1] + cfg.lfr_n - 1) // cfg.lfr_n
                # valid lfr frames per row from valid samples (mel hop = 160)
                valid = np.minimum(t_lfr, (n_valid // 160 + cfg.lfr_n - 1) // cfg.lfr_n)
                mask = (np.arange(t_lfr)[None, :] < valid[:, None]).astype(np.float32)
                b = samples.shape[0]
                logits = sensevoice_logits(
                    params, cfg, mel, torch.as_tensor(mask, device=dev),
                    torch.full((b,), lang_id, dtype=torch.int32, device=dev),
                    torch.full((b,), itn, dtype=torch.int32, device=dev),
                )
                # the prefix (language, ITN) drops; the rest is 1:1 with the mask
                return logits[:, 2:].argmax(dim=-1).cpu().numpy(), mask.astype(bool)

        def transcribe_sync(samples: np.ndarray) -> str:
            ids, mask = frame_ids(samples[None, :], np.asarray([samples.shape[0]]))  # every frame valid
            return _ids_to_text(ctc_collapse(ids, mask, cfg.blank_id)[0])

        # cross-session batching: segments from every sensevoice session
        # sharing the model coalesce per pow-2 sample bucket into one CTC
        # forward (valid-length masks per row)
        def _batch_fn(samples_b: np.ndarray, n_valid_b: np.ndarray):
            n_rows = samples_b.shape[0]
            width = 1 << max(0, (n_rows - 1).bit_length())  # pow-2 batch widths
            if width > n_rows:  # duplicate-last padding; rows are independent
                samples_b = np.concatenate([samples_b, np.repeat(samples_b[-1:], width - n_rows, 0)], 0)
                n_valid_b = np.concatenate([n_valid_b, np.repeat(n_valid_b[-1:], width - n_rows, 0)], 0)
            ids, mask = frame_ids(samples_b, n_valid_b)
            id_rows = ctc_collapse(ids[:n_rows], mask[:n_rows], cfg.blank_id)
            out = np.full((n_rows, max(1, max(len(r) for r in id_rows))), -1, np.int32)
            lens = np.zeros(n_rows, np.int32)
            for b, r in enumerate(id_rows):
                out[b, : len(r)] = r
                lens[b] = len(r)
            return out, lens

        async def transcribe_batched(samples: np.ndarray) -> str:
            n = samples.shape[0]
            bucket = 1 << max(14, (n - 1).bit_length())  # >= 1 s at 16 kHz
            padded = np.zeros(bucket, np.float32)
            padded[:n] = samples
            # the fn closes over language and ITN: they are in the kind, so a
            # session with other settings never gets the first registrant's
            kind = f"sensevoice:{id(params)}:{self.language}:{int(self.use_itn)}:{bucket}"
            ctx.batcher.register(kind, _batch_fn, max_batch=16, host_inputs=True, transient=True)
            ids, ln = await ctx.batcher.submit(kind, padded, np.asarray(n, np.int32))
            return _ids_to_text([int(i) for i in ids[: int(ln)]])

        seg = SpeechSegmenter(self.vad_threshold, self.min_silence_ms, self.max_segment_secs)
        state = vad_init_state((), dev)
        buf = np.zeros(0, np.float32)

        async def emit_segment(samples: np.ndarray, start_f: int, end_f: int) -> None:
            if samples.shape[0] < VAD_FRAME:
                return
            if ctx.batcher is not None:
                text = await transcribe_batched(samples)
            else:
                text = await loop.run_in_executor(None, transcribe_sync, samples)
            t0 = start_f * VAD_FRAME * 1000 // _SR
            t1 = end_f * VAD_FRAME * 1000 // _SR
            data = TranscriptionData(
                text=text,
                segments=(TranscriptionSegment(text, int(t0), int(t1)),),
                language=self.language,
            )
            await ctx.output.send(
                "out", Packet.new_transcription(data, PacketMetadata(timestamp_us=int(t0) * 1000))
            )
            telemetry.emit("stt.segment", {"text": text[:120], "start_ms": int(t0)})
            stats.packet_sent()

        async def handle(events) -> None:
            for kind, samples, start_f, end_f in events:
                if kind == "speech_end":  # segment closed with its samples
                    await emit_segment(samples, start_f, end_f)

        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                if pkt.audio is None:
                    stats.packet_discarded()
                    continue
                buf = np.concatenate([buf, pkt.audio.samples])
                n = len(buf) // VAD_FRAME
                if n == 0:
                    continue
                frames = buf[: n * VAD_FRAME].reshape(n, VAD_FRAME)
                buf = buf[n * VAD_FRAME :]
                if self.use_vad:
                    probs, state = vad_frame_probs(state, torch.from_numpy(np.ascontiguousarray(frames, np.float32))
                                                   .to(dev))
                    probs = probs.cpu().numpy()
                else:
                    probs = np.ones(n, np.float32)
                for i in range(n):
                    await handle(seg.push(frames[i], float(probs[i])))
            await handle(seg.flush())
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
