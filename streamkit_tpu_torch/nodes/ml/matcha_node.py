# SPDX-License-Identifier: Apache-2.0
"""Matcha-TTS node (``plugin::native::matcha``).

Port of ``streamkit_tpu/nodes/ml/matcha_node.py``. Parity target:
``plugins/native/matcha/`` (config.rs:9-60): text → flow-matching acoustic
model (a fixed-step Euler ODE over mels,
:mod:`streamkit_tpu_torch.models.matcha`) → HiFi-GAN vocoder
(:mod:`streamkit_tpu_torch.models.tts`) → RawAudio, on the node's device.

Reference params honoured: ``speaker_id``, ``speed`` (= 1 / length scale),
``noise_scale``, ``length_scale``, ``ode_steps``, ``min_sentence_length``;
``num_threads`` / ``execution_provider`` are accepted for YAML compatibility.
A model dir is refused, as the reference refuses it (no checkpoint
conversion yet); without one the node runs the reference's small random
model (seed 0).
"""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    PacketType,
    ProcessorNode,
    ResourceKey,
    TelemetryEmitter,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason
from ...device import resolve_device
from ...models.matcha import MatchaConfig, matcha_init_params, matcha_synthesize_mel
from ...models.tts import HifiGanConfig, hifigan_generate, hifigan_init_params

__all__ = ["MatchaTtsNode", "random_init_config"]


def random_init_config(ode_steps: int, speaker_id: int) -> MatchaConfig:
    """The model of a node without a checkpoint: the reference node's own
    small configuration."""
    return MatchaConfig(vocab_size=256, d_model=64, heads=2, enc_layers=2, ffn_dim=128, dec_channels=64,
                        dec_layers=2, ode_steps=ode_steps, n_speakers=max(1, speaker_id + 1))


class MatchaTtsNode(ProcessorNode):
    """Text/Transcription → synthesized RawAudio via flow matching."""

    KIND = "plugin::native::matcha"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "model_dir": None,
                "model_path": None,  # alias
                "speaker_id": 0,
                "speed": 1.0,
                "noise_scale": 0.667,
                "length_scale": 1.0,
                "ode_steps": 10,
                "min_sentence_length": 10,
                "sample_rate": 22050,
                "num_threads": 0,  # accepted for reference-yaml compat
                "execution_provider": "tpu",
                "allow_random_init": True,
            },
        )
        self.device = resolve_device(device)
        self.model_dir = cfg["model_dir"] or cfg["model_path"]
        self.speaker_id = int(cfg["speaker_id"])
        speed = float(cfg["speed"])
        if not 0.25 <= speed <= 4.0:
            raise ConfigurationError("matcha: speed must be in [0.25, 4.0]")
        # reference semantics: speed is the inverse of length_scale
        self.length_scale = float(cfg["length_scale"]) / speed
        self.noise_scale = float(cfg["noise_scale"])
        self.ode_steps = int(cfg["ode_steps"])
        self.min_sentence_length = int(cfg["min_sentence_length"])
        self.sample_rate = int(cfg["sample_rate"])
        self.allow_random_init = bool(cfg["allow_random_init"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.text(), PacketType.transcription()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.raw_audio(AudioFormat(self.sample_rate, 1)))]

    async def _load(self, ctx: NodeContext):
        dev = self.device

        async def loader():
            def build():
                if self.model_dir and os.path.isdir(self.model_dir):
                    raise ConfigurationError(
                        "matcha: checkpoint conversion not provisioned in this "
                        "environment — run with allow_random_init for mechanics"
                    )
                if not self.allow_random_init:
                    raise ConfigurationError(f"matcha model not found: {self.model_dir}")
                mcfg = random_init_config(self.ode_steps, self.speaker_id)
                vcfg = HifiGanConfig()
                return mcfg, matcha_init_params(mcfg, 0, device=dev), vcfg, hifigan_init_params(vcfg, 0, device=dev)

            return await asyncio.get_running_loop().run_in_executor(None, build)

        key = ResourceKey.from_params("matcha", {"dir": self.model_dir, "spk": self.speaker_id, "device": str(dev)})
        if ctx.resources is not None:
            return await ctx.resources.get_or_create(key, loader)
        return await loader()

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx)
        mcfg, mparams, vcfg, vparams = await self._load(ctx)
        ctx.emit_state(NodeState.running())
        loop = asyncio.get_running_loop()
        dev = self.device
        up = int(np.prod(vcfg.upsample_rates))

        def tokens_for(text: str) -> np.ndarray:
            # byte-level fallback tokenizer (phonemizer-free environments)
            ids = [b % mcfg.vocab_size for b in text.encode()][:256]
            return np.asarray([ids or [0]], np.int32)

        spk = min(self.speaker_id, mcfg.n_speakers - 1)

        def synth_batch(ids_b: torch.Tensor, mask_b: torch.Tensor, max_frames: int):
            """``[b, tb]`` padded tokens + mask → (audio ``[b, samples]``,
            valid samples ``[b]``)."""
            with torch.inference_mode():
                mel, n_frames = matcha_synthesize_mel(
                    mparams, mcfg, ids_b, max_frames, mask=mask_b.float(), speaker_id=spk,
                    noise_scale=self.noise_scale, length_scale=self.length_scale, ode_steps=self.ode_steps,
                )
                if mel.shape[-1] != vcfg.model_in_dim:  # pad mel channels to the vocoder's input
                    mel = F.pad(mel, (0, max(0, vcfg.model_in_dim - mel.shape[-1])))[..., : vcfg.model_in_dim]
                return hifigan_generate(vparams, vcfg, mel), n_frames * up

        def synth_sync(text: str) -> np.ndarray:
            tokens = torch.as_tensor(tokens_for(text), device=dev)
            audio, n = synth_batch(tokens, torch.ones_like(tokens, dtype=torch.float32),
                                   max(32, tokens.shape[1] * 8))
            return audio[0, : int(n[0])].float().cpu().numpy()

        # cross-session batching: sentences pad to pow-2 token buckets (a
        # budget of 8 frames a token) and coalesce across every matcha
        # session sharing the model
        synth_batched = None
        if ctx.batcher is not None:

            def make_fn(tb: int):
                frames = max(32, tb * 8)
                return lambda ids_b, mask_b: synth_batch(ids_b, mask_b, frames)

            async def synth_batched(text: str) -> np.ndarray:
                ids = tokens_for(text)[0]
                tb = 1 << max(5, (max(1, len(ids)) - 1).bit_length())
                # the fn closes over the noise and length scales: they are
                # in the kind, so differently tuned sessions never share one
                kind = (f"matcha:{id(mparams)}:{spk}:{self.ode_steps}:"
                        f"{self.noise_scale}:{self.length_scale}:{tb}")
                ctx.batcher.register(kind, make_fn(tb), max_batch=16, transient=True)
                padded = np.zeros(tb, np.int32)
                padded[: len(ids)] = ids[:tb]
                mask = np.zeros(tb, np.float32)
                mask[: len(ids)] = 1.0
                audio, n = await ctx.batcher.submit(kind, padded, mask)
                return np.asarray(audio[: int(n)], np.float32)

        pending = ""
        fmt = AudioFormat(self.sample_rate, 1)

        async def speak(text: str) -> None:
            if not text.strip():
                return
            if synth_batched is not None:
                audio = await synth_batched(text)
            else:
                audio = await loop.run_in_executor(None, synth_sync, text)
            peak = float(np.abs(audio).max() or 1.0)
            if peak > 1.0:
                audio = audio / peak
            await ctx.output.send("out", Packet.new_audio(AudioFrame(audio, fmt)))
            telemetry.emit("tts.synthesized", {"chars": len(text), "samples": int(len(audio))})
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
                pending += text
                if len(pending) >= self.min_sentence_length:
                    await speak(pending)
                    pending = ""
            if pending:
                await speak(pending)
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
