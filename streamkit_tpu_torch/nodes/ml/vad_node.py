# SPDX-License-Identifier: Apache-2.0
"""Standalone VAD node emitting speech-segment events, and the speech
segmenter it shares with the Whisper node.

Parity target: ``plugins/native/vad`` (sherpa-onnx Silero VAD): emits
``plugin::native::vad/vad-event@1`` Custom packets for speech segments and
optional start/end telemetry. Scoring runs on the node's device
(:func:`streamkit_tpu_torch.ops.vad_frame_probs`); the segmentation state
machine matches the reference whisper plugin's VAD gating
(``plugins/native/whisper/src/lib.rs:404-490``): speech opens at
``threshold``, closes after ``min_silence_ms`` below it, and is force-cut at
``max_segment_secs``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...core import (
    AudioFormat,
    AudioFrame,
    ChannelClosed,
    ConfigurationError,
    CustomPacketData,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketMetadata,
    PacketType,
    ProcessorNode,
    TelemetryEmitter,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason
from ...device import resolve_device
from ...ops.vad import VAD_FRAME, vad_frame_probs, vad_init_state

__all__ = ["SpeechSegmenter", "VadNode", "VAD_EVENT_TYPE_ID"]

VAD_EVENT_TYPE_ID = "plugin::native::vad/vad-event@1"

_SR = 16_000


class SpeechSegmenter:
    """Host-side speech segmentation over per-frame probabilities."""

    def __init__(
        self,
        threshold: float = 0.5,
        min_silence_ms: float = 700.0,
        max_segment_secs: float = 30.0,
        pre_roll_frames: int = 2,
        store_samples: bool = True,
    ) -> None:
        self.threshold = threshold
        self.min_silence_frames = int(min_silence_ms / 1000.0 * _SR / VAD_FRAME)
        self.max_segment_frames = int(max_segment_secs * _SR / VAD_FRAME)
        self.pre_roll_frames = pre_roll_frames
        # serving engines decode from the device ring and only consume
        # (start_frame, end_frame): buffering the frames there is waste
        self.store_samples = store_samples
        self.in_speech = False
        self._silence_run = 0
        self._segment: List[np.ndarray] = []
        self._segment_frames = 0
        self._pre_roll: List[np.ndarray] = []
        self._pre_roll_len = 0
        self._segment_start_frame = 0
        self._frame_idx = 0

    def push(self, frame: np.ndarray, prob: float):
        """Feed one VAD frame → events ``(kind, segment_samples, start_frame,
        end_frame)``, kind ``speech_start`` or ``speech_end``."""
        events = []
        self._frame_idx += 1
        if not self.in_speech:
            if prob >= self.threshold:
                self.in_speech = True
                self._silence_run = 0
                pre = len(self._pre_roll) if self.store_samples else self._pre_roll_len
                if self.store_samples:
                    self._segment = list(self._pre_roll) + [frame]
                self._pre_roll_len = 0
                self._segment_frames = pre + 1
                self._segment_start_frame = self._frame_idx - self._segment_frames
                events.append(("speech_start", None, self._segment_start_frame, None))
            elif self.store_samples:
                self._pre_roll.append(frame)
                if len(self._pre_roll) > self.pre_roll_frames:
                    self._pre_roll.pop(0)
            else:
                # only the pre-roll length matters for start-frame accounting
                self._pre_roll_len = min(self._pre_roll_len + 1, self.pre_roll_frames)
        else:
            if self.store_samples:
                self._segment.append(frame)
            self._segment_frames += 1
            if prob < self.threshold:
                self._silence_run += 1
            else:
                self._silence_run = 0
            if self._silence_run >= self.min_silence_frames or self._segment_frames >= self.max_segment_frames:
                events.append(self._close_segment())
        return events

    def flush(self):
        return [self._close_segment()] if self.in_speech and self._segment_frames else []

    def _close_segment(self):
        samples = np.concatenate(self._segment) if self._segment else np.zeros(0, np.float32)
        start, end = self._segment_start_frame, self._frame_idx
        self.in_speech = False
        self._segment = []
        self._segment_frames = 0
        self._pre_roll = []
        self._pre_roll_len = 0
        self._silence_run = 0
        return ("speech_end", samples, start, end)


class VadNode(ProcessorNode):
    """RawAudio(16 kHz) → VAD events as Custom packets (``plugin::native::vad``)."""

    KIND = "plugin::native::vad"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "threshold": 0.5,
                "min_silence_duration_ms": 700,
                "max_segment_duration_secs": 30.0,
                "emit_telemetry": True,
                "output_mode": "events",  # events | filtered_audio (vad_node.rs:232-244)
                "min_silence_duration_s": None,  # reference second-denominated aliases
                "min_speech_duration_s": None,
                "max_speech_duration_s": None,
                "model_path": None,  # accepted for reference-pipeline compat
                "vad_model_path": None,
            },
        )
        self.device = resolve_device(device)
        self.output_mode = str(cfg["output_mode"])
        if self.output_mode not in ("events", "filtered_audio"):
            raise ConfigurationError(
                f"vad: unknown output_mode {self.output_mode!r} (events | filtered_audio)"
            )
        self.threshold = float(cfg["threshold"])
        if cfg["min_silence_duration_s"] is not None:
            cfg["min_silence_duration_ms"] = float(cfg["min_silence_duration_s"]) * 1000.0
        if cfg["max_speech_duration_s"] is not None:
            cfg["max_segment_duration_secs"] = float(cfg["max_speech_duration_s"])
        self.min_silence_ms = float(cfg["min_silence_duration_ms"])
        self.min_speech_s = float(cfg["min_speech_duration_s"] or 0.0)
        self.max_segment_secs = float(cfg["max_segment_duration_secs"])
        self.emit_telemetry = bool(cfg["emit_telemetry"])

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.raw_audio(AudioFormat(16000, 0))])]

    def output_pins(self) -> List[OutputPin]:
        if self.output_mode == "filtered_audio":
            return [OutputPin("out", PacketType.raw_audio(AudioFormat(16000, 1)))]
        return [OutputPin("out", PacketType.custom(VAD_EVENT_TYPE_ID))]

    async def run(self, ctx: NodeContext) -> None:
        ctx.emit_state(NodeState.running())
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx)
        state = vad_init_state((), self.device)
        seg = SpeechSegmenter(self.threshold, self.min_silence_ms, self.max_segment_secs)
        buf = np.zeros(0, dtype=np.float32)

        async def handle(events) -> None:
            for kind, samples, start_f, end_f in events:
                t_start_ms = start_f * VAD_FRAME * 1000 // _SR
                if kind == "speech_start":
                    if self.emit_telemetry:
                        telemetry.emit("vad.speech_start", {"t_ms": t_start_ms})
                    continue
                t_end_ms = end_f * VAD_FRAME * 1000 // _SR
                if self.emit_telemetry:
                    telemetry.emit("vad.speech_end", {"t_ms": t_end_ms})
                if self.output_mode == "filtered_audio":
                    # RawAudio speech segments (vad_node.rs FilteredAudio mode)
                    await ctx.output.send(
                        "out",
                        Packet.new_audio(
                            AudioFrame(samples, AudioFormat(16000, 1)),
                            PacketMetadata(timestamp_us=int(t_start_ms) * 1000),
                        ),
                    )
                    stats.packet_sent()
                    continue
                data = CustomPacketData(
                    VAD_EVENT_TYPE_ID,
                    {
                        "event": "segment",
                        "start_ms": int(t_start_ms),
                        "end_ms": int(t_end_ms),
                        "duration_ms": int(t_end_ms - t_start_ms),
                        "num_samples": int(samples.shape[0]),
                    },
                )
                await ctx.output.send(
                    "out", Packet.new_custom(data, PacketMetadata(timestamp_us=t_start_ms * 1000))
                )
                stats.packet_sent()

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
                n_frames = len(buf) // VAD_FRAME
                if n_frames == 0:
                    continue
                frames = buf[: n_frames * VAD_FRAME].reshape(n_frames, VAD_FRAME)
                buf = buf[n_frames * VAD_FRAME :]
                probs, state = vad_frame_probs(state, torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(self.device))
                probs = probs.cpu().numpy()
                for i in range(n_frames):
                    await handle(seg.push(frames[i], float(probs[i])))
            await handle(seg.flush())
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
