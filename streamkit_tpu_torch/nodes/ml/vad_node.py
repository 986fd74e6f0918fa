# SPDX-License-Identifier: Apache-2.0
"""Speech segmentation over per-frame VAD probabilities.

A copy of ``SpeechSegmenter`` from ``streamkit_tpu/nodes/ml/vad_node.py``
(the port imports nothing of the JAX package). The segmentation state
machine matches the reference whisper plugin's VAD gating
(``plugins/native/whisper/src/lib.rs:404-490``): speech opens at
``threshold``, closes after ``min_silence_ms`` below it, and is force-cut at
``max_segment_secs``. The graph node (``VadNode``) is not ported yet.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...ops.vad import VAD_FRAME

__all__ = ["SpeechSegmenter"]

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
