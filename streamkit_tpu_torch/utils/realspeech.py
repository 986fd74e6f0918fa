# SPDX-License-Identifier: Apache-2.0
"""Real-speech fixture loader for benches, VAD training and quality tests.

Port of ``streamkit_tpu/utils/realspeech.py``. Decodes an Ogg/Opus speech
recording (by default the reference checkout's OpenSpeech excerpt
``samples/audio/system/speech_10m.opus``, freely usable telephony test
speech; ``SK_REAL_SPEECH`` names another) through the port's own media
stack: the Ogg page reader, the libopus binding and a 3:1 box decimation to
16 kHz. Host code only: numpy in, numpy out. Returns ``None`` where the
file or libopus is missing (the card's machine has no libopus); callers
then use the formant synthesizer.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

__all__ = [
    "real_speech_16k",
    "real_speech_available",
    "load_opus_16k",
    "DEFAULT_SAMPLE",
]

DEFAULT_SAMPLE = os.environ.get(
    "SK_REAL_SPEECH", "/root/reference/samples/audio/system/speech_10m.opus"
)

_CACHE: dict = {}


def real_speech_available(path: str = None) -> bool:
    """Whether ``path`` (default :data:`DEFAULT_SAMPLE`) exists and libopus loads."""
    path = path or DEFAULT_SAMPLE
    if not os.path.exists(path):
        return False
    from ..nodes.codecs import opus_available

    return opus_available()


def load_opus_16k(path: str, secs: Optional[float] = None) -> Optional[np.ndarray]:
    """Decode an Ogg/Opus file to "16 kHz" mono f32, as the reference does:
    libopus at 48 kHz stereo, then a 3:1 box mean over the decoder's
    interleaved values; optionally capped at ``secs`` (whole packets: the
    decode stops at the first packet that reaches the cap). ``None`` where
    the file or libopus is unavailable.

    The reference's channel mean never runs (its decoder returns interleaved
    1-D frames), so the box mean takes L/R pairs as consecutive samples and
    the result is the recording at half speed. Kept for parity: the VAD's
    teacher labels and the benches are defined on this signal."""
    if not real_speech_available(path):
        return None
    from ..nodes.codecs.opus import OpusDecoder
    from ..nodes.containers.ogg import OggPageReader

    reader = OggPageReader()
    with open(path, "rb") as f:
        packets = [p for p, _ in reader.feed(f.read())]
    dec = OpusDecoder(48000, 2)
    pcm, total = [], 0
    cap48 = int(secs * 48000) if secs else None
    for pkt in packets[2:]:  # skip OpusHead / OpusTags
        pcm.append(dec.decode(pkt))  # interleaved L, R
        total += len(pcm[-1])
        if cap48 is not None and total >= cap48:
            break
    a48 = np.concatenate(pcm)
    n = len(a48) // 3 * 3
    return a48[:n].reshape(-1, 3).mean(axis=1).astype(np.float32)


def _load(path: str) -> Optional[np.ndarray]:
    if path not in _CACHE:
        _CACHE[path] = load_opus_16k(path)
    return _CACHE[path]


def real_speech_16k(seconds: float, seed: int = 0, path: str = None) -> Optional[np.ndarray]:
    """``seconds`` of real speech at 16 kHz mono, sliced at a seed-dependent
    offset (sessions get different content), or ``None`` when unavailable.
    A length past the recording's end wraps around it."""
    audio = _load(path or DEFAULT_SAMPLE)
    if audio is None:
        return None
    n = int(seconds * 16000)
    if n >= len(audio):
        return np.tile(audio, n // len(audio) + 1)[:n].copy()
    rng = np.random.RandomState(seed)
    off = int(rng.randint(0, len(audio) - n))
    return audio[off : off + n].copy()
