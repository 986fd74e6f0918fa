# SPDX-License-Identifier: Apache-2.0
"""Host milliseconds a fused call takes, by the batcher's own dispatch timer,
over the window's stream_step calls."""

META = {
    "unit": "ms",
    "better": "lower",
    "source": "program_span",
    "layer": "models/whisper/streaming.py (fused step)",
    "moves": "device_ms_per_audio_s",
}


def read(rec):
    live = rec["live"]
    return 1000.0 * live["dispatch_s"] / live["calls"] if live["calls"] else None
