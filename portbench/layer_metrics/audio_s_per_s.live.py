# SPDX-License-Identifier: Apache-2.0
"""Audio seconds of all live sessions that the fused calls consumed, over
the seconds of the window's untraced part (a call's rows spread over its
time): the real-time sessions the card sustains with today's host, which
holds it; it reads the session count only when every session keeps up."""

META = {
    "unit": "audio-s/s",
    "better": "higher",
    "source": "host_clock",
    "layer": "engine/stt_serving.py (service)",
    "moves": "device_ms_per_audio_s",
}


def read(rec):
    return rec["live"]["host_audio_s"] / rec["host_window_s"] if rec["host_window_s"] > 0 else None
