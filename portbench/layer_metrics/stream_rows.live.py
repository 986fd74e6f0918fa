# SPDX-License-Identifier: Apache-2.0
"""Sessions per fused call in the window: the batcher's items over its calls of
the stream_step kinds."""

META = {
    "unit": "rows",
    "better": "higher",
    "source": "program_counter",
    "layer": "engine/batcher.py",
    "moves": "device_ms_per_audio_s",
}


def read(rec):
    live = rec["live"]
    return live["items"] / live["calls"] if live["calls"] else None
