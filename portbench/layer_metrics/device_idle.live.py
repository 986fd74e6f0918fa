# SPDX-License-Identifier: Apache-2.0
"""Share of the traced stretch with no operation running on the card, in
percent."""

META = {
    "unit": "%",
    "better": "lower",
    "source": "device_trace",
    "layer": "device",
    "moves": "device_ms_per_audio_s",
}


def read(rec):
    t = rec.get("trace")
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["window_s"] > 0 else None
