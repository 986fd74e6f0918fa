# SPDX-License-Identifier: Apache-2.0
"""K2 (windowed cache write): its least time from the bytes its windows move
(portbench/roofline/k2.py) over its device time, in the fused calls wholly
in the trace, in percent."""

META = {
    "unit": "%",
    "better": "higher",
    "source": "device_trace",
    "layer": "ops/cache_write.py (K2)",
    "moves": "device_ms_per_audio_s",
}


def read(rec):
    k = (rec.get("trace") or {}).get("k2")
    return 100.0 * k["least_s"] / k["device_s"] if k and k["device_s"] > 0 else None
