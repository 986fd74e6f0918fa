# SPDX-License-Identifier: Apache-2.0
"""K4 (the decode continuation's cross-attention): its least time from
operations and bytes at each call's encoder horizons
(portbench/roofline/k4.py) over its device time, in the fused calls wholly
in the trace, in percent."""

META = {
    "unit": "%",
    "better": "higher",
    "source": "device_trace",
    "layer": "ops/decode_attention.py (K4)",
    "moves": "device_ms_per_audio_s",
}


def read(rec):
    k = (rec.get("trace") or {}).get("k4")
    return 100.0 * k["least_s"] / k["device_s"] if k and k["device_s"] > 0 else None
