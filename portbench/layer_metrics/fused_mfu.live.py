# SPDX-License-Identifier: Apache-2.0
"""The whole fused step's share of the card's bf16 peak: the useful model
operations (committed chunk positions encoded, decoder tokens fed;
portbench/roofline/whisper.py) of the fused calls wholly in the trace, over
their device time times the peak, in percent."""

META = {
    "unit": "%",
    "better": "higher",
    "source": "device_trace",
    "layer": "models/whisper/streaming.py (fused step)",
    "moves": "device_ms_per_audio_s",
}


def read(rec):
    step = (rec.get("trace") or {}).get("step")
    peak = rec["peaks"]["bf16_flops"] if rec.get("peaks") else None
    if not peak or not step or not step["flops"] or step["device_s"] <= 0:
        return None
    return 100.0 * step["flops"] / (step["device_s"] * peak)
