# SPDX-License-Identifier: Apache-2.0
"""Device milliseconds that one second of live audio costs: the time with an
operation running on the card during the fused calls that lie wholly in the
trace of the window's last stretch, over the audio seconds of their rows.
1000 over it is the real-time sessions one card's kernels carry once the host
keeps up."""

META = {
    "unit": "ms/audio-s",
    "better": "lower",
    "bound": 0.01,
    "source": "device_trace",
}


def read(rec):
    step = (rec.get("trace") or {}).get("step")
    if not step or step["audio_s"] <= 0 or step["device_s"] <= 0:
        return None
    return 1000.0 * step["device_s"] / step["audio_s"]
